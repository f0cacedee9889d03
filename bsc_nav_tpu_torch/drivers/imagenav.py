"""Instance-ImageNav driver (reference imagenav_benchmark.py:44-147):
the goal is an image of the target instance; localization runs the
image-query path (no diffusion).

  python -m bsc_nav_tpu_torch.drivers.imagenav --env fake --episodes 5 --llm mock

The port's counterpart of ``benchmarks/imagenav.py`` over the port's robot;
``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse

from bsc_nav_tpu_torch.drivers import common as C
from bsc_nav_tpu_torch.drivers import setup as S
from bsc_nav_tpu_torch.agents.robot import ObjectNavRobot


def main(argv=None):
    p = argparse.ArgumentParser()
    S.add_common_args(p)
    args = p.parse_args(argv)
    csv_path = args.csv or "imagenav_results.csv"

    cfg, bench, memory, extras = S.build_world(args, task="imagenav")
    robot = ObjectNavRobot(memory, bench, llm_client=extras["llm"],
                           matcher=extras["matcher"],
                           llm_model=args.llm_model)

    def episode_fn(robot, ep):
        goal_img = ep.goal_image
        if goal_img is None and "imagination" in extras:
            goal_img = extras["imagination"](ep.object_category)[0]
        robot.move2imgprompt(goal_img)

    def metrics_fn(robot, bench, ep):
        m = bench.get_metrics()
        island, area = S.island_stats(bench)
        return {
            "success": m["success"], "spl": m["spl"],
            "distance_to_goal": m["distance_to_goal"],
            "object_goal": ep.object_category,
            "id": ep.scene_id, "island": island, "island_area": area,
            **C.nav_telemetry(robot),
        }

    return C.run_episodes(
        robot, bench, args.episodes, episode_fn, metrics_fn, csv_path,
        log_root=args.log_root, record_video=args.record_video,
        ensure_memory=S.ensure_memory_fake if args.env == "fake" else None,
        num_workers=args.num_workers, worker_id=args.worker_id)


if __name__ == "__main__":
    main()
