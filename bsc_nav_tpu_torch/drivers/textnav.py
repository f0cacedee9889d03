"""Text-instance navigation driver (reference
textnav_benchmark.py:45-156): goals described by intrinsic + extrinsic
attribute texts, merged by the LLM into one imagination prompt.

  python -m bsc_nav_tpu_torch.drivers.textnav --env fake --episodes 5 --llm mock

The port's counterpart of ``benchmarks/textnav.py`` over the port's robot;
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
    p.add_argument("--attributes-json", type=str, default=None,
                   help="per-episode intrinsic/extrinsic attribute texts "
                        "(textnav_benchmark.py:125-127)")
    args = p.parse_args(argv)
    csv_path = args.csv or "textnav_results.csv"

    cfg, bench, memory, extras = S.build_world(args, task="textnav")
    if args.attributes_json:
        # per-episode intrinsic/extrinsic attribute texts keyed by
        # episode index or object category (textnav_benchmark.py:125-127)
        import json
        with open(args.attributes_json) as f:
            attrs = json.load(f)
        for i, ep in enumerate(bench.episodes):
            a = attrs.get(str(i)) or attrs.get(ep.object_category)
            if a:
                ep.intrinsic_attributes = a.get("intrinsic_attributes",
                                                a.get("intrinsic"))
                ep.extrinsic_attributes = a.get("extrinsic_attributes",
                                                a.get("extrinsic"))
    robot = ObjectNavRobot(memory, bench, llm_client=extras["llm"],
                           matcher=extras["matcher"],
                           llm_model=args.llm_model)

    def episode_fn(robot, ep):
        robot.move2text_attributes_prompt(
            ep.intrinsic_attributes or f"a {ep.object_category}",
            ep.extrinsic_attributes or "")

    def metrics_fn(robot, bench, ep):
        m = bench.get_metrics()
        island, area = S.island_stats(bench)
        goal = ((ep.intrinsic_attributes or "") + "...... "
                + (ep.extrinsic_attributes or ""))
        return {
            "success": m["success"], "spl": m["spl"],
            "distance_to_goal": m["distance_to_goal"],
            "object_goal": goal,
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
