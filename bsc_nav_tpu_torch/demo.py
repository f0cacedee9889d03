"""Unified navigation demo (reference demo.py:150 `NavigationDemo`).

Counterpart of the JAX package's root ``demo.py``: one CLI covering the
interactive navigation modes over either backend, on the card unless
``--device cpu`` asks for the CPU:

  python -m bsc_nav_tpu_torch.demo --nav-mode category --goal bed
  python -m bsc_nav_tpu_torch.demo --nav-mode text --goal "a red bed"
  python -m bsc_nav_tpu_torch.demo --nav-mode image --goal-image goal.png
  python -m bsc_nav_tpu_torch.demo --nav-mode localize --goal bed,sofa
  python -m bsc_nav_tpu_torch.demo --nav-mode interactive

Runs fully offline on the fake box world with the mock LLM; pass
--llm openai + --env habitat for real deployments.  Images are read and
written as PNG by ``agents/llm``'s codec (a goal image must be a PNG).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from bsc_nav_tpu_torch.agents.robot import ObjectNavRobot
from bsc_nav_tpu_torch.drivers import setup as S
from bsc_nav_tpu_torch.utils.visualize import (
    read_rgb_png, render_pointcloud_png, render_topdown_png, write_png)


def main(argv=None):
    p = argparse.ArgumentParser()
    S.add_common_args(p)
    p.add_argument("--nav-mode", default="category",
                   choices=["category", "text", "image", "localize",
                            "interactive"])
    p.add_argument("--goal", type=str, default="bed")
    p.add_argument("--goal-image", type=str, default=None,
                   help="goal image (PNG) for --nav-mode image")
    p.add_argument("--out-dir", type=str, default="./demo_out")
    p.add_argument("--window", action="store_true",
                   help="cv2 live view in interactive mode (needs a "
                        "display; falls back to terminal-only)")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    cfg, bench, memory, extras = S.build_world(args, task="objnav")
    obs = bench.reset()

    # build the scene memory (shared helper with the drivers)
    S.build_memory_fake(memory, bench)
    print(f"memory built: {int(memory.state.num_voxels)} voxels, "
          f"{len(memory.long_memory_dict)} instances")

    render_topdown_png(memory.state,
                       os.path.join(args.out_dir, "topdown.png"),
                       cfg.memory.grid_size)

    if args.nav_mode == "interactive":
        # port of the reference's keyboard robot (agent.py:27, :341):
        # w/a/s/d + u/j to look, 'nav <prompt>' for two-stage retrieval
        # navigation, 'save' to dump the current view, 'q' quit.  With
        # --window (and a display) a cv2 live view tracks every step,
        # like the reference's cv2.imshow loop; otherwise terminal-only.
        robot = ObjectNavRobot(memory, bench, llm_client=extras["llm"],
                               matcher=extras["matcher"],
                               llm_model=args.llm_model)
        robot.reset(obs, log_dir=args.out_dir)
        keymap = {"w": "move_forward", "a": "turn_left", "d": "turn_right",
                  "s": "move_backward", "u": "look_up", "j": "look_down"}

        show = None
        has_display = bool(os.environ.get("DISPLAY")
                           or os.environ.get("WAYLAND_DISPLAY"))
        if args.window and not has_display:
            # cv2's Qt backend ABORTS (not raises) without a display
            print("no DISPLAY; terminal mode")
        elif args.window:
            try:
                import cv2
                cv2.namedWindow("bsc-nav", cv2.WINDOW_NORMAL)

                def show():
                    cur = bench.sim.get_sensor_observations(0)
                    bgr = np.asarray(cur["rgb"])[:, :, :3][:, :, ::-1]
                    cv2.imshow("bsc-nav", bgr)
                    cv2.waitKey(1)
                show()
            except Exception as e:               # noqa: BLE001
                print(f"cv2 window unavailable ({e}); terminal mode")
                show = None
        print("interactive mode: w/a/s/d/u/j move, 'nav <prompt>' to "
              "navigate, 'save' to dump view, 'q' to quit")
        step_i = 0
        while True:
            try:
                cmd = input("> ").strip()
            except EOFError:
                break
            if cmd == "q":
                break
            if cmd == "save":
                cur = bench.sim.get_sensor_observations(0)
                out = os.path.join(args.out_dir, f"view_{step_i}.png")
                write_png(np.asarray(cur["rgb"])[:, :, :3], out)
                print(f"saved {out}")
                continue
            if cmd.startswith("nav "):
                robot.move2textprompt(cmd[4:])
                print("nav done:", bench.get_metrics())
                continue
            if cmd in keymap:
                robot.execute_path([keymap[cmd]])
                step_i += 1
                st = bench.sim.agents[0].get_state()
                print(f"pos={np.round(st.position, 2)} "
                      f"yaw={st.rotation.yaw():.2f}")
                if show is not None:
                    show()
                continue
            print("unknown command")
        return

    if args.nav_mode == "localize":
        goals = [g.strip() for g in args.goal.split(",") if g.strip()]
        # ONE localization pass per goal (batched when multi-goal);
        # centers clustered from the SAME results the renders use, with
        # the config's clustering knobs (not the DBSCAN defaults)
        from bsc_nav_tpu_torch.agents.clustering import (
            weighted_cluster_centers)
        results = (memory.voxel_localized_batch(goals)
                   if len(goals) > 1 else
                   [memory.voxel_localized(goals[0])])
        for i, (g, (best, topk, sims)) in enumerate(zip(goals, results)):
            centers, _, _ = weighted_cluster_centers(
                topk, sims, eps=cfg.query.cluster_eps,
                min_samples=cfg.query.cluster_min_samples)
            print(f"{g}: cluster centers: {centers}")
            suffix = f"_{i}_{g}" if len(goals) > 1 else ""
            np.save(os.path.join(
                args.out_dir, f"best_pos_topK_text_prompt{suffix}.npy"),
                np.asarray(topk))
            render_pointcloud_png(
                memory.state,
                os.path.join(args.out_dir, f"localize{suffix}.png"),
                highlight=topk, centers=centers)
        print(f"results saved under {args.out_dir}")
        return

    robot = ObjectNavRobot(memory, bench, llm_client=extras["llm"],
                           matcher=extras["matcher"],
                           llm_model=args.llm_model)
    robot.reset(obs, log_dir=args.out_dir)

    if args.nav_mode == "category":
        robot.move2textprompt(f"a {args.goal}")
    elif args.nav_mode == "text":
        robot.move2NaturalLanguageprompt(args.goal)
    elif args.nav_mode == "image":
        if args.goal_image:
            goal = read_rgb_png(args.goal_image)
        else:
            goal = extras["imagination"](args.goal)[0]
        robot.move2imgprompt(goal)

    m = bench.get_metrics()
    print(f"done: success={m['success']} spl={m['spl']:.3f} "
          f"distance={m['distance_to_goal']:.2f} "
          f"steps={len(robot.action_hist)}")
    from bsc_nav_tpu_torch.drivers.common import save_video
    save_video(robot.episode_images,
               os.path.join(args.out_dir, "navigation.mp4"))
    print(f"outputs saved under {args.out_dir}")


if __name__ == "__main__":
    main()
