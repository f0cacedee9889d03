"""ObjectNavRobot: the episode-scoped navigation agent.

Counterpart of ``bsc_nav_tpu/agents/robot.py`` over the port's
``VoxelTokenMemory``: two-stage memory retrieval (long-term instance
memory first, working-memory voxel query second), waypoint navigation on
the pathfinder, 360-degree view scan scored by the view scorer (CLIP
role), VLM success judging, VLN subgoal decomposition, and per-episode
logging/telemetry.  The body is host control flow, carried over line for
line; what the memory does on the card (a text query's imagination and
scan, the batched radius sweep, the matcher's towers) sits behind the
memory and matcher calls.

All model/LLM dependencies are injected (llm client, view scorer/label
matcher, memory), so the full control flow is testable offline.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Sequence

import numpy as np

from bsc_nav_tpu_torch import geometry as G
from bsc_nav_tpu_torch.agents import llm as L
from bsc_nav_tpu_torch.agents.clustering import weighted_cluster_centers
from bsc_nav_tpu_torch.agents.spatial_memory import VoxelTokenMemory

# output-contract regexes (reference objnav_benchmark.py:303-307)
PATTERN_LOC = re.compile(r"Nav Loc:\s*\[(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\]")
PATTERN_UNABLE = re.compile(r"Nav Loc:\s*Unable to find", re.IGNORECASE)
PATTERN_SUCCESS = re.compile(r"success:\s*(yes|no)", re.IGNORECASE)
PATTERN_FORWARD = re.compile(r"need forward:\s*(yes|no)", re.IGNORECASE)
PATTERN_RESULT = re.compile(r"\*\*Result\*\*: \((.*?)\)")
PATTERN_RESULT_LOC = re.compile(r"Nav Loc \d+: \[(\d+),\s*(\d+),\s*(\d+)\]")
PATTERN_STRATEGY = re.compile(r"\*\*Strategy\*\*:\s*'([^']*)'")
PATTERN_ENHANCE = re.compile(
    r"\*\*Enhancement Description\*\*:\s*(.*?)(?=\n|\Z)", re.DOTALL)


class ObjectNavRobot:
    def __init__(self, memory: VoxelTokenMemory, benchmark_env,
                 llm_client: Optional[L.ChatClient] = None,
                 matcher=None, task: str = "objnav",
                 llm_model: str = "gpt-4o"):
        self.memory = memory
        self.benchmark_env = benchmark_env
        self.client = llm_client or L.OpenAICompatClient()
        self.matcher = matcher        # ViewScorer + LabelMatcher
        self.task = task
        self.llm_model = llm_model

        self.nav_log = {"long_memory_query": 0, "working_memory_query": 0,
                        "search_point": 0, "success": 0}
        self.state_hist: List = []
        self.action_hist: List[str] = []
        self.agent_response_log: List = []
        self.loc_hist = {"long_memory": [], "working_memory": []}
        self.obss: List[np.ndarray] = []
        self.episode_images: List[np.ndarray] = []
        self.episode_topdowns: List[np.ndarray] = []
        self.record_topdowns = False
        self.log_dir = "./tmp/trajectory_0"
        self.curr_obs = None
        self.task_over = False

    # ------------------------------------------------------------------
    def reset(self, obs=None, log_dir: Optional[str] = None):
        self.curr_obs = obs
        self.episode_images = [obs["rgb"]] if obs is not None else []
        self.episode_topdowns = []
        self.nav_log = {"long_memory_query": 0, "working_memory_query": 0,
                        "search_point": 0, "success": 0}
        self.state_hist, self.action_hist = [], []
        self.agent_response_log = []
        self.loc_hist = {"long_memory": [], "working_memory": []}
        self.obss = []
        self.task_over = False
        if log_dir is not None:
            self.log_dir = log_dir
            os.makedirs(log_dir, exist_ok=True)

    # --- grid <-> world (reference objnav_benchmark.py:452-475; the
    # formulas live in geometry.py -- single source of truth) ------------
    def _grid2loc(self, grid_id) -> np.ndarray:
        init = self.memory.Env.original_state.position
        out = G.grid_to_world_2d(grid_id, init, self.memory.gs,
                                 self.memory.cs)
        agent_h = self.benchmark_env.sim.agents[0].get_state().position[1]
        out[1] = agent_h + 0.2
        return out

    def _loc2grid(self, loc) -> np.ndarray:
        init = self.memory.Env.original_state.position
        return G.world_to_grid_3d(loc, init, self.memory.gs,
                                  self.memory.cs, self.memory.minh)

    # ------------------------------------------------------------------
    # retrieval stage 1: long-term instance memory
    # ------------------------------------------------------------------
    def long_term_memory_retrival_v2(self, text_prompt: str):
        """Label-matcher variant (objnav_benchmark.py:519-574): best label
        by embedding similarity, candidates scored
        0.2*(1-dist) + 0.8*confidence, top-3."""
        memory_dict = self.memory.long_memory_filter()
        if not memory_dict:
            return None
        label_data = {}
        for item in memory_dict:
            d = label_data.setdefault(item["label"],
                                      {"locs": [], "confidences": []})
            d["locs"].append(item["loc"])
            d["confidences"].append(item["confidence"])
        labels = list(label_data.keys())
        if self.matcher is None:
            idx = 0
        else:
            idx = self.matcher.best(text_prompt, labels)
        best = label_data[labels[idx]]
        locs = np.asarray(best["locs"], float)
        confs = np.asarray(best["confidences"], float)
        self._save_query_artifact(f"best_locs_{text_prompt}.npy", locs)

        agent_loc = self._loc2grid(
            self.benchmark_env.sim.agents[0].get_state().position)
        dist = np.linalg.norm(locs - agent_loc, axis=1)
        nd = (dist - dist.min()) / (dist.max() - dist.min() + 1e-6)
        nc = (confs - confs.min()) / (confs.max() - confs.min() + 1e-6)
        scores = 0.2 * (1 - nd) + 0.8 * nc
        top_k = min(3, len(locs))
        order = np.argsort(scores)[-top_k:][::-1]
        return locs[order]

    def long_term_memory_retrival(self, text_prompt: str):
        """LLM variant (objnav_benchmark.py:497-517)."""
        memory_dict = self.memory.long_memory_filter()

        def ask():
            return L.long_memory_localized(
                self.client, text_prompt, memory_dict, model=self.llm_model)

        def valid(ans):
            return bool(PATTERN_UNABLE.search(ans)
                        or PATTERN_RESULT.search(ans))

        answer = L.retry(ask, validate=valid)
        self.agent_response_log.append(answer)
        if PATTERN_UNABLE.search(answer):
            return None
        m = PATTERN_RESULT.search(answer)
        locs = PATTERN_RESULT_LOC.findall(m.group(1)) if m else []
        if not locs:
            return None
        return np.array([[int(a), int(b), int(c)] for a, b, c in locs])

    # ------------------------------------------------------------------
    # retrieval stage 2: working memory
    # ------------------------------------------------------------------
    def working_memory_retrival(self, prompts, vis_aug: bool = False,
                                text_aug: bool = True,
                                region_radius: float = np.inf,
                                curr_grid=None):
        """(objnav_benchmark.py:585-662).  Returns np.array([centers])."""
        if curr_grid is None and np.isfinite(region_radius):
            curr = self.benchmark_env.sim.agents[0].get_state().position
            curr_grid = self._loc2grid(curr)

        vis = None
        if vis_aug:
            n = int(360 / self.memory.cfg.actions.turn_left_deg)
            self.execute_path(["turn_left"] * n, save_img_list=True)
            vis = self.obss[:: max(1, len(self.obss) // 2)]

        if isinstance(prompts, str):
            if text_aug:
                if vis:
                    ans = L.retry(
                        lambda: L.imagenary_helper_visaug(
                            self.client, prompts, vis),
                        validate=lambda a: bool(PATTERN_ENHANCE.search(a)))
                    prompt_ext = PATTERN_ENHANCE.search(ans).group(1).strip()
                else:
                    prompt_ext = L.retry(
                        lambda: L.imagenary_helper(self.client, prompts))
            else:
                prompt_ext = prompts
            best, topk, sims = self.memory.voxel_localized(
                prompt_ext, region_radius=region_radius, curr_grid=curr_grid)
        elif isinstance(prompts, list):
            prompt_ext = L.retry(
                lambda: L.imagenary_helper_long_text(self.client, prompts))
            best, topk, sims = self.memory.voxel_localized(
                prompt_ext, region_radius=region_radius, curr_grid=curr_grid)
        else:
            best, topk, sims = self.memory.voxel_localized(
                prompts, region_radius=region_radius, curr_grid=curr_grid)

        return self._cluster_and_log(prompts, topk, sims)

    def _cluster_and_log(self, prompts, topk, sims):
        """Shared working-memory tail: DBSCAN centers + query artifacts
        (objnav_benchmark.py:477-495, :649-659)."""
        if len(topk) == 0:
            return np.array([np.zeros((0, 3))])
        centers, _, _ = weighted_cluster_centers(
            topk, sims, eps=self.memory.cfg.query.cluster_eps,
            min_samples=self.memory.cfg.query.cluster_min_samples)
        if len(centers) == 0:
            centers = np.asarray(topk[:1], float)
        # per-query debug artifacts (objnav_benchmark.py:649-659; text
        # prompts truncated to 64 chars like the reference)
        if isinstance(prompts, str):
            tag = prompts[:64]
            self._save_query_artifact(f"best_pos_topK_{tag}.npy",
                                      np.asarray(topk))
            self._save_query_artifact(f"best_pos_centers_{tag}.npy",
                                      np.asarray(centers))
        return np.array([centers])

    def _prefetch_working_memory(self, text_prompt: str):
        """Dispatch stage-2 retrieval (prompt extension + the text query
        on the card, ``VoxelTokenMemory.voxel_localized_async``) WITHOUT
        waiting: returns a thunk producing working_memory_retrival's
        result, or None when the async path is unavailable.  Called at
        the decision point so the card runs the diffusion sampling and
        the store scan WHILE the host walks the stage-1 candidates (the
        reference runs the stages strictly serially)."""
        if not isinstance(text_prompt, str):
            return None
        dispatch = getattr(self.memory, "voxel_localized_async", None)
        im = getattr(self.memory, "imagination", None)
        # cheap eligibility precheck BEFORE the prompt-extension LLM
        # call (a plain-callable imagination renders on the host and
        # takes the blocking path; don't pay a network round trip to
        # find out)
        if dispatch is None or im is None or not hasattr(im, "imagine_core"):
            return None
        prompt_ext = L.retry(
            lambda: L.imagenary_helper(self.client, text_prompt))
        thunk = dispatch(prompt_ext)
        if thunk is None:
            return None

        def finish():
            best, topk, sims = thunk()
            return self._cluster_and_log(text_prompt, topk, sims)

        return finish

    def _save_query_artifact(self, name: str, arr: np.ndarray) -> None:
        """Best-effort npy dump beside the memory bundle (the reference
        writes retrieval artifacts into memory_save_path,
        objnav_benchmark.py:560,653-659)."""
        path = getattr(self.memory, "memory_save_path", None)
        if not path:
            return
        try:
            os.makedirs(path, exist_ok=True)
            np.save(os.path.join(path, name.replace("/", "_")), arr)
        except OSError:
            pass

    # ------------------------------------------------------------------
    # locomotion + verification
    # ------------------------------------------------------------------
    def execute_path(self, path: Sequence[str],
                     save_img_list: bool = False):
        """(objnav_benchmark.py:805-831): step the benchmark env, record
        history, then sync the memory env to the benchmark agent state."""
        if self.obss:
            self.obss = []
        for action in path:
            self.action_hist.append(action)
            self.state_hist.append(
                self.benchmark_env.sim.agents[0].get_state())
            self.curr_obs = self.benchmark_env.step(action)
            self.episode_images.append(np.asarray(self.curr_obs["rgb"]))
            if self.record_topdowns:
                m = self.benchmark_env.get_metrics()
                if "top_down_map" in m:
                    self.episode_topdowns.append(m["top_down_map"])
            if save_img_list:
                self.obss.append(np.asarray(self.curr_obs["rgb"])[:, :, :3])
        agent_state = self.benchmark_env.sim.agents[0].get_state()
        self.memory.Env.agent.set_state(agent_state)

    def handle_succeed_check(self, prompt, obss):
        """(objnav_benchmark.py:766-802): VLM judge with contract parse."""
        def ask():
            if isinstance(prompt, str):
                return L.succeed_determine_singleview(
                    self.client, prompt, obss, model=self.llm_model)
            return L.succeed_determine_singleview_with_imggoal(
                self.client, prompt, obss, model=self.llm_model)

        answer = L.retry(
            ask, validate=lambda a: bool(PATTERN_SUCCESS.search(a)))
        self.agent_response_log.append(answer)
        status = PATTERN_SUCCESS.search(answer).group(1).lower()
        if status == "no":
            return False, False
        fwd = PATTERN_FORWARD.search(answer)
        return True, bool(fwd and fwd.group(1).lower() == "yes")

    def check_around(self, prompt, max_around: int = 2):
        """360-degree scan -> face the best view -> VLM verdict
        (objnav_benchmark.py:698-763)."""
        n_turns = int(360 / self.memory.cfg.actions.turn_left_deg)
        for j in range(max_around):
            self.execute_path(["turn_left"] * n_turns, save_img_list=True)
            views = self.obss
            if self.matcher is not None:
                sims = self.matcher.score(views, prompt)
            else:
                sims = np.full(len(views), 1.0 / len(views))
            max_idx = int(np.argmax(sims))
            match_obs = [views[max_idx]]

            idx = max_idx % n_turns
            target_angle = idx * self.memory.cfg.actions.turn_left_deg
            if target_angle <= 180:
                actions = ["turn_left"] * idx
            else:
                actions = ["turn_right"] * (n_turns - idx)
            self.execute_path(actions)

            success, need_forward = self.handle_succeed_check(
                prompt, match_obs)
            if success:
                self.task_over = True
                if need_forward:
                    self.execute_path(["move_forward"] * 5)
                return
            if j < max_around - 1:
                self.execute_path(["look_down"])
            else:
                up = ["look_up"] * (max_around - 1)
                if up:
                    self.execute_path(up)

    def touching_goal(self, text: str, obss, max_steps: int = 3):
        """LLM local stepper (objnav_benchmark.py:665-695)."""
        current = obss
        for _ in range(max_steps):
            answer = L.retry(
                lambda: L.touching_helper(self.client, text, current,
                                          model=self.llm_model),
                validate=lambda a: bool(PATTERN_STRATEGY.search(a)))
            strategy = PATTERN_STRATEGY.search(answer).group(1)
            if strategy == "finish_task":
                break
            if strategy not in ("move_forward", "turn_left", "turn_right",
                                "look_up", "look_down"):
                continue
            self.execute_path([strategy] * 4, save_img_list=True)
            current = [self.obss[-1]]

    # ------------------------------------------------------------------
    # navigation entry points (reference move2* family)
    # ------------------------------------------------------------------
    def _navigate_candidates(self, best_poses, prompt,
                             max_candidates: int = 3) -> bool:
        """Shared candidate loop: plan -> walk -> check_around."""
        if best_poses is None:
            return False
        cands = best_poses[0][:max_candidates] if best_poses.ndim == 3 \
            else best_poses[:max_candidates]
        key = ("long_memory" if best_poses.ndim == 2 else "working_memory")
        self.loc_hist[key].extend(np.asarray(cands).tolist())
        for best_pos in cands:
            self.nav_log[f"{key}_query"] += 1
            self.nav_log["search_point"] += 1
            loc = self._grid2loc(best_pos)
            try:
                path, goal = self.memory.Env.move2point(loc)
                if len(path) > self.memory.cfg.agent.max_path_len:
                    continue
                self.execute_path(path[:-1])
            except Exception as e:      # noqa: BLE001 (planner failures)
                print(f"move2point failed: {e}")
                continue
            self.check_around(prompt)
            if self.task_over:
                return True
        return False

    def _finish(self):
        self.execute_path(["stop"])
        self.save_log()
        return self.episode_images

    def move2textprompt(self, text_prompt: str):
        """(objnav_benchmark.py:871-934).  Stage-2 retrieval is
        PREFETCHED before stage-1 navigation begins: both device
        programs (CLIP label match + fused imagination/localize) are in
        flight off one decision point, and the big program's sync
        overlaps the stage-1 walk instead of blocking after it."""
        self.curr_obs = self.benchmark_env.sim.get_sensor_observations(0)
        self.task_over = False
        pending = None
        if not self.memory.cfg.agent.use_only_working_memory:
            best = self.long_term_memory_retrival_v2(text_prompt)
            if best is not None:
                pending = self._prefetch_working_memory(text_prompt)
                if self._navigate_candidates(best, text_prompt):
                    self.nav_log["success"] = 1
                    return self._finish()
        best = (pending() if pending is not None
                else self.working_memory_retrival(text_prompt))
        if self._navigate_candidates(best, text_prompt):
            self.nav_log["success"] = 1
        return self._finish()

    def move2imgprompt(self, goal_image):
        """(objnav_benchmark.py:936-972)."""
        self.curr_obs = self.benchmark_env.sim.get_sensor_observations(0)
        self.task_over = False
        best = self.working_memory_retrival(goal_image)
        if self._navigate_candidates(best, goal_image):
            self.nav_log["success"] = 1
        return self._finish()

    def move2NaturalLanguageprompt(self, text_prompt: str):
        """(objnav_benchmark.py:975-1012)."""
        self.curr_obs = self.benchmark_env.sim.get_sensor_observations(0)
        self.task_over = False
        best = self.working_memory_retrival(text_prompt, vis_aug=False)
        if self._navigate_candidates(best, text_prompt, max_candidates=5):
            self.nav_log["success"] = 1
        return self._finish()

    def move2text_attributes_prompt(self, goal_text_intrinsic: str,
                                    goal_text_extrinsic: str):
        """(objnav_benchmark.py:1014-1051)."""
        self.curr_obs = self.benchmark_env.sim.get_sensor_observations(0)
        self.task_over = False
        prompt = [goal_text_intrinsic, goal_text_extrinsic]
        self.agent_response_log.append(prompt)
        best = self.working_memory_retrival(prompt, vis_aug=False)
        if self._navigate_candidates(best, prompt[0], max_candidates=5):
            self.nav_log["success"] = 1
        return self._finish()

    def move2subgoal(self, best_poses, text_prompt: str) -> bool:
        """(objnav_benchmark.py:1054-1078)."""
        return self._navigate_candidates(best_poses, text_prompt,
                                         max_candidates=2)

    def move2textprompt_adaptive_region(self, text_prompt: str,
                                        text_aug: bool = False,
                                        radius: float = 30.0) -> bool:
        """Growing-radius regional search (objnav_benchmark.py:1080-1100).

        The query vector is radius-independent and the store is frozen
        during navigation, so ALL radii are localized in one batched
        store pass (voxel_localized_batch with per-query region masks)
        instead of one imagination run + store scan + device sync per
        radius; the agent then walks the precomputed candidate sets in
        radius order."""
        self.task_over = False
        curr = self.benchmark_env.sim.agents[0].get_state().position
        curr_grid = self._loc2grid(curr)
        radii = [radius + 10.0 * i for i in range(3)]

        if isinstance(text_prompt, str) and text_aug:
            prompt_ext = L.retry(
                lambda: L.imagenary_helper(self.client, text_prompt))
        else:
            prompt_ext = text_prompt
        results = self.memory.voxel_localized_batch(
            [prompt_ext] * len(radii), region_radii=radii,
            curr_grid=curr_grid)

        for _, topk, sims in results:
            if len(topk) == 0:
                continue
            centers, _, _ = weighted_cluster_centers(
                topk, sims, eps=self.memory.cfg.query.cluster_eps,
                min_samples=self.memory.cfg.query.cluster_min_samples)
            if len(centers) == 0:
                centers = np.asarray(topk[:1], float)
            if len(centers) > 1:
                d = np.linalg.norm(
                    np.asarray(centers, float) - curr_grid, axis=1)
                centers = np.asarray(centers)[np.argsort(d)]
            if self.move2subgoal(np.array([centers]), text_prompt):
                return True
        return False

    def move2VLNprompt(self, text_prompt: str):
        """Instruction following: LLM subgoals -> anchors -> regional
        search (objnav_benchmark.py:1102-1142)."""
        self.curr_obs = self.benchmark_env.sim.get_sensor_observations(0)
        self.task_over = False
        self.agent_response_log.append(text_prompt)

        subgoals = L.retry(
            lambda: L.vln_subgoal_planner_with_obs(self.client, text_prompt),
            validate=lambda a: "{" in a)
        self.agent_response_log.append(subgoals)
        subgoal_list = []
        for line in subgoals.split("\n"):
            if "{" not in line:
                continue
            subgoal_list.append(line.split("{")[1].split("}")[0].strip())

        n_turns = int(360 / self.memory.cfg.actions.turn_left_deg)
        for subgoal in subgoal_list:
            self.execute_path(["turn_left"] * n_turns, save_img_list=True)
            anchor = L.retry(
                lambda: L.vln_anchor_planner_v2(
                    self.client, subgoal, self.obss))
            self.agent_response_log.append(anchor)
            ok = self.move2textprompt_adaptive_region(
                anchor, text_aug=False, radius=50)
            if not ok:
                print(f"failed to reach subgoal: {subgoal}")
        if self.task_over:
            self.nav_log["success"] = 1
        return self._finish()

    # ------------------------------------------------------------------
    def save_log(self):
        """(objnav_benchmark.py:833-868)."""
        def ser(o):
            if hasattr(o, "tolist"):
                return o.tolist()
            if hasattr(o, "__dict__"):
                return {k: ser(v) for k, v in vars(o).items()
                        if not k.startswith("_")}
            if isinstance(o, (list, tuple)):
                return [ser(i) for i in o]
            if isinstance(o, dict):
                return {k: ser(v) for k, v in o.items()}
            if isinstance(o, (int, float, str, bool)) or o is None:
                return o
            return str(o)

        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "log_data.json"), "w") as f:
            json.dump({
                "state_hist": ser(self.state_hist),
                "agent_response_log": ser(self.agent_response_log),
                "loc_hist": ser(self.loc_hist),
                "nav_log": ser(self.nav_log),
            }, f, indent=4)
