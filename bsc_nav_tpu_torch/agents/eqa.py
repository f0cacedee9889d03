"""Embodied question answering agent.

Behavioral port of the reference EQAAgent (reference agent_eqa.py:14-261):
question -> LLM anchor instance -> navigate collecting <=10 views per
leg -> on success a look-up/down triple-spin keeping every 3rd view ->
fallback area-scaled random walk (<=50 views) -> VLM answer.

Counterpart of ``bsc_nav_tpu/agents/eqa.py`` over the port's robot; its
``random`` draws come in the same order, so that episodes agree.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np

from bsc_nav_tpu_torch.agents import llm as L
from bsc_nav_tpu_torch.agents.robot import ObjectNavRobot


class EQAAgent(ObjectNavRobot):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.obs_for_qa: List[np.ndarray] = []
        self._rng = random.Random(0)

    def move2anchorobject(self, text_prompt: str) -> None:
        """(agent_eqa.py:136-181)."""
        self.obs_for_qa = []
        self.curr_obs = self.benchmark_env.sim.get_sensor_observations(0)
        self.task_over = False

        best = self.working_memory_retrival(text_prompt, vis_aug=False)
        if best is None or len(best[0]) == 0:
            return
        n_turns = int(360 / self.memory.cfg.actions.turn_left_deg)
        for best_pos in best[0][:3]:
            self.nav_log["working_memory_query"] += 1
            self.nav_log["search_point"] += 1
            loc = self._grid2loc(best_pos)
            try:
                path, _ = self.memory.Env.move2point(loc)
                if len(path) > self.memory.cfg.agent.max_path_len:
                    continue
                self.execute_path(path[:-1], save_img_list=True)
                views = self.obss
                if len(views) > 10:
                    views = self._rng.sample(views, 10)
                self.obs_for_qa += views
            except Exception as e:      # noqa: BLE001
                print(f"move2point failed: {e}")
                continue
            self.check_around(text_prompt)
            if self.task_over:
                # sweep: look_up spin, level spin, look_down spin,
                # keeping every 3rd view (agent_eqa.py:168-170)
                sweep = (["look_up"] * 2 + ["turn_left"] * n_turns
                         + ["look_down"] * 2 + ["turn_left"] * n_turns
                         + ["look_down"] * 2 + ["turn_left"] * n_turns)
                self.execute_path(sweep, save_img_list=True)
                self.obs_for_qa += self.obss[::3]
                self.save_log()
                return
        self.save_log()

    # reference API name (agent_eqa.py:136 spells it 'anhor')
    def move2anhorobject(self, text_prompt: str) -> None:
        return self.move2anchorobject(text_prompt)

    def random_move(self) -> None:
        """Area-scaled random exploration fallback (agent_eqa.py:183-215)."""
        self.obs_for_qa = []
        pf = self.memory.Env.plnner.pathfinder
        state = self.benchmark_env.sim.agents[0].get_state()
        island = pf.get_island(state.position)
        n_moves = int(pf.island_area(island) / 2) + 1
        n_turns = int(360 / self.memory.cfg.actions.turn_left_deg)

        for _ in range(min(n_moves, 20)):
            subgoal = pf.get_random_navigable_point()
            tries = 0
            while ((not pf.is_navigable(subgoal)
                    or pf.get_island(subgoal) != island) and tries < 50):
                subgoal = pf.get_random_navigable_point()
                tries += 1
            try:
                path, _ = self.memory.Env.move2point(subgoal)
                self.execute_path(path[:-1], save_img_list=True)
                views = self.obss
                if len(views) > 5:
                    views = self._rng.sample(views, 5)
                self.obs_for_qa += views
                self.execute_path(["turn_left"] * n_turns,
                                  save_img_list=True)
                self.obs_for_qa += self.obss[::3]
            except Exception as e:      # noqa: BLE001
                print(f"random move failed: {e}")
                continue
        if len(self.obs_for_qa) > 50:
            self.obs_for_qa = self._rng.sample(self.obs_for_qa, 50)

    def main(self, question: str):
        """(agent_eqa.py:219-261): anchor -> navigate/explore -> answer."""
        self.obs_for_qa = []
        anchor_text = L.retry(
            lambda: L.EQA_generate_anchor_object(self.client, question))
        self.agent_response_log.append(anchor_text)

        if "{" in anchor_text:
            anchor = anchor_text.split("{")[1].split("}")[0]
            self.move2anchorobject(anchor)
            if len(self.obs_for_qa) == 0 or not self.task_over:
                self.random_move()
        else:
            self.random_move()

        answer = L.retry(
            lambda: L.EQA_Answer_4o(self.client, question, self.obs_for_qa))
        return self.episode_images, answer
