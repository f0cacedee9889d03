"""Offline query harness: localize text/image prompts against a saved
memory and dump top-K results (reference agent_localize.py:11-55).

Counterpart of ``bsc_nav_tpu/agents/localize.py`` over the port's robot;
``LocalizeTextPrompts`` scans the store once for all prompts (K2b on the
card).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from bsc_nav_tpu_torch.agents import llm as L
from bsc_nav_tpu_torch.agents.clustering import weighted_cluster_centers
from bsc_nav_tpu_torch.agents.robot import ObjectNavRobot


class LocalizeAgent(ObjectNavRobot):
    def __init__(self, memory, benchmark_env=None,
                 save_dir: str = "localize_results", **kwargs):
        super().__init__(memory, benchmark_env, **kwargs)
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    def LocalizeTextPrompt(self, text_prompt: str,
                           text_aug: bool = True) -> np.ndarray:
        if text_aug:
            text_prompt = L.retry(
                lambda: L.imagenary_helper(self.client, text_prompt))
        best, topk, sims = self.memory.voxel_localized(text_prompt)
        centers, _, _ = weighted_cluster_centers(topk, sims)
        np.save(os.path.join(self.save_dir, "best_pos_topK_text_prompt.npy"),
                np.asarray(topk))
        return centers

    def LocalizeTextPrompts(self, text_prompts, text_aug: bool = True):
        """Batched variant: all prompts scanned against the store in ONE
        [VK, D] x [D, Q] pass (memory.voxel_localized_batch)."""
        if text_aug:
            text_prompts = [
                L.retry(lambda t=t: L.imagenary_helper(self.client, t))
                for t in text_prompts]
        results = self.memory.voxel_localized_batch(list(text_prompts))
        centers_out = []
        for i, (best, topk, sims) in enumerate(results):
            centers, _, _ = weighted_cluster_centers(topk, sims)
            np.save(os.path.join(self.save_dir,
                                 f"best_pos_topK_text_prompt_{i}.npy"),
                    np.asarray(topk))
            centers_out.append(centers)
        return centers_out

    def LocalizeImagePrompt(self, img) -> np.ndarray:
        best, topk, sims = self.memory.voxel_localized(img)
        centers, _, _ = weighted_cluster_centers(topk, sims)
        np.save(os.path.join(self.save_dir, "best_pos_topK_img_input.npy"),
                np.asarray(topk))
        return centers
