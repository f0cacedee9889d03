"""Load ViT weights into the torch module.

Two sources, one key scheme: the JAX params tree (nested dicts and lists,
``bsc_nav_tpu/models/vit.py`` layout, linear ``w`` stored
``[fan_in, fan_out]``) and the ``.npz`` that
``bsc_nav_tpu.models.weights.save_params_npz`` writes, whose keys are the
tree's paths joined by dots (``blocks.3.qkv.w``).  Those dotted keys are
exactly ``ViT.state_dict()``'s keys, so loading is a strict
``load_state_dict`` and a missing or extra tensor raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from bsc_nav_tpu_torch.models.vit import ViT, ViTConfig


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list tree -> {dotted path: numpy array} (the key scheme
    of the JAX package's ``flatten_params``)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}."))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def _load(flat: Mapping[str, np.ndarray], cfg: ViTConfig, dtype,
          device) -> ViT:
    model = ViT(cfg, dtype=dtype, device=device)
    sd = {k: torch.from_numpy(np.array(v, np.float32)).to(dtype)  # writable
          for k, v in flat.items()}
    model.load_state_dict(sd, strict=True)
    return model


def vit_from_jax_params(params: Any, cfg: ViTConfig, dtype=torch.float32,
                        device="cpu") -> ViT:
    """A ViT holding the weights of a JAX params tree (numpy leaves)."""
    return _load(flatten_params(params), cfg, dtype, device)


def load_dinov2_npz(path: str, cfg: ViTConfig, dtype=torch.float32,
                    device="cpu") -> ViT:
    """A ViT holding the weights of a converted ``.npz``."""
    with np.load(path) as z:
        return _load(dict(z.items()), cfg, dtype, device)
