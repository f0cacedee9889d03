"""Load ViT and CLIP weights into the torch modules.

Two sources, one key scheme: the JAX params tree (nested dicts and lists,
``bsc_nav_tpu/models/vit.py`` layout, linear ``w`` stored
``[fan_in, fan_out]``) and the ``.npz`` that
``bsc_nav_tpu.models.weights.save_params_npz`` writes, whose keys are the
tree's paths joined by dots (``blocks.3.qkv.w``).  Those dotted keys are
exactly the modules' ``state_dict()`` keys, so loading is a strict
``load_state_dict`` and a missing or extra tensor raises.  A CLIP tree may
hold int8 ``w_q`` / ``w_s`` leaves (``clip.quantize_params``); the towers
that do are built quantized.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from bsc_nav_tpu_torch.models.clip import CLIP, CLIPConfig
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


def _fill(model, flat: Mapping[str, np.ndarray]):
    """Strict load; each tensor takes its parameter's dtype (int8 leaves
    stay int8; floats, bf16 included, pass through f32)."""
    want = model.state_dict()

    def tensor(k, v):
        a = np.asarray(v)
        t = torch.from_numpy(np.array(a, np.int8 if a.dtype == np.int8
                                      else np.float32))       # writable
        return t.to(want[k].dtype) if k in want else t

    sd = {k: tensor(k, v) for k, v in flat.items()}
    model.load_state_dict(sd, strict=True)
    return model


def vit_from_jax_params(params: Any, cfg: ViTConfig, dtype=torch.float32,
                        device="cpu") -> ViT:
    """A ViT holding the weights of a JAX params tree (numpy leaves)."""
    return _fill(ViT(cfg, dtype=dtype, device=device),
                 flatten_params(params))


def load_dinov2_npz(path: str, cfg: ViTConfig, dtype=torch.float32,
                    device="cpu") -> ViT:
    """A ViT holding the weights of a converted ``.npz``."""
    with np.load(path) as z:
        return _fill(ViT(cfg, dtype=dtype, device=device), dict(z.items()))


def _clip(flat: Mapping[str, np.ndarray], cfg: CLIPConfig, dtype,
          device) -> CLIP:
    q = {t for t in ("visual", "text")
         if any(k.startswith(t + ".") and k.endswith(".w_q") for k in flat)}
    quantized = ("both" if len(q) == 2 else q.pop() if q else "none")
    return _fill(CLIP(cfg, dtype=dtype, device=device, quantized=quantized),
                 flat)


def clip_from_jax_params(params: Any, cfg: CLIPConfig, dtype=torch.float32,
                         device="cpu") -> CLIP:
    """A CLIP holding the weights of a JAX ``clip.init_params`` tree (numpy
    leaves), quantized or not."""
    return _clip(flatten_params(params), cfg, dtype, device)


def load_clip_npz(path: str, cfg: CLIPConfig, dtype=torch.float32,
                  device="cpu") -> CLIP:
    """A CLIP holding the weights of the ``.npz`` that
    ``tools/convert_weights.py clip`` writes."""
    with np.load(path) as z:
        return _clip(dict(z.items()), cfg, dtype, device)
