"""Seeded random weights in the layout of the converted checkpoints.

The keys are those of the ``.npz`` file a user converts (DINOv2:
``blocks.3.qkv.w``, linear weights stored [fan_in, fan_out]), laid out
here from the configuration file's widths, not from the program's
modules.  All leaves of one model come
from one normal draw on the card (one ``torch.Generator`` per model,
seeded from the run's seed), sliced and scaled per leaf:

- linear weights N(0, 1/fan_in); biases N(0, 0.02^2);
- layer norms: scale 1 + N(0, 0.1^2), bias N(0, 0.05^2);
- DINOv2 layer scales 0.3 + N(0, 0.05^2) (trained values are O(0.1-1);
  the 1e-5 of a fresh init would hide every block behind the residual);
- class, register and position tokens N(0, 0.02^2).

``draw`` returns f32 tensors; a model served in bf16 takes them rounded
to bf16, and the reference is handed those rounded values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str]


def _block(prefix: str, width: int, mlp: int, layerscale: bool) -> List[Spec]:
    out = [(f"{prefix}ln1.scale", (width,), "ln_scale"),
           (f"{prefix}ln1.bias", (width,), "ln_bias"),
           (f"{prefix}qkv.w", (width, 3 * width), "w"),
           (f"{prefix}qkv.b", (3 * width,), "b"),
           (f"{prefix}proj.w", (width, width), "w"),
           (f"{prefix}proj.b", (width,), "b"),
           (f"{prefix}ln2.scale", (width,), "ln_scale"),
           (f"{prefix}ln2.bias", (width,), "ln_bias"),
           (f"{prefix}fc1.w", (width, mlp), "w"),
           (f"{prefix}fc1.b", (mlp,), "b"),
           (f"{prefix}fc2.w", (mlp, width), "w"),
           (f"{prefix}fc2.b", (width,), "b")]
    if layerscale:
        out += [(f"{prefix}ls1", (width,), "ls"),
                (f"{prefix}ls2", (width,), "ls")]
    return out


def dinov2_specs(c: Dict) -> List[Spec]:
    """DINOv2 with registers (c: the configuration's ``encoder``)."""
    d, p = c["dim"], c["patch_size"]
    n = (c["img_size"] // p) ** 2
    out = [("patch_embed.w", (p * p * 3, d), "w"),
           ("patch_embed.b", (d,), "b"),
           ("cls_token", (1, 1, d), "tok"),
           ("pos_embed", (1, 1 + n, d), "tok"),
           ("reg_token", (1, c["num_registers"], d), "tok"),
           ("norm.scale", (d,), "ln_scale"),
           ("norm.bias", (d,), "ln_bias")]
    mlp = int(d * c["mlp_ratio"])
    for i in range(c["depth"]):
        out += _block(f"blocks.{i}.", d, mlp, True)
    return out


@torch.no_grad()
def draw(specs: List[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """{key: f32 tensor on ``device``}: one normal draw for all leaves."""
    sizes = [math.prod(s) for _, s, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind), n in zip(specs, sizes):
        x = flat[at:at + n].view(shape)
        at += n
        if kind == "w":
            x.mul_(1.0 / math.sqrt(shape[0]))
        elif kind == "b":
            x.mul_(0.02)
        elif kind == "ln_scale":
            x.mul_(0.1).add_(1.0)
        elif kind == "ln_bias":
            x.mul_(0.05)
        elif kind == "ls":
            x.mul_(0.05).add_(0.3)
        elif kind == "tok":
            x.mul_(0.02)
        else:
            raise ValueError(f"{name}: unknown leaf kind {kind!r}")
        out[name] = x
    return out


def served(weights: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """The leaves as a model served in ``dtype`` holds them, back in f32
    (what the reference is handed)."""
    return {k: v.to(dtype).to(torch.float32) for k, v in weights.items()}
