"""Plain DINOv2 ViT with registers (arXiv 2304.07193, 2309.16588): the
patch tokens of RGB frames, as the voxel memory ingests them.

uint8 frames are scaled to [0, 1], resized to the query size (antialiased
bilinear), ImageNet-normalised and cut into 14-pixel patches; a linear
patch embedding, the class token and the position embeddings, then the
four register tokens after the class token; pre-LN blocks (the configuration's
GELU, layer scales) and a final layer norm.  The patch tokens are returned as
a grid [B, nh, nw, D] in f32.  Weights: the converted checkpoint's keys
(``navbench/weights.py``).
"""

from __future__ import annotations

from typing import Dict

import torch

from navbench.reference.common import (
    activation, attention, layer_norm, linear, patches, resize)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@torch.no_grad()
def patch_grid(w: Dict[str, torch.Tensor], c: Dict, query_size: int,
               frames_uint8: torch.Tensor) -> torch.Tensor:
    """frames [B, H, W, 3] uint8 -> [B, nh, nw, D] f32 (c: the
    configuration's ``encoder``; w: f32 weights on the frames' device)."""
    dev = frames_uint8.device
    x = frames_uint8.to(torch.float32) / 255.0
    x = resize(x, query_size)
    x = (x - torch.tensor(IMAGENET_MEAN, device=dev)) / torch.tensor(
        IMAGENET_STD, device=dev)
    B = x.shape[0]
    p, D, eps = c["patch_size"], c["dim"], c["ln_eps"]
    g = query_size // p
    if (1 + g * g) != w["pos_embed"].shape[1]:
        raise ValueError("the reference takes the position grid as trained: "
                         f"{query_size}^2 gives {g}^2 patches")
    h = linear(patches(x, p), w["patch_embed.w"], w["patch_embed.b"])
    h = torch.cat([w["cls_token"].expand(B, 1, D), h], 1) + w["pos_embed"]
    h = torch.cat([h[:, :1], w["reg_token"].expand(B, -1, D), h[:, 1:]], 1)
    act = activation(c)
    for i in range(c["depth"]):
        b = f"blocks.{i}."
        a = attention(linear(layer_norm(h, w[b + "ln1.scale"],
                                        w[b + "ln1.bias"], eps),
                             w[b + "qkv.w"], w[b + "qkv.b"]), c["heads"])
        h = h + linear(a, w[b + "proj.w"], w[b + "proj.b"]) * w[b + "ls1"]
        m = act(linear(layer_norm(h, w[b + "ln2.scale"],
                                        w[b + "ln2.bias"], eps),
                             w[b + "fc1.w"], w[b + "fc1.b"]))
        h = h + linear(m, w[b + "fc2.w"], w[b + "fc2.b"]) * w[b + "ls2"]
    h = layer_norm(h, w["norm.scale"], w["norm.bias"], eps)
    n_reg = w["reg_token"].shape[1]
    return h[:, 1 + n_reg:].reshape(B, g, g, D)
