"""Seeded random MetaCLIP weights in the converted checkpoint's layout
(``visual.blocks.3.qkv.w``, linear weights stored [fan_in, fan_out]),
laid out from the configuration's ``detector`` widths and drawn as
``navbench/weights.py`` draws every model: one normal draw on the card,
sliced and scaled per leaf (linear weights and the projections
N(0, 1/fan_in), biases N(0, 0.02^2), layer norms 1 + N(0, 0.1^2) and
N(0, 0.05^2), class, token and position embeddings N(0, 0.02^2)).

One structured term makes the detector detect: random weights give every
patch a near-uniform softmax over the classes (best heat 0.10-0.29, under
the 0.55 threshold), so no box would be drawn and the long-term memory
would never run.  ``visual.proj`` gains ``scale * A @ T^T``: A [width, C]
holds C unit directions of the vision width drawn from their own seed, T
[C, embed_dim] the class prompts' text embeddings from the drawn text
tower (the plain reference's), less their mean and scaled to unit norm:
the raw embeddings of a random text tower share one direction (mutual
cosines ~0.98), along which the term would tell no class from another.
A patch token whose component along a_c stands out then lies closer to
class c's text embedding than to the others'.

How many boxes a given scale draws depends on the drawn tower and on the
room the seed draws (one fixed scale gave 1.1-15.9 boxes a frame over 12
seeds), and the host's box drawing and long-term feed grow with the
boxes.  So ``calibrate`` sets the scale per run, from the plain
reference's patch tokens of the patrol's views, so that the views give
the configuration's ``boxes_a_frame`` on average and a box in its
``frames_with_box`` share of them: every seed then puts the same
detection load on the build.  Boxes a frame rise with the scale and then
fall as the classes' masks merge, and a drawn tower may not reach the
target within the scales searched (one seed in 12 read 1.3 boxes a frame
at the top one): the caller then draws the CLIP again.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from navbench import weights as W
from navbench.reference import metaclip
from navbench.reference.common import full_f32

LOGIT_SCALE_KEY = "logit_scale"
# the scales ``calibrate`` searches, the steps of its grid over them (a
# factor sqrt(2) apart) and the halvings of a step (on a log scale) it
# then makes: the last moves the scale by under 0.04 %
SCALE_RANGE = (1.0, 64.0)
SCALE_GRID = 13
SCALE_STEPS = 10


def specs(d: Dict) -> List[W.Spec]:
    """Every leaf of the CLIP (d: the configuration's ``detector``) but
    ``logit_scale``, which ``draw_plain`` sets."""
    vw, tw, e, p = (d["vision_width"], d["text_width"], d["embed_dim"],
                    d["patch_size"])
    g = d["image_size"] // p
    out = [("visual.patch_embed.w", (p * p * 3, vw), "w"),
           ("visual.class_embedding", (vw,), "tok"),
           ("visual.pos_embed", (g * g + 1, vw), "tok"),
           ("visual.ln_pre.scale", (vw,), "ln_scale"),
           ("visual.ln_pre.bias", (vw,), "ln_bias")]
    for i in range(d["vision_layers"]):
        out += W._block(f"visual.blocks.{i}.", vw, d["vision_mlp"], False)
    out += [("visual.ln_post.scale", (vw,), "ln_scale"),
            ("visual.ln_post.bias", (vw,), "ln_bias"),
            ("visual.proj", (vw, e), "w"),
            ("text.token_embedding", (d["vocab_size"], tw), "tok"),
            ("text.pos_embed", (d["context_length"], tw), "tok")]
    for i in range(d["text_layers"]):
        out += W._block(f"text.blocks.{i}.", tw, d["text_mlp"], False)
    out += [("text.ln_final.scale", (tw,), "ln_scale"),
            ("text.ln_final.bias", (tw,), "ln_bias"),
            ("text.proj", (tw, e), "w")]
    return out


def class_targets(text: torch.Tensor) -> torch.Tensor:
    """T [C, embed_dim]: the class prompts' text embeddings ``text`` less
    their mean, each scaled to unit norm."""
    t = text - text.mean(dim=0, keepdim=True)
    return t / torch.linalg.norm(t, dim=1, keepdim=True)


def class_directions(d: Dict, dirs_seed: int, device) -> torch.Tensor:
    """A [vision_width, C]: C unit directions drawn from ``dirs_seed``."""
    gen = torch.Generator(device=device).manual_seed(dirs_seed)
    a = torch.randn(d["vision_width"], len(d["classes"]), generator=gen,
                    device=device, dtype=torch.float32)
    return a / torch.linalg.norm(a, dim=0, keepdim=True)


@torch.no_grad()
def class_term(d: Dict, text: torch.Tensor, dirs_seed: int) -> torch.Tensor:
    """A @ T^T [vision_width, embed_dim], ``text`` the class prompts' unit
    text embeddings from the drawn tower."""
    with full_f32():
        return class_directions(d, dirs_seed, text.device) @ class_targets(
            text)


@torch.no_grad()
def draw_plain(d: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{key: f32 tensor on ``device``}: the drawn leaves, without the
    structured term, and ``logit_scale`` log(d["logit_scale"])."""
    w = W.draw(specs(d), seed, device)
    w[LOGIT_SCALE_KEY] = torch.tensor(math.log(d["logit_scale"]),
                                      device=device)
    return w


@torch.no_grad()
def draw(d: Dict, seed: int, dirs_seed: int, device,
         scale: float) -> Dict[str, torch.Tensor]:
    """``draw_plain``'s weights with ``visual.proj += scale * A @ T^T``."""
    w = draw_plain(d, seed, device)
    text = metaclip.text_embeddings(w, d, metaclip.class_prompts(d))
    with full_f32():
        w["visual.proj"] += scale * class_term(d, text, dirs_seed)
    return w


@torch.no_grad()
def box_counts(tokens: torch.Tensor, proj: torch.Tensor,
               text: torch.Tensor, d: Dict) -> np.ndarray:
    """[N]: the boxes the reference draws in each of N frames from their
    patch tokens [N, grid^2, vision_width] (``metaclip.value_tokens``)
    under the projection ``proj``: the 4-connected components of each
    class's mask (``metaclip.boxes``'s count)."""
    g = d["image_size"] // d["patch_size"]
    with full_f32():
        z = d["logit_scale"] * (metaclip.project(tokens, proj).double()
                                @ text.double().T)
    hv, best = torch.softmax(z, dim=-1).max(dim=-1)
    hv = hv.reshape(-1, g, g).cpu().numpy()
    best = best.reshape(-1, g, g).cpu().numpy()
    n = np.zeros(len(hv), np.int64)
    for i, (h, b) in enumerate(zip(hv, best)):
        on = h >= d["confidence"]
        for ci in np.unique(b[on]):
            n[i] += len(metaclip.components(on & (b == ci)))
    return n


def calibrate(tokens: torch.Tensor, proj: torch.Tensor, term: torch.Tensor,
              text: torch.Tensor, d: Dict) -> Optional[float]:
    """The least scale s at which the frames give at least
    ``d["boxes_a_frame"]`` boxes a frame and a box in at least
    ``d["frames_with_box"]`` of them under ``proj + s * term``: the first
    of ``SCALE_GRID`` scales spread over ``SCALE_RANGE`` on a log scale
    that does, then ``SCALE_STEPS`` bisections of the step below it.
    None where no scale of the grid does."""

    def met(s):
        n = box_counts(tokens, proj + s * term, text, d)
        return (n.mean() >= d["boxes_a_frame"]
                and (n > 0).mean() >= d["frames_with_box"])

    grid = np.geomspace(*SCALE_RANGE, SCALE_GRID)
    k = next((i for i, s in enumerate(grid) if met(float(s))), None)
    if k is None:
        return None
    if k == 0:
        return float(grid[0])
    lo, hi = float(grid[k - 1]), float(grid[k])
    for _ in range(SCALE_STEPS):
        mid = math.sqrt(lo * hi)
        if met(mid):
            hi = mid
        else:
            lo = mid
    return hi
