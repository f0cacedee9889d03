"""Plain MetaCLIP ViT-H/14 (arXiv 2309.16671; open_clip
``ViT-H-14-quickgelu``, ``metaclip_fullcc``) as BSC-Nav's patch detector
feeding the long-term instance memory (``memory_2.py:993``), in float32
with TF32 off (the products in full f32) and geometry in float64.

The vision tower: uint8 frames scaled to [0, 1], resized to the image
size, normalised with open_clip's mean and std and cut into patches; a
linear patch embedding without bias, the class token and the position
embeddings, ``ln_pre``; pre-LN blocks (``ln_1`` -> qkv -> attention ->
out-proj, ``ln_2`` -> fc1 -> activation -> fc2, each with its residual)
but the last; of the last block only its value path, MaskCLIP-style
(``ln_1`` -> v -> out-proj, plus the residual); ``ln_post``, ``proj`` and
a unit norm give each patch token's embedding.  The text tower: token and
position embeddings, causal pre-LN blocks, ``ln_final``, the row at the
end-of-text token (the first arg-max id), ``proj``, a unit norm.

Detection: each patch embedding against the class text embeddings through
a softmax of ``logit_scale`` times the cosines; a patch whose best class
reaches the confidence joins that class's mask; each 4-connected
component of a mask is a box, scaled from the patch grid to the frame, with
the component's best heat as its confidence; classes in their order,
components in raster order of their first patch.  Each box's centre pixel
is back-projected with its depth (pinhole, depth along the optical axis)
into the world frame of the first frame's robot base, and its voxel is
the instance's place; same-label instances within L1 ``dedup_l1`` voxels
merge, the first kept holding the slot and taking a more confident one's
place and confidence.  A centre within ``edge_m`` of a voxel's face may
fall on either side of it in the program's float32 geometry (the scene's
walls lie on voxel faces): the instance carries every voxel it could fall
into (``cands``).  A merge that one of those voxels, or confidences
within their possible error, would decide otherwise taints the slot, and
every later decision within the merge distance of a tainted place
(``Unsure``).

Departures from the published pipeline, each also in the configuration's
``assumed``: frames are resized by antialiased bilinear resampling (as the
memory's encoder is), not open_clip's bicubic resize and centre crop; the
class prompts are tokenized by the hash tokenizer (whitespace words hashed
into the id range between the start and end tokens), not CLIP's BPE,
whose merges file does not ship.  Weights: the converted checkpoint's keys
(``visual.blocks.3.qkv.w``, linear weights stored [fan_in, fan_out]).
Nothing of the program is imported.
"""

from __future__ import annotations

import hashlib
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from navbench.reference.common import (
    gelu_erf, gelu_tanh, layer_norm, linear, patches, resize)
from navbench.reference.voxel_memory import BASE, _cam_flip, _tf

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def activation(d: Dict):
    """The MLP activation the detector block ``d`` states."""
    if d["quick_gelu"]:
        return quick_gelu
    return gelu_erf if d["gelu_exact"] else gelu_tanh


def _attention(qkv: torch.Tensor, heads: int, causal: bool):
    """[B, S, 3D] fused q|k|v -> [B, S, D]: softmax(q k^T / sqrt(hd)) v,
    a key after its query masked out where ``causal``."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads
    q, k, v = (t.reshape(B, S, heads, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                     device=s.device).triu(1), -math.inf)
    return (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, S, D)


def _blocks(h, w, prefix: str, n: int, heads: int, eps: float, act,
            causal: bool = False):
    for i in range(n):
        b = f"{prefix}blocks.{i}."
        a = _attention(linear(layer_norm(h, w[b + "ln1.scale"],
                                         w[b + "ln1.bias"], eps),
                              w[b + "qkv.w"], w[b + "qkv.b"]), heads, causal)
        h = h + linear(a, w[b + "proj.w"], w[b + "proj.b"])
        m = act(linear(layer_norm(h, w[b + "ln2.scale"], w[b + "ln2.bias"],
                                  eps), w[b + "fc1.w"], w[b + "fc1.b"]))
        h = h + linear(m, w[b + "fc2.w"], w[b + "fc2.b"])
    return h


def _unit(x):
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

def tokenize(texts: Sequence[str], vocab_size: int,
             context_length: int) -> np.ndarray:
    """The hash tokenizer: the start token (vocab - 2), each lower-cased
    whitespace word's MD5 (first 4 bytes, little-endian) modulo vocab - 2,
    the end token (vocab - 1), zero padding; cut to the context with the
    end token last."""
    out = np.zeros((len(texts), context_length), np.int64)
    for i, text in enumerate(texts):
        ids = [vocab_size - 2] + [
            int.from_bytes(hashlib.md5(word.encode()).digest()[:4],
                           "little") % (vocab_size - 2)
            for word in text.strip().lower().split()] + [vocab_size - 1]
        ids = ids[:context_length]
        ids[-1] = vocab_size - 1
        out[i, :len(ids)] = ids
    return out


@torch.no_grad()
def text_embeddings(w: Dict[str, torch.Tensor], d: Dict,
                    prompts: Sequence[str]) -> torch.Tensor:
    """[C, embed_dim] unit f32 embeddings of the prompts (d: the
    configuration's ``detector``; w: f32 weights on one device)."""
    dev = w["text.token_embedding"].device
    ids = torch.from_numpy(tokenize(prompts, d["vocab_size"],
                                    d["context_length"])).to(dev)
    h = w["text.token_embedding"][ids] + w["text.pos_embed"][None]
    h = _blocks(h, w, "text.", d["text_layers"], d["text_heads"],
                d["ln_eps"], activation(d), causal=True)
    h = layer_norm(h, w["text.ln_final.scale"], w["text.ln_final.bias"],
                   d["ln_eps"])
    eot = ids.argmax(dim=-1)
    return _unit(h[torch.arange(len(prompts), device=dev), eot]
                 @ w["text.proj"])


def class_prompts(d: Dict) -> List[str]:
    return [d["prompt"].format(c) for c in d["classes"]]


# ---------------------------------------------------------------------------
# the dense vision path
# ---------------------------------------------------------------------------

@torch.no_grad()
def value_tokens(w: Dict[str, torch.Tensor], d: Dict,
                 frames_uint8: torch.Tensor) -> torch.Tensor:
    """frames [B, H, W, 3] uint8 -> [B, grid^2, vision_width] f32: each
    patch token after the last block's value path and ``ln_post``, before
    ``proj``."""
    dev = frames_uint8.device
    x = frames_uint8.to(torch.float32) / 255.0
    x = resize(x, d["image_size"])
    x = (x - torch.tensor(CLIP_MEAN, device=dev)) / torch.tensor(
        CLIP_STD, device=dev)
    B = x.shape[0]
    Wd, eps = d["vision_width"], d["ln_eps"]
    h = linear(patches(x, d["patch_size"]), w["visual.patch_embed.w"])
    h = torch.cat([w["visual.class_embedding"].expand(B, 1, Wd), h], 1)
    h = layer_norm(h + w["visual.pos_embed"][None], w["visual.ln_pre.scale"],
                   w["visual.ln_pre.bias"], eps)
    n = d["vision_layers"]
    h = _blocks(h, w, "visual.", n - 1, d["vision_heads"], eps, activation(d))
    b = f"visual.blocks.{n - 1}."
    v = linear(layer_norm(h, w[b + "ln1.scale"], w[b + "ln1.bias"], eps),
               w[b + "qkv.w"][:, 2 * Wd:], w[b + "qkv.b"][2 * Wd:])
    h = linear(v, w[b + "proj.w"], w[b + "proj.b"]) + h
    h = layer_norm(h, w["visual.ln_post.scale"], w["visual.ln_post.bias"],
                   eps)
    return h[:, 1:]


def project(tokens: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """``value_tokens``' output through ``proj``, to unit embeddings."""
    return _unit(tokens @ proj)


@torch.no_grad()
def patch_embeddings(w: Dict[str, torch.Tensor], d: Dict,
                     frames_uint8: torch.Tensor) -> torch.Tensor:
    """frames [B, H, W, 3] uint8 -> [B, grid^2, embed_dim] unit f32."""
    return project(value_tokens(w, d, frames_uint8), w["visual.proj"])


# ---------------------------------------------------------------------------
# heat maps, boxes and the long-term memory (host, float64)
# ---------------------------------------------------------------------------

def heat(emb: np.ndarray, text_emb: np.ndarray, logit_scale: float):
    """emb [T, E], text_emb [C, E] -> per patch (heat, best class, the
    best class's lead over the second), the softmax in float64."""
    z = logit_scale * (emb.astype(np.float64) @ text_emb.astype(np.float64).T)
    p = np.exp(z - z.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    top2 = np.sort(p, axis=1)[:, -2:]
    return p.max(axis=1), p.argmax(axis=1), top2[:, 1] - top2[:, 0]


def components(mask: np.ndarray) -> List[List[Tuple[int, int]]]:
    """4-connected components of a 2-D mask, in raster order of their
    first cell; each a list of (row, col)."""
    seen = np.zeros_like(mask, bool)
    out = []
    for r0, c0 in zip(*np.nonzero(mask)):
        if seen[r0, c0]:
            continue
        seen[r0, c0] = True
        comp, todo = [], deque([(r0, c0)])
        while todo:
            r, c = todo.popleft()
            comp.append((r, c))
            for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                if (0 <= rr < mask.shape[0] and 0 <= cc < mask.shape[1]
                        and mask[rr, cc] and not seen[rr, cc]):
                    seen[rr, cc] = True
                    todo.append((rr, cc))
        out.append(comp)
    return out


def boxes(emb: np.ndarray, text_emb: np.ndarray, d: Dict, height: int,
          width: int) -> List[Tuple[str, float, Tuple[float, ...]]]:
    """One frame's patch embeddings [grid^2, E] -> [(label, confidence,
    (x1, y1, x2, y2))] in frame pixels."""
    g = d["image_size"] // d["patch_size"]
    hv, best, _ = heat(emb, text_emb, d["logit_scale"])
    hv, best = hv.reshape(g, g), best.reshape(g, g)
    sy, sx = height / g, width / g
    out = []
    for ci, name in enumerate(d["classes"]):
        for comp in components((best == ci) & (hv >= d["confidence"])):
            rows, cols = np.array(comp).T
            out.append((name, float(max(hv[r, c] for r, c in comp)),
                        (float(cols.min() * sx), float(rows.min() * sy),
                         float((cols.max() + 1) * sx),
                         float((rows.max() + 1) * sy))))
    return out


def locate(dets, depth: np.ndarray, pose: np.ndarray, pose0: np.ndarray,
           s: Dict, m: Dict, edge_m: float = 0.0) -> List[Dict]:
    """One frame's boxes -> instances {label, loc, cands, confidence}: each
    box's centre pixel (truncated) back-projected with its depth, in
    float64, into the first frame's robot base (x forward, y left, z up),
    and the voxel (G/2 - int(x/cs), G/2 - int(y/cs), int(z/cs) - zmin),
    Python's int truncating toward zero; a centre outside the depth range,
    the grid or the height range gives none.  ``cands``: the voxels the
    point moved by up to ``edge_m`` along each axis falls into, ``loc``
    among them.  pose, pose0: (px, py, pz, qx, qy, qz, qw) of the frame and
    of the build's first frame."""
    H, W = depth.shape
    f = W / (2.0 * math.tan(math.radians(s["hfov_deg"]) / 2.0))
    cam2world = (BASE @ np.linalg.inv(_tf(pose0)) @ _tf(pose)
                 @ _cam_flip(s["sensor_height"]))
    G, cs = m["grid_size"], m["cell_size"]
    zmin, zmax = int(m["floor_height"] / cs), int(m["map_height"] / cs)

    def voxel(p):
        return [G // 2 - int(p[0] / cs), G // 2 - int(p[1] / cs),
                int(p[2] / cs) - zmin]

    def inside(v):
        return 0 <= v[0] < G and 0 <= v[1] < G and 0 <= v[2] < zmax - zmin

    out = []
    for label, conf, (x1, y1, x2, y2) in dets:
        col, row = int((x1 + x2) / 2), int((y1 + y2) / 2)
        z = float(depth[row, col])
        if not s["min_depth"] < z < s["max_depth"]:
            continue
        pc = np.array([(col + 0.5 - W / 2) / f * z,
                       (row + 0.5 - H / 2) / f * z, z])
        pw = cam2world[:3, :3] @ pc + cam2world[:3, 3]
        loc = voxel(pw)
        if not inside(loc):
            continue
        axes = [sorted({voxel(pw + e * np.eye(3)[a])[a]
                        for e in (-edge_m, 0.0, edge_m)}) for a in range(3)]
        cands = [[r, c, h] for r in axes[0] for c in axes[1] for h in axes[2]
                 if inside([r, c, h])]
        out.append({"label": label, "loc": loc, "cands": cands,
                    "confidence": conf})
    return out


def _l1(a, b) -> int:
    return sum(abs(x - y) for x, y in zip(a, b))


class Unsure:
    """Per label, the voxels where the program's long-term memory may
    differ from the reference's replay (``at``), and every voxel within
    L1 ``threshold`` of them (``near``): an instance there could merge
    with, or take the place of, a slot the two hold at other places."""

    def __init__(self, threshold: int):
        r = range(-threshold, threshold + 1)
        self.offsets = [(a, b, c) for a in r for b in r for c in r
                        if abs(a) + abs(b) + abs(c) <= threshold]
        self.at: Dict[str, Set[tuple]] = {}
        self.near: Dict[str, Set[tuple]] = {}

    def add(self, label: str, voxels) -> None:
        at = self.at.setdefault(label, set())
        near = self.near.setdefault(label, set())
        for v in map(tuple, voxels):
            if v not in at:
                at.add(v)
                near.update((v[0] + a, v[1] + b, v[2] + c)
                            for a, b, c in self.offsets)

    def touches(self, label: str, voxels) -> bool:
        near = self.near.get(label, ())
        return any(tuple(v) in near for v in voxels)


def integrate(instances: List[Dict], threshold: int,
              err: Optional[Callable[[float], float]] = None,
              unsure: Optional[Unsure] = None) -> List[Dict]:
    """Same-label instances within L1 ``threshold`` merge: the first kept
    holds the slot and takes a later one's place (and ``cands``) and
    confidence when that one is more confident.

    With ``unsure``, what another precision may decide otherwise is
    followed.  A decision is unsure where another of the two instances'
    ``cands`` would put them on the other side of ``threshold``; where
    the two confidences differ by no more than ``err(a) + err(b)``
    (``err``: the most a confidence may be off; in float32 both may round
    to 1.0) and the places differ; where the instance is ``tainted`` (its
    box may differ); or where it lies within ``threshold`` of a place
    already unsure.  The instance, and the slot it merges into, are then
    ``tainted``, and their places join ``unsure``: every later decision
    near them may differ too, and nowhere else."""
    kept: Dict[str, List[Dict]] = {}
    for it in instances:
        label = it["label"]
        same = kept.setdefault(label, [])
        cands = it.get("cands", [it["loc"]])
        doubt = unsure is not None and (it.get("tainted", False)
                                        or unsure.touches(label, cands))
        hit = None
        for k in same:
            near = _l1(k["loc"], it["loc"]) <= threshold
            if unsure is not None and not doubt and any(
                    (_l1(a, b) <= threshold) != near
                    for a in k.get("cands", [k["loc"]]) for b in cands):
                doubt = True
            if near:
                hit = k
                break
        gain = 0.0 if hit is None else it["confidence"] - hit["confidence"]
        if (unsure is not None and hit is not None
                and list(it["loc"]) != hit["loc"] and 0 < abs(gain)
                <= err(it["confidence"]) + err(hit["confidence"])):
            doubt = True
        if hit is None:
            hit = dict(it, loc=list(it["loc"]))
            same.append(hit)
        if doubt:
            unsure.add(label, cands)
            unsure.add(label, hit.get("cands", [hit["loc"]]))
            hit["tainted"] = True
        if gain > 0:
            hit["loc"], hit["confidence"] = list(it["loc"]), it["confidence"]
            hit["cands"] = cands
    return [k for same in kept.values() for k in same]
