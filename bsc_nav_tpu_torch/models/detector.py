"""Open-vocabulary detection feeding the long-term memory, over the torch
CLIP image tower.

Counterpart of ``bsc_nav_tpu/models/detector.py``.  ``ClipPatchDetector``
is MaskCLIP-style dense zero-shot detection: the vision tower runs its
blocks but the last (kernel K3 in every layer on the card), the last block
contributes its value path only, and ``ln_post`` + ``proj`` turn each
patch token into an embedding compared with the class text embeddings.
Unlike the JAX package's, whose blocks always take the tanh GELU, the
blocks take the activation the ``CLIPConfig`` states.  ``detect_batch``
records the spans ``detector.forward`` and ``detector.post`` and counts
``detector.frames`` and ``detector.boxes`` (``utils/profiling.py``).
The host side -- ``Detection``, the heat-map to boxes step and the
``ColorPrototypeDetector`` test double -- is the port's own copy of the
JAX package's (``detector.py:28-59, 147-182``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from bsc_nav_tpu_torch.agents.matchers import model_device
from bsc_nav_tpu_torch.models import clip as C
from bsc_nav_tpu_torch.models import tokenizer as T
from bsc_nav_tpu_torch.utils.profiling import SPANS, TELEMETRY


@dataclasses.dataclass
class Detection:
    label: str
    confidence: float
    xyxy: Tuple[float, float, float, float]


class Detector(Protocol):
    def detect(self, rgb: np.ndarray) -> List[Detection]: ...


def _boxes_from_heatmap(heat: np.ndarray, labels_idx: np.ndarray,
                        classes: Sequence[str], conf: float, scale_y: float,
                        scale_x: float) -> List[Detection]:
    """Connected components over a thresholded per-patch heatmap."""
    from scipy import ndimage

    out: List[Detection] = []
    for ci, cname in enumerate(classes):
        mask = (labels_idx == ci) & (heat >= conf)
        if not mask.any():
            continue
        lab, n = ndimage.label(mask)
        for comp in range(1, n + 1):
            ys, xs = np.nonzero(lab == comp)
            score = float(heat[lab == comp].max())
            out.append(Detection(
                cname, score,
                (float(xs.min() * scale_x), float(ys.min() * scale_y),
                 float((xs.max() + 1) * scale_x),
                 float((ys.max() + 1) * scale_y))))
    return out


@torch.no_grad()
def dense_embed(model: C.CLIP, images_uint8: torch.Tensor,
                cfg: C.CLIPConfig) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> unit patch embeddings [B, grid^2, embed_dim]
    f32 (``detector.py:93-118``).  The blocks take the activation ``cfg``
    states, as ``encode_image`` does."""
    v = model.visual
    h = C.vision_tokens(v, C.preprocess(images_uint8, cfg), cfg)
    h = C._tower_forward(h, v.blocks[:-1], cfg.vision_heads, cfg.ln_eps,
                         gelu_exact=cfg.gelu_exact,
                         quick_gelu=cfg.quick_gelu)
    # value-only path of the last block (MaskCLIP)
    blk = v.blocks[-1]
    val = blk.qkv(blk.ln1(h))[..., 2 * cfg.vision_width:]
    val = v.ln_post(blk.proj(val) + h)
    emb = C._normalize(C._project(val, v.proj))
    return emb[:, 1:]                   # patch tokens only


class ClipPatchDetector:
    """MaskCLIP-style dense zero-shot detector.  ``clip_params`` is the
    ``CLIP`` module; frames go to its device (``device``, when given, must
    be that device)."""

    def __init__(self, clip_params: C.CLIP, clip_cfg: C.CLIPConfig,
                 tokenizer, classes: Sequence[str],
                 confidence: float = 0.55, device: Optional[str] = None):
        self.device = model_device(clip_params, device)
        self.classes = list(classes)
        self.confidence = confidence
        self.cfg = clip_cfg
        self.params = clip_params
        ids = T.tokenize([f"a photo of a {c}" for c in classes], tokenizer)
        self.text_emb = C.encode_text(
            clip_params, torch.from_numpy(ids).to(self.device),
            clip_cfg).cpu().numpy()

    def embed(self, rgbs: np.ndarray) -> np.ndarray:
        """[B, H, W, 3+] uint8 frames -> [B, grid^2, embed_dim] numpy.
        Span ``detector.forward``: it ends in the blocking copy back, so
        it holds the device work."""
        with SPANS("detector.forward"):
            imgs = torch.from_numpy(np.ascontiguousarray(rgbs[:, :, :, :3]))
            return dense_embed(self.params, imgs.to(self.device),
                               self.cfg).cpu().numpy()

    def detect(self, rgb: np.ndarray) -> List[Detection]:
        return self.detect_batch(rgb[None])[0]

    def detect_batch(self, rgbs: np.ndarray) -> List[List[Detection]]:
        """One device call for a whole frame batch; heat maps and boxes on
        the host, as ``detector.py:125-144``."""
        B, H, W = rgbs.shape[:3]
        embs = self.embed(rgbs)
        g = self.cfg.grid
        out: List[List[Detection]] = []
        with SPANS("detector.post"):
            for b in range(B):
                sims = embs[b] @ self.text_emb.T             # [T, C]
                p = np.exp(sims * 100.0
                           - sims.max(axis=1, keepdims=True) * 100.0)
                p /= p.sum(axis=1, keepdims=True)
                heat = p.max(axis=1).reshape(g, g)
                labels_idx = p.argmax(axis=1).reshape(g, g)
                out.append(_boxes_from_heatmap(
                    heat, labels_idx, self.classes, self.confidence,
                    scale_y=H / g, scale_x=W / g))
        TELEMETRY.count("detector.frames", B)
        TELEMETRY.count("detector.boxes", sum(map(len, out)))
        return out


class ColorPrototypeDetector:
    """Test-double detector for the fake box world: per-class RGB
    prototypes matched within tolerance, component boxes with confidence
    proportional to color closeness."""

    def __init__(self, prototypes: dict, confidence: float = 0.55,
                 tol: float = 40.0):
        self.prototypes = {k: np.asarray(v, float)
                           for k, v in prototypes.items()}
        self.confidence = confidence
        self.tol = tol

    def detect(self, rgb: np.ndarray) -> List[Detection]:
        from scipy import ndimage

        img = rgb[:, :, :3].astype(float)
        out: List[Detection] = []
        for label, proto in self.prototypes.items():
            d = np.linalg.norm(img - proto[None, None], axis=-1)
            mask = d < self.tol
            if mask.sum() < 12:
                continue
            lab, n = ndimage.label(mask)
            for comp in range(1, n + 1):
                sel = lab == comp
                if sel.sum() < 12:
                    continue
                ys, xs = np.nonzero(sel)
                conf = float(1.0 - d[sel].mean() / 255.0)
                if conf < self.confidence:
                    continue
                out.append(Detection(
                    label, conf,
                    (float(xs.min()), float(ys.min()),
                     float(xs.max() + 1), float(ys.max() + 1))))
        return out
