"""View scoring and label matching over the torch CLIP towers.

Counterpart of ``bsc_nav_tpu/agents/matchers.py``: ``CLIPMatcher`` scores
the 360-degree scan views against a text or image prompt (``check_around``)
and picks the goal label among long-term memory labels.  The Protocols and
the ``ColorViewScorer`` test double are the port's own copies of the JAX
package's (``matchers.py:18-24, 95-136``).
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.models import clip as C
from bsc_nav_tpu_torch.models import tokenizer as T


class ViewScorer(Protocol):
    def score(self, views: Sequence[np.ndarray],
              prompt) -> np.ndarray: ...


class LabelMatcher(Protocol):
    def best(self, text: str, labels: Sequence[str]) -> int: ...


def model_device(model: C.CLIP, device=None) -> torch.device:
    """The device the CLIP module lives on; raises when ``device`` names
    another one (tensors never move between host and card quietly)."""
    if device is None:
        return model.device
    dev = resolve_device(device)
    if model.device.type != dev.type or (
            dev.index is not None and model.device.index != dev.index):
        raise ValueError(f"the CLIP weights live on {model.device}, not on "
                         f"the requested {dev}")
    return model.device


class CLIPMatcher:
    """CLIP-backed scorer + matcher.  ``clip_params`` is the ``CLIP`` module
    holding the weights; inputs go to its device (``device``, when given,
    must be that device).  ``quantize`` serves the tower block matmuls in
    int8 W8A8 (``clip.quantize_params``), leaving ``clip_params`` as it
    is."""

    def __init__(self, clip_params: C.CLIP, clip_cfg: C.CLIPConfig,
                 tokenizer, quantize: bool = False,
                 device: Optional[str] = None):
        self.device = model_device(clip_params, device)
        if quantize:
            clip_params = C.quantize_params(clip_params)
        self.params, self.cfg, self.tok = clip_params, clip_cfg, tokenizer
        # prompt and label embeddings are reused across every scan and
        # retrieval of an episode
        self._text_cache = {}

    def _embed_text(self, texts: Sequence[str]) -> np.ndarray:
        missing = [t for t in texts if t not in self._text_cache]
        if missing:
            if len(self._text_cache) > 4096:
                self._text_cache.clear()
            ids = torch.from_numpy(T.tokenize(missing, self.tok))
            feats = C.encode_text(self.params, ids.to(self.device),
                                  self.cfg).cpu().numpy()
            for t, f in zip(missing, feats):
                self._text_cache[t] = f
        return np.stack([self._text_cache[t] for t in texts])

    def _embed_views(self, views) -> np.ndarray:
        arr = np.stack([np.asarray(v)[:, :, :3]
                        for v in views]).astype(np.uint8)
        imgs = torch.from_numpy(arr).to(self.device)
        return C.encode_image(self.params, C.preprocess(imgs, self.cfg),
                              self.cfg).cpu().numpy()

    def score(self, views, prompt) -> np.ndarray:
        """Softmax similarity of each view to the prompt."""
        img_f = self._embed_views(views)
        if isinstance(prompt, str):
            q = self._embed_text([prompt])[0]
        else:
            q = self._embed_views([prompt])[0]
        sims = img_f @ q
        e = np.exp(sims - sims.max())
        return e / e.sum()

    def best(self, text: str, labels: Sequence[str]) -> int:
        tf = self._embed_text([text])[0]
        lf = self._embed_text(list(labels))
        return int(np.argmax(lf @ tf))


class ColorViewScorer:
    """Test double: scores a view by the fraction of pixels close to the
    prototype color of the prompt's object (fake box world)."""

    def __init__(self, prototypes: dict, tol: float = 40.0):
        self.prototypes = {k: np.asarray(v, float)
                           for k, v in prototypes.items()}
        self.tol = tol

    def _frac(self, view: np.ndarray, proto: np.ndarray) -> float:
        img = np.asarray(view)[:, :, :3].astype(float)
        d = np.linalg.norm(img - proto[None, None], axis=-1)
        return float((d < self.tol).mean())

    def _proto_for(self, prompt) -> Optional[np.ndarray]:
        if not isinstance(prompt, str):
            # image prompt: dominant non-gray color
            img = np.asarray(prompt)[:, :, :3].astype(float)
            best, bestf = None, 0.0
            for proto in self.prototypes.values():
                f = self._frac(img, proto)
                if f > bestf:
                    best, bestf = proto, f
            return best
        for label, proto in self.prototypes.items():
            if label in prompt:
                return proto
        return None

    def score(self, views, prompt) -> np.ndarray:
        proto = self._proto_for(prompt)
        if proto is None:
            return np.full(len(views), 1.0 / len(views))
        f = np.array([self._frac(v, proto) for v in views])
        e = np.exp(f * 20.0 - (f * 20.0).max())
        return e / e.sum()

    def best(self, text: str, labels: Sequence[str]) -> int:
        for i, lbl in enumerate(labels):
            if lbl in text or text in lbl:
                return i
        return 0
