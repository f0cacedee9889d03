"""Local VLM judge: Qwen2.5-VL in this process behind the ChatClient
protocol.

Counterpart of ``bsc_nav_tpu/agents/local_vlm.py`` (the reference's local
judge option, objnav_benchmark.py:165-171): with ``--llm local
--weights-dir <dir>`` the robots' judge calls run offline on the card.
Per ``chat()``: the OpenAI-format messages (PNG data-URL images) become
the Qwen chat template with ``<|vision_start|><|image_pad|>*N
<|vision_end|>``; each image becomes fixed-resolution patches in the HF
Qwen2VL processor's layout, the vision tower's merged tokens take the pad
positions, and greedy generation on a KV cache gives the text.

What the JAX module takes from other packages, the port has of its own:
the tokenizer is ``models/qwen_tokenizer.QwenTokenizer`` over the
directory's ``tokenizer.json`` (no ``transformers``), the images are read
by ``agents/llm.decode_png`` (no PIL: PNG only, the format the port's LLM
layer sends), and the antialiased bilinear resize of ``jax.image.resize``
is ``models/vit.resize_weights``.

Prompt lengths go to the JAX module's buckets, so the cache length and the
"prompt too long" error are the JAX client's.
"""

from __future__ import annotations

import base64
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bsc_nav_tpu_torch import full_f32_matmul, resolve_device
from bsc_nav_tpu_torch.agents.llm import decode_png
from bsc_nav_tpu_torch.models import qwen_vl as Q
from bsc_nav_tpu_torch.models.vit import resize_weights

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073],
                            np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711],
                           np.float32)

# Qwen2.5 special tokens (the tokenizer defines their ids)
IM_START = "<|im_start|>"
IM_END = "<|im_end|>"
VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"


def resize_bilinear(x: np.ndarray, size: int) -> np.ndarray:
    """[H, W, C] f32 -> [size, size, C]: ``jax.image.resize(...,
    "bilinear")``, antialiased, as a product with each axis's resampling
    matrix."""
    H, W, C = x.shape
    wh = resize_weights(H, size, "bilinear")
    ww = resize_weights(W, size, "bilinear")
    y = (wh.T @ x.reshape(H, W * C)).reshape(size, W, C)     # [size, W, C]
    y = y.transpose(0, 2, 1) @ ww                            # [size, C, size]
    return np.ascontiguousarray(y.transpose(0, 2, 1))


def image_to_patches(img: np.ndarray, size: int,
                     cfg: Q.QwenVLVisionConfig
                     ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """uint8 [H, W, 3] -> (flat patches [S, C * tp * p * p], grid_thw) in
    the HF Qwen2VL image processor's layout (merge-unit raster order;
    local_vlm.py:45-66)."""
    x = np.asarray(img)[:, :, :3].astype(np.float32) / 255.0
    if x.shape[:2] != (size, size):
        x = resize_bilinear(x, size)
    x = (x - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD
    x = x.transpose(2, 0, 1)                            # [C, H, W]
    x = np.repeat(x[None], cfg.temporal_patch, axis=0)  # [tp, C, H, W]
    p, m = cfg.patch, cfg.merge
    gh, gw = size // p, size // p
    pt = x.reshape(1, cfg.temporal_patch, 3, gh // m, m, p,
                   gw // m, m, p)
    pt = pt.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return (pt.reshape(gh * gw, 3 * cfg.temporal_patch * p * p),
            (1, gh, gw))


def decode_data_url(url: str) -> np.ndarray:
    """data:image/png;base64,... -> uint8 RGB [H, W, 3] (grey repeated,
    alpha dropped, as PIL's ``convert("RGB")``).  PNG only."""
    img = decode_png(base64.b64decode(url.split("base64,", 1)[1]))
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def build_prompt(messages: List[dict], n_image_tokens: int
                 ) -> Tuple[str, List[np.ndarray]]:
    """OpenAI messages -> (Qwen chat-template string, images)
    (local_vlm.py:77-100)."""
    parts: List[str] = []
    images: List[np.ndarray] = []
    for msg in messages:
        content = msg.get("content", "")
        body: List[str] = []
        if isinstance(content, str):
            body.append(content)
        else:
            for item in content:
                if item.get("type") == "text":
                    body.append(item["text"])
                elif item.get("type") == "image_url":
                    images.append(
                        decode_data_url(item["image_url"]["url"]))
                    body.append(VISION_START
                                + IMAGE_PAD * n_image_tokens
                                + VISION_END)
        parts.append(f"{IM_START}{msg['role']}\n" + "".join(body)
                     + f"{IM_END}\n")
    parts.append(f"{IM_START}assistant\n")
    return "".join(parts), images


def mm_position_ids(ids: np.ndarray, image_token_id: int,
                    grids: Sequence[Tuple[int, int, int]],
                    merge: int) -> np.ndarray:
    """3-D M-RoPE position ids [3, 1, S] of one sequence with inline images
    (HF get_rope_index: text advances the three axes together, an image
    block advances t / h / w apart, and text resumes at max + 1;
    local_vlm.py:103-133)."""
    S = len(ids)
    out = np.zeros((3, S), np.int64)
    pos = 0
    img_i = 0
    i = 0
    while i < S:
        if ids[i] == image_token_id:
            t, h, w = grids[img_i]
            lh, lw = h // merge, w // merge
            n = t * lh * lw
            tt = np.repeat(np.arange(t), lh * lw)
            hh = np.tile(np.repeat(np.arange(lh), lw), t)
            ww = np.tile(np.tile(np.arange(lw), lh), t)
            out[0, i:i + n] = pos + tt
            out[1, i:i + n] = pos + hh
            out[2, i:i + n] = pos + ww
            pos = out[:, i:i + n].max() + 1
            i += n
            img_i += 1
        else:
            out[:, i] = pos
            pos += 1
            i += 1
    return out[:, None, :]


class ByteTokenizer:
    """Dependency-free byte-level tokenizer for tests and the card's smoke:
    bytes are ids 0..255, the special tokens the ids above
    (local_vlm.py:136-169)."""

    SPECIALS = [IM_START, IM_END, VISION_START, VISION_END, IMAGE_PAD]

    def __init__(self):
        self.special_ids = {s: 256 + i for i, s in enumerate(self.SPECIALS)}
        self.eos_id = self.special_ids[IM_END]
        self.image_pad_id = self.special_ids[IMAGE_PAD]
        self.vocab_size = 256 + len(self.SPECIALS)

    def encode(self, text: str) -> List[int]:
        pattern = "(" + "|".join(re.escape(s) for s in self.SPECIALS) + ")"
        out: List[int] = []
        for chunk in re.split(pattern, text):
            if chunk in self.special_ids:
                out.append(self.special_ids[chunk])
            else:
                out.extend(chunk.encode("utf-8"))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        rev = {v: k for k, v in self.special_ids.items()}
        out, buf = [], []
        for t in ids:
            if t in rev:
                out.append(bytes(buf).decode("utf-8", "ignore"))
                buf = []
                out.append(rev[t])
            elif t < 256:
                buf.append(int(t))
        out.append(bytes(buf).decode("utf-8", "ignore"))
        return "".join(out)


class LocalVLMClient:
    """ChatClient-protocol wrapper over the in-process Qwen2.5-VL
    (local_vlm.py:172-252).  ``params`` is the port's tree on its device
    (``models/weights.qwen_vl_from_jax_params`` / ``load_qwen_vl_npz`` /
    ``qwen_vl.init_params``); ``quantize`` applies
    ``quantize_params(scope="text")``, the W8A8 decoder that
    ``llm_int8`` (default True) asks for."""

    def __init__(self, params, cfg: Q.QwenVLConfig, tokenizer,
                 image_size: int = 224, max_new_tokens: int = 128,
                 prompt_buckets: Sequence[int] = (256, 512, 1024, 2048),
                 quantize: bool = False):
        if quantize:
            params = Q.quantize_params(params, scope="text")
        self.params = params
        self.device = params["embed"].device
        self.cfg = cfg
        self.tok = tokenizer
        self.image_size = image_size
        self.max_new = max_new_tokens
        self.buckets = sorted(prompt_buckets)
        self._gens: Dict[int, Q.GreedyGenerator] = {}
        self.eos_id = getattr(tokenizer, "eos_id", None) or \
            getattr(tokenizer, "eos_token_id", 151645)
        self.image_pad_id = getattr(tokenizer, "image_pad_id", None) or \
            cfg.image_token_id
        gh = image_size // cfg.vision.patch
        self.grid: Tuple[int, int, int] = (1, gh, gh)
        self.n_image_tokens = (gh // cfg.vision.merge) ** 2
        self.calls: List[Dict[str, Any]] = []
        self.last: Dict[str, Any] = {}

    def _generator(self, max_len: int) -> Q.GreedyGenerator:
        if max_len not in self._gens:
            self._gens[max_len] = Q.make_greedy_generator(
                self.cfg.text, max_len=max_len, max_new=self.max_new,
                eos_id=int(self.eos_id))
        return self._gens[max_len]

    def prepare(self, messages: List[dict]) -> Dict[str, Any]:
        """The host half of a call: prompt ids (image pads as the model's
        image token), M-RoPE positions, image patches, the bucket."""
        prompt, images = build_prompt(messages, self.n_image_tokens)
        ids = np.asarray(self.tok.encode(prompt), np.int64)
        # the template's image pads carry the tokenizer's special id;
        # remap to the model's image token id where they differ
        if self.image_pad_id != self.cfg.image_token_id:
            ids = np.where(ids == self.image_pad_id,
                           self.cfg.image_token_id, ids)
        S = len(ids)
        max_len = next((b for b in self.buckets if b >= S),
                       self.buckets[-1])
        if S > max_len:
            raise ValueError(f"prompt too long: {S} > {max_len}")
        grids = [self.grid] * len(images)
        pos = mm_position_ids(ids, self.cfg.image_token_id, grids,
                              self.cfg.vision.merge)
        patches = (np.concatenate(
            [image_to_patches(im, self.image_size, self.cfg.vision)[0]
             for im in images]) if images else None)
        return {"ids": ids, "pos": pos, "patches": patches, "grids": grids,
                "max_len": max_len}

    def embed(self, prep: Dict[str, Any]) -> torch.Tensor:
        """The prompt's embeddings [1, S, D], the vision tower's merged
        tokens in the image pads."""
        dev = self.device
        ids = torch.from_numpy(prep["ids"]).to(dev)[None]
        if prep["patches"] is None:
            return Q.embed_tokens(self.params, ids)
        # f32 patches, as the JAX client passes them: the vision tower's
        # activations stay f32 whatever the weights' dtype
        vis = Q.vision_forward(
            self.params["vision"], torch.from_numpy(prep["patches"]).to(dev),
            prep["grids"], self.cfg.vision)
        return Q.merge_vision_embeds(self.params, ids, vis,
                                     self.cfg.image_token_id)

    def generate(self, prep: Dict[str, Any], emb: torch.Tensor,
                 trace: Optional[list] = None,
                 step_ms: Optional[list] = None) -> List[int]:
        """Greedy tokens after the prompt, EOS dropped (``trace`` and
        ``step_ms`` as ``GreedyGenerator`` takes them)."""
        S, max_len = len(prep["ids"]), prep["max_len"]
        emb = torch.nn.functional.pad(emb, (0, 0, 0, max_len - S))
        pos = np.pad(prep["pos"], ((0, 0), (0, 0), (0, max_len - S)))
        tokens, n = self._generator(max_len)(
            self.params, emb, S, torch.from_numpy(pos).to(self.device),
            int(prep["pos"].max()) + 1, trace=trace, step_ms=step_ms)
        return [int(t) for t in tokens[:n].cpu().tolist()
                if int(t) != int(self.eos_id)]

    def chat(self, model: str, messages: List[dict],
             timeout: float = 500.0) -> str:
        del model, timeout
        prep = self.prepare(messages)
        with torch.no_grad(), full_f32_matmul():
            toks = self.generate(prep, self.embed(prep))
        text = self.tok.decode(toks)
        self.last = {"prompt_len": len(prep["ids"]), "tokens": toks,
                     "images": len(prep["grids"])}
        self.calls.append({"messages": messages, "response": text})
        return text.strip()


def load_local_vlm(weights_dir: str, cfg: Optional[Q.QwenVLConfig] = None,
                   dtype=None, device="cuda", **kw) -> LocalVLMClient:
    """A LocalVLMClient from a converted-weights directory: ``qwen_vl.npz``
    (the JAX package's flat layout; bf16 by default) and the HF
    ``tokenizer.json`` beside it (local_vlm.py:255-273), on ``device``."""
    from bsc_nav_tpu_torch.models.qwen_tokenizer import QwenTokenizer
    from bsc_nav_tpu_torch.models.weights import load_qwen_vl_npz

    cfg = cfg or Q.QWEN25_VL_3B
    params = load_qwen_vl_npz(os.path.join(weights_dir, "qwen_vl.npz"), cfg,
                              dtype=dtype or torch.bfloat16,
                              device=resolve_device(device))
    tok = QwenTokenizer.from_file(os.path.join(weights_dir,
                                               "tokenizer.json"))
    return LocalVLMClient(params, cfg, tok, **kw)
