"""Qwen2.5-VL, the local VLM judge, in PyTorch.

Counterpart of ``bsc_nav_tpu/models/qwen_vl.py``: the configs (:44-102),
the shared pieces (:108-201), the windowed vision tower with its 2-D
rotary and 2x2 merger (:208-318), the Qwen2 decoder with M-RoPE and GQA
(:324-408) and greedy generation on a preallocated KV cache (:413-512).
The params are the JAX package's tree (nested dicts and lists), with
tensors for arrays; ``quantize_params`` gives the same int8 leaves
``{"w_q", "w_s"}`` that ``_linear`` sends to ``ops/quant.linear_q8``.

The JAX judge reaches no Pallas kernel: its attention and its linears are
XLA einsums.  So is the port's: every product here is a plain PyTorch op,
the attention in f32 logits as the JAX source writes it.  The judge's
forward runs under ``full_f32_matmul()`` (the caller's TF32 flags would
otherwise turn the f32 products of an f32 judge into TF32 products).

``GreedyGenerator`` runs the JAX generator's prefill and decode steps
eagerly, each at a static shape (the cache is allocated once per call at
``max_len + max_new``; a step writes its slot by ``index_copy_`` and masks
by a tensor position), and checks EOS on the host once a token.
``convert_hf`` stays in the JAX package; the port reads its ``.npz``
(``models/weights.load_qwen_vl_npz``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bsc_nav_tpu_torch.ops import quant


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    depth: int = 32
    hidden: int = 1280
    heads: int = 16
    patch: int = 14
    temporal_patch: int = 2
    merge: int = 2
    out_hidden: int = 2048
    intermediate: int = 3420
    window: int = 112
    fullatt: Tuple[int, ...] = (7, 15, 23, 31)
    in_ch: int = 3

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


@dataclasses.dataclass(frozen=True)
class QwenVLTextConfig:
    hidden: int = 2048
    layers: int = 36
    heads: int = 16
    kv_heads: int = 2
    intermediate: int = 11008
    vocab: int = 151936
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    mrope_section: Tuple[int, ...] = (16, 24, 24)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


@dataclasses.dataclass(frozen=True)
class QwenVLConfig:
    text: QwenVLTextConfig = dataclasses.field(
        default_factory=QwenVLTextConfig)
    vision: QwenVLVisionConfig = dataclasses.field(
        default_factory=QwenVLVisionConfig)
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    tie_word_embeddings: bool = True


QWEN25_VL_3B = QwenVLConfig()

QWEN_VL_TEST = QwenVLConfig(
    text=QwenVLTextConfig(hidden=24, layers=2, heads=4, kv_heads=2,
                          intermediate=48, vocab=128,
                          mrope_section=(1, 1, 1)),
    vision=QwenVLVisionConfig(depth=2, hidden=32, heads=2, patch=2,
                              temporal_patch=2, merge=2, out_hidden=24,
                              intermediate=40, window=8, fullatt=(1,)),
    image_token_id=120, vision_start_token_id=122,
    tie_word_embeddings=False)


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 statistics and f32 product with ``w``, rounded once to
    ``x.dtype``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (w.float() * (xf * torch.rsqrt(var + eps))).to(x.dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """A plain leaf: the product accumulated in f32, the bias added in f32,
    one rounding to ``x.dtype`` (``quant.linear``); an int8 leaf
    ``{"w_q", "w_s"}``: ``quant.linear_q8``."""
    if isinstance(w, dict):
        return quant.linear_q8(x, w if b is None else {**w, "b": b})
    return quant.linear(x, {"w": w, "b": b})


def quantize_params(params: Dict[str, Any],
                    scope: str = "text") -> Dict[str, Any]:
    """int8 W8A8 leaves on the judge's matmul weights (JAX
    ``quantize_params``, qwen_vl.py:131): ``scope`` "text" (the decoder and
    ``lm_head``: a decode step reads every one of them once), "vision" or
    "all".  Embeddings, norm scales and biases stay as they are."""
    def q(w):
        return quant.quantize_weight({"w": w})

    def q_mlp(m):
        nm = dict(m)
        for k in ("gate_w", "up_w", "down_w"):
            nm[k] = q(nm[k])
        return nm

    out = dict(params)
    if scope in ("text", "all"):
        layers = []
        for blk in params["layers"]:
            nb = dict(blk)
            for k in ("q_w", "k_w", "v_w", "o_w"):
                nb[k] = q(nb[k])
            nb["mlp"] = q_mlp(nb["mlp"])
            layers.append(nb)
        out["layers"] = layers
        out["lm_head"] = q(params["lm_head"])
    if scope in ("vision", "all"):
        vis = dict(params["vision"])
        blocks = []
        for blk in vis["blocks"]:
            nb = dict(blk)
            nb["qkv_w"] = q(nb["qkv_w"])
            nb["proj_w"] = q(nb["proj_w"])
            nb["mlp"] = q_mlp(nb["mlp"])
            blocks.append(nb)
        vis["blocks"] = blocks
        merger = dict(vis["merger"])
        merger["fc1_w"] = q(merger["fc1_w"])
        merger["fc2_w"] = q(merger["fc2_w"])
        vis["merger"] = merger
        out["vision"] = vis
    return out


def _swiglu(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    g = _linear(x, p["gate_w"], p.get("gate_b"))
    u = _linear(x, p["up_w"], p.get("up_b"))
    return _linear(F.silu(g.float()).to(x.dtype) * u, p["down_w"],
                   p.get("down_b"))


def _masked_attention(q, k, v, mask, scale) -> torch.Tensor:
    """q, k, v [B, H, S, hd]; mask [.., Sq, Sk] bool (True attends).  f32
    logits, the -1e30 fill, an f32 softmax, the probabilities cast to
    ``v.dtype``, the P.V product accumulated in f32, cast to ``q.dtype``
    (qwen_vl.py:194-201)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# vision tower
# --------------------------------------------------------------------------

def vision_window_layout(vcfg: QwenVLVisionConfig,
                         grid_thw: Sequence[Tuple[int, int, int]]):
    """Host bookkeeping of the windows, as the JAX package's (a copy of
    qwen_vl.py:208-255): (window_index [S/mu], seg_window [S], seg_full
    [S], pos_hw [S, 2]) for the fixed image grid."""
    mu = vcfg.merge * vcfg.merge
    win = vcfg.window // vcfg.merge // vcfg.patch
    window_index: List[np.ndarray] = []
    cu_window: List[int] = [0]
    seg_full: List[np.ndarray] = []
    pos_list: List[np.ndarray] = []
    base = 0
    for img_i, (t, h, w) in enumerate(grid_thw):
        lh, lw = h // vcfg.merge, w // vcfg.merge
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % win, (-lw) % win
        nh, nw = (lh + pad_h) // win, (lw + pad_w) // win
        idxp = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
        idxp[:, :lh, :lw] = idx
        idxp = idxp.reshape(t, nh, win, nw, win).transpose(0, 1, 3, 2, 4)
        idxp = idxp.reshape(t, nh * nw, win, win)
        seqlens = (idxp != -100).sum(axis=(2, 3)).reshape(-1)
        flat = idxp.reshape(-1)
        window_index.append(flat[flat != -100] + base)
        for s in np.cumsum(seqlens) * mu + cu_window[-1]:
            if s != cu_window[-1] or not cu_window:
                cu_window.append(int(s))
        base += t * lh * lw
        # full attention is per (image, temporal frame)
        seg_full.append(np.repeat(
            img_i * 1000 + np.arange(t, dtype=np.int32), h * w))
        # 2-D rotary positions (merged-unit raster order, pre-window)
        hp = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hp = hp.reshape(lh, vcfg.merge, lw, vcfg.merge
                        ).transpose(0, 2, 1, 3).reshape(-1)
        wp = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wp = wp.reshape(lh, vcfg.merge, lw, vcfg.merge
                        ).transpose(0, 2, 1, 3).reshape(-1)
        pos_list.append(np.tile(np.stack([hp, wp], -1), (t, 1)))
    window_index = np.concatenate(window_index)
    S = base * mu
    seg_window = np.zeros(S, np.int32)
    for i in range(len(cu_window) - 1):
        seg_window[cu_window[i]:cu_window[i + 1]] = i
    return (window_index, seg_window,
            np.concatenate(seg_full), np.concatenate(pos_list))


def vision_forward(params, patches: torch.Tensor,
                   grid_thw: Sequence[Tuple[int, int, int]],
                   vcfg: QwenVLVisionConfig) -> torch.Tensor:
    """patches [S, in_ch * tp * p * p] (the HF pixel_values layout) ->
    merged tokens [S / mu, out_hidden] (qwen_vl.py:258-318)."""
    mu = vcfg.merge * vcfg.merge
    window_index, seg_window, seg_full, pos_hw = vision_window_layout(
        vcfg, grid_thw)
    S = patches.shape[0]
    dev = patches.device

    x = _linear(patches, params["patch_w"])              # [S, hidden]

    # 2-D rotary: head_dim / 2 split between h and w positions, in float64
    # on the host and rounded once to f32, as the JAX source does
    hd = vcfg.head_dim
    inv = 1.0 / (10000.0 ** (np.arange(0, hd // 2, 2) / (hd // 2)))
    freqs = np.concatenate([pos_hw[:, :1] * inv[None],
                            pos_hw[:, 1:] * inv[None]], axis=-1)

    # the window shuffle (a static gather) of tokens and rotary positions
    perm = (window_index[:, None] * mu + np.arange(mu)[None]).reshape(-1)
    x = x[torch.from_numpy(perm).to(dev)]
    freqs = freqs[perm]
    emb = np.concatenate([freqs, freqs], axis=-1)
    cos = torch.from_numpy(np.cos(emb).astype(np.float32)).to(dev)[None, None]
    sin = torch.from_numpy(np.sin(emb).astype(np.float32)).to(dev)[None, None]
    seg_full_w = torch.from_numpy(seg_full[perm]).to(dev)
    seg_win = torch.from_numpy(seg_window).to(dev)
    mask_window = seg_win[:, None] == seg_win[None, :]
    mask_full = seg_full_w[:, None] == seg_full_w[None, :]

    scale = 1.0 / math.sqrt(hd)
    H = vcfg.heads

    def rot(t):                                 # rotary in f32
        tf = t.transpose(0, 1)[None].float()    # [1, H, S, hd]
        return tf * cos + _rotate_half(tf) * sin

    for i, blk in enumerate(params["blocks"]):
        y = rms_norm(x, blk["norm1"], 1e-6)
        qkv = _linear(y, blk["qkv_w"], blk["qkv_b"]).reshape(S, 3, H, hd)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        vv = v.transpose(0, 1)[None].float()
        mask = mask_full if i in vcfg.fullatt else mask_window
        att = _masked_attention(rot(q), rot(k), vv, mask, scale)
        att = att[0].transpose(0, 1).reshape(S, -1).to(x.dtype)
        x = x + _linear(att, blk["proj_w"], blk["proj_b"])
        y = rms_norm(x, blk["norm2"], 1e-6)
        x = x + _swiglu(y, blk["mlp"])

    # the spatial merger
    m = params["merger"]
    y = rms_norm(x, m["ln_q"], 1e-6).reshape(S // mu, mu * vcfg.hidden)
    y = _linear(F.gelu(_linear(y, m["fc1_w"], m["fc1_b"]).float()).to(
        x.dtype), m["fc2_w"], m["fc2_b"])
    # undo the window shuffle
    reverse = np.argsort(window_index)
    return y[torch.from_numpy(reverse).to(dev)]


# --------------------------------------------------------------------------
# text decoder
# --------------------------------------------------------------------------

def mrope_cos_sin(pos_ids: torch.Tensor, tcfg: QwenVLTextConfig):
    """pos_ids [3, B, S] -> (cos, sin) [B, S, hd], each channel section
    rotated by its (temporal, height, width) position (qwen_vl.py:324)."""
    hd = tcfg.head_dim
    inv = torch.from_numpy((1.0 / (tcfg.rope_theta ** (
        np.arange(0, hd, 2) / hd))).astype(np.float32)).to(pos_ids.device)
    freqs = pos_ids[..., None].float() * inv               # [3, B, S, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)                # [3, B, S, hd]
    cos, sin = torch.cos(emb), torch.sin(emb)
    sections = list(tcfg.mrope_section) * 2
    starts = np.cumsum([0] + sections[:-1])
    cos = torch.cat([cos[i % 3, ..., int(s):int(s) + sec]
                     for i, (s, sec) in enumerate(zip(starts, sections))],
                    dim=-1)
    sin = torch.cat([sin[i % 3, ..., int(s):int(s) + sec]
                     for i, (s, sec) in enumerate(zip(starts, sections))],
                    dim=-1)
    return cos, sin


def _text_layer_qkv(blk, x, cos, sin, tcfg: QwenVLTextConfig):
    """q, k rotated (``q * cos`` promotes a bf16 q to f32, then one cast
    back), v as projected: [B, heads, S, hd] (qwen_vl.py:343)."""
    B, S, _ = x.shape
    hd, H, KV = tcfg.head_dim, tcfg.heads, tcfg.kv_heads
    q = _linear(x, blk["q_w"], blk["q_b"]).reshape(B, S, H, hd)
    k = _linear(x, blk["k_w"], blk["k_b"]).reshape(B, S, KV, hd)
    v = _linear(x, blk["v_w"], blk["v_b"]).reshape(B, S, KV, hd)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    c, s = cos[:, None], sin[:, None]                      # [B, 1, S, hd]
    q = q * c + _rotate_half(q) * s
    k = k * c + _rotate_half(k) * s
    return q.to(x.dtype), k.to(x.dtype), v


def _layer_rest(blk, x, att, tcfg: QwenVLTextConfig) -> torch.Tensor:
    x = x + _linear(att, blk["o_w"])
    y = rms_norm(x, blk["ln2"], tcfg.rms_eps)
    return x + _swiglu(y, blk["mlp"])


def text_forward(params, embeds: torch.Tensor, pos_ids: torch.Tensor,
                 tcfg: QwenVLTextConfig,
                 valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward: embeds [B, S, D], pos_ids [3, B, S] ->
    logits [B, S, vocab] (qwen_vl.py:359)."""
    B, S, D = embeds.shape
    dev = embeds.device
    cos, sin = mrope_cos_sin(pos_ids, tcfg)
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()[None, None]
    if valid_len is not None:
        causal = causal & (torch.arange(S, device=dev)[None, None, None, :]
                           < valid_len.to(dev)[:, None, None, None])
    x = embeds
    g = tcfg.heads // tcfg.kv_heads
    scale = 1.0 / math.sqrt(tcfg.head_dim)
    for blk in params["layers"]:
        y = rms_norm(x, blk["ln1"], tcfg.rms_eps)
        q, k, v = _text_layer_qkv(blk, y, cos, sin, tcfg)
        att = _masked_attention(q, k.repeat_interleave(g, dim=1),
                                v.repeat_interleave(g, dim=1), causal, scale)
        x = _layer_rest(blk, x, att.transpose(1, 2).reshape(B, S, D), tcfg)
    x = rms_norm(x, params["norm"], tcfg.rms_eps)
    return _linear(x, params["lm_head"])


def embed_tokens(params, ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][ids]


def merge_vision_embeds(params, ids: torch.Tensor, vision_tokens,
                        image_token_id: int) -> torch.Tensor:
    """The merged vision tokens in the image-pad positions of the token
    embeddings, the n-th image slot taking the n-th token (the cumsum slot
    order of qwen_vl.py:391-410).  ids [B, S]; vision_tokens [N, D]."""
    emb = embed_tokens(params, ids)
    B, S, D = emb.shape
    flat = emb.reshape(B * S, D)
    is_img = ids.reshape(-1) == image_token_id
    slot = torch.cumsum(is_img.to(torch.int64), 0) - 1
    gathered = vision_tokens.to(flat.dtype)[
        slot.clamp(0, vision_tokens.shape[0] - 1)]
    return torch.where(is_img[:, None], gathered, flat).reshape(B, S, D)


# --------------------------------------------------------------------------
# greedy generation (prefill + decode steps on a preallocated KV cache)
# --------------------------------------------------------------------------

class GreedyGenerator:
    """The JAX ``make_greedy_generator`` (qwen_vl.py:413-512), eagerly:
    ``gen(params, embeds [1, max_len, D], prompt_len, pos_ids [3, 1,
    max_len], start_pos) -> (tokens [max_new] int32, n)``.  A prefill over
    the padded prompt (masked by ``prompt_len``) fills a cache of
    ``max_len + max_new`` slots per layer; decode step i writes slot
    ``prompt_len + i`` at text position ``start_pos + i`` and attends to
    the slots up to it.  Tokens after the last generated one are EOS, the
    first token comes from the prefill's logits, and decoding stops at EOS
    or ``max_new`` tokens.  ``trace`` (a list) receives the prefill's and
    each step's logits."""

    def __init__(self, tcfg: QwenVLTextConfig, max_len: int, max_new: int,
                 eos_id: int):
        self.tcfg, self.max_len, self.max_new = tcfg, max_len, max_new
        self.total = max_len + max_new
        self.eos_id = int(eos_id)
        self.g = tcfg.heads // tcfg.kv_heads
        self.scale = 1.0 / math.sqrt(tcfg.head_dim)

    def prefill(self, params, embeds, prompt_len: int, pos_ids):
        tcfg = self.tcfg
        B, S, D = embeds.shape
        dev = embeds.device
        cos, sin = mrope_cos_sin(pos_ids, tcfg)
        causal = (torch.ones(S, S, dtype=torch.bool, device=dev).tril()
                  & (torch.arange(S, device=dev) < prompt_len)[None, :]
                  )[None, None]
        x = embeds
        caches = []
        for blk in params["layers"]:
            y = rms_norm(x, blk["ln1"], tcfg.rms_eps)
            q, k, v = _text_layer_qkv(blk, y, cos, sin, tcfg)
            kc = torch.zeros(1, tcfg.kv_heads, self.total, tcfg.head_dim,
                             dtype=k.dtype, device=dev)
            vc = torch.zeros_like(kc)
            kc[:, :, :S] = k
            vc[:, :, :S] = v.to(k.dtype)
            caches.append((kc, vc))
            att = _masked_attention(q, k.repeat_interleave(self.g, dim=1),
                                    v.repeat_interleave(self.g, dim=1),
                                    causal, self.scale)
            x = _layer_rest(blk, x, att.transpose(1, 2).reshape(B, S, D),
                            tcfg)
        x = rms_norm(x, params["norm"], tcfg.rms_eps)
        return caches, _linear(x[0, prompt_len - 1], params["lm_head"])

    def decode_step(self, params, caches, token: torch.Tensor,
                    pos: torch.Tensor, cache_pos: torch.Tensor):
        """One token through every layer, static in shape: ``token``,
        ``pos`` (its text position; the three M-RoPE sections agree for
        text) and ``cache_pos`` are 1-element device tensors."""
        tcfg = self.tcfg
        dev = token.device
        x = params["embed"][token][None]                    # [1, 1, D]
        cos, sin = mrope_cos_sin(pos.reshape(1, 1, 1).expand(3, 1, 1), tcfg)
        D = x.shape[-1]
        mask = (torch.arange(self.total, device=dev) <= cache_pos
                )[None, None, None, :]
        for blk, (kc, vc) in zip(params["layers"], caches):
            y = rms_norm(x, blk["ln1"], tcfg.rms_eps)
            q, k, v = _text_layer_qkv(blk, y, cos, sin, tcfg)
            kc.index_copy_(2, cache_pos, k.to(kc.dtype))
            vc.index_copy_(2, cache_pos, v.to(vc.dtype))
            att = _masked_attention(q, kc.repeat_interleave(self.g, dim=1),
                                    vc.repeat_interleave(self.g, dim=1),
                                    mask, self.scale)
            x = _layer_rest(blk, x, att.reshape(1, 1, D), tcfg)
        x = rms_norm(x, params["norm"], tcfg.rms_eps)
        return _linear(x[0, 0], params["lm_head"])

    def __call__(self, params, embeds, prompt_len: int, pos_ids,
                 start_pos: int, trace: Optional[list] = None,
                 step_ms: Optional[list] = None):
        """``step_ms`` (a list) receives the host time of the prefill and
        of each decode step, each ending where its token is read on the
        host."""
        prompt_len, start_pos = int(prompt_len), int(start_pos)
        if embeds.shape[1] != self.max_len:
            raise ValueError(f"embeds of {embeds.shape[1]} positions, the "
                             f"generator's max_len is {self.max_len}")
        dev = embeds.device
        t0 = time.perf_counter()
        caches, logits = self.prefill(params, embeds, prompt_len, pos_ids)
        tokens = torch.full((self.max_new,), self.eos_id, dtype=torch.int32,
                            device=dev)
        i = -1
        while True:
            if trace is not None:
                trace.append(logits)
            tok = torch.argmax(logits).reshape(1)
            tokens[i + 1] = tok[0]
            i += 1
            done = int(tok) == self.eos_id          # the host's sync
            if step_ms is not None:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if done or i + 1 >= self.max_new:
                return tokens, i + 1
            t0 = time.perf_counter()
            logits = self.decode_step(
                params, caches, tok,
                torch.tensor([start_pos + i], device=dev),
                torch.tensor([prompt_len + i], device=dev))


def make_greedy_generator(tcfg: QwenVLTextConfig, max_len: int,
                          max_new: int, eos_id: int) -> GreedyGenerator:
    return GreedyGenerator(tcfg, max_len, max_new, eos_id)


# --------------------------------------------------------------------------
# random init (the card's full-width weights, drawn on the device)
# --------------------------------------------------------------------------

def init_params(cfg: QwenVLConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda",
                std: float = 0.02) -> Dict[str, Any]:
    """Random weights at the configured shapes, in the JAX ``init_params``
    layout (qwen_vl.py:593): normals of ``std`` drawn on ``device`` from
    ``generator`` (in f32, then cast), unit norm scales, zero biases, an
    untied ``lm_head``."""
    from bsc_nav_tpu_torch import resolve_device
    dev = resolve_device(device)
    v, tc = cfg.vision, cfg.text

    def r(*shape):
        return (torch.randn(shape, generator=generator, device=dev)
                * std).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    mh = v.hidden * v.merge ** 2
    vis = {
        "patch_w": r(v.in_ch * v.temporal_patch * v.patch * v.patch,
                     v.hidden),
        "blocks": [{
            "norm1": ones(v.hidden), "norm2": ones(v.hidden),
            "qkv_w": r(v.hidden, 3 * v.hidden), "qkv_b": zeros(3 * v.hidden),
            "proj_w": r(v.hidden, v.hidden), "proj_b": zeros(v.hidden),
            "mlp": {"gate_w": r(v.hidden, v.intermediate),
                    "gate_b": zeros(v.intermediate),
                    "up_w": r(v.hidden, v.intermediate),
                    "up_b": zeros(v.intermediate),
                    "down_w": r(v.intermediate, v.hidden),
                    "down_b": zeros(v.hidden)},
        } for _ in range(v.depth)],
        "merger": {"ln_q": ones(v.hidden), "fc1_w": r(mh, mh),
                   "fc1_b": zeros(mh), "fc2_w": r(mh, v.out_hidden),
                   "fc2_b": zeros(v.out_hidden)},
    }
    kvd = tc.kv_heads * tc.head_dim
    return {
        "vision": vis,
        "embed": r(tc.vocab, tc.hidden),
        "norm": ones(tc.hidden),
        "layers": [{
            "ln1": ones(tc.hidden), "ln2": ones(tc.hidden),
            "q_w": r(tc.hidden, tc.hidden), "q_b": zeros(tc.hidden),
            "k_w": r(tc.hidden, kvd), "k_b": zeros(kvd),
            "v_w": r(tc.hidden, kvd), "v_b": zeros(kvd),
            "o_w": r(tc.hidden, tc.hidden),
            "mlp": {"gate_w": r(tc.hidden, tc.intermediate),
                    "up_w": r(tc.hidden, tc.intermediate),
                    "down_w": r(tc.intermediate, tc.hidden)},
        } for _ in range(tc.layers)],
        "lm_head": r(tc.hidden, tc.vocab),
    }
