"""Grounding DINO open-vocabulary detector (IDEA-Research grounding-dino-tiny)
in PyTorch.

Counterpart of ``bsc_nav_tpu/models/grounding_dino.py``: the Swin-T
backbone (window attention, shifted windows, patch merging), the BERT-base
text encoder over phrase-grouped masks, the feature-enhancer encoder
(bi-directional vision<->text fusion, text self-attention, multi-scale
deformable attention), the two-stage query selection, the decoder with
iterative box refinement, the contrastive class head and
``GroundingDinoDetector``.  Parameters are the JAX package's tree (nested
dicts and lists of tensors, linear ``w`` stored ``[fan_in, fan_out]``, HWIO
convs, NHWC activations), as the port's YOLO-World keeps its own;
``convert_hf`` stays in the JAX package and the port reads the ``.npz`` it
writes (``models/weights.py``).  The host parts (configs, the Swin index
tables, the text masks, the phrase map and scores) are copies of the
original's.

The JAX module reaches no ``pallas_call``, so this one launches no kernel
of the port: attention (``_mha``, the Swin windows, ``_bi_attention``) is
plain products and softmax, as there.  Routes:

- Products run in f32 under ``full_f32_matmul`` (the detector's boxes and
  its top-900 selection rest on f32 sums).  The patch embedding (a 4x4
  stride-4 "VALID" conv) and the 1x1 input projections are products; the
  3x3 stride-2 input projection is one ``F.conv2d``, on a CUDA tensor cuDNN
  with TF32 off for that call (PyTorch's default lets cuDNN use TF32).
- Multi-scale deformable attention samples each level with
  ``F.grid_sample`` (bilinear, zero padding, ``align_corners=False``), as
  HF's PyTorch path does: the JAX module's quad-row gather was laid out for
  the TPU, and at B 8 and 800^2 its encoder gather alone would write 6.97 GB
  (8 x 8 heads x 13,294 queries x 16 samples x 128 f32), where a level's
  ``grid_sample`` output is at most 0.44 GB.
- The top-900 selection takes ``memory.query.stable_top_k`` (``lax.top_k``'s
  order: ties by the lower index); ``forward(..., topk_idx=)`` takes given
  indices instead, so that a test can hand JAX's selection on.
- ``_bi_attention`` subtracts the max over the whole score tensor, the
  batch included, before its clip at +-50,000, as the JAX module does: a
  batch's frames are not independent there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bsc_nav_tpu_torch import full_f32_matmul, resolve_device
from bsc_nav_tpu_torch.memory.query import stable_top_k
from bsc_nav_tpu_torch.models import vit
from bsc_nav_tpu_torch.models.detector import Detection
from bsc_nav_tpu_torch.models.yolo_world import nms


# --------------------------------------------------------------------------
# configs (host copies)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 4
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-5
    out_stages: Tuple[int, ...] = (1, 2, 3)   # 0-indexed (HF stage2/3/4)

    def stage_dim(self, i: int) -> int:
        return int(self.embed_dim * 2 ** i)


@dataclasses.dataclass(frozen=True)
class BertTextConfig:
    vocab_size: int = 30522
    dim: int = 768
    layers: int = 12
    heads: int = 12
    ffn: int = 3072
    max_pos: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class GroundingDinoConfig:
    d_model: int = 256
    encoder_layers: int = 6
    decoder_layers: int = 6
    heads: int = 8
    ffn_dim: int = 2048
    num_levels: int = 4
    enc_points: int = 4
    dec_points: int = 4
    num_queries: int = 900
    max_text_len: int = 256
    pos_temperature: int = 20
    ln_eps: float = 1e-5
    swin: SwinConfig = dataclasses.field(default_factory=SwinConfig)
    text: BertTextConfig = dataclasses.field(default_factory=BertTextConfig)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads

    @property
    def fusion_dim(self) -> int:
        return self.ffn_dim // 2

    @property
    def fusion_heads(self) -> int:
        return self.heads // 2


GROUNDING_DINO_TINY = GroundingDinoConfig()

# BERT [CLS], [SEP], '.', '?' — phrase delimiters in the prompt
SPECIAL_TOKEN_IDS = (101, 102, 1012, 1029)


# --------------------------------------------------------------------------
# shared primitives
# --------------------------------------------------------------------------

def _ln(x, p, eps):
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


def _lin(x, p):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _gelu(x):
    return F.gelu(x, approximate="none")


def _attend(q, k, v, additive_mask=None):
    """q [B, Sq, h, hd], k / v [B, Sk, h, hd] -> [B, Sq, h * hd]: scaled
    scores, the additive mask, softmax, the weighted values -- the JAX
    module's einsums, not a fused attention."""
    B, Sq, h, hd = q.shape
    scores = (q.permute(0, 2, 1, 3) @ k.permute(0, 2, 3, 1)) / math.sqrt(hd)
    if additive_mask is not None:
        scores = scores + additive_mask
    out = torch.softmax(scores, dim=-1) @ v.permute(0, 2, 1, 3)
    return out.permute(0, 2, 1, 3).reshape(B, Sq, h * hd)


def _mha(x_q, x_k, x_v, p, heads, additive_mask=None):
    """Multi-head attention with separate q/k/v linears (HF
    GroundingDinoMultiheadAttention / BertSelfAttention layout)."""
    B, Sq, _ = x_q.shape
    Sk = x_k.shape[1]
    hd = p["q"]["w"].shape[1] // heads
    q = _lin(x_q, p["q"]).reshape(B, Sq, heads, hd)
    k = _lin(x_k, p["k"]).reshape(B, Sk, heads, hd)
    v = _lin(x_v, p["v"]).reshape(B, Sk, heads, hd)
    return _lin(_attend(q, k, v, additive_mask), p["out"])


def _mlp_head(x, layers):
    """DETR MLPPredictionHead: relu between layers, none at the end."""
    for i, p in enumerate(layers):
        x = _lin(x, p)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _inverse_sigmoid(x, eps=1e-5):
    x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def _conv2d(x, w_hwio, b, stride: int, pad: int):
    """NHWC conv with explicit symmetric padding (the JAX module's
    ``[(1, 1), (1, 1)]``), f32 whatever the process's cuDNN TF32 flag says."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                     stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1) + b


# --------------------------------------------------------------------------
# Swin backbone
# --------------------------------------------------------------------------

def _swin_rel_pos_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)                                   # [w*w, w*w]


def _window_partition(x, w):
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def _window_reverse(x, w, H, W, C):
    B = x.shape[0] // ((H // w) * (W // w))
    x = x.reshape(B, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _swin_shift_mask(Hp, Wp, window, shift) -> np.ndarray:
    """Additive attention mask for shifted windows (-100 across shift
    region boundaries, HF SwinLayer.get_attn_mask)."""
    img = np.zeros((1, Hp, Wp, 1), np.float32)
    slices = (slice(0, -window), slice(-window, -shift),
              slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[:, hs, ws, :] = cnt
            cnt += 1
    w = window
    mw = img.reshape(1, Hp // w, w, Wp // w, w, 1).transpose(
        0, 1, 3, 2, 4, 5).reshape(-1, w * w)
    attn = mw[:, None, :] - mw[:, :, None]
    return np.where(attn != 0, -100.0, 0.0).astype(np.float32)


def _swin_block(x, H, W, blk, cfg: SwinConfig, heads, shift):
    """One Swin layer on tokens x [B, H*W, C]; windows always partitioned at
    cfg.window_size with zero padding (backbone ``always_partition``)."""
    B, _, C = x.shape
    w = cfg.window_size
    shortcut = x
    y = _ln(x, blk["ln1"], cfg.ln_eps).reshape(B, H, W, C)

    pad_b = (w - H % w) % w
    pad_r = (w - W % w) % w
    if pad_b or pad_r:
        y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
    Hp, Wp = H + pad_b, W + pad_r

    if shift > 0:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))

    wins = _window_partition(y, w)                       # [nW*B, w*w, C]
    hd = C // heads
    q, k, v = (_lin(wins, blk[n]).reshape(-1, w * w, heads, hd)
               for n in ("q", "k", "v"))
    rpb = blk["rpb"][blk["rpb_index"].reshape(-1)]
    bias = rpb.reshape(w * w, w * w, heads).permute(2, 0, 1)[None]
    if shift > 0:
        smask = torch.from_numpy(_swin_shift_mask(Hp, Wp, w, shift)).to(
            x.device)
        # scores + rpb + mask, the mask per window of each frame
        bias = (bias + smask[:, None]).repeat(B, 1, 1, 1)
    att = _lin(_attend(q, k, v, bias), blk["attn_out"])

    y = _window_reverse(att, w, Hp, Wp, C)
    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    if pad_b or pad_r:
        y = y[:, :H, :W]
    x = shortcut + y.reshape(B, H * W, C)

    y = _ln(x, blk["ln2"], cfg.ln_eps)
    y = _lin(_gelu(_lin(y, blk["fc1"])), blk["fc2"])
    return x + y


def _patch_merge(x, H, W, p, eps):
    B, _, C = x.shape
    x = x.reshape(B, H, W, C)
    if H % 2 or W % 2:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                   x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
    x = x.reshape(B, -1, 4 * C)
    x = _ln(x, p["norm"], eps)
    return _lin(x, p["reduction"])


def swin_backbone(params, pixel_values, cfg: SwinConfig
                  ) -> List[Tuple[torch.Tensor, Tuple[int, int]]]:
    """pixel_values [B, H, W, 3] normalized -> list of (feature map
    [B, h, w, C_stage], (h, w)) for each out stage, LayerNormed
    (HF SwinBackbone hidden_states_norms)."""
    B, H, W, _ = pixel_values.shape
    ps = cfg.patch_size
    pad_b = (ps - H % ps) % ps
    pad_r = (ps - W % ps) % ps
    if pad_b or pad_r:
        pixel_values = F.pad(pixel_values, (0, 0, 0, pad_r, 0, pad_b))
    h, w = pixel_values.shape[1] // ps, pixel_values.shape[2] // ps
    # the 4x4 stride-4 "VALID" conv as one product over (kh, kw, c) patches
    patches = pixel_values.reshape(B, h, ps, w, ps, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(B, h * w, ps * ps * 3)
    x = patches @ params["patch_proj"]["w"].reshape(ps * ps * 3, -1)
    x = _ln(x + params["patch_proj"]["b"], params["embed_norm"], cfg.ln_eps)

    outs = []
    for si, stage in enumerate(params["stages"]):
        heads = cfg.num_heads[si]
        for bi, blk in enumerate(stage["blocks"]):
            shift = 0 if bi % 2 == 0 else cfg.window_size // 2
            x = _swin_block(x, h, w, blk, cfg, heads, shift)
        if si in cfg.out_stages:
            oi = cfg.out_stages.index(si)
            f = _ln(x, params["out_norms"][oi], 1e-5)
            outs.append((f.reshape(B, h, w, -1), (h, w)))
        if "downsample" in stage:
            x = _patch_merge(x, h, w, stage["downsample"], cfg.ln_eps)
            h, w = (h + 1) // 2, (w + 1) // 2
    return outs


# --------------------------------------------------------------------------
# BERT text encoder
# --------------------------------------------------------------------------

def bert_encode(params, input_ids, token_type_ids, position_ids,
                attn_3d_mask, cfg: BertTextConfig) -> torch.Tensor:
    """attn_3d_mask [B, S, S] bool, True = attend (the phrase-grouped mask
    from generate_text_masks)."""
    x = (params["word_emb"][input_ids]
         + params["pos_emb"][position_ids]
         + params["type_emb"][token_type_ids])
    x = _ln(x, params["emb_norm"], cfg.ln_eps)
    add_mask = (1.0 - attn_3d_mask.to(torch.float32)[:, None]) * -1e30
    for layer in params["layers"]:
        att = _mha(x, x, x, layer, cfg.heads, additive_mask=add_mask)
        x = _ln(x + att, layer["attn_norm"], cfg.ln_eps)
        y = _lin(_gelu(_lin(x, layer["fc1"])), layer["fc2"])
        x = _ln(x + y, layer["out_norm"], cfg.ln_eps)
    return x


# --------------------------------------------------------------------------
# position embeddings
# --------------------------------------------------------------------------

def _interleave(p):
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                       dim=-1).reshape(*p.shape[:-1], -1)


def _dim_t(n, temperature, device):
    d = torch.arange(n, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(float(temperature), device=device),
                     2 * torch.floor(d / 2) / n)


def _sine_pos_2d(h, w, d_model, temperature, device) -> torch.Tensor:
    """Image sine position embedding over a full-valid map
    (HF GroundingDinoSinePositionEmbedding with an all-ones mask)."""
    half = d_model // 2
    scale = 2 * math.pi
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.arange(1, h + 1, **f32)[:, None] / (h + 1e-6) * scale
    x = torch.arange(1, w + 1, **f32)[None, :] / (w + 1e-6) * scale
    dim_t = _dim_t(half, temperature, device)
    py = _interleave(y[:, :, None] / dim_t).expand(h, w, half)
    px = _interleave(x[:, :, None] / dim_t).expand(h, w, half)
    return torch.cat([py, px], dim=-1)                   # [h, w, d_model]


def _sine_pos_1d(pos, num_feats, temperature=10000, exchange_xy=True
                 ) -> torch.Tensor:
    """get_sine_pos_embed: pos [..., n] -> [..., n*num_feats]."""
    dim_t = _dim_t(num_feats, temperature, pos.device)
    embs = [_interleave(pos[..., i, None] * (2 * math.pi) / dim_t)
            for i in range(pos.shape[-1])]
    if exchange_xy and len(embs) >= 2:
        embs[0], embs[1] = embs[1], embs[0]
    return torch.cat(embs, dim=-1)


# --------------------------------------------------------------------------
# multi-scale deformable attention (grid_sample per level)
# --------------------------------------------------------------------------

def _deform_attention(query, value_flat, ref_points, shapes, p, heads,
                      points):
    """query [B, Q, D]; value_flat [B, N, D] (projected here); ref_points
    [B, Q, L, 2 or 4] normalized; shapes: (h, w) per level.

    HF MultiScaleDeformableAttention: each level's samples by
    ``F.grid_sample`` (bilinear, zero padding, ``align_corners=False``:
    pixel x = loc * w - 0.5, as the JAX module's gather), weighted by the
    softmax over the levels' points and summed."""
    B, Q, D = query.shape
    L = len(shapes)
    hd = D // heads

    value = _lin(value_flat, p["value_proj"])
    off = _lin(query, p["sampling_offsets"]).reshape(B, Q, heads, L,
                                                     points, 2)
    aw = torch.softmax(_lin(query, p["attention_weights"]).reshape(
        B, Q, heads, L * points), dim=-1).reshape(B, Q, heads, L, points)

    if ref_points.shape[-1] == 2:
        normalizer = torch.tensor([[w, h] for (h, w) in shapes],
                                  dtype=torch.float32, device=query.device)
        loc = (ref_points[:, :, None, :, None, :]
               + off / normalizer[None, None, None, :, None, :])
    else:
        loc = (ref_points[:, :, None, :, None, :2]
               + off / points * ref_points[:, :, None, :, None, 2:] * 0.5)
    # [B, Q, heads, L, P, 2] -> per level [B*heads, Q, P, 2] in [-1, 1]
    grid = (2 * loc - 1).permute(0, 2, 3, 1, 4, 5)
    aw = aw.permute(0, 2, 3, 1, 4)                        # [B, h, L, Q, P]
    out = None
    start = 0
    for li, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].reshape(B, h, w, heads, hd)
        start += h * w
        v = v.permute(0, 3, 4, 1, 2).reshape(B * heads, hd, h, w)
        s = F.grid_sample(v, grid[:, :, li].reshape(B * heads, Q, points, 2),
                          mode="bilinear", padding_mode="zeros",
                          align_corners=False)           # [Bh, hd, Q, P]
        a = aw[:, :, li].reshape(B * heads, 1, Q, points)
        term = (s * a).sum(-1)                            # [Bh, hd, Q]
        out = term if out is None else out + term
    out = out.reshape(B, heads, hd, Q).permute(0, 3, 1, 2).reshape(B, Q, D)
    return _lin(out, p["output_proj"])


# --------------------------------------------------------------------------
# encoder (feature enhancer)
# --------------------------------------------------------------------------

def _bi_attention(v_feat, t_feat, p, cfg: GroundingDinoConfig,
                  text_pad_mask):
    """GroundingDinoBiMultiHeadAttention: vision<->text cross attention.
    text_pad_mask [B, S] bool, True = padding."""
    B, Sv, _ = v_feat.shape
    St = t_feat.shape[1]
    nh, hd = cfg.fusion_heads, cfg.fusion_dim // cfg.fusion_heads

    vq = (_lin(v_feat, p["vision_proj"]) * hd ** -0.5).reshape(B, Sv, nh, hd)
    tk = _lin(t_feat, p["text_proj"]).reshape(B, St, nh, hd)
    vv = _lin(v_feat, p["values_vision_proj"]).reshape(B, Sv, nh, hd)
    tv = _lin(t_feat, p["values_text_proj"]).reshape(B, St, nh, hd)

    scores = vq.permute(0, 2, 1, 3) @ tk.permute(0, 2, 3, 1)  # [B,h,Sv,St]
    scores = scores - scores.max()          # over the whole tensor, batch too
    scores = torch.clamp(scores, -50000, 50000)

    t_scores = scores.transpose(2, 3)                     # [B, h, St, Sv]
    t_scores = t_scores - t_scores.amax(dim=-1, keepdim=True)
    t_scores = torch.clamp(t_scores, -50000, 50000)
    text_attn = torch.softmax(t_scores, dim=-1)           # text->vision

    if text_pad_mask is not None:
        scores = scores.masked_fill(text_pad_mask[:, None, None, :],
                                    -math.inf)
    vision_attn = torch.softmax(scores, dim=-1)           # vision->text

    dv = (vision_attn @ tv.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
    dt = (text_attn @ vv.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
    dv = _lin(dv.reshape(B, Sv, -1), p["out_vision_proj"])
    dt = _lin(dt.reshape(B, St, -1), p["out_text_proj"])
    return dv, dt


def _encoder_layer(v_feat, t_feat, layer, cfg: GroundingDinoConfig, *,
                   v_pos, ref_points, shapes, text_pos, text_attn_3d,
                   text_pad_mask):
    # 1) fusion (pre-LN + layer-scale residual)
    f = layer["fusion"]
    vn = _ln(v_feat, f["ln_v"], cfg.ln_eps)
    tn = _ln(t_feat, f["ln_t"], cfg.ln_eps)
    dv, dt = _bi_attention(vn, tn, f, cfg, text_pad_mask)
    v_feat = vn + f["vision_param"] * dv
    t_feat = tn + f["text_param"] * dt

    # 2) text self-attention enhancer (post-LN)
    te = layer["text_enh"]
    add_mask = (1.0 - text_attn_3d.to(torch.float32)[:, None]) * -1e30
    qk = t_feat + text_pos
    att = _mha(qk, qk, t_feat, te, cfg.fusion_heads, additive_mask=add_mask)
    t_feat = _ln(t_feat + att, te["ln_before"], cfg.ln_eps)
    y = _lin(torch.relu(_lin(t_feat, te["fc1"])), te["fc2"])
    t_feat = _ln(t_feat + y, te["ln_after"], cfg.ln_eps)

    # 3) deformable vision self-attention (post-LN)
    d = layer["deform"]
    att = _deform_attention(v_feat + v_pos, v_feat, ref_points, shapes,
                            d, cfg.heads, cfg.enc_points)
    v_feat = _ln(v_feat + att, d["ln1"], cfg.ln_eps)
    y = _lin(torch.relu(_lin(v_feat, d["fc1"])), d["fc2"])
    v_feat = _ln(v_feat + y, d["ln2"], cfg.ln_eps)
    return v_feat, t_feat


# --------------------------------------------------------------------------
# full forward
# --------------------------------------------------------------------------

def generate_text_masks(input_ids: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: phrase-grouped self-attention mask + position ids
    (HF generate_masks_with_special_tokens_and_transfer_map).  Tokens
    between consecutive special tokens attend within their group;
    position ids restart per group."""
    input_ids = np.asarray(input_ids)
    B, S = input_ids.shape
    special = np.isin(input_ids, np.asarray(SPECIAL_TOKEN_IDS))
    attn = np.repeat(np.eye(S, dtype=bool)[None], B, axis=0)
    pos = np.zeros((B, S), np.int64)
    for b in range(B):
        prev = 0
        for col in np.nonzero(special[b])[0]:
            if col == 0 or col == S - 1:
                attn[b, col, col] = True
                pos[b, col] = 0
            else:
                attn[b, prev + 1:col + 1, prev + 1:col + 1] = True
                pos[b, prev + 1:col + 1] = np.arange(0, col - prev)
            prev = col
    return attn, pos


def _group_norm(x, p, groups=32, eps=1e-5):
    """GroupNorm over channel-last [B, H, W, C]."""
    B, H, W, C = x.shape
    xf = x.reshape(B, H, W, groups, C // groups)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return xf * p["scale"] + p["bias"]


def _proposals(shapes, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel anchors (cx, cy, w, h), inverse-sigmoid space; invalid
    anchors (outside (0.01, 0.99)) -> +inf (HF
    generate_encoder_output_proposals with no padding)."""
    out = []
    f32 = dict(dtype=torch.float32, device=device)
    for level, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, **f32),
                                torch.arange(w, **f32), indexing="ij")
        grid = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], dim=-1)
        wh = torch.full_like(grid, 0.05 * 2.0 ** level)
        out.append(torch.cat([grid, wh], dim=-1).reshape(-1, 4))
    p = torch.cat(out, dim=0)                             # [N, 4]
    valid = ((p > 0.01) & (p < 0.99)).all(dim=-1, keepdim=True)
    logit = torch.log(p / (1 - p))
    return torch.where(valid, logit, math.inf), valid[:, 0]


def _input_projections(params, backbone_feats, cfg: GroundingDinoConfig):
    feats = []
    for level in range(cfg.num_levels):
        ip = params["input_proj"][level]
        w, b = ip["conv"]["w"], ip["conv"]["b"]
        if level < len(backbone_feats):
            # a 1x1 "VALID" conv: one product over the channels
            y = backbone_feats[level][0] @ w[0, 0] + b
        else:
            # extra levels: 3x3 stride-2 conv on the previous source
            src = (backbone_feats[-1][0] if level == len(backbone_feats)
                   else feats[-1])
            y = _conv2d(src, w, b, stride=2, pad=1)
        feats.append(_group_norm(y, ip["gn"]))
    return feats


@torch.no_grad()
def forward(params, pixel_values, input_ids, token_type_ids,
            text_attn_3d, position_ids, text_token_mask,
            cfg: GroundingDinoConfig, stage: str = "full",
            topk_idx: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
    """pixel_values [B, H, W, 3] normalized f32; input_ids [B, S];
    text_attn_3d [B, S, S] bool (True=attend); text_token_mask [B, S] bool
    (True=real token).  Returns a dict with ``logits`` [B, num_queries,
    max_text_len] and ``pred_boxes`` [B, num_queries, 4] (cxcywh,
    normalized), in full f32 products.

    ``stage`` truncates the program for cumulative-prefix timing, as the
    JAX module's: "encoder" returns right after the fusion encoder,
    "select" after the two-stage top-k query selection (with each
    proposal's score, ``enc_scores`` [B, N], the selection's input).
    ``topk_idx`` [B, num_queries] replaces that selection's indices; the
    output's ``topk_idx`` are the ones taken."""
    with full_f32_matmul():
        return _forward(params, pixel_values, input_ids, token_type_ids,
                        text_attn_3d, position_ids, text_token_mask, cfg,
                        stage, topk_idx)


def _forward(params, pixel_values, input_ids, token_type_ids, text_attn_3d,
             position_ids, text_token_mask, cfg, stage, topk_idx):
    B = pixel_values.shape[0]
    D = cfg.d_model
    dev = pixel_values.device

    # ---- text tower -----------------------------------------------------
    t_hidden = bert_encode(params["text"], input_ids, token_type_ids,
                           position_ids, text_attn_3d, cfg.text)
    t_feat = _lin(t_hidden, params["text_proj"])
    text_pad_mask = ~text_token_mask

    # ---- vision tower + input projections -------------------------------
    feats = _input_projections(
        params, swin_backbone(params["backbone"], pixel_values, cfg.swin),
        cfg)
    shapes = [(int(f.shape[1]), int(f.shape[2])) for f in feats]
    v_flat = torch.cat([f.reshape(B, -1, D) for f in feats], dim=1)
    pos_flat = torch.cat(
        [(_sine_pos_2d(h, w, D, cfg.pos_temperature, dev).reshape(1, -1, D)
          + params["level_embed"][li][None, None])
         for li, (h, w) in enumerate(shapes)], dim=1)

    # encoder reference points: normalized cell centers, same for all
    # levels (valid_ratios = 1 with no padding)
    refs = []
    f32 = dict(dtype=torch.float32, device=dev)
    for (h, w) in shapes:
        gy, gx = torch.meshgrid((torch.arange(h, **f32) + 0.5) / h,
                                (torch.arange(w, **f32) + 0.5) / w,
                                indexing="ij")
        refs.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    enc_refs = torch.cat(refs, dim=0)[None, :, None, :].expand(
        B, -1, cfg.num_levels, 2)

    text_pos = _sine_pos_1d(position_ids.to(torch.float32)[..., None],
                            cfg.d_model, exchange_xy=False)

    v_feat, tf = v_flat, t_feat
    for layer in params["encoder"]["layers"]:
        v_feat, tf = _encoder_layer(
            v_feat, tf, layer, cfg, v_pos=pos_flat, ref_points=enc_refs,
            shapes=shapes, text_pos=text_pos, text_attn_3d=text_attn_3d,
            text_pad_mask=text_pad_mask)
    enc_text = tf
    if stage == "encoder":
        return {"v_feat": v_feat, "encoder_text": enc_text}

    # ---- two-stage query selection --------------------------------------
    prop_logit, prop_valid = _proposals(shapes, dev)
    obj_query = torch.where(prop_valid[None, :, None], v_feat, 0.0)
    obj_query = _ln(_lin(obj_query, params["enc_output"]),
                    params["enc_output_norm"], cfg.ln_eps)

    enc_class = obj_query @ enc_text.transpose(1, 2)
    enc_class = torch.where(text_token_mask[:, None, :], enc_class,
                            -math.inf)
    enc_coord_logits = (_mlp_head(obj_query, params["enc_bbox_head"])
                        + prop_logit[None])

    enc_scores = enc_class.amax(dim=-1)                   # [B, N]
    if topk_idx is None:
        _, topk_idx = stable_top_k(enc_scores, cfg.num_queries)
    topk_coords = torch.gather(enc_coord_logits, 1,
                               topk_idx[:, :, None].expand(-1, -1, 4))
    reference = torch.sigmoid(topk_coords)                # [B, nq, 4]
    if stage == "select":
        return {"pred_boxes": reference, "encoder_text": enc_text,
                "topk_idx": topk_idx, "enc_scores": enc_scores}
    # query_embed is stored at the checkpoint's 900 queries; a pruned
    # config takes the leading rows
    target = params["query_embed"][None, :cfg.num_queries].expand(B, -1, -1)

    # ---- decoder ---------------------------------------------------------
    dec_text_mask = text_pad_mask.to(torch.float32)[:, None, None, :] * -1e30
    hidden = target
    for layer in params["decoder"]["layers"]:
        # query position embedding from the current reference boxes:
        # sine(cy|cx|w|h interleaved) -> 2-layer MLP
        qpos = _mlp_head(_sine_pos_1d(reference, D // 2, exchange_xy=True),
                         params["decoder"]["ref_head"])
        qk = hidden + qpos
        att = _mha(qk, qk, hidden, layer["self_attn"], cfg.heads)
        hidden = _ln(hidden + att, layer["ln_sa"], cfg.ln_eps)

        att = _mha(hidden + qpos, enc_text, enc_text, layer["text_cross"],
                   cfg.heads, additive_mask=dec_text_mask)
        hidden = _ln(hidden + att, layer["ln_tc"], cfg.ln_eps)

        ref_in = reference[:, :, None, :].expand(B, -1, cfg.num_levels, 4)
        att = _deform_attention(hidden + qpos, v_feat, ref_in, shapes,
                                layer["deform"], cfg.heads, cfg.dec_points)
        hidden = _ln(hidden + att, layer["ln_ca"], cfg.ln_eps)

        y = _lin(torch.relu(_lin(hidden, layer["fc1"])), layer["fc2"])
        hidden = _ln(hidden + y, layer["ln_ffn"], cfg.ln_eps)

        # iterative box refinement (shared bbox head)
        delta = _mlp_head(hidden, params["bbox_head"])
        reference = torch.sigmoid(delta + _inverse_sigmoid(reference))

    hidden = _ln(hidden, params["decoder"]["norm"], cfg.ln_eps)

    # ---- heads (final decoder level) -------------------------------------
    logits = hidden @ enc_text.transpose(1, 2)
    logits = torch.where(text_token_mask[:, None, :], logits, -math.inf)
    S = logits.shape[-1]
    if S < cfg.max_text_len:
        logits = F.pad(logits, (0, cfg.max_text_len - S), value=-math.inf)
    return {"logits": logits, "pred_boxes": reference,
            "encoder_text": enc_text, "topk_idx": topk_idx}


# --------------------------------------------------------------------------
# init (random weights at the real shapes, in the JAX tree's names)
# --------------------------------------------------------------------------

def init_params(cfg: GroundingDinoConfig, gen: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random f32 weights in the JAX package's layout and distributions
    (``init_params``), drawn from ``gen``, which must live on ``device``;
    the draws do not reproduce jax.random."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, **f32)

    def lin(fi, fo, bias=True):
        out = {"w": normal(fi, fo) / math.sqrt(fi)}
        if bias:
            out["b"] = torch.zeros(fo, **f32)
        return out

    def ln(d):
        return {"scale": torch.ones(d, **f32), "bias": torch.zeros(d, **f32)}

    D = cfg.d_model
    sw = cfg.swin
    rpb_index = torch.from_numpy(_swin_rel_pos_index(sw.window_size)).to(dev)

    def swin_params():
        stages = []
        for si, depth in enumerate(sw.depths):
            dim = sw.stage_dim(si)
            hidden = int(dim * sw.mlp_ratio)
            blocks = [{
                "ln1": ln(dim), "ln2": ln(dim),
                "q": lin(dim, dim), "k": lin(dim, dim),
                "v": lin(dim, dim), "attn_out": lin(dim, dim),
                "rpb": normal((2 * sw.window_size - 1) ** 2,
                              sw.num_heads[si]) * 0.02,
                "rpb_index": rpb_index,
                "fc1": lin(dim, hidden), "fc2": lin(hidden, dim),
            } for _ in range(depth)]
            stage = {"blocks": blocks}
            if si < len(sw.depths) - 1:
                stage["downsample"] = {
                    "norm": ln(4 * dim),
                    "reduction": lin(4 * dim, 2 * dim, bias=False)}
            stages.append(stage)
        return {
            "patch_proj": {
                "w": normal(sw.patch_size, sw.patch_size, 3,
                            sw.embed_dim) * 0.02,
                "b": torch.zeros(sw.embed_dim, **f32)},
            "embed_norm": ln(sw.embed_dim),
            "stages": stages,
            "out_norms": [ln(sw.stage_dim(i)) for i in sw.out_stages],
        }

    tc = cfg.text

    def bert_params():
        layers = [{
            "q": lin(tc.dim, tc.dim), "k": lin(tc.dim, tc.dim),
            "v": lin(tc.dim, tc.dim), "out": lin(tc.dim, tc.dim),
            "attn_norm": ln(tc.dim),
            "fc1": lin(tc.dim, tc.ffn), "fc2": lin(tc.ffn, tc.dim),
            "out_norm": ln(tc.dim),
        } for _ in range(tc.layers)]
        return {
            "word_emb": normal(tc.vocab_size, tc.dim) * 0.02,
            "pos_emb": normal(tc.max_pos, tc.dim) * 0.02,
            "type_emb": normal(tc.type_vocab, tc.dim) * 0.02,
            "emb_norm": ln(tc.dim),
            "layers": layers,
        }

    def deform(points):
        return {
            "sampling_offsets": lin(D, cfg.heads * cfg.num_levels
                                    * points * 2),
            "attention_weights": lin(D, cfg.heads * cfg.num_levels
                                     * points),
            "value_proj": lin(D, D), "output_proj": lin(D, D),
        }

    def enc_layer():
        fd = cfg.fusion_dim
        return {
            "fusion": {
                "ln_v": ln(D), "ln_t": ln(D),
                "vision_proj": lin(D, fd), "text_proj": lin(D, fd),
                "values_vision_proj": lin(D, fd),
                "values_text_proj": lin(D, fd),
                "out_vision_proj": lin(fd, D), "out_text_proj": lin(fd, D),
                "vision_param": torch.full((D,), 1e-4, **f32),
                "text_param": torch.full((D,), 1e-4, **f32),
            },
            "text_enh": {
                "q": lin(D, D), "k": lin(D, D), "v": lin(D, D),
                "out": lin(D, D), "ln_before": ln(D), "ln_after": ln(D),
                "fc1": lin(D, cfg.ffn_dim // 2),
                "fc2": lin(cfg.ffn_dim // 2, D),
            },
            "deform": {**deform(cfg.enc_points), "ln1": ln(D),
                       "fc1": lin(D, cfg.ffn_dim),
                       "fc2": lin(cfg.ffn_dim, D), "ln2": ln(D)},
        }

    def dec_layer():
        return {
            "self_attn": {"q": lin(D, D), "k": lin(D, D), "v": lin(D, D),
                          "out": lin(D, D)},
            "ln_sa": ln(D),
            "text_cross": {"q": lin(D, D), "k": lin(D, D),
                           "v": lin(D, D), "out": lin(D, D)},
            "ln_tc": ln(D),
            "deform": deform(cfg.dec_points),
            "ln_ca": ln(D),
            "fc1": lin(D, cfg.ffn_dim), "fc2": lin(cfg.ffn_dim, D),
            "ln_ffn": ln(D),
        }

    in_ch = [sw.stage_dim(i) for i in sw.out_stages]
    input_proj = []
    for level in range(cfg.num_levels):
        if level < len(in_ch):
            c, k = in_ch[level], 1
        else:
            c, k = (in_ch[-1] if level == len(in_ch) else D), 3
        input_proj.append({
            "conv": {"w": normal(k, k, c, D) * 0.02,
                     "b": torch.zeros(D, **f32)},
            "gn": ln(D)})

    return {
        "backbone": swin_params(),
        "text": bert_params(),
        "text_proj": lin(tc.dim, D),
        "input_proj": input_proj,
        "level_embed": normal(cfg.num_levels, D) * 0.02,
        "query_embed": normal(cfg.num_queries, D) * 0.02,
        "encoder": {"layers": [enc_layer()
                               for _ in range(cfg.encoder_layers)]},
        "enc_output": lin(D, D), "enc_output_norm": ln(D),
        "enc_bbox_head": [lin(D, D), lin(D, D), lin(D, 4)],
        "decoder": {
            "layers": [dec_layer() for _ in range(cfg.decoder_layers)],
            "norm": ln(D),
            "ref_head": [lin(2 * D, D), lin(D, D)],
        },
        "bbox_head": [lin(D, D), lin(D, D), lin(D, 4)],
    }


# --------------------------------------------------------------------------
# post-processing: logits over text tokens -> per-phrase detections (host)
# --------------------------------------------------------------------------

def phrase_label_map(input_ids: np.ndarray) -> np.ndarray:
    """[S] token ids -> [num_phrases, S] binary map grouping tokens
    between delimiter tokens into class phrases (HF build_label_maps)."""
    ids = np.asarray(input_ids)
    delim = np.isin(ids, np.asarray(SPECIAL_TOKEN_IDS + (0,)))
    groups = np.cumsum(delim) * (~delim)
    uniq = np.unique(groups)
    uniq = uniq[uniq != 0]
    return (groups[None, :] == uniq[:, None]).astype(np.float32)


def scores_per_phrase(logits: np.ndarray, label_map: np.ndarray
                      ) -> np.ndarray:
    """sigmoid token logits -> mean score over each phrase's tokens
    (the HF processor's phrase scoring).  logits [Q, max_text_len],
    label_map [P, S] -> [Q, P]."""
    lg = logits[:, :label_map.shape[1]]
    probs = np.where(lg >= 0, 1.0 / (1.0 + np.exp(-np.maximum(lg, 0))),
                     np.exp(np.minimum(lg, 0))
                     / (1.0 + np.exp(np.minimum(lg, 0))))
    denom = np.maximum(label_map.sum(-1), 1.0)
    return probs @ label_map.T / denom


# --------------------------------------------------------------------------
# Detector-protocol wrapper (drop-in alternative to YoloWorldDetector)
# --------------------------------------------------------------------------

class GroundingDinoDetector:
    """Open-vocab detector behind the same Detection interface as
    ``models/yolo_world.YoloWorldDetector``, over one params tree on one
    device (the tree's).

    classes -> one BERT prompt "a. b. c." (HF processor convention);
    phrase scores = mean sigmoid over each class's tokens; detections
    thresholded + class-wise NMS on the host.  uint8 frames go to the
    device; the resize (``jax.image.resize``'s bilinear, antialiased), the
    ImageNet normalization, the forward and the phrase scores run there;
    only [B, Q, P] scores and [B, Q, 4] boxes come to the host.
    """

    def __init__(self, params, cfg: GroundingDinoConfig,
                 classes, tokenizer=None, input_ids=None,
                 confidence: float = 0.35, iou_thr: float = 0.5,
                 image_size: int = 800):
        from bsc_nav_tpu_torch.models.wordpiece import classes_to_prompt

        self.params = params
        self.cfg = cfg
        self.classes = list(classes)
        self.confidence = confidence
        self.iou_thr = iou_thr
        self.image_size = image_size
        self.device = params["query_embed"].device

        if input_ids is None:
            if tokenizer is None:
                raise ValueError("need a WordPiece tokenizer (vocab.txt) "
                                 "or explicit input_ids")
            input_ids = np.asarray(
                [tokenizer.encode(classes_to_prompt(classes))], np.int64)
        self.input_ids = np.asarray(input_ids, np.int64)
        lm = phrase_label_map(self.input_ids[0])
        if lm.shape[0] != len(self.classes):
            raise ValueError(
                f"prompt produced {lm.shape[0]} phrases for "
                f"{len(self.classes)} classes -- check tokenization")
        attn3d, pos_ids = generate_text_masks(self.input_ids)
        dev = self.device
        self._ids = torch.from_numpy(self.input_ids).to(dev)
        self._attn3d = torch.from_numpy(attn3d).to(dev)
        self._pos_ids = torch.from_numpy(pos_ids).to(dev)
        self._label_map = torch.from_numpy(lm).to(dev)

    def images(self, rgbs_u8) -> torch.Tensor:
        """uint8 [B, H, W, >=3] -> the normalized f32 [B, s, s, 3] input on
        the device (``vit.preprocess``: the JAX detector's /255, bilinear
        resize and ImageNet normalization)."""
        x = torch.from_numpy(np.ascontiguousarray(
            np.asarray(rgbs_u8)[..., :3])).to(self.device)
        return vit.preprocess(x, (self.image_size, self.image_size))

    def text_inputs(self, B: int) -> tuple:
        """(input_ids, token_type_ids, text_attn_3d, position_ids,
        text_token_mask) of the prompt, broadcast to B frames."""
        ids = self._ids.expand(B, -1)
        return (ids, torch.zeros_like(ids),
                self._attn3d.expand(B, -1, -1),
                self._pos_ids.expand(B, -1),
                torch.ones(ids.shape, dtype=torch.bool, device=self.device))

    @torch.no_grad()
    def scores_boxes(self, images: torch.Tensor, **kw):
        """(phrase scores [B, Q, P], boxes [B, Q, 4] cxcywh) on the
        device for ``images()``'s output; ``kw`` goes to ``forward``."""
        out = forward(self.params, images, *self.text_inputs(
            images.shape[0]), self.cfg, **kw)
        S = self.input_ids.shape[1]
        probs = torch.sigmoid(out["logits"][:, :, :S])
        denom = torch.clamp(self._label_map.sum(-1), min=1.0)
        return probs @ self._label_map.T / denom, out["pred_boxes"]

    def detect(self, rgb: np.ndarray) -> List[Detection]:
        return self.detect_batch(rgb[None])[0]

    def detect_batch(self, rgbs: np.ndarray) -> List[List[Detection]]:
        H0, W0 = rgbs.shape[1:3]
        scores, boxes = self.scores_boxes(self.images(rgbs))
        return self.detections(scores.cpu().numpy(), boxes.cpu().numpy(),
                               H0, W0)

    def detections(self, scores: np.ndarray, boxes: np.ndarray, H0: int,
                   W0: int) -> List[List[Detection]]:
        """The host half: threshold, class-wise NMS, clip, per frame."""
        results = []
        for b in range(scores.shape[0]):
            conf = scores[b].max(axis=-1)
            cls_idx = scores[b].argmax(axis=-1)
            sel = conf >= self.confidence
            cxy, wh = boxes[b][sel, :2], boxes[b][sel, 2:]
            xyxy = np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=-1)
            xyxy = xyxy * np.array([W0, H0, W0, H0], np.float32)
            conf_s, cls_s = conf[sel], cls_idx[sel]
            dets = []
            for ci in np.unique(cls_s):
                m = cls_s == ci
                for k in nms(xyxy[m], conf_s[m], self.iou_thr):
                    bx = np.clip(xyxy[m][k],
                                 0, [W0, H0, W0, H0])   # per-axis
                    dets.append(Detection(
                        self.classes[int(ci)], float(conf_s[m][k]),
                        tuple(bx.tolist())))
            results.append(dets)
        return results
