"""YOLO-World open-vocabulary detector (YOLOv8-World v2) in PyTorch.

Counterpart of ``bsc_nav_tpu/models/yolo_world.py``: the CSPDarknet
backbone (Conv-BN-SiLU, C2f, SPPF), the PAN neck with text-guided C2fAttn
blocks (max-sigmoid attention against the class text embeddings), the
WorldDetect head (DFL box branch, BN-contrastive class head), the batched
device decode and top-k, the fixpoint class-wise NMS and
``YoloWorldDetector``.  Parameters are the JAX package's tree (nested
dicts and lists of tensors, HWIO conv weights, NHWC activations), as the
port's MMDiT and VAE keep theirs; ``convert_ultralytics`` stays in the JAX
package and the port reads its ``.npz`` (``models/weights.py``).

The convolution route (``conv_bn_act``), chosen per conv:

- f32 activations, 3x3 stride 1: kernel K8 (``ops/conv2d.conv3x3_s1``)
  on weights and bias with the BN folded in once, when the tree is built
  (``fold_params``; the leaf's ``w9`` and ``b9``), never per call.  Act
  "silu" for the Conv blocks, "none" for max-sigmoid attention's
  ``proj``.  The fold rounds differently from JAX's conv-then-BN:
  ``fold_bound`` states by how much.  A CUDA tensor launches K8 or
  raises; nothing falls back to cuDNN.
- int8 leaves (``quantize_params``): ``ops/quant.conv_q8``.
- every other conv (stride 2, 1x1, bf16 activations; K8 in bf16 measured
  slower than cuDNN at the model's shapes, PERF.md section 6):
  ``ops/conv2d.conv2d_same``, cuDNN with TF32 off per call, the BN applied
  in f32 after it as in the JAX package.

On the CPU the route is the same, K8 taking its plain version.  Top-k
takes a stable sort, so tied confidences keep the lower index first as
``lax.top_k`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.models.detector import Detection
from bsc_nav_tpu_torch.ops.conv2d import conv2d_same, conv3x3_s1, fold_bn
from bsc_nav_tpu_torch.ops.quant import conv_q8, quantize_conv_weight


@dataclasses.dataclass(frozen=True)
class YoloWorldConfig:
    width: float = 1.25            # v8x
    depth: float = 1.0
    max_channels: int = 512
    reg_max: int = 16
    embed_dim: int = 512           # text/vision joint embed
    img_size: int = 640
    strides: Tuple[int, ...] = (8, 16, 32)

    def ch(self, c: int) -> int:
        return int(min(c, self.max_channels) * self.width)

    def n(self, n: int) -> int:
        return max(1, round(n * self.depth))


YOLOV8X_WORLDV2 = YoloWorldConfig()
YOLO_TEST = YoloWorldConfig(width=0.125, depth=1 / 3, max_channels=512,
                            embed_dim=32, img_size=64)

#: top-level keys of the backbone (stem..sppf), the part ``quantize_params``
#: leaves in float by default
BACKBONE_KEYS = ("stem0", "stem1", "c2f_2", "down3", "c2f_4", "down5",
                 "c2f_6", "down7", "c2f_8", "sppf")
#: top-level keys of the 3x3 convs that run at stride 2 (everything else
#: 3x3 runs at stride 1, and is folded for K8)
STRIDE2_KEYS = ("stem0", "stem1", "down3", "down5", "down7", "d16", "d19")
BN_EPS = 1e-3           # ultralytics' Conv blocks
HEAD_BN_EPS = 1e-5      # the BN-contrastive head (torch's default eps)


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------

class _Init:
    """Draws of the init, all from one generator on one device."""

    def __init__(self, gen: torch.Generator, dtype, device):
        self.gen, self.dtype, self.device = gen, dtype, device

    def normal(self, *shape):
        return torch.randn(*shape, generator=self.gen, device=self.device,
                           dtype=torch.float32).to(self.dtype)

    def full(self, shape, value):
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def conv(self, cin, cout, k):
        return {"w": self.normal(k, k, cin, cout) / math.sqrt(k * k * cin),
                "bn_scale": self.full((cout,), 1.0),
                "bn_bias": self.full((cout,), 0.0),
                "bn_mean": self.full((cout,), 0.0),
                "bn_var": self.full((cout,), 1.0)}

    def plain_conv(self, cin, cout, k):
        return {"w": self.normal(k, k, cin, cout) / math.sqrt(k * k * cin),
                "b": self.full((cout,), 0.0)}

    def c2f(self, cin, cout, n, attn=None):
        h = cout // 2
        p = {"cv1": self.conv(cin, cout, 1),
             "cv2": self.conv((2 + n + (attn is not None)) * h, cout, 1),
             "m": [{"cv1": self.conv(h, h, 3), "cv2": self.conv(h, h, 3)}
                   for _ in range(n)]}
        if attn is not None:
            ec, nh, gc = attn
            a = {"gl_w": self.normal(gc, ec) / math.sqrt(gc),
                 "gl_b": self.full((ec,), 0.0),
                 "bias": self.full((nh,), 0.0),
                 "proj": self.conv(h, h, 3),
                 "scale": self.full((nh,), 1.0)}
            if h != ec:
                a["ec_conv"] = self.conv(h, ec, 1)
            p["attn"] = a
        return p


def init_params(cfg: YoloWorldConfig, gen: torch.Generator,
                dtype=torch.float32, text_dim: int = 512,
                device="cuda") -> Dict[str, Any]:
    """Random weights in the JAX package's layout (``init_params``,
    identity BN statistics, ``logit_bias`` -10), drawn from ``gen``, and
    folded for K8 (``fold_params``)."""
    r = _Init(gen, dtype, resolve_device(device))
    c, n = cfg.ch, cfg.n
    p: Dict[str, Any] = {
        "stem0": r.conv(3, c(64), 3), "stem1": r.conv(c(64), c(128), 3),
        "c2f_2": r.c2f(c(128), c(128), n(3)),
        "down3": r.conv(c(128), c(256), 3),
        "c2f_4": r.c2f(c(256), c(256), n(6)),
        "down5": r.conv(c(256), c(512), 3),
        "c2f_6": r.c2f(c(512), c(512), n(6)),
        "down7": r.conv(c(512), c(1024), 3),
        "c2f_8": r.c2f(c(1024), c(1024), n(3))}
    sp = c(1024)
    p["sppf"] = {"cv1": r.conv(sp, sp // 2, 1), "cv2": r.conv(sp * 2, sp, 1)}
    gc = text_dim
    p["n12"] = r.c2f(c(1024) + c(512), c(512), n(3), (c(256), 8, gc))
    p["n15"] = r.c2f(c(512) + c(256), c(256), n(3), (c(128), 4, gc))
    p["d16"] = r.conv(c(256), c(256), 3)
    p["n18"] = r.c2f(c(256) + c(512), c(512), n(3), (c(256), 8, gc))
    p["d19"] = r.conv(c(512), c(512), 3)
    p["n21"] = r.c2f(c(512) + c(1024), c(1024), n(3), (c(512), 16, gc))
    chs = [c(256), c(512), c(1024)]
    c2 = max(16, chs[0] // 4, cfg.reg_max * 4)
    c3 = max(chs[0], min(100, text_dim))
    e = cfg.embed_dim
    p["head"] = [{
        "box0": r.conv(ch, c2, 3), "box1": r.conv(c2, c2, 3),
        "box2": r.plain_conv(c2, 4 * cfg.reg_max, 1),
        "cls0": r.conv(ch, c3, 3), "cls1": r.conv(c3, c3, 3),
        "cls2": r.plain_conv(c3, e, 1),
        "bn_scale": r.full((e,), 1.0), "bn_bias": r.full((e,), 0.0),
        "bn_mean": r.full((e,), 0.0), "bn_var": r.full((e,), 1.0),
        "logit_scale": r.full((), 0.0), "logit_bias": r.full((), -10.0),
    } for ch in chs]
    if text_dim != cfg.embed_dim:
        p["txt_proj"] = {"w": r.normal(text_dim, e) / math.sqrt(text_dim)}
    return fold_params(p)


def _is_conv_bn(node) -> bool:
    return (isinstance(node, dict) and "bn_var" in node
            and isinstance(node.get("w"), torch.Tensor)
            and node["w"].dim() == 4)


def fold_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The tree with K8's operands beside every float 3x3 stride-1 conv +
    BN leaf: ``w9`` [9, C, CO] and ``b9`` [CO], both f32, the BN folded
    (eps 1e-3) into the f32 weights as the JAX conv casts them for f32
    activations.  Other leaves are shared, not copied."""
    def walk(node):
        if _is_conv_bn(node):
            if node["w"].shape[0] != 3 or "w9" in node:
                return node
            w9, b9 = fold_bn(*(node[k].to(torch.float32) for k in (
                "w", "bn_scale", "bn_bias", "bn_mean", "bn_var")),
                eps=BN_EPS)
            return {**node, "w9": w9.contiguous(), "b9": b9.contiguous()}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return {k: (v if k in STRIDE2_KEYS else walk(v))
            for k, v in params.items()}


def quantize_params(params: Dict[str, Any], scope: str = "neck"
                    ) -> Dict[str, Any]:
    """int8 W8A8 conv + BN leaves (``ops/quant.conv_q8``), as the JAX
    package's ``quantize_params``: scope "neck" (its default) quantizes the
    PAN neck and the head's conv stacks, "all" the backbone too.  The
    head's last 1x1 box / cls convs, the BN-contrastive statistics and
    ``txt_proj`` stay float.  A quantized leaf drops its K8 operands."""
    def walk(node):
        if _is_conv_bn(node):
            return quantize_conv_weight(
                {k: v for k, v in node.items() if k not in ("w9", "b9")})
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    skip = set(BACKBONE_KEYS) if scope == "neck" else set()
    return {k: (v if k in skip else walk(v)) for k, v in params.items()}


# --------------------------------------------------------------------------
# forward ops
# --------------------------------------------------------------------------

def _bn_act(y, p, dtype, act: str):
    """JAX's affine after the conv, in f32: (y - mean) * rsqrt(var + eps)
    * scale + bias, cast to the activations' dtype, then the activation."""
    f = lambda k: p[k].to(torch.float32)
    inv = torch.rsqrt(f("bn_var") + BN_EPS)
    y = ((y.to(torch.float32) - f("bn_mean")) * inv * f("bn_scale")
         + f("bn_bias")).to(dtype)
    return F.silu(y) if act == "silu" else y


def conv_bn_act(x, p, stride: int = 1, act: str = "silu"):
    """One Conv-BN-activation block (JAX ``_conv_bn_silu``) by the route
    the module docstring gives: K8 on the folded leaf for f32 3x3 stride
    1, ``conv_q8`` for an int8 leaf, cuDNN otherwise."""
    if "w_q" in p:
        return _bn_act(conv_q8(x, p, stride), p, x.dtype, act)
    if stride == 1 and p["w"].shape[0] == 3 and x.dtype == torch.float32:
        if "w9" not in p:
            raise ValueError("conv_bn_act: a 3x3 stride-1 leaf without its "
                             "folded K8 operands (build the tree with "
                             "init_params, fold_params or the loaders)")
        return conv3x3_s1(x.contiguous(), p["w9"], p["b9"], act)
    return _bn_act(conv2d_same(x, p["w"].to(x.dtype), stride), p, x.dtype,
                   act)


def fold_bound(x, p, act: str = "silu") -> torch.Tensor:
    """Elementwise bound on |K8 route - JAX's conv then BN| for one f32 3x3
    stride-1 leaf at input x, both summed in f32 in any order: with
    s = scale / sqrt(var + eps), A = conv(|x|, |w| |s|) and
    y = conv(x, w) s,

        1.1 * ((2 gamma_{9C+1} + 2u) A + 4u (|y| + |mean s| + |bias|))

    where u = 2^-24: each side's sum within gamma_n of its terms' sum of
    magnitudes, the fold's rounding of w s (u of each term), the few
    roundings of the affine on each side (JAX: minus the mean, times
    rsqrt, times scale, plus bias; the fold: b - mean s and the bias add),
    and SiLU's slope, at most 1.0998.  A card run adds K8's own f32 bound
    (three-pass TF32, 1e-4 of max |out| in chip_smoke)."""
    u = 2.0 ** -24
    n = 9 * x.shape[-1] + 1
    gamma = n * u / (1 - n * u)
    f = lambda k: p[k].to(torch.float32)
    s = f("bn_scale") / torch.sqrt(f("bn_var") + BN_EPS)
    w = f("w")
    A = conv2d_same(x.abs(), w.abs() * s.abs(), 1)
    y = conv2d_same(x, w, 1) * s
    slope = 1.1 if act == "silu" else 1.0
    return slope * ((2 * gamma + 2 * u) * A + 4 * u * (
        y.abs() + (f("bn_mean") * s).abs() + f("bn_bias").abs()))


def _conv_plain(x, p):
    y = conv2d_same(x, p["w"].to(x.dtype), 1)
    return (y.to(torch.float32) + p["b"].to(torch.float32)).to(x.dtype)


def _run_c2f(x, p, guide=None, shortcut=True):
    # backbone C2f keeps residual shortcuts; the neck's C2fAttn does not
    ys = list(conv_bn_act(x, p["cv1"]).chunk(2, dim=-1))
    for m in p["m"]:
        h = conv_bn_act(conv_bn_act(ys[-1], m["cv1"]), m["cv2"])
        ys.append(ys[-1] + h if shortcut else h)
    if guide is not None:
        ys.append(max_sigmoid_attention(ys[-1], guide, p["attn"]))
    return conv_bn_act(torch.cat(ys, dim=-1), p["cv2"])


def _run_sppf(x, p):
    y = conv_bn_act(x, p["cv1"])
    pools = [y]
    for _ in range(3):          # 5x5 max, stride 1, "SAME" with -inf pads
        pools.append(F.max_pool2d(pools[-1].permute(0, 3, 1, 2), 5, 1, 2
                                  ).permute(0, 2, 3, 1))
    return conv_bn_act(torch.cat(pools, dim=-1), p["cv2"])


def max_sigmoid_attention(x, guide, p):
    """Text-guided spatial gating (ultralytics MaxSigmoidAttnBlock): per
    head, each pixel embedding against every class text embedding, the
    max over classes, a sigmoid gate on the projection.  guide [B, T, gc]
    f32; the products run in f32, as JAX's promote f32 text with bf16
    weights and accumulate bf16 pixels in f32."""
    B, H, W, C = x.shape
    nh = p["bias"].shape[0]
    ec = p["gl_w"].shape[1]
    hc = ec // nh
    emb = (conv_bn_act(x, p["ec_conv"], act="none") if "ec_conv" in p
           else x)
    g = guide @ p["gl_w"].float() + p["gl_b"]
    aw = torch.einsum("bhwnc,btnc->bhwnt",
                      emb.reshape(B, H, W, nh, hc).float(),
                      g.reshape(B, -1, nh, hc))
    aw = aw.amax(dim=-1) / math.sqrt(hc)
    aw = torch.sigmoid(aw + p["bias"]) * p["scale"]        # [B, H, W, nh]
    y = conv_bn_act(x, p["proj"], act="none")
    y = y.reshape(B, H, W, nh, -1) * aw[..., None]
    return y.reshape(B, H, W, -1).to(x.dtype)


def _upsample2(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def forward(params, images: torch.Tensor, text_emb: torch.Tensor,
            cfg: YoloWorldConfig) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """images [B, H, W, 3] float in [0, 1]; text_emb [T, text_dim] f32,
    normalized.  Returns per level (box_logits [B, h, w, 4 * reg_max],
    cls_logits [B, h, w, T] f32)."""
    B = images.shape[0]
    guide = text_emb[None].expand(B, *text_emb.shape)
    proj = text_emb
    if "txt_proj" in params:
        proj = text_emb @ params["txt_proj"]["w"].float()

    x = conv_bn_act(images, params["stem0"], stride=2)
    x = conv_bn_act(x, params["stem1"], stride=2)
    x = _run_c2f(x, params["c2f_2"])
    x = conv_bn_act(x, params["down3"], stride=2)
    p3 = _run_c2f(x, params["c2f_4"])
    x = conv_bn_act(p3, params["down5"], stride=2)
    p4 = _run_c2f(x, params["c2f_6"])
    x = conv_bn_act(p4, params["down7"], stride=2)
    x = _run_c2f(x, params["c2f_8"])
    p5 = _run_sppf(x, params["sppf"])

    # top-down
    n12 = _run_c2f(torch.cat([_upsample2(p5), p4], dim=-1), params["n12"],
                   guide, shortcut=False)
    n15 = _run_c2f(torch.cat([_upsample2(n12), p3], dim=-1), params["n15"],
                   guide, shortcut=False)
    # bottom-up
    d = conv_bn_act(n15, params["d16"], stride=2)
    n18 = _run_c2f(torch.cat([d, n12], dim=-1), params["n18"], guide,
                   shortcut=False)
    d = conv_bn_act(n18, params["d19"], stride=2)
    n21 = _run_c2f(torch.cat([d, p5], dim=-1), params["n21"], guide,
                   shortcut=False)

    gn = proj / torch.clamp(torch.linalg.vector_norm(proj, dim=-1,
                                                     keepdim=True), min=1e-12)
    outs = []
    for feat, hp in zip([n15, n18, n21], params["head"]):
        box = _conv_plain(conv_bn_act(conv_bn_act(feat, hp["box0"]),
                                      hp["box1"]), hp["box2"])
        emb = _conv_plain(conv_bn_act(conv_bn_act(feat, hp["cls0"]),
                                      hp["cls1"]), hp["cls2"])
        # BNContrastiveHead: BN the embedding (eps 1e-5), dot with the
        # L2-normalized text, times exp(logit_scale), plus logit_bias
        inv = torch.rsqrt(hp["bn_var"].to(torch.float32) + HEAD_BN_EPS)
        embn = ((emb - hp["bn_mean"]) * inv * hp["bn_scale"]
                + hp["bn_bias"])
        cls = torch.einsum("bhwc,tc->bhwt", embn.float(), gn)
        cls = cls * torch.exp(hp["logit_scale"]) + hp["logit_bias"]
        outs.append((box, cls))
    return outs


# --------------------------------------------------------------------------
# decode: DFL + anchor-free boxes + NMS
# --------------------------------------------------------------------------

def dfl_decode(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """[..., 4 * reg_max] distribution logits -> [..., 4] ltrb distances
    (the expectation over the softmax bins)."""
    x = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max)
    p = torch.softmax(x.to(torch.float32), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (p * bins).sum(dim=-1)


def _level_boxes(box, stride, reg_max):
    B, H, W, _ = box.shape
    ltrb = dfl_decode(box, reg_max)                       # [B, H, W, 4]
    cy = (torch.arange(H, dtype=torch.float32, device=box.device)
          + 0.5)[None, :, None]
    cx = (torch.arange(W, dtype=torch.float32, device=box.device)
          + 0.5)[None, None, :]
    xyxy = torch.stack([(cx - ltrb[..., 0]) * stride,
                        (cy - ltrb[..., 1]) * stride,
                        (cx + ltrb[..., 2]) * stride,
                        (cy + ltrb[..., 3]) * stride], dim=-1)
    return xyxy.reshape(B, H * W, 4)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties in
    index order (``lax.top_k``'s order): a stable descending sort."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def decode_boxes(level_outs, cfg: YoloWorldConfig
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-level logits of frame 0 -> (boxes xyxy [N, 4] px, scores
    [N, T]) on the host."""
    boxes = [_level_boxes(box, s, cfg.reg_max)
             for (box, _), s in zip(level_outs, cfg.strides)]
    scores = [torch.sigmoid(cls.to(torch.float32)).reshape(
        cls.shape[0], -1, cls.shape[-1]) for _, cls in level_outs]
    return (torch.cat(boxes, 1)[0].cpu().numpy(),
            torch.cat(scores, 1)[0].cpu().numpy())


def decode_topk_device(level_outs, cfg: YoloWorldConfig, k: int = 256):
    """Batched decode on the device: DFL + anchor-free boxes + sigmoid
    scores, each anchor's best class, each frame's top k by confidence.
    Returns (boxes [B, k, 4] px xyxy, conf [B, k], cls_idx [B, k] int32),
    confidence descending."""
    boxes, conf, cls_idx = [], [], []
    for (box, cls), stride in zip(level_outs, cfg.strides):
        boxes.append(_level_boxes(box, stride, cfg.reg_max))
        sc = torch.sigmoid(cls.to(torch.float32)).reshape(
            cls.shape[0], -1, cls.shape[-1])
        c, i = sc.max(dim=-1)
        conf.append(c)
        cls_idx.append(i.to(torch.int32))
    boxes, conf, cls_idx = (torch.cat(t, 1) for t in (boxes, conf, cls_idx))
    top_conf, top_i = _top_k(conf, min(k, conf.shape[1]))
    return (torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4)),
            top_conf, torch.gather(cls_idx, 1, top_i))


def nms_device(boxes, conf, cls_idx, iou_thr: float = 0.5,
               conf_thr: float = 0.0, k_out: int = 32):
    """Batched class-wise greedy NMS on the device over
    ``decode_topk_device``'s output (confidence descending).

    alive_{t+1}[j] = init[j] and no alive_t i < j of j's class with
    IoU(i, j) > iou_thr; after t steps every prefix of length t is exact,
    so K steps (K = boxes.shape[1]) give greedy NMS.  Each step is one
    [B, 1, K] x [B, K, K] product and two elementwise ops on the device;
    all K steps run, since stopping early would need the host to read the
    state.  Returns (boxes [B, k_out, 4], conf [B, k_out], cls_idx
    [B, k_out], valid [B, k_out] bool), confidence descending."""
    B, K = conf.shape
    x1 = torch.maximum(boxes[:, :, None, 0], boxes[:, None, :, 0])
    y1 = torch.maximum(boxes[:, :, None, 1], boxes[:, None, :, 1])
    x2 = torch.minimum(boxes[:, :, None, 2], boxes[:, None, :, 2])
    y2 = torch.minimum(boxes[:, :, None, 3], boxes[:, None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    iou = inter / torch.clamp(area[:, :, None] + area[:, None, :] - inter,
                              min=1e-9)
    same = cls_idx[:, :, None] == cls_idx[:, None, :]
    later = torch.ones(K, K, dtype=torch.bool, device=conf.device).triu(1)
    sup = ((iou > iou_thr) & same & later).to(torch.float32)
    init = (conf >= conf_thr).to(torch.float32)[:, None, :]
    alive, hits = init.clone(), torch.empty_like(init)
    free = torch.empty_like(init, dtype=torch.bool)
    for _ in range(K):
        torch.bmm(alive, sup, out=hits)
        torch.lt(hits, 0.5, out=free)
        torch.mul(init, free, out=alive)
    score = torch.where(alive[:, 0] > 0.5, conf, -1.0)
    top, idx = _top_k(score, min(k_out, K))
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
            torch.gather(conf, 1, idx), torch.gather(cls_idx, 1, idx),
            top >= 0.0)


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 4] x [M, 4] -> [N, M] (host)."""
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float = 0.5
        ) -> List[int]:
    """Greedy class-agnostic NMS on the host; kept indices by score."""
    order = np.argsort(-scores)
    keep: List[int] = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        ious = iou_xyxy(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= iou_thr]
    return keep


class YoloWorldDetector:
    """Detector protocol (``detect``, ``detect_batch``) and the device
    long-term feed (``detect_batch_instances``) over one params tree on
    one device (the tree's)."""

    def __init__(self, params, cfg: YoloWorldConfig,
                 classes: Sequence[str], text_embeddings: np.ndarray,
                 confidence: float = 0.55, iou_thr: float = 0.5,
                 decode_k: int = 256, keep_k: int = 64):
        self.params = params
        self.cfg = cfg
        self.classes = list(classes)
        self.device = params["stem0"]["w"].device
        t = np.asarray(text_embeddings)
        self.text_emb = torch.as_tensor(t / np.maximum(
            np.linalg.norm(t, axis=-1, keepdims=True), 1e-12),
            dtype=torch.float32, device=self.device)
        self.confidence = confidence
        self.iou_thr = iou_thr
        # decode_k candidates per frame into the NMS (the host path's pool);
        # keep_k survivors per frame: at conf 0.55 real scenes yield ~3-10
        # detections a frame, so 64 is a wide bound, but a bound the host
        # chain does not have
        self.decode_k = decode_k
        self.keep_k = keep_k

    def _images(self, rgbs_u8) -> torch.Tensor:
        """uint8 [B, H, W, >=3] -> f32 [B, s, s, 3] in [0, 1] on the
        device, resized (antialiased bilinear, as jax.image.resize)."""
        from bsc_nav_tpu_torch.models.vit import resize_bhwc
        s = self.cfg.img_size
        x = torch.from_numpy(np.ascontiguousarray(
            np.asarray(rgbs_u8)[..., :3])).to(self.device)
        x = x.to(torch.float32) / 255.0
        if x.shape[1:3] != (s, s):
            x = resize_bhwc(x, (s, s), "bilinear")
        return x

    def detect(self, rgb: np.ndarray) -> List[Detection]:
        return self.detect_batch(rgb[None])[0]

    def detect_batch(self, rgbs: np.ndarray) -> List[List[Detection]]:
        """Batched forward + device decode and top-256 (one small copy to
        the host), then the host NMS per frame."""
        H0, W0 = rgbs.shape[1:3]
        boxes, conf, cls_idx = (a.cpu().numpy() for a in decode_topk_device(
            forward(self.params, self._images(rgbs), self.text_emb,
                    self.cfg), self.cfg, k=256))
        results = []
        for b in range(len(conf)):
            sel = conf[b] >= self.confidence
            results.append(self._nms_detections(
                boxes[b][sel], cls_idx[b][sel], conf[b][sel], H0, W0))
        return results

    def _nms_detections(self, boxes, cls_idx, conf, H0, W0):
        s = self.cfg.img_size
        out: List[Detection] = []
        for ci in np.unique(cls_idx):
            m = cls_idx == ci
            for k in nms(boxes[m], conf[m], self.iou_thr):
                bx = boxes[m][k] * np.array([W0 / s, H0 / s, W0 / s, H0 / s])
                bx = np.clip(bx, 0, [W0, H0, W0, H0])       # per axis
                out.append(Detection(self.classes[int(ci)],
                                     float(conf[m][k]), tuple(bx.tolist())))
        return out

    def instances_device(self, rgbs, depths, cam_tfs, mem_cfg):
        """The long-term feed's device half: forward -> decode -> class-wise
        NMS -> depth backprojection to grid instances, with no host sync.
        Returns ``longterm.instances_device``'s tensors."""
        from bsc_nav_tpu_torch.memory import longterm as LT
        boxes, conf, cls_idx = decode_topk_device(
            forward(self.params, self._images(rgbs), self.text_emb,
                    self.cfg), self.cfg, k=self.decode_k)
        boxes, conf, cls_idx, ok = nms_device(
            boxes, conf, cls_idx, iou_thr=self.iou_thr,
            conf_thr=self.confidence, k_out=self.keep_k)
        dev = self.device
        return LT.instances_device(
            boxes, conf, cls_idx, ok,
            torch.as_tensor(np.asarray(depths), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.asarray(cam_tfs), dtype=torch.float32,
                            device=dev), mem_cfg, self.cfg.img_size)

    def detect_batch_instances(self, rgbs, depths, cam_tfs, mem_cfg):
        """The whole long-term feed of a batch: ``instances_device`` and
        one small [B, keep_k, *] copy to the host.  rgbs [B, H0, W0, 3]
        uint8; depths [B, H0, W0] f32; cam_tfs [B, 4, 4] camera ->
        allocentric.  Returns the flat instance-dict list of the batch
        (before integration)."""
        from bsc_nav_tpu_torch.memory import longterm as LT
        return LT.instances_from_device(
            self.instances_device(rgbs, depths, cam_tfs, mem_cfg),
            self.classes)
