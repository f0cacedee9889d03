"""MMDiT: the multimodal diffusion transformer of the text -> image
"imagination" (SD3.5-medium).

Counterpart of ``bsc_nav_tpu/models/mmdit.py``: joint (dual-stream) blocks
with adaLN-Zero modulation and attention over the [latent | context]
tokens, per-head RMS qk-norm, the MMDiT-X dual-attention blocks (a second
self-attention on the latent stream), the ``context_pre_only`` last block
of converted checkpoints (a 2-chunk ctx modulation), and the
rectified-flow Euler sampler with classifier-free guidance.  Parameters are
a plain dict tree in the JAX layout (linear leaves ``{"w" [fan_in,
fan_out], "b"}`` or, once quantized, ``{"w_q", "w_s", "b"}``), so a
converted ``.npz`` loads key for key (``models.weights``).

The joint attention runs through kernel K4 (``ops.flash_attention
.joint_qkv_attention``) wherever ``use_joint_qkv_attention`` holds, and the
dual-attention branch through ``self_qkv_dispatch``; otherwise -- no
qk-norm (SD3-medium), or a joint sequence past 4096 tokens (SD3.5-medium
at 1024^2) -- the composed path splits heads and calls ``attention`` with
ctx rows first, as the JAX package does, which takes K5 ``mid_attention``
or K6 ``flash_attention`` by shape.  ``fuse_mods`` stacks every adaLN
modulation linear into one, which ``forward(mod_layout=)`` and
``sample(mod_layout=)`` take.  ``forward(tp_mesh=)`` runs a tree sharded by
``parallel/mesh.shard_mmdit_params`` tensor-parallel: the joint attention
per rank on its heads (K4 at heads/mp), the dual attention whole on
``attention`` (K5 at 512^2), as the JAX package's TP branch does.
``convert_sd3`` stays in the JAX package (the port reads its ``.npz``).

Dtypes: activations stay in the compute dtype of the latents passed to
``forward``.  The conditioning vector is cast to it, where the JAX
package's promotion of its f32 timestep embedding lifts a bf16 forward to
f32 activations; ``sample`` keeps the Euler state in f32 and feeds the
forward in the context's dtype.  In f32 the two agree op for op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.ops.flash_attention import (
    attention, joint_qkv_attention, joint_qkv_attention_tp,
    self_qkv_dispatch, use_joint_qkv_attention)
from bsc_nav_tpu_torch.ops.quant import full_columns
from bsc_nav_tpu_torch.ops.quant import linear as _linear
from bsc_nav_tpu_torch.ops.quant import quantize_weight


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    input_size: int = 64           # latent spatial size (512px / 8)
    patch_size: int = 2
    in_channels: int = 16          # SD3 VAE latent channels
    dim: int = 1536
    depth: int = 24
    heads: int = 24
    context_dim: int = 4096        # T5-XXL width (joint text stream)
    pooled_dim: int = 2048         # CLIP-L + CLIP-G pooled concat
    qk_norm: bool = True           # SD3.5 revision
    ln_eps: float = 1e-6
    # MMDiT-X (SD3.5-medium): blocks with an extra self-attention on the
    # latent stream and a 9-chunk modulation
    dual_attention_layers: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def num_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2


# stabilityai/stable-diffusion-3.5-medium transformer config: 24 layers
# x 24 heads x 64 head_dim, dual attention in blocks 0-12 (MMDiT-X)
SD35_MEDIUM = MMDiTConfig(dual_attention_layers=tuple(range(13)))
MMDIT_TEST = MMDiTConfig(input_size=8, patch_size=2, in_channels=4,
                         dim=64, depth=2, heads=4, context_dim=32,
                         pooled_dim=16)
MMDIT_TEST_DUAL = dataclasses.replace(MMDIT_TEST,
                                      dual_attention_layers=(0,))

#: block weights carrying the token-matmul FLOPs (``mmdit.py:359``)
QUANT_KEYS = ("qkv", "proj", "fc1", "fc2", "qkv2", "proj2")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: MMDiTConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """Random weights with the JAX package's distributions
    (``mmdit.py:82-134``): linears N(0, 1/fan_in) with zero biases, the
    adaLN ``mod``, ``final_mod`` and ``final_out`` linears zero, unit
    qk-norm gammas, ``pos_embed`` N(0, 1e-4).  ``generator`` must live on
    ``device``; the draws do not reproduce jax.random."""
    dev = resolve_device(device)
    d = cfg.dim

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    def lin(fi, fo, zero=False):
        w = (torch.zeros((fi, fo), dtype=dtype, device=dev) if zero
             else normal((fi, fo), 1.0 / math.sqrt(fi)))
        return {"w": w, "b": torch.zeros(fo, dtype=dtype, device=dev)}

    def ones():
        return torch.ones(cfg.head_dim, dtype=dtype, device=dev)

    def stream(dual=False):
        s = {"qkv": lin(d, 3 * d), "proj": lin(d, d),
             "mod": lin(d, (9 if dual else 6) * d, zero=True),
             "fc1": lin(d, 4 * d), "fc2": lin(4 * d, d)}
        if cfg.qk_norm:
            s["q_norm"], s["k_norm"] = ones(), ones()
        if dual:
            s["qkv2"], s["proj2"] = lin(d, 3 * d), lin(d, d)
            if cfg.qk_norm:
                s["q_norm2"], s["k_norm2"] = ones(), ones()
        return s

    p = cfg.patch_size
    return {
        "patch_embed": lin(p * p * cfg.in_channels, d),
        "pos_embed": normal((1, cfg.num_patches, d), 0.01),
        "t_embed1": lin(256, d),
        "t_embed2": lin(d, d),
        "pooled_embed1": lin(cfg.pooled_dim, d),
        "pooled_embed2": lin(d, d),
        "ctx_embed": lin(cfg.context_dim, d),
        "final_mod": lin(d, 2 * d, zero=True),
        "final_out": lin(d, p * p * cfg.in_channels, zero=True),
        "blocks": [{"x": stream(dual=i in cfg.dual_attention_layers),
                    "ctx": stream()} for i in range(cfg.depth)],
    }


@torch.no_grad()
def quantize_params(params: Dict[str, Any], keys=QUANT_KEYS
                    ) -> Dict[str, Any]:
    """int8 W8A8 on the per-block token matmuls (``mmdit.py:362-386``);
    modulation, embeddings and the final layer stay as they are.  The
    returned tree shares the unquantized leaves with ``params``."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = [
        {name: {k: (quantize_weight(v) if k in keys else v)
                for k, v in blk[name].items()}
         for name in ("x", "ctx")}
        for blk in params["blocks"]]
    return out


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int = 256,
                       max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None] * 1000.0
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _rms_head_norm(x, gamma):
    """x [B, H, S, hd]: RMS over hd in f32, times gamma, cast back."""
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * gamma.to(torch.float32)).to(
        x.dtype)


def _pre_norm(x, eps):
    """Non-affine LayerNorm with f32 statistics (the adaLN form)."""
    return F.layer_norm(x.to(torch.float32), x.shape[-1:], eps=eps).to(
        x.dtype)


def _qkv(x, leaf):
    """The whole fused qkv projection of ``x`` (gathered over mp where the
    leaf is column-parallel)."""
    return full_columns(_linear(x, leaf), leaf.get("tp"))


def _stream_qkv(x, s, cfg: MMDiTConfig):
    B, S, _ = x.shape
    qkv = _qkv(x, s["qkv"]).reshape(B, S, 3, cfg.heads, cfg.head_dim)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if cfg.qk_norm:
        q = _rms_head_norm(q, s["q_norm"])
        k = _rms_head_norm(k, s["k_norm"])
    return q, k, v


def _tp_heads(blk, cfg: MMDiTConfig, tp_mesh) -> bool:
    """True when the block's joint attention runs per rank: ``tp_mesh``
    with mp > 1, both streams' qkv head-blocked and column-parallel, and
    the heads splitting over mp."""
    if tp_mesh is None or tp_mesh.mp == 1 or cfg.heads % tp_mesh.mp:
        return False
    tps = [blk[s]["qkv"].get("tp") for s in ("x", "ctx")]
    return all(t is not None and t.perm is not None for t in tps)


def _joint_block(x, ctx, c, blk, cfg: MMDiTConfig, mods=None, tp_mesh=None):
    """One dual-stream block (``mmdit.py:182-286``): both streams feed one
    attention, then mix back into their own residuals.  ``mods``: the
    block's precomputed {"x": [chunks], "ctx": [chunks]} adaLN modulation
    (``fuse_mods``); when None it is computed here from the per-block
    "mod" linears.  ``tp_mesh``: see ``forward``; a sharded block called
    otherwise gathers its qkv columns and attends whole."""
    if mods is None:
        mods = {}
        for name in ("x", "ctx"):
            m = _linear(F.silu(c), blk[name]["mod"])
            mods[name] = m.split(cfg.dim, dim=-1)
    # context_pre_only (the last converted SD3 block): the ctx stream only
    # feeds attention k/v through a 2-chunk shift/scale norm -- no gate, no
    # ctx FFN, ctx not updated
    ctx_pre_only = len(mods["ctx"]) == 2

    xpn = _pre_norm(x, cfg.ln_eps)
    xn = _modulate(xpn, mods["x"][0], mods["x"][1])
    cn = _modulate(_pre_norm(ctx, cfg.ln_eps), mods["ctx"][0],
                   mods["ctx"][1])

    Sx, Sc = x.shape[1], ctx.shape[1]
    if _tp_heads(blk, cfg, tp_mesh):
        # this rank's heads from its head-blocked [B, S, 3D/mp] chunks; the
        # row-parallel proj below carries the sum
        att = joint_qkv_attention_tp(
            _linear(xn, blk["x"]["qkv"]), _linear(cn, blk["ctx"]["qkv"]),
            cfg.heads, blk["x"].get("q_norm"), blk["x"].get("k_norm"),
            blk["ctx"].get("q_norm"), blk["ctx"].get("k_norm"),
            mesh=tp_mesh)
        att_x, att_c = att[:, :Sx], att[:, Sx:]
    elif use_joint_qkv_attention(Sx + Sc, cfg.heads, cfg.head_dim,
                                 cfg.qk_norm):
        # K4 reads head column blocks straight from the two [B, S, 3D]
        # projections (x rows first) and applies the qk-norm in kernel
        att = joint_qkv_attention(
            _qkv(xn, blk["x"]["qkv"]), _qkv(cn, blk["ctx"]["qkv"]),
            cfg.heads, blk["x"]["q_norm"], blk["x"]["k_norm"],
            blk["ctx"]["q_norm"], blk["ctx"]["k_norm"], eps=1e-6)
        att_x, att_c = att[:, :Sx], att[:, Sx:]
    else:
        qx, kx, vx = _stream_qkv(xn, blk["x"], cfg)
        qc, kc, vc = _stream_qkv(cn, blk["ctx"], cfg)
        att = attention(torch.cat([qc, qx], dim=2), torch.cat([kc, kx], dim=2),
                        torch.cat([vc, vx], dim=2))   # [B, H, Sc+Sx, hd]
        att = att.transpose(1, 2).reshape(x.shape[0], -1, cfg.dim)
        att_c, att_x = att[:, :Sc], att[:, Sc:]

    x = x + mods["x"][2][:, None] * _linear(att_x, blk["x"]["proj"])

    if "qkv2" in blk["x"]:
        # MMDiT-X dual attention: a second self-attention over the latent
        # stream, modulated by the extra 3 chunks
        xn2 = _modulate(xpn, mods["x"][6], mods["x"][7])
        if tp_mesh is None:
            att2 = self_qkv_dispatch(
                _linear(xn2, blk["x"]["qkv2"]), cfg.heads,
                blk["x"].get("q_norm2"), blk["x"].get("k_norm2"))
        else:
            # under TP qkv2 / proj2 stay whole and the JAX package takes
            # the split-head path on attention() (K5 at S 1024)
            s2 = {"qkv": blk["x"]["qkv2"]}
            if cfg.qk_norm:
                s2["q_norm"] = blk["x"]["q_norm2"]
                s2["k_norm"] = blk["x"]["k_norm2"]
            att2 = attention(*(t.contiguous()
                               for t in _stream_qkv(xn2, s2, cfg)))
            att2 = att2.transpose(1, 2).reshape(x.shape[0], Sx, cfg.dim)
        x = x + mods["x"][8][:, None] * _linear(att2, blk["x"]["proj2"])

    xm = _modulate(_pre_norm(x, cfg.ln_eps), mods["x"][3], mods["x"][4])
    x = x + mods["x"][5][:, None] * _linear(
        F.gelu(_linear(xm, blk["x"]["fc1"]), approximate="tanh"),
        blk["x"]["fc2"])
    if ctx_pre_only:
        return x, ctx
    ctx = ctx + mods["ctx"][2][:, None] * _linear(att_c, blk["ctx"]["proj"])
    cm = _modulate(_pre_norm(ctx, cfg.ln_eps), mods["ctx"][3],
                   mods["ctx"][4])
    ctx = ctx + mods["ctx"][5][:, None] * _linear(
        F.gelu(_linear(cm, blk["ctx"]["fc1"]), approximate="tanh"),
        blk["ctx"]["fc2"])
    return x, ctx


def patchify_latent(lat: torch.Tensor, p: int) -> torch.Tensor:
    B, H, W, C = lat.shape
    x = lat.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify_latent(tokens: torch.Tensor, p: int, h: int, w: int,
                      c: int) -> torch.Tensor:
    B = tokens.shape[0]
    x = tokens.reshape(B, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h, w, c)


@torch.no_grad()
def fuse_mods(params: Dict[str, Any], cfg: MMDiTConfig) -> tuple:
    """Stack every adaLN modulation linear (per-block x/ctx "mod" and
    "final_mod") into ONE [D, total] linear (``mmdit.py:304-356``), so that
    ``forward`` computes all modulations of a step in one matmul.  Each
    output column sees the same D-length reduction as on the per-block
    path, so the two agree up to the GEMM's tiling.

    Returns (params', layout): params' has blocks without "mod", no
    "final_mod", and a top-level "mods" linear (the other leaves are
    shared with ``params``); layout is the tuple of (x_chunks, ctx_chunks)
    per block for ``forward(mod_layout=)``, derived from the parameter
    shapes, so a converted last block's 2-chunk ``context_pre_only`` ctx
    modulation is taken as it is.  Composes with ``quantize_params``
    (disjoint keys).  Allocates one more copy of the modulation weights."""
    d = cfg.dim
    ws, bs, layout, blocks = [], [], [], []
    for blk in params["blocks"]:
        nb, chunks = {}, []
        for name in ("x", "ctx"):
            mod = blk[name]["mod"]
            nb[name] = {k: v for k, v in blk[name].items() if k != "mod"}
            ws.append(mod["w"])
            bs.append(mod["b"])
            chunks.append(mod["w"].shape[-1] // d)
        layout.append(tuple(chunks))
        blocks.append(nb)
    ws.append(params["final_mod"]["w"])
    bs.append(params["final_mod"]["b"])
    out = {k: v for k, v in params.items()
           if k not in ("blocks", "final_mod")}
    out["blocks"] = blocks
    out["mods"] = {"w": torch.cat(ws, dim=-1), "b": torch.cat(bs, dim=-1)}
    return out, tuple(layout)


@torch.no_grad()
def forward(params, latents: torch.Tensor, t: torch.Tensor,
            context: torch.Tensor, pooled: torch.Tensor,
            cfg: MMDiTConfig, mod_layout=None, tp_mesh=None) -> torch.Tensor:
    """Velocity prediction.  latents [B, H, W, C] (their dtype is the
    compute dtype); t [B] in [0, 1]; context [B, S, context_dim]; pooled
    [B, pooled_dim].  mod_layout: the layout ``fuse_mods`` returned, when
    ``params`` carry its fused "mods" linear (one modulation matmul for the
    whole step).  tp_mesh: the mesh of a tree sharded by
    ``parallel/mesh.shard_mmdit_params``: the joint attention runs per
    rank on heads/mp heads with no collective, the row-parallel proj and
    fc2 all-reduce over mp (JAX ``mmdit.py:240-286``)."""
    B, H, W, C = latents.shape
    p = cfg.patch_size
    x = _linear(patchify_latent(latents, p), params["patch_embed"])
    x = x + params["pos_embed"].to(x.dtype)
    ctx = _linear(context.to(x.dtype), params["ctx_embed"])

    temb = _linear(F.silu(_linear(
        timestep_embedding(t), params["t_embed1"])), params["t_embed2"])
    pemb = _linear(F.silu(_linear(
        pooled.to(x.dtype), params["pooled_embed1"])),
        params["pooled_embed2"])
    c = (temb + pemb).to(x.dtype)

    d = cfg.dim
    if mod_layout is not None:
        allm = _linear(F.silu(c), params["mods"])       # [B, total * d]
        off = 0
        for blk, (nx, nc) in zip(params["blocks"], mod_layout):
            mods = {"x": allm[:, off * d:(off + nx) * d].split(d, dim=-1),
                    "ctx": allm[:, (off + nx) * d:(off + nx + nc) * d
                                ].split(d, dim=-1)}
            off += nx + nc
            x, ctx = _joint_block(x, ctx, c, blk, cfg, mods=mods,
                                  tp_mesh=tp_mesh)
        shift = allm[:, off * d:(off + 1) * d]
        scale = allm[:, (off + 1) * d:(off + 2) * d]
    else:
        for blk in params["blocks"]:
            x, ctx = _joint_block(x, ctx, c, blk, cfg, tp_mesh=tp_mesh)
        shift, scale = _linear(F.silu(c), params["final_mod"]).chunk(
            2, dim=-1)
    x = _modulate(_pre_norm(x, cfg.ln_eps), shift, scale)
    out = _linear(x, params["final_out"])
    return unpatchify_latent(out, p, H, W, C)


# --------------------------------------------------------------------------
# rectified-flow Euler sampler (SD3 formulation)
# --------------------------------------------------------------------------

def shifted_sigmas(num_steps: int, shift: float = 3.0,
                   device=None) -> torch.Tensor:
    """SD3 timestep schedule: sigma in (0, 1], resolution-shifted."""
    t = torch.linspace(1.0, 1.0 / num_steps, num_steps, dtype=torch.float32,
                       device=device)
    return shift * t / (1 + (shift - 1) * t)


@torch.no_grad()
def sample(params, context, pooled, cfg: MMDiTConfig,
           num_steps: int = 28, guidance_scale: float = 7.0,
           context_uncond=None, pooled_uncond=None, shift: float = 3.0,
           noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           mod_layout=None) -> torch.Tensor:
    """Euler rectified-flow sampling with classifier-free guidance
    (``mmdit.py:446-484``; the reference's 28 steps, scale 7.0).  The
    initial noise [B, H, W, C] is ``noise`` when given, else drawn from
    ``generator`` (which does not reproduce jax.random).  mod_layout: the
    ``fuse_mods`` layout when ``params`` are mod-fused.  Returns f32
    latents [B, H, W, C]."""
    B = context.shape[0]
    H = W = cfg.input_size
    dev, dt = context.device, context.dtype
    if noise is None:
        noise = torch.randn((B, H, W, cfg.in_channels), generator=generator,
                            device=dev, dtype=torch.float32)
    sigmas = torch.cat([shifted_sigmas(num_steps, shift, dev),
                        torch.zeros(1, device=dev)])
    x = noise.to(device=dev, dtype=torch.float32) * sigmas[0]

    use_cfg = context_uncond is not None
    if use_cfg:
        # one 2B-batch forward per step (standard CFG batching)
        context = torch.cat([context, context_uncond])
        pooled = torch.cat([pooled, pooled_uncond])
    for i in range(num_steps):
        xin = torch.cat([x, x]) if use_cfg else x
        t = sigmas[i].expand(xin.shape[0])
        v = forward(params, xin.to(dt), t, context, pooled, cfg,
                    mod_layout=mod_layout).float()
        if use_cfg:
            v, vu = v[:B], v[B:]
            v = vu + guidance_scale * (v - vu)
        x = x + (sigmas[i + 1] - sigmas[i]) * v
    return x
