"""Multi-rank dry run: the framework's build and query step over a dp x mp
mesh of processes, on tiny shapes.

Counterpart of ``bsc_nav_tpu/parallel/dryrun.py``.  Every rank runs the
same body (SPMD): the dp-split frame batch through a tensor-parallel ViT
into an mp-sharded store, the tiny YOLO-World leg into long-term
instances (replicated), a pooled image query through the distributed
top-K, the distributed top-K against ``localize`` on the whole store, the
MMDiT forward tensor-parallel against the whole one (mp > 1), and the
fused text query (CLIP + T5 conditioning, CFG sampling, VAE, ViT, the
sharded localize).  Rank 0 prints JAX's ``dryrun_multichip OK: ...`` line.

    python -m bsc_nav_tpu_torch.parallel.dryrun --ranks N \
        [--backend gloo|nccl] [--device cpu|cuda] [--timeout S]

starts N rank processes (``parallel/launch``), runs ``dryrun_all(N)`` in
each, and exits non-zero if any rank does or the run passes its timeout.
On one card, N > 1 ranks need ``--backend gloo`` (NCCL takes one rank a
card).  The tiny models' head widths are multiples of 16, so that the
kernels take them on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import tempfile
import zlib

import numpy as np
import torch

from bsc_nav_tpu_torch import geometry as G
from bsc_nav_tpu_torch.config import (Config, MemoryConfig, QueryConfig,
                                      SensorConfig)
from bsc_nav_tpu_torch.memory import longterm as LT
from bsc_nav_tpu_torch.memory.pipeline import (make_build_step,
                                               make_text_query_step)
from bsc_nav_tpu_torch.memory.query import gaussian_center_pool, localize
from bsc_nav_tpu_torch.memory.store import init_store
from bsc_nav_tpu_torch.models import vit
from bsc_nav_tpu_torch.models import yolo_world as Y
from bsc_nav_tpu_torch.parallel import mesh as M
from bsc_nav_tpu_torch.parallel.sharded_query import sharded_localize


def dryrun_config() -> Config:
    """Tiny but structurally real: every dp / mp split has whole shapes
    (``dryrun.py:36-50``)."""
    return Config(
        sensor=SensorConfig(width=56, height=56),
        memory=MemoryConfig(grid_size=64, floor_height=-3.2, map_height=3.2,
                            token_dim=64, cache_size=4,
                            voxel_capacity=1015,   # padded rows 1016 = 8*127
                            depth_sample_rate=8),
        query=QueryConfig(top_k=16, query_width=28, query_height=28),
    )


def _balanced_mp(n: int) -> int:
    """The widest 2-D split's mp: the largest divisor <= sqrt(n)."""
    return next(c for c in range(int(n ** 0.5), 0, -1) if n % c == 0)


def _fill_mods(params, gen, std=0.25):
    """Seeded values in an MMDiT's zero-initialised adaLN and final linears,
    so that the attention reaches the output."""
    leaves = [blk[s]["mod"] for blk in params["blocks"] for s in ("x", "ctx")]
    for p in leaves + [params["final_mod"], params["final_out"]]:
        w = p["w"]
        w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                * (std / math.sqrt(w.shape[0])))


class _HashT5Tokenizer:
    """Whitespace words to ids 2..63 by a hash that every rank computes
    alike (Python's ``hash`` of a str differs between processes)."""

    def encode(self, text):
        return [zlib.crc32(w.encode()) % 62 + 2 for w in text.split()]


def _tiny_imagination(dev, seed):
    from bsc_nav_tpu_torch.models import clip as CL
    from bsc_nav_tpu_torch.models import mmdit as MM
    from bsc_nav_tpu_torch.models import t5 as T5
    from bsc_nav_tpu_torch.models import tokenizer as TOK
    from bsc_nav_tpu_torch.models import vae as VV
    from bsc_nav_tpu_torch.models.imagination import DiffusionImagination

    mcfg = dataclasses.replace(MM.MMDIT_TEST, context_dim=64)
    vcfg = VV.VAEConfig(latent_channels=mcfg.in_channels, base_channels=16,
                        channel_mults=(1, 2), blocks_per_stage=1, groups=4,
                        scaling_factor=1.0, shift_factor=0.0)
    lcfg = CL.CLIPConfig(embed_dim=6, text_width=32, text_heads=2,
                         text_layers=1, context_length=16, vocab_size=512,
                         quick_gelu=True)
    gcfg = CL.CLIPConfig(embed_dim=10, text_width=32, text_heads=2,
                         text_layers=1, context_length=16, vocab_size=512)
    tcfg = T5.T5Config(vocab_size=64, dim=mcfg.context_dim, d_kv=16,
                       heads=2, d_ff=64, layers=1, rel_buckets=8,
                       rel_max_distance=16)

    def g(k):
        return torch.Generator(device=dev).manual_seed(seed + k)

    mparams = MM.init_params(mcfg, g(11), device=dev)
    _fill_mods(mparams, g(16))
    return DiffusionImagination(
        mmdit_params=mparams, mmdit_cfg=mcfg,
        vae_params=VV.init_params(vcfg, g(12), device=dev), vae_cfg=vcfg,
        clip_l_params=CL.init_text_params(lcfg, g(13), device=dev),
        clip_l_cfg=lcfg,
        clip_g_params=CL.init_text_params(gcfg, g(14), device=dev),
        clip_g_cfg=gcfg,
        tokenizer=TOK.HashTokenizer(vocab_size=lcfg.vocab_size,
                                    context_length=lcfg.context_length),
        num_images=2, num_steps=2,
        t5_params=T5.init_params(tcfg, g(15), device=dev), t5_cfg=tcfg,
        t5_tokenizer=_HashT5Tokenizer(), t5_seq_len=8, seed=seed)


def _detector_leg(frames, cfg, dev):
    """Tiny YOLO-World (replicated) over the whole batch -> device decode
    -> device NMS -> instance backprojection (``dryrun.py:126-144``)."""
    rgb, depth, poses = frames
    ycfg = Y.YOLO_TEST
    yparams = Y.init_params(ycfg, torch.Generator(device=dev).manual_seed(3),
                            text_dim=ycfg.embed_dim, device=dev)
    rng = np.random.default_rng(3)
    temb = rng.normal(size=(4, ycfg.embed_dim)).astype(np.float32)
    temb = torch.from_numpy(
        temb / np.linalg.norm(temb, axis=-1, keepdims=True)).to(dev)
    x = vit.resize_bhwc(rgb.to(torch.float32) / 255.0,
                        (ycfg.img_size, ycfg.img_size), "bilinear")
    boxes, conf, cls_idx = Y.decode_topk_device(
        Y.forward(yparams, x, temb, ycfg), ycfg, k=8)
    boxes, conf, cls_idx, ok = Y.nms_device(boxes, conf, cls_idx,
                                            iou_thr=0.5, conf_thr=0.0,
                                            k_out=4)
    base = torch.as_tensor(G.base_axes_transform(), dtype=torch.float32,
                           device=dev)
    b2c = torch.as_tensor(G.base_to_cam_transform(cfg.sensor.sensor_height),
                          dtype=torch.float32, device=dev)
    cam_tfs = (base @ G.pose_vec_to_tf(poses) @ torch.linalg.inv(base)
               @ base @ b2c)
    return LT.instances_device(boxes, conf, cls_idx, ok, depth, cam_tfs, cfg,
                               ycfg.img_size)


def _mmdit_leg(mesh, dp, mp, rng, dev) -> None:
    """The MMDiT forward with sharded params and per-rank joint attention
    against the whole forward (``dryrun.py:191-213``), at 2e-4; head_dim
    16 (JAX's 8 is below what the attention kernels take)."""
    from bsc_nav_tpu_torch.models import mmdit as MM
    mcfg = MM.MMDiTConfig(input_size=8, patch_size=2, in_channels=4,
                          dim=32 * mp, depth=2, heads=mp * 2, context_dim=32,
                          pooled_dim=16)
    mparams = MM.init_params(mcfg, torch.Generator(device=dev).manual_seed(2),
                             device=dev)
    _fill_mods(mparams, torch.Generator(device=dev).manual_seed(7))
    B = dp * 2

    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    lat, ctx, pool = arr(B, 8, 8, 4), arr(B, 5, 32), arr(B, 16)
    t = torch.full((B,), 0.5, device=dev)
    ref = MM.forward(mparams, lat, t, ctx, pool, mcfg)
    out = MM.forward(M.shard_mmdit_params(mparams, mesh), lat, t, ctx, pool,
                     mcfg, tp_mesh=mesh)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)


@torch.no_grad()
def dryrun_multichip(n_devices: int, dp=None, mp=None, textq: bool = False,
                     device="cpu", backend=None) -> str:
    """One rank's part of the dry run on a dp x mp mesh of ``n_devices``
    ranks (``dryrun.py:53-270``); raises on any failure and returns the OK
    line.  dp / mp unset: the widest 2-D split (8 -> 4 x 2)."""
    if dp is None or mp is None:
        mp = _balanced_mp(n_devices)
        dp = n_devices // mp
    if dp * mp != n_devices:
        raise ValueError(f"dp={dp} * mp={mp} != {n_devices}")
    mesh = M.make_mesh(dp=dp, mp=mp, device=device, backend=backend)
    dev = mesh.device

    cfg = dryrun_config()
    if mp > 1:
        # padded rows a multiple of lcm(8, mp), so that the store splits
        rows = 8 * mp // math.gcd(8, mp)
        padded = -(-1016 // rows) * rows
        cfg = cfg.replace(memory=dataclasses.replace(
            cfg.memory, voxel_capacity=padded - 1))
    heads = mp if mp > 2 and cfg.memory.token_dim % mp == 0 else 2
    vit_cfg = vit.ViTConfig(img_size=28, patch_size=14,
                            dim=cfg.memory.token_dim, depth=2, heads=heads,
                            num_registers=4, mlp_ratio=4.0)
    use_tp = mp > 1 and heads % mp == 0
    params = M.shard_vit_params(
        vit.init_params(vit_cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev), mesh, tp_qkv_layout=use_tp)
    tp_mesh = mesh if use_tp else None
    state = M.shard_store(init_store(cfg.memory, device=dev), mesh)

    B = 2 * dp
    rng = np.random.default_rng(0)
    H, W = cfg.sensor.height, cfg.sensor.width
    rgb = rng.integers(0, 255, size=(B, H, W, 3), dtype=np.uint8)
    depth = rng.uniform(0.3, 3.0, size=(B, H, W)).astype(np.float32)
    poses = np.zeros((B, 7), np.float32)
    poses[:, 6] = 1.0
    poses[:, :3] = rng.uniform(-0.5, 0.5, size=(B, 3))
    frames = [torch.from_numpy(a).to(dev) for a in (rgb, depth, poses)]
    qimg = torch.from_numpy(
        rng.integers(0, 255, size=(3, H, W, 3), dtype=np.uint8)).to(dev)

    inst = _detector_leg(frames, cfg, dev)
    build = make_build_step(cfg, vit_cfg, mesh=mesh)
    (state, _), stats = build(
        (state, torch.Generator(device=dev).manual_seed(1)), params,
        *(M.frames_shard(mesh, f) for f in frames))
    tokens = params.forward_features(
        vit.preprocess(qimg, out_hw=(28, 28)),
        tp_mesh=tp_mesh)["x_norm_patchtokens"]
    _, scores = sharded_localize(state, gaussian_center_pool(tokens), mesh,
                                 top_k=8)

    n = int(stats["num_voxels"])
    if n <= 0:
        raise AssertionError("dry run ingested no voxels")
    s = scores.cpu().numpy()
    if np.isnan(s).any() or not np.isfinite(s[s > -np.inf]).all():
        raise AssertionError(f"dry run scores {s}")
    locs, iconf, _, iok = (t.cpu().numpy() for t in inst)
    if locs.shape != (B, 4, 3) or iok.shape != (B, 4):
        raise AssertionError(f"instances {locs.shape}, {iok.shape}")
    n_inst = int(iok.sum())
    if not np.isfinite(iconf[iok]).all():
        raise AssertionError("non-finite instance confidence")

    # the explicit-collective top-K against localize on the whole store
    q = torch.ones(cfg.memory.token_dim, device=dev)
    _, s_ref = localize(M.unshard_store(state, mesh), q, top_k=8)
    _, s_sh = sharded_localize(state, q, mesh, top_k=8)
    torch.testing.assert_close(s_sh, s_ref, rtol=1e-4, atol=1e-5)

    mmdit_ok = ""
    if mp > 1:
        _mmdit_leg(mesh, dp, mp, rng, dev)
        mmdit_ok = ", mmdit-tp verified"

    textq_ok = ""
    if textq:
        imag = _tiny_imagination(dev, seed=0)
        tq = make_text_query_step(cfg, vit_cfg, imag, mesh=mesh)
        _, tscores, timgs = tq(state, params, *imag.prep_inputs("a red sofa"),
                               top_k=8)
        if torch.isnan(tscores).any():
            raise AssertionError("NaN text-query scores")
        if timgs.dtype != torch.uint8:
            raise AssertionError(f"text-query images {timgs.dtype}")
        textq_ok = (", fused text query (clip+t5 -> mmdit -> vae -> "
                    "localize) verified")

    return (f"dryrun_multichip OK: mesh dp={dp} mp={mp}, {n} voxels, "
            f"{n_inst} detector instances, top score {float(s[0]):.4f}, "
            f"distributed top-k verified{mmdit_ok}{textq_ok}")


def dryrun_all(n_devices: int, device="cpu", backend=None) -> list:
    """The dry run at the three splits (``dryrun.py:277-305``): dp = n,
    the widest balanced split with the fused text query, and mp = n; a
    repeated split keeps the text query.  Returns the OK lines."""
    mp_mid = _balanced_mp(n_devices)
    merged = {}
    for dp, mp, textq in ((n_devices, 1, False),
                          (n_devices // mp_mid, mp_mid, True),
                          (1, n_devices, False)):
        merged[(dp, mp)] = merged.get((dp, mp), False) or textq
    return [dryrun_multichip(n_devices, dp=dp, mp=mp, textq=textq,
                             device=device, backend=backend)
            for (dp, mp), textq in merged.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if "RANK" in os.environ:                      # one rank of the run
        lines = dryrun_all(args.ranks, device=args.device,
                           backend=args.backend)
        if int(os.environ["RANK"]) == 0:
            print("\n".join(lines), flush=True)
        torch.distributed.destroy_process_group()
        return 0
    from bsc_nav_tpu_torch.parallel.launch import (RankFailure, RankTimeout,
                                                   python_argv, spawn)
    if torch.device(args.device).type == "cuda":
        # build the kernels once, before any rank starts
        from bsc_nav_tpu_torch.ops import _build
        _build.build()
    argv = ["-m", "bsc_nav_tpu_torch.parallel.dryrun", "--ranks",
            str(args.ranks), "--device", args.device]
    if args.backend:
        argv += ["--backend", args.backend]
    with tempfile.TemporaryDirectory(prefix="dryrun-") as work:
        try:
            outs = spawn(python_argv(*argv), args.ranks, work, args.timeout)
        except (RankFailure, RankTimeout) as e:
            print(f"dryrun: {e}", file=sys.stderr)
            return 1
    print(outs[0], end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
