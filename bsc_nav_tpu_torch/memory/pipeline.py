"""The two device pipelines of the memory spine.

Counterpart of ``bsc_nav_tpu/memory/pipeline.py``:

  build_step: RGB-D frames + poses -> DINOv2 patch tokens -> voxel ingest
  query_step: query images -> pooled token -> store scan -> top-K voxels
  text_query_step: text -> imagined images -> the query step
  text_pool_step: text -> imagined images -> pooled token (the split
      text query's first half; ``query.localize`` is the second)
  query_batch_step: Q groups of N images -> one ViT forward -> Q pooled
      tokens -> one Q-query store scan -> top-K per query

PyTorch runs eagerly, so each "step" is a plain function; kernels are
queued on the current CUDA stream and nothing synchronises until a caller
reads a result, so the imagined images never leave the device between
the diffusion sampler and the encoder.  The carry is ``(state,
generator)``; the state is updated in place.  The build step's encode is
the exception: on one card it replays a CUDA graph of its fixed-shape
launches (``encode_patch_grid``), so that the host enqueues one launch
where it enqueued ViT-L's hundreds.

Over a dp x mp mesh (``parallel/mesh``) the build step takes this rank's
B/dp frames, encodes them (tensor-parallel over mp with a sharded ViT),
all-gathers the patch tokens and frames over dp, checks that every rank
holds the same token bits, and ingests the whole batch into the store --
whole, or this rank's mp shard of it.  The text query then localizes on
the shard with the distributed top-K (``parallel/sharded_query``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.distributed as dist

from bsc_nav_tpu_torch.config import Config
from bsc_nav_tpu_torch.memory.ingest import ingest_frames
from bsc_nav_tpu_torch.memory.query import (
    gaussian_center_pool, localize, localize_batch)
from bsc_nav_tpu_torch.memory.store import VoxelStoreState
from bsc_nav_tpu_torch.models import vit
from bsc_nav_tpu_torch.ops import _build
from bsc_nav_tpu_torch.ops import flash_attention as fa
from bsc_nav_tpu_torch.utils.profiling import SPANS, TELEMETRY


def _encode(params: vit.ViT, images_uint8: torch.Tensor,
            vit_cfg: vit.ViTConfig, cfg: Config, compute_dtype,
            tp_mesh=None) -> torch.Tensor:
    q = (cfg.query.query_height, cfg.query.query_width)
    x = vit.preprocess(images_uint8, out_hw=q).to(compute_dtype)
    feats = params.forward_features(
        x, tp_mesh=tp_mesh)["x_norm_patchtokens"]
    B = images_uint8.shape[0]
    return feats.reshape(B, q[0] // vit_cfg.patch_size,
                         q[1] // vit_cfg.patch_size, -1)


# the kernel wrappers a ViT forward reaches (``attention_from_qkv``'s
# routes), each counting its launches in ``.launches``
_COUNTED = (fa.short_attention_qkv, fa.short_attention, fa.mid_attention,
            fa.flash_attention)


def _tile_counts():
    """The kernel library's launches by tile (``bsc_tile_launches``), as
    a ctypes array that writes through."""
    lib = _build.kernels()
    n = ctypes.c_int.in_dll(lib, "bsc_tile_kinds").value
    return (ctypes.c_longlong * n).in_dll(lib, "bsc_tile_launches")


def _launch_counts() -> list:
    return [f.launches for f in _COUNTED] + list(_tile_counts())


def _add_launch_counts(delta) -> None:
    for f, n in zip(_COUNTED, delta):
        f.launches += n
    tiles = _tile_counts()
    for i, n in enumerate(delta[len(_COUNTED):]):
        tiles[i] += n


def _param_slots(params: torch.nn.Module) -> list:
    return [(m._parameters, name) for m in params.modules()
            for name, p in m._parameters.items() if p is not None]


def _storage(slots) -> list:
    return [d[name].data_ptr() for d, name in slots]


# device -> the stream on which a key's warm-up and capture run: cuBLAS
# makes its workspace for a stream on first use, which then lies outside
# the graph's memory pool
_CAPTURE_STREAMS: dict = {}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    s = _CAPTURE_STREAMS.get(dev)
    if s is None:
        s = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return s


def _warm_up(run, images: torch.Tensor) -> torch.Tensor:
    """run(images) on the capture stream, after the current stream's work
    so far and before its later work."""
    cur = torch.cuda.current_stream(images.device)
    side = _capture_stream(images.device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = run(images)
    cur.wait_stream(side)
    out.record_stream(cur)
    return out


class _EncodeGraph:
    """One batch shape's encode captured as a CUDA graph: the frames are
    copied into ``static_in``, the graph replays every launch of the
    eager encode on the current stream, and the caller gets a copy of
    ``static_out``.  The graph reads the parameters' storage as it was at
    capture (``stale`` tells when one was replaced); weights loaded into
    it in place show in the next replay."""

    def __init__(self, run, params: vit.ViT, images: torch.Tensor):
        self.slots = _param_slots(params)
        self.storage = _storage(self.slots)
        self.static_in = torch.empty(images.shape, dtype=images.dtype,
                                     device=images.device)
        self.static_in.copy_(images)
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph,
                              stream=_capture_stream(images.device)):
            self.static_out = run(self.static_in)
        # the capture ran nothing: its launches count on each replay
        self.launched = [a - b for a, b in zip(_launch_counts(), before)]
        _add_launch_counts([-n for n in self.launched])

    def stale(self) -> bool:
        return _storage(self.slots) != self.storage

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        self.static_in.copy_(images)
        self.graph.replay()
        _add_launch_counts(self.launched)
        return self.static_out.clone()


def encode_patch_grid(params: vit.ViT, images_uint8: torch.Tensor,
                      vit_cfg: vit.ViTConfig, cfg: Config,
                      compute_dtype=torch.float32,
                      tp_mesh=None) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] -> patch-token grid [B, nh, nw, D]:
    resize to the query resolution, ImageNet-normalize, ViT forward
    (``tp_mesh``: see ``ViT.forward_features``).

    On the card, with no ``tp_mesh`` (whose collectives cannot be
    captured) and outside a capture, the encode is a CUDA graph held in
    ``params.graphs``, one per key (the frames' shape, dtype and device,
    the compute dtype, the query size, the matmul precision flags): a
    key's first call runs eagerly as its warm-up, the second captures the
    graph, and every call from the second on copies the frames in and
    replays it.  A parameter whose storage was replaced drops the graph
    (the key starts over).  The result is the caller's own.  Counted in
    ``TELEMETRY``: encode.eager_calls, encode.graph_captures,
    encode.graph_replays."""
    def run(images):
        return _encode(params, images, vit_cfg, cfg, compute_dtype, tp_mesh)

    if (not images_uint8.is_cuda or tp_mesh is not None
            or torch.cuda.is_current_stream_capturing()):
        TELEMETRY.count("encode.eager_calls")
        return run(images_uint8)
    mm = torch.backends.cuda.matmul
    key = (tuple(images_uint8.shape), images_uint8.dtype,
           images_uint8.device, compute_dtype,
           (cfg.query.query_height, cfg.query.query_width), vit_cfg,
           mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
           torch.get_float32_matmul_precision())
    graphs = params.graphs
    graph = graphs.get(key)
    if graph is not None and graph.stale():
        del graphs[key]
    if key not in graphs:
        graphs[key] = None
        TELEMETRY.count("encode.eager_calls")
        return _warm_up(run, images_uint8)
    if graph is None:
        graph = graphs[key] = _EncodeGraph(run, params, images_uint8)
        TELEMETRY.count("encode.graph_captures")
    TELEMETRY.count("encode.graph_replays")
    return graph(images_uint8)


def gather_frames(mesh, *local) -> list:
    """Each tensor's whole batch from every dp rank's slice (all-gather
    over dp, in rank order)."""
    return [torch.cat(mesh.all_gather(t, "dp")) for t in local]


def check_replicas(tokens: torch.Tensor) -> None:
    """Raise unless every rank of the world holds the same bits in
    ``tokens``: the ingest computes its replicated index side on each rank,
    and a slot map must not fork on a last-bit difference."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    bits = tokens.to(torch.float32).reshape(-1).view(torch.int32).to(
        torch.int64)
    # position-weighted, so that a swap of two values shows too
    w = torch.arange(1, bits.numel() + 1, device=bits.device) % 65521
    sums = torch.stack([bits.sum(), (bits * w).sum()])
    out = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
    dist.all_gather(out, sums)
    if any(not torch.equal(o, out[0]) for o in out):
        raise RuntimeError("replicas diverged: the ranks' patch tokens "
                           f"differ (checksums {[o.tolist() for o in out]})")


def make_build_step(cfg: Config, vit_cfg: vit.ViTConfig,
                    compute_dtype=torch.float32, mesh=None):
    """Returns (carry, params, rgb, depth, poses, pix=None, repl_idx=None,
    points=None) -> (carry, stats) with carry = (state, generator).
    ``pix`` and ``repl_idx`` inject the ingest's random draws, ``points``
    its float geometry (see ingest_frames).

    ``mesh``: the dp x mp mesh of this rank.  rgb, depth and poses are then
    this rank's dp slice of the batch (``parallel/mesh.frames_shard``),
    ``params`` the (possibly sharded) ViT, ``state`` the whole store or
    this rank's mp shard, and the injected draws, points and the
    generator's draws are the whole batch's, equal on every rank.

    The encode and the ingest are the spans ``perception.encode`` and
    ``perception.ingest`` of ``utils.profiling.SPANS`` (host time, as
    enqueued)."""

    def build_step(carry, params: vit.ViT, rgb, depth, poses,
                   pix: Optional[torch.Tensor] = None,
                   repl_idx: Optional[torch.Tensor] = None,
                   points=None):
        state, generator = carry
        with SPANS("perception.encode"):
            patch = encode_patch_grid(params, rgb, vit_cfg, cfg,
                                      compute_dtype, tp_mesh=mesh)
        if mesh is not None:
            patch, rgb, depth, poses = gather_frames(mesh, patch, rgb, depth,
                                                     poses)
            check_replicas(patch)
        with SPANS("perception.ingest"):
            state, stats = ingest_frames(
                state, rgb, depth, poses, patch.to(torch.float32), generator,
                cfg, pix=pix, repl_idx=repl_idx, points=points)
        return (state, generator), stats

    return build_step


def pooled_query(cfg: Config, vit_params: vit.ViT, images_uint8,
                  compute_dtype) -> torch.Tensor:
    """uint8 images -> the center-Gaussian pooled DINOv2 token [D]."""
    q = (cfg.query.query_height, cfg.query.query_width)
    x = vit.preprocess(images_uint8, out_hw=q).to(compute_dtype)
    return gaussian_center_pool(
        vit_params.forward_features(x)["x_norm_patchtokens"])


def make_query_step(cfg: Config, vit_cfg: vit.ViTConfig,
                    compute_dtype=torch.float32):
    """Returns (state, params, query_images_uint8, top_k, masks...) ->
    (positions [top_k, 3], scores [top_k])."""

    def query_step(state: VoxelStoreState, params: vit.ViT, images_uint8,
                   top_k: int = 100,
                   use_region: bool = False,
                   curr_grid: Optional[torch.Tensor] = None,
                   region_radius: float = 0.0,
                   use_floor: bool = False,
                   floor_range: Optional[torch.Tensor] = None):
        pooled = pooled_query(cfg, params, images_uint8, compute_dtype)
        return localize(
            state, pooled, top_k=top_k, use_region=use_region,
            curr_grid=curr_grid, region_radius=region_radius,
            use_floor=use_floor, floor_range=floor_range)

    return query_step


def make_text_query_step(cfg: Config, vit_cfg: vit.ViTConfig, imagination,
                         compute_dtype=torch.float32, mesh=None):
    """The whole text query in one call (``pipeline.py:98-143``): text ids
    -> ``imagination.imagine_core`` -> DINOv2 encode -> store scan.
    Returns (state, vit_params, ids, ids_uncond, t5_ids, t5_ids_uncond,
    noise=None, top_k, masks...) -> (positions [K, 3], scores [K], images
    [N, H, W, 3] uint8 on the device); ``noise`` injects the sampler's
    initial draw.  ``mesh``: every rank runs the replicated imagination and
    encoder (a sharded ViT gathers its qkv columns) and localizes on its
    shard of the store with the distributed top-K (no masks)."""

    def text_query_step(state: VoxelStoreState, vit_params: vit.ViT,
                        ids, ids_uncond, t5_ids, t5_ids_uncond,
                        noise: Optional[torch.Tensor] = None,
                        top_k: int = 100,
                        use_region: bool = False,
                        curr_grid: Optional[torch.Tensor] = None,
                        region_radius: float = 0.0,
                        use_floor: bool = False,
                        floor_range: Optional[torch.Tensor] = None):
        imgs = imagination.imagine_core(ids, ids_uncond, t5_ids,
                                        t5_ids_uncond, noise)
        pooled = pooled_query(cfg, vit_params, imgs, compute_dtype)
        if mesh is not None:
            if use_region or use_floor:
                raise NotImplementedError("the sharded text query takes no "
                                          "region or floor mask")
            from bsc_nav_tpu_torch.parallel.sharded_query import (
                sharded_localize)
            positions, scores = sharded_localize(state, pooled, mesh, top_k)
            return positions, scores, imgs
        positions, scores = localize(
            state, pooled, top_k=top_k, use_region=use_region,
            curr_grid=curr_grid, region_radius=region_radius,
            use_floor=use_floor, floor_range=floor_range)
        return positions, scores, imgs

    return text_query_step


def make_text_pool_step(cfg: Config, vit_cfg: vit.ViTConfig, imagination,
                        compute_dtype=torch.float32):
    """First half of the split text query (``pipeline.py:146-178``):
    (vit_params, ids, ids_uncond, t5_ids, t5_ids_uncond, noise=None) ->
    (pooled [D] f32, images [N, H, W, 3] uint8), both on the device; the
    store scan (``query.localize``) consumes the pooled vector as it is."""

    def text_pool_step(vit_params: vit.ViT, ids, ids_uncond, t5_ids,
                       t5_ids_uncond, noise: Optional[torch.Tensor] = None):
        imgs = imagination.imagine_core(ids, ids_uncond, t5_ids,
                                        t5_ids_uncond, noise)
        return pooled_query(cfg, vit_params, imgs, compute_dtype), imgs

    return text_pool_step


def make_query_batch_step(cfg: Config, vit_cfg: vit.ViTConfig,
                          compute_dtype=torch.float32):
    """Returns (state, params, images_uint8 [Q, N, H, W, 3], top_k) ->
    (positions [Q, top_k, 3], scores [Q, top_k]) (JAX ``pipeline.py:181-
    203``): the Q*N images in one ViT forward (K1 at batch Q*N), pooled
    per query, localized in one Q-query scan of the store."""

    def query_batch_step(state: VoxelStoreState, params: vit.ViT,
                         images_uint8, top_k: int = 100):
        Qn, Ni = images_uint8.shape[0], images_uint8.shape[1]
        q = (cfg.query.query_height, cfg.query.query_width)
        flat = images_uint8.reshape((Qn * Ni,) + tuple(images_uint8.shape[2:]))
        x = vit.preprocess(flat, out_hw=q).to(compute_dtype)
        tokens = params.forward_features(x)["x_norm_patchtokens"]
        grouped = tokens.reshape(Qn, Ni, tokens.shape[1], tokens.shape[2])
        pooled = torch.stack([gaussian_center_pool(g) for g in grouped])
        return localize_batch(state, pooled, top_k=top_k)

    return query_batch_step


@torch.no_grad()
def token_similarity_map(params: vit.ViT, query_img: torch.Tensor,
                         ref_img: torch.Tensor, vit_cfg: vit.ViTConfig,
                         cfg: Config) -> torch.Tensor:
    """Cosine between a query image's mean patch token and every patch of
    a reference image (uint8 [H, W, 3] each) -> [nh, nw] f32 (JAX
    ``pipeline.py:206-225``)."""
    q = (cfg.query.query_height, cfg.query.query_width)
    qt = params.forward_features(
        vit.preprocess(query_img[None], out_hw=q))["x_norm_patchtokens"]
    rt = params.forward_features(
        vit.preprocess(ref_img[None], out_hw=q))["x_norm_patchtokens"]
    qv = qt[0].mean(dim=0)
    qv = qv / torch.linalg.norm(qv).clamp_min(1e-12)
    rn = rt[0] / torch.linalg.norm(rt[0], dim=-1,
                                   keepdim=True).clamp_min(1e-12)
    return (rn @ qv).reshape(q[0] // vit_cfg.patch_size,
                             q[1] // vit_cfg.patch_size)
