"""The dp x mp process mesh and the tensor-parallel and store layouts.

Counterpart of ``bsc_nav_tpu/parallel/mesh.py``.  The JAX package states
its sharding with GSPMD annotations and lets XLA insert the collectives;
here the program is SPMD over ``torch.distributed``, one process a rank,
and every collective is written out:

  dp  splits the frame batch: each dp rank encodes its B/dp frames, then
      the patch tokens and frames are all-gathered over dp and every rank
      ingests the whole batch (``memory/pipeline.make_build_step``);
  mp  splits (a) the encoders' matmuls Megatron-style -- qkv and fc1
      column-parallel, proj and fc2 row-parallel, the row-parallel sum an
      all-reduce over mp -- and (b) the token store's capacity axis, which
      ``parallel/sharded_query`` scans per shard with a distributed top-K.

Rank r sits at (d, m) = divmod(r, mp), as JAX reshapes its devices to
(dp, mp).  Each rank holds only its own shard of a sharded tensor.  A
sharded linear carries its split (``TPSplit``) on the leaf itself -- the
ViT's ``Linear.tp``, an MMDiT leaf's ``"tp"`` entry -- so that the model's
own linear does the all-reduce and the same call sites serve the sharded
and the whole model.  A leaf whose split does not divide stays whole, as
in JAX.  Quantized (int8) leaves are refused: JAX documents int8 and TP
as not composable, and its ``shard_mmdit_params`` would permute an int8
leaf's bias but not its weight.

The only collectives are the list forms of ``all_reduce`` (sum, after a
row-parallel product) and ``all_gather`` (top-K candidates, a qkv that
cannot stay head-blocked, the dp gather before the ingest), which gloo
also takes on CUDA tensors.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.memory.store import (ShardedStoreState,
                                            VoxelStoreState)
from bsc_nav_tpu_torch.ops.flash_attention import qkv_tp_permutation

#: rendezvous and collective timeout: a hung rank fails its caller instead
#: of blocking forever
TIMEOUT_S = 60.0
INIT_FILE_ENV = "BSC_NAV_INIT_FILE"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A dp x mp grid of ranks seen from one rank: its coordinates (d, m)
    and one process group per axis (the group of ranks that share this
    rank's other coordinate).  A mesh without groups only places
    parameters and store rows."""

    dp: int
    mp: int
    d: int = 0
    m: int = 0
    device: torch.device = torch.device("cpu")
    dp_group: Any = None
    mp_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def rank(self) -> int:
        return self.d * self.mp + self.m

    def _group(self, axis: str):
        size, group = ((self.dp, self.dp_group) if axis == "dp"
                       else (self.mp, self.mp_group))
        if group is None and size > 1:
            raise RuntimeError(f"mesh has no process group for {axis}")
        return size, group

    def all_gather(self, t: torch.Tensor, axis: str) -> list:
        """[t of every rank of ``axis``'s group], in rank order."""
        size, group = self._group(axis)
        if group is None:
            return [t]
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(out, t, group=group)
        return out

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``t`` over ``axis``'s group, in place."""
        size, group = self._group(axis)
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        # one card per rank where there are enough; otherwise (the one-card
        # gloo check) every rank shares card 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(dp: int = 1, mp: int = 1, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """The dp x mp mesh of this process (``mesh.py:26``).

    Joins the process group if this process has not: ``nccl`` on cuda and ``gloo`` on cpu unless
    ``backend`` says otherwise (``"gloo"`` on cuda puts several ranks on
    one card, which NCCL refuses), rendezvous through the file named by
    ``$BSC_NAV_INIT_FILE`` (``parallel/launch``) or else ``env://``, rank
    and world size from ``$RANK`` / ``$WORLD_SIZE``, timeout ``TIMEOUT_S``.
    Raises when the world size is not dp*mp, or when the process group
    cannot be joined (no fallback to another backend).  Every rank creates
    the axis groups in the same order.  (A ``Mesh`` built directly, with no
    groups, only places parameters and store rows.)"""
    if dp < 1 or mp < 1:
        raise ValueError(f"make_mesh: dp={dp} mp={mp}")
    n = dp * mp
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dev = _rank_device(dev, int(os.environ["RANK"]))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_file = os.environ.get(INIT_FILE_ENV)
        dist.init_process_group(
            backend, init_method=(f"file://{init_file}" if init_file
                                  else "env://"),
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    elif dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs "
                         f"{dist.get_backend()}, {backend} asked for")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"make_mesh: need {n} ranks for dp={dp} x mp={mp}, "
                         f"the world has {world}")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    d, m = divmod(dist.get_rank(), mp)
    dev = _rank_device(dev, dist.get_rank())
    mp_groups = [dist.new_group([e * mp + j for j in range(mp)])
                 for e in range(dp)]
    dp_groups = [dist.new_group([e * mp + j for e in range(dp)])
                 for j in range(mp)]
    return Mesh(dp, mp, d, m, dev, dp_groups[m], mp_groups[d])


# --------------------------------------------------------------------------
# tensor-parallel linears
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class TPSplit:
    """How a linear leaf is split over the mesh's mp axis.

    ``"col"``: the leaf holds its rank's fan_out/mp output columns (and
    bias entries); its output is the rank's columns.  ``perm`` is the
    head-blocked column permutation of a qkv leaf.  ``"row"``: the leaf
    holds its rank's fan_in/mp input rows and the whole bias; ``row_linear``
    takes the whole input or the rank's columns of it, all-reduces the
    partial products over mp and adds the bias once."""

    kind: str
    mesh: Mesh
    perm: Optional[np.ndarray] = None

    def row_linear(self, x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor]) -> torch.Tensor:
        """y = x @ W + b for the whole W whose rows [m*k, (m+1)*k) this
        rank holds as ``w`` [k, fan_out].  The partial product is formed in
        the promoted dtype, summed over mp in f32, and the bias is added
        once, after the sum; the result takes x's dtype."""
        k, mp, m = w.shape[0], self.mesh.mp, self.mesh.m
        if x.shape[-1] == k * mp:
            x = x[..., m * k:(m + 1) * k]
        elif x.shape[-1] != k:
            raise ValueError(f"row-parallel linear: input width "
                             f"{x.shape[-1]}, shard rows {k}, mp {mp}")
        ct = torch.promote_types(x.dtype, w.dtype)
        y = (x.reshape(-1, k).to(ct) @ w.to(ct)).to(torch.float32)
        self.mesh.all_reduce(y, "mp")
        if b is not None:
            y = y + b.to(torch.float32)
        return y.reshape(*x.shape[:-1], -1).to(x.dtype)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """A column-parallel output [..., n/mp] -> the whole [..., n] in the
        unpermuted column order (all-gather over mp)."""
        full = torch.cat(self.mesh.all_gather(y, "mp"), dim=-1)
        if self.perm is not None:
            inv = np.argsort(self.perm)
            full = full[..., torch.from_numpy(inv).to(full.device)]
        return full


def _refuse_int8(what: str) -> None:
    raise ValueError(
        f"{what}: int8 (quantized) leaves do not compose with tensor "
        "parallelism (TP keeps bf16 or f32; JAX vit.py:163-164, "
        "mmdit.py:371)")


def _split_leaf(w, b, kind: str, mesh: Mesh, perm=None):
    """(w, b) of one rank, or None when the split does not divide (the
    leaf then stays whole, JAX's ``ok`` test, ``mesh.py:83-87``)."""
    mp, m = mesh.mp, mesh.m
    if perm is not None:
        w = w[:, torch.from_numpy(perm).to(w.device)]
        b = None if b is None else b[torch.from_numpy(perm).to(b.device)]
    if kind == "col":
        n = w.shape[1]
        if n % mp:
            return None
        c = n // mp
        return (w[:, m * c:(m + 1) * c].contiguous(),
                None if b is None else b[m * c:(m + 1) * c].contiguous())
    n = w.shape[0]
    if n % mp:
        return None
    r = n // mp
    return w[m * r:(m + 1) * r].contiguous(), b


#: the Megatron split of a transformer block's linears (``vit_param_spec``,
#: ``mesh.py:38-50``); every other leaf stays whole
TP_KINDS = {"qkv": "col", "fc1": "col", "proj": "row", "fc2": "row"}


@torch.no_grad()
def shard_vit_params(model, mesh: Mesh, tp_qkv_layout: bool = False):
    """A copy of the ViT ``model`` holding this rank's shards
    (``mesh.py:53-89``).  ``tp_qkv_layout`` permutes the qkv columns into
    the head-blocked layout, so that ``forward_features(tp_mesh=mesh)``
    runs attention per rank with no collective; without it (or called
    without ``tp_mesh``) the blocks all-gather the qkv columns first."""
    if model.quantized:
        _refuse_int8("shard_vit_params")
    out = copy.deepcopy(model)
    if mesh.mp == 1:
        return out
    perm = (qkv_tp_permutation(model.cfg.dim, mesh.mp)
            if tp_qkv_layout else None)
    for blk in out.blocks:
        for name, kind in TP_KINDS.items():
            lin = getattr(blk, name)
            p = perm if name == "qkv" else None
            split = _split_leaf(lin.w, lin.b, kind, mesh, p)
            if split is None:
                continue
            lin.w = torch.nn.Parameter(split[0], requires_grad=False)
            if lin.b is not None:
                lin.b = torch.nn.Parameter(split[1], requires_grad=False)
            lin.tp = TPSplit(kind, mesh, p)
    return out


@torch.no_grad()
def shard_mmdit_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's MMDiT tree (``mesh.py:92-146``): per stream, qkv
    column-parallel in the head-blocked layout, fc1 column-parallel, proj
    and fc2 row-parallel; adaLN ``mod``, the qk-norm gammas, the
    dual-attention ``qkv2`` / ``proj2``, the embeddings and the final head
    stay whole.  A sharded leaf is ``{"w", "b", "tp": TPSplit}``; the tree
    shares its whole leaves with ``params``.  ``forward(tp_mesh=mesh)``
    then runs the joint attention per rank."""
    for blk in params["blocks"]:
        for s in blk.values():
            if any(isinstance(v, dict) and "w_q" in v for v in s.values()):
                _refuse_int8("shard_mmdit_params")
    if mesh.mp == 1:
        return params
    dim = params["blocks"][0]["x"]["qkv"]["w"].shape[0]
    hint = params["blocks"][0]["x"].get("q_norm")
    if hint is not None and (dim // hint.shape[0]) % mesh.mp:
        raise ValueError(f"MMDiT TP needs heads % mp == 0 (heads="
                         f"{dim // hint.shape[0]}, mp={mesh.mp})")
    perm = qkv_tp_permutation(dim, mesh.mp)
    out = {k: v for k, v in params.items() if k != "blocks"}
    blocks = []
    for blk in params["blocks"]:
        nb = {}
        for name, s in blk.items():
            ns = dict(s)
            for leaf, kind in TP_KINDS.items():
                if leaf not in s:
                    continue
                p = perm if leaf == "qkv" else None
                split = _split_leaf(s[leaf]["w"], s[leaf].get("b"), kind,
                                    mesh, p)
                if split is not None:
                    ns[leaf] = {"w": split[0], "b": split[1],
                                "tp": TPSplit(kind, mesh, p)}
            nb[name] = ns
        blocks.append(nb)
    out["blocks"] = blocks
    return out


# --------------------------------------------------------------------------
# the store: capacity axis over mp
# --------------------------------------------------------------------------

def store_sharding(mesh: Mesh) -> Dict[str, Optional[str]]:
    """Which store fields split over mp along their capacity axis
    (``mesh.py:149-172``); None: replicated."""
    return {
        "feats": "mp", "feat_norm": "mp", "feat_dist": "mp",
        "feat_scale": "mp", "feat_sum": "mp", "feat_obs": "mp",
        "feat_count": "mp", "rgb_sum": "mp", "weight": "mp",
        "slot_pos": "mp",
        "slot_map": None, "num_voxels": None, "dropped_voxels": None,
        "cv_map": None, "max_height": None, "inv_init_base_tf": None,
        "initialized": None,
    }


def _sharded_fields(state: VoxelStoreState) -> list:
    """The capacity fields that split: those whose leading axis is a
    multiple of the slot rows V1 (``feat_sum`` and ``feat_obs`` under the
    dist policy, and an f32 store's ``feat_scale``, are size-1
    placeholders and stay whole, ``mesh.py:182-183``)."""
    V1 = state.feat_count.shape[0]
    return [f for f, ax in store_sharding(None).items()
            if ax and getattr(state, f).shape[0] % V1 == 0
            and getattr(state, f).shape[0] >= V1]


def shard_store(state: VoxelStoreState, mesh: Mesh) -> VoxelStoreState:
    """This rank's shard of a whole store (``mesh.py:175-188``): slot rows
    [m*V1/mp, (m+1)*V1/mp) of every capacity field and their K token rows,
    copied, in a ``ShardedStoreState``; the index side stays whole.  A
    store whose slot rows V1 do not divide over mp stays whole (JAX's
    fallback; here the test is on V1, so that a rank holds whole slots)."""
    V1 = state.feat_count.shape[0]
    mp, m = mesh.mp, mesh.m
    if mp == 1 or V1 % mp:
        return state
    Vl = V1 // mp
    fields = {f: getattr(state, f) for f in VoxelStoreState.__dataclass_fields__}
    for f in _sharded_fields(state):
        t = fields[f]
        rows = t.shape[0] // V1 * Vl
        fields[f] = t[m * rows:(m + 1) * rows].clone()
    return ShardedStoreState(**fields, shard_index=m, shard_count=mp)


def unshard_store(state: VoxelStoreState, mesh: Mesh) -> VoxelStoreState:
    """The whole store from every rank's shard (all-gather over mp); a whole
    store is returned as it is."""
    if getattr(state, "shard_count", 1) == 1:
        return state
    fields = {f: getattr(state, f) for f in VoxelStoreState.__dataclass_fields__}
    for f in _sharded_fields(state):
        fields[f] = torch.cat(mesh.all_gather(fields[f], "mp"))
    return VoxelStoreState(**fields)


def frames_shard(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's dp slice of a frame batch (``frames_sharding``,
    ``mesh.py:191``: frames split over dp on the leading axis)."""
    B = x.shape[0]
    if B % mesh.dp:
        raise ValueError(f"frame batch {B} does not split over dp {mesh.dp}")
    n = B // mesh.dp
    return x[mesh.d * n:(mesh.d + 1) * n]
