"""One rank of the port's parallel tests (tests/test_torch_parallel*.py).

    python tests/torch_parallel_worker.py SUITE WORKDIR

Started by ``bsc_nav_tpu_torch.parallel.launch.spawn`` (RANK, WORLD_SIZE
and the rendezvous file in the environment), on the CPU over gloo.  It
reads ``WORKDIR/inputs.npz`` and ``WORKDIR/inputs.json`` (written by the
test process from the JAX package's parameters and stores), runs every
case of SUITE, and writes ``WORKDIR/rank{r}.npz`` (the case results,
``case.name`` keys) and ``WORKDIR/rank{r}.json`` (each case's error, if it
raised, this rank's mesh coordinates and whether JAX was imported).  A
case that raises does not stop the others.  Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bsc_nav_tpu_torch.config import small_test_config  # noqa: E402
from bsc_nav_tpu_torch.memory.ingest import ingest_frames  # noqa: E402
from bsc_nav_tpu_torch.memory.pipeline import (  # noqa: E402
    check_replicas, gather_frames, make_build_step)
from bsc_nav_tpu_torch.memory.store import (  # noqa: E402
    VoxelStoreState, init_store)
from bsc_nav_tpu_torch.models import mmdit as MM  # noqa: E402
from bsc_nav_tpu_torch.models import vit  # noqa: E402
from bsc_nav_tpu_torch.models.weights import (  # noqa: E402
    mmdit_from_jax_params, unflatten_params, vit_from_jax_params)
from bsc_nav_tpu_torch.ops import flash_attention as FA  # noqa: E402
from bsc_nav_tpu_torch.parallel import mesh as M  # noqa: E402
from bsc_nav_tpu_torch.parallel.sharded_query import (  # noqa: E402
    sharded_localize)

STORE_FIELDS = tuple(VoxelStoreState.__dataclass_fields__)


# --------------------------------------------------------------------------
# fault injection for the negative controls
# --------------------------------------------------------------------------

class NoReduceMesh(M.Mesh):
    """A mesh whose all-reduce does nothing (a lost all-reduce)."""

    def all_reduce(self, t, axis):
        return t


class DropFirstMesh(M.Mesh):
    """A mesh whose all-gather loses rank 0's part (a dropped shard of
    top-K candidates)."""

    def all_gather(self, t, axis):
        return super().all_gather(t, axis)[1:]


def _as(cls, mesh):
    return cls(**{f.name: getattr(mesh, f.name)
                  for f in dataclasses.fields(mesh)})


class BiasEveryRank(M.TPSplit):
    """A row-parallel split that adds the bias on every rank before the
    sum (the bias counted mp times)."""

    def row_linear(self, x, w, b):
        y = super().row_linear(x, w, b)
        return y + ((self.mesh.mp - 1) * b).to(y.dtype)


def no_reduce_in(model_or_leaf, mesh):
    """A lost all-reduce in the first block's attention projection."""
    if isinstance(model_or_leaf, dict):
        leaf = model_or_leaf["blocks"][0]["x"]["proj"]
        leaf["tp"] = dataclasses.replace(leaf["tp"],
                                         mesh=_as(NoReduceMesh, mesh))
    else:
        lin = model_or_leaf.blocks[0].proj
        lin.tp = dataclasses.replace(lin.tp, mesh=_as(NoReduceMesh, mesh))


def bias_every_rank_in(model, mesh):
    lin = model.blocks[0].fc2
    lin.tp = BiasEveryRank(lin.tp.kind, mesh, lin.tp.perm)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

class Inputs:
    def __init__(self, workdir: Path):
        self.z = dict(np.load(workdir / "inputs.npz"))
        self.meta = json.loads((workdir / "inputs.json").read_text())

    def __getitem__(self, k):
        return torch.from_numpy(np.array(self.z[k]))

    def tree(self, prefix):
        n = len(prefix) + 1
        return unflatten_params({k[n:]: v for k, v in self.z.items()
                                 if k.startswith(prefix + ".")})

    def store(self, prefix) -> VoxelStoreState:
        return VoxelStoreState(**{f: self[f"{prefix}.{f}"]
                                  for f in STORE_FIELDS})

    def vit(self, prefix):
        cfg = vit.ViTConfig(**self.meta[prefix])
        return cfg, vit_from_jax_params(self.tree(f"p.{prefix}"), cfg,
                                        device="cpu")

    def mmdit(self, prefix):
        cfg = MM.MMDiTConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in self.meta[prefix].items()})
        return cfg, mmdit_from_jax_params(self.tree(f"p.{prefix}"), cfg,
                                          device="cpu")


def dp_slice(mesh, x):
    return M.frames_shard(mesh, x)


def store_arrays(state, prefix):
    return {f"{prefix}.{f}": getattr(state, f).numpy() for f in STORE_FIELDS}


# --------------------------------------------------------------------------
# suites: each case returns {name: array}
# --------------------------------------------------------------------------

def suite_tp(inp, out, errors):
    """World 4, a 2 x 2 mesh: TP attention, the ViT and MMDiT forwards,
    the joint attention, and their negative controls."""
    mesh = M.make_mesh(dp=2, mp=2, device="cpu")
    out["mesh.coords"] = np.array([mesh.d, mesh.m, mesh.dp, mesh.mp])
    try:
        M.make_mesh(dp=3, mp=1, device="cpu")
        errors["mesh.wrong_world"] = "no error"
    except ValueError as e:
        out["mesh.wrong_world_raised"] = np.array(1)
        errors["mesh.wrong_world_message"] = str(e)

    def case(name, fn):
        try:
            out.update({f"{name}.{k}": v for k, v in fn().items()})
        except Exception:                          # recorded, the test fails
            errors[name] = traceback.format_exc()

    def attn():
        qkv, h = inp["attn.qkv"], inp.meta["attn"]["heads"]
        D = qkv.shape[-1] // 3
        perm = torch.from_numpy(FA.qkv_tp_permutation(D, 2))
        blk = dp_slice(mesh, qkv[..., perm])
        c = 3 * D // 2
        local = blk[..., mesh.m * c:(mesh.m + 1) * c].contiguous()
        return {"out": FA.attention_from_qkv_tp(local, h, mesh).numpy()}

    def vit_case():
        cfg, model = inp.vit("vit")
        x = dp_slice(mesh, inp["vit.x"])
        sharded = M.shard_vit_params(model, mesh, tp_qkv_layout=True)
        res = {"tp": sharded.forward_features(x, tp_mesh=mesh),
               "gather": sharded.forward_features(x)}
        plain = M.shard_vit_params(model, mesh)
        res["plain"] = plain.forward_features(x, tp_mesh=mesh)
        no_reduce_in(sharded, mesh)
        res["noreduce"] = sharded.forward_features(x, tp_mesh=mesh)
        biased = M.shard_vit_params(model, mesh, tp_qkv_layout=True)
        bias_every_rank_in(biased, mesh)
        res["bias"] = biased.forward_features(x, tp_mesh=mesh)
        return {k: v["x_norm_patchtokens"].numpy() for k, v in res.items()}

    def mmdit_case(prefix):
        def run():
            cfg, params = inp.mmdit(prefix)
            args = [dp_slice(mesh, inp[f"{prefix}.{k}"])
                    for k in ("lat", "t", "ctx", "pool")]
            sp = M.shard_mmdit_params(params, mesh)
            res = {"tp": MM.forward(sp, args[0], args[1], args[2], args[3],
                                    cfg, tp_mesh=mesh),
                   "gather": MM.forward(sp, args[0], args[1], args[2],
                                        args[3], cfg)}
            no_reduce_in(sp, mesh)
            res["noreduce"] = MM.forward(sp, args[0], args[1], args[2],
                                         args[3], cfg, tp_mesh=mesh)
            return {k: v.numpy() for k, v in res.items()}
        return run

    def joint():
        h = inp.meta["joint"]["heads"]
        D = inp["joint.qkv_x"].shape[-1] // 3
        perm = torch.from_numpy(FA.qkv_tp_permutation(D, 2))
        c = 3 * D // 2

        def local(k):
            t = dp_slice(mesh, inp[k][..., perm])
            return t[..., mesh.m * c:(mesh.m + 1) * c].contiguous()

        gq, gk = inp["joint.gq"], inp["joint.gk"]
        ax, ac = local("joint.qkv_x"), local("joint.qkv_c")
        return {"gammas": FA.joint_qkv_attention_tp(
                    ax, ac, h, gq, gk, gq, gk, mesh).numpy(),
                "none": FA.joint_qkv_attention_tp(
                    ax, ac, h, None, None, None, None, mesh).numpy()}

    case("attn", attn)
    case("vit", vit_case)
    for prefix in inp.meta["mmdit_prefixes"]:
        case(prefix, mmdit_case(prefix))
    case("joint", joint)


def suite_store(inp, out, errors):
    """World 8: the sharded localize (mp 8 on f32 and int8 stores, 4 x 2),
    the dp 8 ingest, the dp 2 x mp 4 build step (heads 2: the gather path),
    the sharded ingest against the whole one, the replicas' check."""
    cfg = small_test_config()

    def case(name, fn):
        try:
            out.update({f"{name}.{k}": v for k, v in fn().items()})
        except Exception:
            errors[name] = traceback.format_exc()

    def localize_case(prefix):
        def run():
            m = inp.meta[prefix]
            mesh = M.make_mesh(dp=m["dp"], mp=m["mp"], device="cpu")
            state = M.shard_store(inp.store(prefix), mesh)
            q, k = inp[f"{prefix}.q"], m["top_k"]
            p, s = sharded_localize(state, q, mesh, top_k=k)
            pd, sd = sharded_localize(state, q, _as(DropFirstMesh, mesh),
                                      top_k=k)
            return {"pos": p.numpy(), "scores": s.numpy(),
                    "drop_pos": pd.numpy(), "drop_scores": sd.numpy(),
                    "rows": np.array(state.feat_count.shape[0])}
        return run

    def frames(prefix):
        return [inp[f"{prefix}.{k}"] for k in ("rgb", "depth", "poses")]

    def injected(prefix):
        points = ((inp[f"{prefix}.pl"], inp[f"{prefix}.pw"])
                  if f"{prefix}.pl" in inp.z else None)
        return dict(pix=inp[f"{prefix}.pix"], repl_idx=inp[f"{prefix}.repl"],
                    points=points)

    def ingest_dp8():
        mesh = M.make_mesh(dp=8, mp=1, device="cpu")
        local = [dp_slice(mesh, t) for t in
                 frames("dp8") + [inp["dp8.tokens"]]]
        rgb, depth, poses, tokens = gather_frames(mesh, *local)
        check_replicas(tokens)
        state, _ = ingest_frames(init_store(cfg.memory, device="cpu"), rgb,
                                 depth, poses, tokens, None, cfg,
                                 **injected("dp8"))
        return store_arrays(state, "store")

    def build_dp2mp4():
        mesh = M.make_mesh(dp=2, mp=4, device="cpu")
        vcfg, model = inp.vit("bvit")
        res = {}
        for fault in (None, no_reduce_in):
            sp = M.shard_vit_params(model, mesh)
            if fault is not None:
                fault(sp, mesh)
            state = M.shard_store(init_store(cfg.memory, device="cpu"), mesh)
            build = make_build_step(cfg, vcfg, mesh=mesh)
            try:
                (state, _), _ = build(
                    (state, None), sp,
                    *(dp_slice(mesh, t) for t in frames("b")),
                    **injected("b"))
            except RuntimeError as e:
                if fault is None:
                    raise
                # the mp ranks' tokens differ: the replica check stops it
                errors["build.noreduce"] = str(e)
                continue
            res.update({f"slab.{k}": v for k, v in
                        store_arrays(state, "s").items()})
            res["base"] = np.array(state.shard_base)
            res.update(store_arrays(M.unshard_store(state, mesh), "ok"))
        return res

    def sharded_ingest(dtype):
        def run():
            mesh = M.make_mesh(dp=1, mp=8, device="cpu")
            whole = init_store(cfg.memory, store_dtype=dtype, device="cpu")
            shard = M.shard_store(
                init_store(cfg.memory, store_dtype=dtype, device="cpu"), mesh)
            for i in range(2):
                p = f"si{i}"
                args = frames(p) + [inp[f"{p}.tokens"], None, cfg]
                whole, _ = ingest_frames(whole, *args, **injected(p))
                shard, _ = ingest_frames(shard, *args, **injected(p))
            rows = M.shard_store(whole, mesh)
            return {**store_arrays(shard, "shard"),
                    **store_arrays(rows, "whole")}
        return run

    def replicas():
        mesh = M.make_mesh(dp=8, mp=1, device="cpu")
        t = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
        check_replicas(t)                       # equal on every rank
        if mesh.rank == 3:
            t[1, 2, 3] = torch.nextafter(t[1, 2, 3], torch.tensor(1e9))
        try:
            check_replicas(t)
        except RuntimeError as e:
            errors["replicas.message"] = str(e)
            return {"raised": np.array(1)}
        return {"raised": np.array(0)}

    for name in inp.meta["localize"]:
        case(name, localize_case(name))
    case("dp8", ingest_dp8)
    case("build", build_dp2mp4)
    case("si_f32", sharded_ingest(torch.float32))
    case("si_int8", sharded_ingest(torch.int8))
    case("replicas", replicas)


def suite_dryrun(inp, out, errors):
    from bsc_nav_tpu_torch.parallel.dryrun import dryrun_all
    try:
        errors["dryrun.lines"] = "\n".join(
            dryrun_all(int(os.environ["WORLD_SIZE"]), device="cpu"))
        out["dryrun.ok"] = np.array(1)
    except Exception:
        errors["dryrun"] = traceback.format_exc()


SUITES = {"tp": suite_tp, "store": suite_store, "dryrun": suite_dryrun}
REPO = Path(__file__).resolve().parent.parent


def run_suite(suite: str, world: int, workdir, arrays=None, meta=None,
              timeout_s: float = 300.0):
    """The test process's side: write the inputs, start ``world`` ranks of
    SUITE on the CPU, wait (``launch.spawn``: a failed rank fails at once,
    a hung one at ``timeout_s``), and return (per-rank result dicts,
    per-rank error dicts)."""
    from bsc_nav_tpu_torch.parallel.launch import spawn
    wd = Path(workdir)
    wd.mkdir(parents=True, exist_ok=True)
    if arrays is not None:
        np.savez(wd / "inputs.npz", **arrays)
        (wd / "inputs.json").write_text(json.dumps(meta or {}))
    spawn(lambda r: [sys.executable, str(Path(__file__).resolve()), suite,
                     str(wd)], world, wd, timeout_s, cwd=str(REPO))
    outs = [dict(np.load(wd / f"rank{r}.npz")) for r in range(world)]
    errs = [json.loads((wd / f"rank{r}.json").read_text())
            for r in range(world)]
    return outs, errs


@torch.no_grad()
def main(suite: str, workdir: str) -> int:
    wd = Path(workdir)
    rank = int(os.environ["RANK"])
    inp = Inputs(wd) if (wd / "inputs.npz").exists() else None
    out, errors = {}, {}
    SUITES[suite](inp, out, errors)
    errors["jax_imported"] = any(m.split(".")[0] in ("jax", "jaxlib",
                                                     "bsc_nav_tpu")
                                 for m in sys.modules)
    np.savez(wd / f"rank{rank}.npz", **out)
    (wd / f"rank{rank}.json").write_text(json.dumps(errors))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
