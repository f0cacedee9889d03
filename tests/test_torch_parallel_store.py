"""The port's mp-sharded store, distributed top-K and dp x mp build
(``parallel/mesh.shard_store``, ``parallel/sharded_query``, the sharded
``ingest_frames`` and ``pipeline.make_build_step(mesh=)``) against the JAX
package's, case by case after ``tests/test_sharded_query.py`` and
``tests/test_sharded_ingest.py``.

The JAX side runs in this process on conftest's 8 virtual CPU devices; the
port's side runs as 8 rank processes over gloo, all of its cases in one
start (``torch_parallel_worker.py``, suite "store").  The ingest's draws
and world points are JAX's, injected (``torch_parity``).  Tolerances are
JAX's: sharded scores rtol 1e-5 (int8 rows rtol 1e-2, atol 1e-3) with the
positions equal, the dp ingest's fields equal, the build step's feats
2e-4.  Negative controls: top-K candidates without rank 0's shard must
fail them, and a lost all-reduce in the encoder's first block must stop
the build at its replica check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.memory import query as JQ
from bsc_nav_tpu.memory.ingest import ingest_frames as jax_ingest
from bsc_nav_tpu.memory.pipeline import make_build_step as jax_build_step
from bsc_nav_tpu.memory.store import dequantized_feats, init_store
from bsc_nav_tpu.models import vit as JV
from bsc_nav_tpu.parallel import mesh as JMESH
from bsc_nav_tpu.parallel.sharded_query import sharded_localize
from bsc_nav_tpu_torch.config import small_test_config as port_config
from bsc_nav_tpu_torch.memory.pipeline import make_build_step
from bsc_nav_tpu_torch.memory.store import (VoxelStoreState,
                                            init_store as port_init_store)
from bsc_nav_tpu_torch.models.vit import ViTConfig
from bsc_nav_tpu_torch.models.weights import (flatten_params,
                                              vit_from_jax_params)

from test_ingest import make_frames
from test_query import build_store
from test_torch_parallel import vit_params
from torch_parallel_worker import run_suite
from torch_parity import (build_step_draws, ingest_draws, jax_frame_points,
                          store_fields_equal, store_from_jax)

FIELDS = tuple(VoxelStoreState.__dataclass_fields__)
BUILD_VIT = dict(img_size=28, patch_size=14, dim=32, depth=2, heads=2,
                 num_registers=1)
LOCALIZE = {            # name: (n_vox, seed, top_k, dp, mp)
    "loc_f32": (200, 3, 32, 1, 8),
    "loc_all": (1000, 4, 32, 1, 8),       # live voxels in every shard
    "loc_42": (77, 5, 16, 4, 2),
}


def store_arrays(state, prefix):
    return {f"{prefix}.{f}": np.array(getattr(state, f)) for f in FIELDS}


def frames_arrays(prefix, rgb, depth, poses, pix, repl, points=None):
    out = {f"{prefix}.rgb": rgb, f"{prefix}.depth": depth,
           f"{prefix}.poses": poses, f"{prefix}.pix": pix,
           f"{prefix}.repl": repl}
    if points is not None:
        out[f"{prefix}.pl"], out[f"{prefix}.pw"] = points
    return out


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """JAX's stores, queries and builds, then one start of 8 port ranks."""
    cfg = small_test_config()
    rng = np.random.default_rng(0)
    arrays, meta, ref = {}, {"localize": list(LOCALIZE) + ["loc_int8"]}, {}

    for name, (n_vox, seed, k, dp, mp) in LOCALIZE.items():
        state, *_ = build_store(cfg, n_vox=n_vox, seed=seed)
        q = rng.normal(size=cfg.memory.token_dim).astype(np.float32)
        arrays.update(store_arrays(state, name))
        arrays[f"{name}.q"] = q
        meta[name] = {"top_k": k, "dp": dp, "mp": mp}
        ref[name] = JQ.localize(state, jnp.asarray(q), top_k=k)
        mesh = JMESH.make_mesh(dp=dp, mp=mp)
        ref[name + ".jax_sh"] = sharded_localize(
            JMESH.shard_store(state, mesh), jnp.asarray(q), mesh, top_k=k)

    # an int8 store from a real ingest
    rgb, depth, poses, tokens = make_frames(cfg, 4, seed=7)
    s8 = init_store(cfg.memory, store_dtype=jnp.int8)
    s8, _ = jax_ingest(s8, *map(jnp.asarray, (rgb, depth, poses, tokens)),
                       jax.random.PRNGKey(0), cfg)
    assert int(s8.num_voxels) > 0
    q = rng.normal(size=cfg.memory.token_dim).astype(np.float32)
    arrays.update(store_arrays(s8, "loc_int8"))
    arrays["loc_int8.q"] = q
    meta["loc_int8"] = {"top_k": 16, "dp": 1, "mp": 8}
    ref["loc_int8"] = JQ.localize(s8, jnp.asarray(q), top_k=16)
    mesh = JMESH.make_mesh(dp=1, mp=8)
    ref["loc_int8.jax_sh"] = sharded_localize(
        JMESH.shard_store(s8, mesh), jnp.asarray(q), mesh, top_k=16)

    # the dp 8 ingest (tokens given, no encoder)
    rgb, depth, poses, tokens = make_frames(cfg, 8, seed=2)
    key = jax.random.PRNGKey(3)
    ref["dp8"], _ = jax_ingest(init_store(cfg.memory),
                               *map(jnp.asarray, (rgb, depth, poses, tokens)),
                               key, cfg)
    pix, repl = ingest_draws(key, cfg, 8)
    pts = jax_frame_points(cfg, depth, poses, pix)[2:4]
    arrays.update(frames_arrays("dp8", rgb, depth, poses, pix, repl, pts))
    arrays["dp8.tokens"] = tokens

    # the dp 2 x mp 4 build step, heads 2 (the gather path)
    jcfg = JV.ViTConfig(**BUILD_VIT)
    vp = vit_params(jcfg, 1)
    arrays.update({f"p.bvit.{k}": v for k, v in flatten_params(vp).items()})
    meta["bvit"] = BUILD_VIT
    rgb, depth, poses, _ = make_frames(cfg, 8, seed=4)
    build = jax_build_step(cfg, jcfg)
    (ref["build"], _), _ = build(
        (init_store(cfg.memory), jax.random.PRNGKey(1)),
        jax.tree.map(jnp.asarray, vp),
        *map(jnp.asarray, (rgb, depth, poses)))
    _, pix, repl = build_step_draws(jax.random.PRNGKey(1), cfg, 8)
    pts = jax_frame_points(cfg, depth, poses, pix)[2:4]
    arrays.update(frames_arrays("b", rgb, depth, poses, pix, repl, pts))
    pcfg = port_config()
    pstate = port_init_store(pcfg.memory, device="cpu")
    (ref["build.port"], _), _ = make_build_step(pcfg, ViTConfig(**BUILD_VIT))(
        (pstate, None),
        vit_from_jax_params(vp, ViTConfig(**BUILD_VIT), device="cpu"),
        *map(torch.from_numpy, (rgb, depth, poses)),
        pix=torch.from_numpy(pix), repl_idx=torch.from_numpy(repl),
        points=tuple(map(torch.from_numpy, pts)))

    # two batches over the same views, for the sharded ingest (the second
    # fills caches and replaces rows)
    rgb, depth, poses, _ = make_frames(cfg, 4, seed=11)
    for i in range(2):
        pix, repl = ingest_draws(jax.random.PRNGKey(21 + i), cfg, 4)
        arrays.update(frames_arrays(f"si{i}", rgb, depth, poses, pix, repl))
        arrays[f"si{i}.tokens"] = rng.normal(
            size=(4, 2, 2, cfg.memory.token_dim)).astype(np.float32)

    outs, errs = run_suite("store", 8, tmp_path_factory.mktemp("store"),
                           arrays, meta)
    return outs, errs, ref, cfg


def no_errors(errs, *cases):
    for r, e in enumerate(errs):
        for c in cases:
            assert c not in e, f"rank {r}, case {c}:\n{e[c]}"


def test_ranks_import_no_jax(store):
    _, errs, *_ = store
    assert [e["jax_imported"] for e in errs] == [False] * 8


@pytest.mark.parametrize("name", ["loc_f32", "loc_all", "loc_42",
                                  "loc_int8"])
def test_sharded_localize_matches_jax(store, name):
    """Every rank returns the same top-K, held to JAX's single-device
    localize and to its shard_map localize: positions equal, scores rtol
    1e-5 (int8 rows: rtol 1e-2, atol 1e-3, as JAX's test); without rank
    0's candidates the positions differ."""
    outs, errs, ref, _ = store
    no_errors(errs, name)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{name}.pos"], outs[0][f"{name}.pos"])
        np.testing.assert_array_equal(o[f"{name}.scores"],
                                      outs[0][f"{name}.scores"])
    pos, sc = outs[0][f"{name}.pos"], outs[0][f"{name}.scores"]
    tol = (dict(rtol=1e-2, atol=1e-3) if name == "loc_int8"
           else dict(rtol=1e-5))
    for which in ("", ".jax_sh"):
        p_ref, s_ref = (np.asarray(a) for a in ref[name + which])
        np.testing.assert_allclose(sc, s_ref, **tol)
        if name != "loc_int8":
            np.testing.assert_array_equal(pos, p_ref)
    assert not np.array_equal(outs[0][f"{name}.drop_pos"], pos)


def test_dp8_ingest_matches_single_device(store):
    """Frames split over dp 8, all-gathered, ingested on every rank: each
    rank's store equals JAX's single-device ingest (integer fields, feats
    rtol 1e-6, weight rtol 1e-5), and the ranks agree to the bit."""
    outs, errs, ref, cfg = store
    no_errors(errs, "dp8")
    s_ref = ref["dp8"]
    n = int(s_ref.num_voxels)
    for o in outs:
        t = VoxelStoreState(**{f: torch.from_numpy(o[f"dp8.store.{f}"])
                               for f in FIELDS})
        store_fields_equal(s_ref, t, cfg)
        np.testing.assert_allclose(t.feats.view(-1, 4, 32).numpy()[:n],
                                   np.asarray(dequantized_feats(s_ref))[:n],
                                   rtol=1e-6)
        np.testing.assert_allclose(o["dp8.store.weight"][:n],
                                   np.asarray(s_ref.weight)[:n], rtol=1e-5)
        for f in ("slot_map", "feat_count", "slot_pos", "feats"):
            np.testing.assert_array_equal(o[f"dp8.store.{f}"],
                                          outs[0][f"dp8.store.{f}"])


def test_dp_mp_build_step_matches(store):
    """The build step at dp 2 x mp 4 (ViT heads 2: the qkv all-gathered;
    the store split over mp) against JAX's unsharded step and the port's:
    slot positions and counts equal, feats within 2e-4; each rank's slab
    is its rows of the port's whole store; a lost all-reduce in the
    encoder's first block is caught by the replica check."""
    outs, errs, ref, cfg = store
    no_errors(errs, "build")
    s_ref, p_ref = ref["build"], ref["build.port"]
    n = int(s_ref.num_voxels)
    got = {k[len("build."):]: v for k, v in outs[0].items()
           if k.startswith("build.")}
    assert int(got["ok.num_voxels"]) == n == int(p_ref.num_voxels)
    np.testing.assert_array_equal(got["ok.slot_pos"][:n],
                                  np.asarray(s_ref.slot_pos)[:n])
    np.testing.assert_array_equal(got["ok.feat_count"][:n],
                                  np.asarray(s_ref.feat_count)[:n])
    feats = got["ok.feats"].reshape(-1, 4, 32)[:n]
    np.testing.assert_allclose(feats, np.asarray(dequantized_feats(s_ref))[:n],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(feats, p_ref.feats.view(-1, 4, 32)[:n].numpy(),
                               rtol=2e-4, atol=2e-4)
    V = cfg.memory.voxel_capacity
    for o in outs:
        lo = int(o["build.base"])
        rows = o["build.slab.s.feat_count"].shape[0]
        hi = min(lo + rows, n)
        if hi <= lo:
            continue
        for f in ("slot_pos", "feat_count"):
            np.testing.assert_array_equal(
                o[f"build.slab.s.{f}"][:hi - lo],
                getattr(p_ref, f)[lo:hi].numpy(), err_msg=f)
        np.testing.assert_allclose(
            o["build.slab.s.feats"].reshape(rows, 4, 32)[:hi - lo],
            p_ref.feats.view(-1, 4, 32)[lo:hi].numpy(), rtol=2e-4, atol=2e-4)
        assert hi <= V
    # a lost all-reduce leaves the mp ranks with different tokens: the
    # build step's replica check stops it on every rank
    assert all("replicas diverged" in e.get("build.noreduce", "")
               for e in errs)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_sharded_ingest_equals_the_whole_rows(store, dtype):
    """Two batches over the same views (the second fills caches and
    replaces rows) into a store split over mp 8 and into a whole one: each
    rank's slab equals its rows of the whole store exactly, the garbage
    slot aside, and the index side is the same."""
    outs, errs, _, cfg = store
    no_errors(errs, f"si_{dtype}")
    V, K = cfg.memory.voxel_capacity, cfg.memory.cache_size
    full = 0
    for r, o in enumerate(outs):
        cnt = o[f"si_{dtype}.whole.feat_count"]
        full += int((cnt == K).sum())
        rows = cnt.shape[0]
        g = V - r * rows                  # the garbage slot's local row
        for f in FIELDS:
            a, b = o[f"si_{dtype}.shard.{f}"], o[f"si_{dtype}.whole.{f}"]
            if a.ndim and a.shape[0] in (rows, rows * K) and 0 <= g < rows:
                per = a.shape[0] // rows
                keep = np.ones(a.shape[0], bool)
                keep[g * per:(g + 1) * per] = False
                a, b = a[keep], b[keep]
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert full > 0, "no cache filled: the replacement branch was not run"


def test_replicas_checked_bitwise(store):
    """check_replicas passes on equal tokens and raises on every rank when
    one rank's tokens differ by one ulp."""
    outs, errs, *_ = store
    no_errors(errs, "replicas")
    assert [int(o["replicas.raised"]) for o in outs] == [1] * 8
    assert "replicas diverged" in errs[0]["replicas.message"]
