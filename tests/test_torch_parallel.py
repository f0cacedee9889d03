"""The port's tensor parallelism (``bsc_nav_tpu_torch/parallel/mesh.py``,
the TP attention, the ``tp_mesh`` forwards of the ViT and the MMDiT)
against the JAX package's, case by case after ``tests/test_multichip.py``.

The JAX side runs in this process on conftest's 8 virtual CPU devices; the
port's side runs as 4 rank processes on a 2 x 2 gloo mesh, all of its
cases in one start (``torch_parallel_worker.py``, suite "tp").  Each rank
holds only its shards; its dp slice of the result comes back and is held,
at JAX's tolerances, to JAX's tensor-parallel result and to the port's
whole forward: 2e-5 for the attention (``test_multichip.py:81``), 2e-4 for
the forwards.  The ViT's layer scales are 1 and its biases random, and the
MMDiT's adaLN linears are filled, so that a fault in a block reaches the
output: a lost all-reduce in the first block and a row-parallel bias added
on every rank must fail those tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from bsc_nav_tpu.models import mmdit as JM
from bsc_nav_tpu.models import vit as JV
from bsc_nav_tpu.ops import flash_attention as JFA
from bsc_nav_tpu.parallel import mesh as JMESH
from bsc_nav_tpu_torch.models import mmdit as TM
from bsc_nav_tpu_torch.models import vit as TV
from bsc_nav_tpu_torch.models.weights import (flatten_params,
                                              mmdit_from_jax_params,
                                              vit_from_jax_params)
from bsc_nav_tpu_torch.ops import flash_attention as TFA
from bsc_nav_tpu_torch.parallel import mesh as TMESH

from torch_parallel_worker import run_suite
from torch_parity import fill_zero_mods, numpy_tree

ATTN_TOL = 2e-5
FWD_TOL = 2e-4
VIT_CFG = dict(img_size=28, patch_size=14, dim=256, depth=2, heads=4,
               num_registers=2)
MMDIT_CFGS = {
    "mm256": JM.MMDiTConfig(input_size=8, patch_size=2, in_channels=4,
                            dim=256, depth=2, heads=4, context_dim=32,
                            pooled_dim=16),
    "mmtest": JM.MMDIT_TEST,
    "mmdual": JM.MMDIT_TEST_DUAL,
}


def vit_params(cfg, seed):
    """JAX ViT params with layer scales 1 and random biases (numpy)."""
    p = numpy_tree(JV.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for blk in p["blocks"]:
        blk["ls1"][:] = 1.0
        blk["ls2"][:] = 1.0
        for k in ("qkv", "proj", "fc1", "fc2"):
            blk[k]["b"] = (rng.normal(size=blk[k]["b"].shape) * 0.5
                           ).astype(np.float32)
    return p


def assert_close(a, b, tol, what):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def gathered(outs, key, dp, mp):
    """The whole batch of a dp-split, mp-replicated result: the ranks of
    one dp row must agree to the bit (the all-reduce gives every rank the
    same sum)."""
    rows = []
    for d in range(dp):
        part = [outs[d * mp + m][key] for m in range(mp)]
        for m in range(1, mp):
            np.testing.assert_array_equal(part[m], part[0], err_msg=key)
        rows.append(part[0])
    return np.concatenate(rows)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """JAX's references, then one start of the 4 port ranks."""
    rng = np.random.default_rng(0)
    jmesh = JMESH.make_mesh(dp=2, mp=2)
    arrays, meta, ref = {}, {"mmdit_prefixes": list(MMDIT_CFGS)}, {}

    # attention_from_qkv_tp: B 2, S 12, 4 heads x 64
    qkv = rng.normal(size=(2, 12, 3 * 256)).astype(np.float32)
    arrays["attn.qkv"], meta["attn"] = qkv, {"heads": 4}
    perm = JFA.qkv_tp_permutation(256, 2)
    ref["attn.jax_tp"] = np.asarray(JFA.attention_from_qkv_tp(
        jax.device_put(jnp.asarray(qkv[..., perm]),
                       NamedSharding(jmesh, P("dp", None, "mp"))),
        heads=4, mesh=jmesh))
    ref["attn.port"] = TFA.attention_from_qkv(torch.from_numpy(qkv),
                                              4).numpy()

    # the ViT
    jcfg = JV.ViTConfig(**VIT_CFG)
    vp = vit_params(jcfg, 0)
    x = rng.normal(size=(4, 28, 28, 3)).astype(np.float32)
    arrays.update({f"p.vit.{k}": v for k, v in flatten_params(vp).items()})
    arrays["vit.x"], meta["vit"] = x, VIT_CFG
    sp = JMESH.shard_vit_params(jax.tree.map(jnp.asarray, vp), jmesh,
                                tp_qkv_layout=True)
    with jmesh:
        ref["vit.jax_tp"] = np.asarray(jax.jit(
            lambda p, x: JV.forward_features(p, x, jcfg, tp_mesh=jmesh)[
                "x_norm_patchtokens"])(sp, jnp.asarray(x)))
    ref["vit.port"] = vit_from_jax_params(
        vp, TV.ViTConfig(**VIT_CFG), device="cpu").forward_features(
        torch.from_numpy(x))["x_norm_patchtokens"].numpy()

    # the MMDiTs: B 4, split over dp
    for i, (name, cfg) in enumerate(MMDIT_CFGS.items()):
        mp = numpy_tree(fill_zero_mods(JM.init_params(
            cfg, jax.random.PRNGKey(i)), 10 + i))
        B = 4
        args = {"lat": rng.normal(size=(B, 8, 8, 4)),
                "t": np.full((B,), 0.4),
                "ctx": rng.normal(size=(B, 5, cfg.context_dim)),
                "pool": rng.normal(size=(B, cfg.pooled_dim))}
        args = {k: v.astype(np.float32) for k, v in args.items()}
        arrays.update({f"{name}.{k}": v for k, v in args.items()})
        arrays.update({f"p.{name}.{k}": v for k, v in
                       flatten_params(mp).items()})
        meta[name] = dataclasses.asdict(cfg)
        jargs = [jnp.asarray(args[k]) for k in ("lat", "t", "ctx", "pool")]
        smp = JMESH.shard_mmdit_params(jax.tree.map(jnp.asarray, mp), jmesh)
        with jmesh:
            ref[f"{name}.jax_tp"] = np.asarray(jax.jit(
                lambda p, a: JM.forward(p, a[0], a[1], a[2], a[3], cfg,
                                        tp_mesh=jmesh))(smp, jargs))
        tcfg = TM.MMDiTConfig(**dataclasses.asdict(cfg))
        ref[f"{name}.port"] = TM.forward(
            mmdit_from_jax_params(mp, tcfg, device="cpu"),
            *(torch.from_numpy(args[k]) for k in ("lat", "t", "ctx", "pool")),
            tcfg).numpy()

    # the joint attention: 4 heads x 64, B 2, Sx 40, Sc 9
    D = 256
    jq = {"qkv_x": rng.normal(size=(2, 40, 3 * D)),
          "qkv_c": rng.normal(size=(2, 9, 3 * D)),
          "gq": rng.normal(size=64) * 0.1 + 1, "gk": rng.normal(size=64) * 0.1 + 1}
    jq = {k: v.astype(np.float32) for k, v in jq.items()}
    arrays.update({f"joint.{k}": v for k, v in jq.items()})
    meta["joint"] = {"heads": 4}
    sh = NamedSharding(jmesh, P("dp", None, "mp"))
    ax, ac = (jax.device_put(jnp.asarray(jq[k][..., perm]), sh)
              for k in ("qkv_x", "qkv_c"))
    g = [jnp.asarray(jq["gq"]), jnp.asarray(jq["gk"])]
    with jmesh:
        ref["joint.gammas.jax_tp"] = np.asarray(JFA.joint_qkv_attention_tp(
            ax, ac, 4, g[0], g[1], g[0], g[1], mesh=jmesh))
        ref["joint.none.jax_tp"] = np.asarray(JFA.joint_qkv_attention_tp(
            ax, ac, 4, None, None, None, None, mesh=jmesh))
    t = {k: torch.from_numpy(v) for k, v in jq.items()}
    ref["joint.gammas.port"] = TFA.joint_qkv_reference(
        t["qkv_x"], t["qkv_c"], 4, t["gq"], t["gk"], t["gq"], t["gk"]).numpy()
    ref["joint.none.port"] = TFA.joint_qkv_reference(
        t["qkv_x"], t["qkv_c"], 4, None, None, None, None).numpy()

    outs, errs = run_suite("tp", 4, tmp_path_factory.mktemp("tp"), arrays,
                           meta)
    return outs, errs, ref


def no_errors(errs, *cases):
    for r, e in enumerate(errs):
        for c in cases:
            assert c not in e, f"rank {r}, case {c}:\n{e[c]}"


def test_mesh_construction_and_the_wrong_world(tp):
    outs, errs, _ = tp
    coords = sorted(tuple(o["mesh.coords"]) for o in outs)
    assert coords == [(d, m, 2, 2) for d in range(2) for m in range(2)]
    for o, e in zip(outs, errs):
        assert "mesh.wrong_world_raised" in o, e.get("mesh.wrong_world")
        assert "need 3 ranks" in e["mesh.wrong_world_message"]


def test_ranks_import_no_jax(tp):
    _, errs, _ = tp
    assert [e["jax_imported"] for e in errs] == [False] * 4


def test_qkv_tp_permutation_matches_jax():
    for dim, mp in ((8, 2), (256, 2), (64, 4), (1536, 2), (96, 3)):
        np.testing.assert_array_equal(TFA.qkv_tp_permutation(dim, mp),
                                      JFA.qkv_tp_permutation(dim, mp))
    with pytest.raises(ValueError):
        TFA.qkv_tp_permutation(10, 4)


def test_leaf_shapes_match_jax_shards():
    """Each rank's leaf shapes are JAX's shard shapes (``test_multichip.py``
    ``test_vit_param_tp_sharding``, every block leaf), for the ViT at 2 x 4
    and the MMDiT at 1 x 2."""
    jmesh = JMESH.make_mesh(dp=2, mp=4)
    jcfg = JV.ViTConfig(img_size=28, patch_size=14, dim=64, depth=2, heads=4,
                        num_registers=1)
    params = JV.init_params(jcfg, jax.random.PRNGKey(0))
    jsh = JMESH.shard_vit_params(params, jmesh, tp_qkv_layout=True)
    model = vit_from_jax_params(numpy_tree(params), TV.ViTConfig(
        **dataclasses.asdict(jcfg)), device="cpu")
    for m in range(4):
        tmesh = TMESH.Mesh(dp=2, mp=4, d=0, m=m)
        tsh = TMESH.shard_vit_params(model, tmesh, tp_qkv_layout=True)
        for i, blk in enumerate(tsh.blocks):
            for k in ("qkv", "proj", "fc1", "fc2"):
                for leaf in ("w", "b"):
                    shards = {s.data.shape for s in
                              jsh["blocks"][i][k][leaf].addressable_shards}
                    assert shards == {tuple(getattr(getattr(blk, k),
                                                    leaf).shape)}, (i, k, leaf)
    assert {s.data.shape for s in
            jsh["blocks"][0]["qkv"]["w"].addressable_shards} == {(64, 48)}

    jmesh2 = JMESH.make_mesh(dp=1, mp=2)
    mparams = JM.init_params(JM.MMDIT_TEST_DUAL, jax.random.PRNGKey(1))
    jm = JMESH.shard_mmdit_params(mparams, jmesh2)
    tm = TMESH.shard_mmdit_params(
        mmdit_from_jax_params(numpy_tree(mparams), TM.MMDIT_TEST_DUAL,
                              device="cpu"),
        TMESH.Mesh(dp=1, mp=2, m=1))
    jflat = jax.tree_util.tree_flatten_with_path(jm)[0]
    for path, leaf in jflat:
        node = tm
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert {s.data.shape for s in leaf.addressable_shards} == {
            tuple(node.shape)}, path


def test_int8_params_are_refused_under_tp():
    """JAX's ``shard_mmdit_params`` would permute an int8 leaf's bias but
    not its weight; the port refuses quantized leaves in both layouts."""
    mesh = TMESH.Mesh(dp=1, mp=2)
    gen = torch.Generator().manual_seed(0)
    model = TV.init_params(TV.ViTConfig(img_size=28, patch_size=14, dim=64,
                                        depth=1, heads=2), gen, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        TMESH.shard_vit_params(TV.quantize_params(model), mesh,
                               tp_qkv_layout=True)
    params = TM.init_params(TM.MMDIT_TEST, gen, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        TMESH.shard_mmdit_params(TM.quantize_params(params), mesh)


def test_attention_from_qkv_tp_matches_jax(tp):
    """Per rank, heads/mp heads of its dp rows; assembled, the whole
    attention (JAX's shard_map TP and the port's plain version)."""
    outs, errs, ref = tp
    no_errors(errs, "attn")
    rows = [np.concatenate([outs[d * 2 + m]["attn.out"] for m in range(2)],
                           axis=-1) for d in range(2)]
    got = np.concatenate(rows)
    assert_close(got, ref["attn.jax_tp"], ATTN_TOL, "against JAX TP")
    assert_close(got, ref["attn.port"], ATTN_TOL, "against the port whole")


@pytest.mark.parametrize("path", ["tp", "gather", "plain"])
def test_vit_forward_tp_matches_jax(tp, path):
    """The head-blocked forward with tp_mesh ("tp"), the same shards
    without it ("gather": qkv all-gathered and unpermuted), and the
    [q | k | v] layout ("plain": gathered)."""
    outs, errs, ref = tp
    no_errors(errs, "vit")
    got = gathered(outs, f"vit.{path}", 2, 2)
    assert_close(got, ref["vit.jax_tp"], FWD_TOL, "against JAX TP")
    assert_close(got, ref["vit.port"], FWD_TOL, "against the port whole")


@pytest.mark.parametrize("fault", ["noreduce", "bias"])
def test_vit_tp_negative_controls(tp, fault):
    """A lost all-reduce in block 0's proj, or fc2's bias on every rank,
    must fail the 2e-4 the forward is held to."""
    outs, errs, ref = tp
    no_errors(errs, "vit")
    got = np.concatenate([outs[d * 2][f"vit.{fault}"] for d in range(2)])
    with pytest.raises(AssertionError):
        assert_close(got, ref["vit.jax_tp"], FWD_TOL, fault)


@pytest.mark.parametrize("name", list(MMDIT_CFGS))
def test_mmdit_tp_matches_jax(tp, name):
    """The MMDiT at mp 2 (B 4 over dp 2): per-rank joint attention with
    tp_mesh, and the same shards gathered without it, against JAX's TP
    forward and the port's whole one; a lost all-reduce fails."""
    outs, errs, ref = tp
    no_errors(errs, name)
    for path in ("tp", "gather"):
        got = gathered(outs, f"{name}.{path}", 2, 2)
        assert_close(got, ref[f"{name}.jax_tp"], FWD_TOL, path)
        assert_close(got, ref[f"{name}.port"], FWD_TOL, path)
    bad = np.concatenate([outs[d * 2][f"{name}.noreduce"] for d in range(2)])
    with pytest.raises(AssertionError):
        assert_close(bad, ref[f"{name}.jax_tp"], FWD_TOL, "noreduce")


@pytest.mark.parametrize("norm", ["gammas", "none"])
def test_joint_qkv_attention_tp_matches_jax(tp, norm):
    """joint_qkv_attention_tp per rank with the replicated gammas, and
    without them (the composed path), against JAX's and the reference."""
    outs, errs, ref = tp
    no_errors(errs, "joint")
    got = np.concatenate([np.concatenate(
        [outs[d * 2 + m][f"joint.{norm}"] for m in range(2)], axis=-1)
        for d in range(2)])
    assert_close(got, ref[f"joint.{norm}.jax_tp"], ATTN_TOL, "JAX TP")
    assert_close(got, ref[f"joint.{norm}.port"], ATTN_TOL, "reference")
