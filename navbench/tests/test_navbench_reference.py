"""The plain references against the program at tiny sizes on the CPU:
the same weights, frames and draws give the same answers."""

from __future__ import annotations

import pytest
import torch

from navbench import scene
from navbench import weights as W
from navbench.drivers import memory_build as MB
from navbench.reference import dinov2
from navbench.reference.voxel_memory import VoxelMemory
from navbench.tests import tiny


@pytest.fixture(scope="module")
def cell():
    c, t = tiny.config(), tiny.traffic()
    s = c["sensor"]
    poses = scene.bank_poses(t)
    rgb, depth = scene.render(poses, t, 5, s["height"], s["width"],
                              s["hfov_deg"], s["sensor_height"], "cpu")
    return c, t, poses, rgb, depth


@pytest.mark.parametrize("gelu_exact", [True, False])
def test_dinov2_patch_tokens(cell, gelu_exact):
    from bsc_nav_tpu_torch.memory.pipeline import encode_patch_grid
    from bsc_nav_tpu_torch.models import vit
    c, _, _, rgb, _ = cell
    e = dict(c["encoder"], gelu_exact=gelu_exact)
    w = W.draw(W.dinov2_specs(e), 1, "cpu")
    m = vit.ViT(MB.vit_config(e), device="cpu")
    m.load_state_dict(w, strict=True)
    cfg = MB.program_config(c, 0, False)
    frames = torch.from_numpy(rgb[:4])
    got = encode_patch_grid(m, frames, m.cfg, cfg, torch.float32)
    want = dinov2.patch_grid(w, e, c["query"]["query_width"], frames)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("capacity", [65536, 300])
def test_voxel_memory_against_ingest(cell, capacity):
    """The same tokens and draws: stores equal voxel by voxel, rows
    bit-equal, but for points a float rounding moves across a cell edge;
    with a small capacity the store fills and drops points alike.  The
    reference with its geometry in TF32 (the control) moves points across
    edges: its voxels come out off."""
    from bsc_nav_tpu_torch.memory.ingest import ingest_frames
    from bsc_nav_tpu_torch.memory.store import init_store
    c, t, poses, rgb, depth = cell
    c = dict(c, memory=dict(c["memory"], voxel_capacity=capacity))
    cfg = MB.program_config(c, 11, False)
    state = init_store(cfg.memory, device="cpu")
    gen = torch.Generator().manual_seed(11)
    vm = VoxelMemory(c["memory"], c["sensor"], 11, "cpu", edge_m=1e-5)
    vt = VoxelMemory(c["memory"], c["sensor"], 11, "cpu", tf32=True)
    tok_gen = torch.Generator().manual_seed(3)
    B = c["batch"]
    walk = MB.Walk(rgb, depth, poses)
    for f in range(8):                      # the loop and 3 flushes again
        idx, p = walk.flush(f, B)
        toks = torch.randn(B, 2, 2, c["memory"]["token_dim"],
                           generator=tok_gen)
        ingest_frames(state, torch.from_numpy(rgb[idx]),
                      torch.from_numpy(depth[idx]), torch.from_numpy(p),
                      toks, gen, cfg)
        vm.ingest(rgb[idx], depth[idx], p, toks.numpy())
        vt.ingest(rgb[idx], depth[idx], p, toks.numpy())
    info = {}
    c = dict(c, limits={"rows_off": 0.01, "voxels_off": 0.0},
             check={"row_gap": 0.0})
    rows = MB.compare_rows(c, state, MB.program_store(c, state), vm, info)
    voxels = MB.compare_voxels(c, MB.program_store(c, state), vm, info)
    assert info["rows_compared"] > 1000 and vm.replaced > 0
    assert info["row_gap_max"] == 0.0 and info["voxels_compared"] > 250
    assert rows.ok and voxels.ok, info
    tf32 = MB.compare_voxels(c, MB.reference_store(vt), vm, {})
    assert tf32.value > 0.01, tf32
    if capacity < 1000:
        assert vm.dropped > 0 and info["voxels_program"] == capacity
    else:
        assert vm.dropped == 0 and info["voxels_program"] > 300
