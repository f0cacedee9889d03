"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py).

The port and the JAX package get the same numpy inputs; results come back
as numpy and are compared with a tolerance stated in each test.  The JAX
package's random draws are rebuilt from its key exactly as
``bsc_nav_tpu/memory/ingest.py`` and ``memory/pipeline.py`` make them, and
injected into the port, whose own draws come from a torch.Generator.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from bsc_nav_tpu.memory import ingest as jing


def ingest_draws(key, cfg, B):
    """(pix [B, P], repl_idx [B*P]) that ``ingest_frames(..., key, cfg)``
    draws for a batch of B frames."""
    H, W = cfg.sensor.height, cfg.sensor.width
    P = jing.points_per_frame(cfg)
    keys = jax.random.split(key, B + 1)
    pix = np.stack([np.asarray(jing._select_pixels(keys[1 + b], H, W, P))
                    for b in range(B)])
    repl = np.array(jax.random.randint(       # a writable copy, for torch
        keys[0], (B * P,), 0, cfg.memory.cache_size, dtype=jnp.int32))
    return pix, repl


def build_step_draws(key, cfg, B):
    """(next key, pix, repl_idx) of one JAX ``build_step`` call: it splits
    its carry key first and ingests with the sub-key."""
    key, sub = jax.random.split(key)
    return (key,) + ingest_draws(sub, cfg, B)


def tensors(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def store_fields_equal(jstate, tstate, cfg):
    """Assert the integer fields of a JAX store and a port store are equal,
    garbage rows excluded."""
    m = cfg.memory
    V, G = m.voxel_capacity, m.grid_size
    cut = {"slot_pos": V, "feat_count": V, "slot_map": -1,
           "cv_map": G * G, "max_height": G * G}
    for f in ("slot_pos", "feat_count", "slot_map", "cv_map", "max_height",
              "num_voxels", "dropped_voxels", "initialized"):
        a = np.asarray(getattr(jstate, f))
        b = getattr(tstate, f).cpu().numpy()
        if f in cut:
            a, b = a[:cut[f]], b[:cut[f]]
        np.testing.assert_array_equal(a, b, err_msg=f)


def assert_same_topk(pos_a, sc_a, pos_b, sc_b, atol):
    """Two top-K results agree: the same -inf padding, scores within
    ``atol``, and the same voxel set above the K-th score.  Voxels tied
    with the K-th score (within ``atol``) may differ: lax.top_k and
    torch.topk break ties differently, and a store whose voxels share
    tokens has many ties."""
    sc_a, sc_b = np.asarray(sc_a), np.asarray(sc_b)
    np.testing.assert_array_equal(np.isneginf(sc_a), np.isneginf(sc_b))
    live = np.isfinite(sc_a)
    np.testing.assert_allclose(sc_a[live], sc_b[live], atol=atol, rtol=0)
    assert np.all(np.diff(sc_a[live]) <= 0)
    kth = sc_a[live].min()

    def above(pos, sc):
        keep = live & (sc > kth + atol)
        return set(map(tuple, np.asarray(pos)[keep]))

    assert above(pos_a, sc_a) == above(pos_b, sc_b)
