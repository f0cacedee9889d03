"""Port parity: the native grid runtime (``bsc_nav_tpu_torch/
runtime_native.py`` over its copy of ``runtime/navgrid.cpp``) against the
JAX package's ``runtime_native`` and the port's numpy ``env/pathfinding``
and ``memory/frontier`` copies, on random grids (tests/test_native_
runtime.py's cases, on the port): equal distance fields, A* paths of
equal cost, equal frontier masks and component labels; the FrameQueue
round trip; a failed build raises with the compiler's message.
"""

import shutil

import numpy as np
import pytest

from bsc_nav_tpu import runtime_native as JRN
from bsc_nav_tpu_torch import runtime_native as TRN
from bsc_nav_tpu_torch.env.pathfinding import GridPathfinder
from bsc_nav_tpu_torch.memory import frontier as TFR


def make_grid(seed=0, n=48):
    rng = np.random.default_rng(seed)
    nav = np.ones((n, n), bool)
    nav[:2], nav[-2:], nav[:, :2], nav[:, -2:] = False, False, False, False
    for _ in range(n // 8):
        i, j = rng.integers(5, n - 10, 2)
        nav[i:i + 5, j:j + 5] = False
    return nav


@pytest.fixture(scope="module")
def jax_lib():
    if not JRN.available():
        pytest.skip("the JAX package's native build failed here")
    return JRN


def path_cost(cells):
    c = np.asarray(cells, float)
    return np.linalg.norm(np.diff(c, axis=0), axis=1).sum()


@pytest.mark.parametrize("seed,n", [(0, 48), (1, 64), (2, 33)])
def test_distance_field_and_astar_match(jax_lib, seed, n):
    nav = make_grid(seed, n)
    pf = GridPathfinder(nav, (0.0, 0.0), 1.0)
    grid, jgrid = TRN.NativeNavGrid(nav), jax_lib.NativeNavGrid(nav)
    field = grid.distance_field(5, 5)
    np.testing.assert_array_equal(field, jgrid.distance_field(5, 5))
    py = pf.distance_field(pf.cell_to_world(5, 5))
    np.testing.assert_allclose(np.where(np.isfinite(py), py, -1),
                               np.where(np.isfinite(field), field, -1),
                               rtol=1e-5)
    rng = np.random.default_rng(seed)
    free = np.argwhere(nav)
    for gi, gj in free[rng.choice(len(free), 4, replace=False)]:
        path = grid.astar(5, 5, int(gi), int(gj))
        np.testing.assert_array_equal(path, jgrid.astar(5, 5, int(gi),
                                                        int(gj)))
        want = pf.shortest_path(pf.cell_to_world(5, 5),
                                pf.cell_to_world(int(gi), int(gj)))
        assert (path is None) == (want is None)
        if path is not None:
            cells = [pf.world_to_cell(p) for p in want]
            np.testing.assert_allclose(path_cost(path), path_cost(cells),
                                       rtol=1e-5)
            assert tuple(path[0]) == (5, 5) and tuple(path[-1]) == (gi, gj)
            assert all(nav[i, j] for i, j in path)
            np.testing.assert_allclose(path_cost(path), field[gi, gj],
                                       rtol=1e-5)
    # a blocked or out-of-grid end: no path
    assert grid.astar(5, 5, 0, 0) is None
    assert grid.astar(5, 5, n + 3, 1) is None
    assert np.isinf(grid.distance_field(-1, 5)).all()


@pytest.mark.parametrize("seed", [3, 4])
def test_frontiers_and_labels_match(jax_lib, seed):
    rng = np.random.default_rng(seed)
    known = rng.random((40, 44)) < 0.6
    navigable = make_grid(seed, 44)[:40]
    got = TRN.NativeNavGrid.frontiers(known, navigable)
    np.testing.assert_array_equal(
        got, jax_lib.NativeNavGrid.frontiers(known, navigable))
    np.testing.assert_array_equal(got, TFR.find_frontiers(known, navigable))
    for conn in (4, 8):
        labels, n = TRN.NativeNavGrid.label(known, connectivity=conn)
        jl, jn = jax_lib.NativeNavGrid.label(known, connectivity=conn)
        np.testing.assert_array_equal(labels, jl)
        assert n == jn and labels.max() == n - 1
        assert (labels[~known] == -1).all()
    with pytest.raises(ValueError, match="differ"):
        TRN.NativeNavGrid.frontiers(known, navigable[:-1])


def test_frame_queue_roundtrip():
    q = TRN.FrameQueue(capacity=4, h=8, w=6)
    rng = np.random.default_rng(0)
    frames = []
    for _ in range(3):
        rgb = rng.integers(0, 255, (8, 6, 4), dtype=np.uint8)
        depth = rng.uniform(0, 5, (8, 6)).astype(np.float32)
        pose = rng.normal(size=7).astype(np.float32)
        assert q.push(rgb, depth, pose)
        frames.append((rgb, depth, pose))
    assert len(q) == 3
    rgb_b, depth_b, poses_b, m = q.pop_batch(8)
    assert m == 3 and len(q) == 0
    for i, (r, d, p) in enumerate(frames):
        np.testing.assert_array_equal(rgb_b[i], r[:, :, :3])
        np.testing.assert_array_equal(depth_b[i], d)
        np.testing.assert_array_equal(poses_b[i], p)
    # overflow protection, then the ring wraps
    for i in range(5):
        assert q.push(*frames[i % 3]) == (i < 4)
    _, depth_b, _, m = q.pop_batch(2)
    assert m == 2 and len(q) == 2
    assert q.push(*frames[2])
    _, depth_b, _, m = q.pop_batch(3)
    np.testing.assert_array_equal(depth_b[:3], [frames[2][1], frames[0][1],
                                                frames[2][1]])
    with pytest.raises(ValueError, match="queue holds"):
        q.push(frames[0][0][:4], frames[0][1], frames[0][2])


def test_build_raises_with_the_compiler_s_message(tmp_path, monkeypatch):
    """A source that does not compile: the build raises, naming g++'s
    error, and available() says False; nothing is built at import."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    bad = tmp_path / "navgrid.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(TRN, "SRC", bad)
    monkeypatch.setattr(TRN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TRN, "LIB_PATH", tmp_path / "build" / "lib.so")
    monkeypatch.setattr(TRN, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*\n.*error"):
        TRN.build()
    assert not TRN.available()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == []
