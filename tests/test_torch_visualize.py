"""Port parity: the headless renderers (``bsc_nav_tpu_torch/utils/
visualize.py``) against the JAX package's ``utils/visualize.py``.

``TrajectoryDrawer`` is a numpy copy: its frames must equal JAX's bit for
bit.  The PNG renderers draw without matplotlib (the card machine has none):
the top-down PNG must decode to the cv_map itself, the point cloud must draw
the voxels JAX's subsample draws (the same indices) and put a known voxel,
highlight and cluster centre on the pixels reckoned here from the stated
projection, and the heat map's colour table must be matplotlib's
``inferno``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from matplotlib import colormaps
from matplotlib.colors import Normalize

from bsc_nav_tpu.config import small_test_config as jsmall
from bsc_nav_tpu.memory.store import init_store as jinit_store
from bsc_nav_tpu.utils import visualize as JV
from bsc_nav_tpu_torch.agents.llm import decode_png
from bsc_nav_tpu_torch.config import small_test_config
from bsc_nav_tpu_torch.memory.store import init_store
from bsc_nav_tpu_torch.utils import visualize as TV


def stores(n, seed=0):
    """A JAX store and a port store holding the same n voxels (positions,
    colours) and the same random cv_map."""
    jcfg, cfg = jsmall(), small_test_config()
    rng = np.random.default_rng(seed)
    G = cfg.memory.grid_size
    pos = rng.integers(0, G, size=(n, 3)).astype(np.int32)
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    cv = rng.integers(0, 256, (G * G + 1, 3), dtype=np.uint8)
    js = jinit_store(jcfg.memory)
    js = js.replace(num_voxels=jnp.asarray(n, jnp.int32),
                    slot_pos=js.slot_pos.at[:n].set(jnp.asarray(pos)),
                    rgb_sum=js.rgb_sum.at[:n].set(jnp.asarray(rgb)),
                    weight=js.weight.at[:n].set(1.0),
                    cv_map=jnp.asarray(cv))
    ts = init_store(cfg.memory, device="cpu")
    ts.num_voxels.fill_(n)
    ts.slot_pos[:n] = torch.from_numpy(pos)
    ts.rgb_sum[:n] = torch.from_numpy(rgb)
    ts.weight[:n] = 1.0
    ts.cv_map.copy_(torch.from_numpy(cv))
    return jcfg, cfg, js, ts, pos


def test_trajectory_drawer_frames_equal_jax():
    jcfg, cfg, js, ts, _ = stores(10)
    rng = np.random.default_rng(1)
    origin = np.array([0.3, 0.0, -0.2])
    jd = JV.TrajectoryDrawer(js, jcfg, origin)
    td = TV.TrajectoryDrawer(ts, cfg, torch.from_numpy(origin))
    G, cell = cfg.memory.grid_size, cfg.memory.cell_size
    for _ in range(12):
        # poses on and past the map's edge
        pos = origin + rng.uniform(-0.7, 0.7, 3) * G * cell
        yaw = float(rng.uniform(-np.pi, np.pi))
        np.testing.assert_array_equal(td.step(pos, yaw), jd.step(pos, yaw))
    np.testing.assert_array_equal(td.base_map, jd.base_map)


def test_topdown_png_is_the_cv_map(tmp_path):
    _, cfg, _, ts, _ = stores(3)
    G = cfg.memory.grid_size
    path = TV.render_topdown_png(ts, str(tmp_path / "td.png"), G)
    img = decode_png(open(path, "rb").read())
    s = max(1, TV.TOPDOWN_SIDE // G)
    want = ts.cv_map[:G * G].numpy().reshape(G, G, 3)
    assert img.shape == (G * s, G * s, 3)
    np.testing.assert_array_equal(img[::s, ::s], want)
    np.testing.assert_array_equal(img, np.repeat(np.repeat(want, s, 0), s,
                                                 1))


def test_pointcloud_subsample_is_jax_s(tmp_path, monkeypatch):
    """Past max_points both draw the same voxels: the JAX figure's first
    scatter (the cloud) gets the (col, row, h) the port keeps."""
    from mpl_toolkits.mplot3d import Axes3D
    _, _, js, ts, pos = stores(300, seed=2)
    drawn = []
    scatter = Axes3D.scatter

    def spy(self, xs, ys, zs=0, *a, **k):
        drawn.append(np.stack([np.asarray(xs), np.asarray(ys),
                               np.asarray(zs)], 1))
        return scatter(self, xs, ys, zs, *a, **k)
    monkeypatch.setattr(Axes3D, "scatter", spy)
    JV.render_pointcloud_png(js, str(tmp_path / "j.png"), max_points=40)
    kept = []
    project = TV.project

    def spy_project(points, *a, **k):
        kept.append(np.asarray(points))
        return project(points, *a, **k)
    monkeypatch.setattr(TV, "project", spy_project)
    TV.render_pointcloud_png(ts, str(tmp_path / "t.png"), max_points=40)
    assert len(drawn[0]) == 40
    np.testing.assert_array_equal(kept[0], drawn[0])
    sel = np.random.default_rng(0).choice(300, 40, replace=False)
    np.testing.assert_array_equal(kept[0], pos[sel][:, [1, 0, 2]])


def reckon(p, lo, hi, elev, azim):
    """The stated projection, reckoned here: the data box to a centred
    4:4:3 box, the eye at (elev, azim), orthographic, fitted into the
    image less the margin (by the box's corners)."""
    H, W = TV.POINTCLOUD_SIZE
    e, a = np.radians(elev), np.radians(azim)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.array([-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a),
                   np.cos(e)])
    box = np.array([4.0, 4.0, 3.0])
    q = (np.asarray(p, float) - lo) / np.maximum(hi - lo, 1) * box - box / 2
    corners = np.array([[x, y, z] for x in (-2, 2) for y in (-2, 2)
                        for z in (-1.5, 1.5)])
    s = min((W - 2 * TV.MARGIN) / np.ptp(corners @ right),
            (H - 2 * TV.MARGIN) / np.ptp(corners @ up))
    return (int(np.floor(H / 2 - q @ up * s + 0.5)),
            int(np.floor(W / 2 + q @ right * s + 0.5)))


@pytest.mark.parametrize("elev,azim", [(55.0, -60.0), (20.0, 30.0)])
def test_pointcloud_pixels_land_where_reckoned(tmp_path, elev, azim):
    """A voxel in its own colour at the data box's corner nearest the eye
    (no voxel can cover it), a highlight (red, drawn over the cloud) in
    the middle and a cluster centre (lime with a black edge, drawn last)
    at the far corner."""
    _, _, _, ts, pos = stores(200, seed=3)
    G = small_test_config().memory.grid_size
    e, a = np.radians(elev), np.radians(azim)
    eye = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    near = np.where(eye > 0, G - 1, 0)              # (col, row, h)
    ts.slot_pos[0] = torch.tensor(near[[1, 0, 2]], dtype=torch.int32)
    ts.rgb_sum[0] = torch.tensor([1.0, 2.0, 3.0])
    hl = np.array([[G // 2, G // 2, G // 2]])
    ce = (G - 1 - near)[None, [1, 0, 2]]
    path = TV.render_pointcloud_png(ts, str(tmp_path / "pc.png"),
                                    highlight=hl, centers=ce, elev=elev,
                                    azim=azim)
    img = decode_png(open(path, "rb").read())
    assert img.shape == TV.POINTCLOUD_SIZE + (3,)
    allp = np.concatenate([ts.slot_pos[:200].numpy(), hl, ce])[:, [1, 0, 2]]
    lo, hi = allp.min(0).astype(float), allp.max(0).astype(float)
    r, c = reckon(near, lo, hi, elev, azim)
    assert tuple(img[r, c]) == (1, 2, 3)
    r, c = reckon(hl[0][[1, 0, 2]], lo, hi, elev, azim)
    assert tuple(img[r, c]) == TV.HIGHLIGHT_COLOR
    r, c = reckon(ce[0][[1, 0, 2]], lo, hi, elev, azim)
    assert tuple(img[r, c]) == TV.CENTER_COLOR
    assert tuple(img[r - TV.CENTER_RADIUS, c]) == TV.EDGE_COLOR
    assert tuple(img[0, 0]) == (TV.BACKGROUND,) * 3


def test_inferno_is_matplotlib_s(tmp_path):
    np.testing.assert_array_equal(TV.INFERNO,
                                  np.asarray(colormaps["inferno"].colors))
    x = np.random.default_rng(4).normal(size=(6, 9))
    want = colormaps["inferno"](Normalize()(x), bytes=True)[..., :3]
    np.testing.assert_array_equal(TV.inferno(x), want)
    q = np.full((56, 56, 3), 200, np.uint8)
    ref = np.zeros((28, 42, 4), np.uint8)
    path = TV.render_token_matching(q, ref, x, str(tmp_path / "m.png"))
    img = decode_png(open(path, "rb").read())
    g = TV.PANEL_GAP
    assert img.shape == (56, 56 + g + 84 + g + 84, 3)
    np.testing.assert_array_equal(img[:, :56], q)
    np.testing.assert_array_equal(img[:, 56 + g:56 + g + 84], 0)
    np.testing.assert_array_equal(                  # nearest-neighbour
        img[:, -84:], want[(np.arange(56) * 6) // 56][:, (np.arange(84) * 9)
                                                      // 84])


def test_open3d_view_is_gated():
    import importlib.util
    if importlib.util.find_spec("open3d") is not None:
        pytest.skip("open3d is installed here")
    _, _, _, ts, _ = stores(3)
    with pytest.raises(ImportError, match="open3d"):
        TV.open3d_view(ts)
