"""The traffic is a function of the seed: the same seed gives the same
room, frames and weights; another seed another room of the same sizes.
The patrol is made of the agent's documented actions and revisits."""

from __future__ import annotations

import math

import numpy as np
import torch

from navbench import scene
from navbench import weights as W
from navbench.tests import tiny


def test_room_by_seed():
    t = tiny.traffic()
    a, b, c = (scene.room(t, s) for s in (1, 1, 2))
    np.testing.assert_array_equal(a["boxes"], b["boxes"])
    assert a["x"] == b["x"] and a["ceiling"] == b["ceiling"]
    assert not np.array_equal(a["boxes"], c["boxes"])
    assert a["boxes"].shape == c["boxes"].shape
    lo, hi = t["ceiling_m"]
    assert lo <= a["ceiling"] <= hi


def test_patrol_is_the_documented_actions():
    t = tiny.traffic()
    bank = scene.bank_poses(t).astype(np.float64)
    acts = scene.actions(t)
    assert len(bank) == len(acts)
    assert set(acts) <= {"move_forward", "turn_left", "turn_right"}
    step = np.linalg.norm(np.diff(np.r_[bank, bank[:1]][:, :3], axis=0),
                          axis=1)
    yaw = 2 * np.arctan2(bank[:, 4], bank[:, 6])
    dyaw = np.abs(np.remainder(np.diff(np.r_[yaw, yaw[:1]]) + math.pi,
                               2 * math.pi) - math.pi)
    for a, d, r in zip(acts, step, dyaw):
        if a == "move_forward":
            assert abs(d - 0.25) < 1e-6 and r < 1e-6
        else:
            assert d < 1e-6 and abs(r - math.radians(30)) < 1e-6
    # the walk repeats the loop: every place is revisited
    n = len(bank)
    np.testing.assert_array_equal(scene.walk_pose(bank, 3),
                                  scene.walk_pose(bank, 3 + n))


def test_the_loop_stays_clear_of_the_furniture():
    t = tiny.traffic()
    bank = scene.bank_poses(t)
    for seed in range(20):
        r = scene.room(t, seed)
        for lo, hi in r["boxes"]:
            inside = ((bank[:, 0] > lo[0] - 0.1) & (bank[:, 0] < hi[0] + 0.1)
                      & (bank[:, 2] > lo[2] - 0.1)
                      & (bank[:, 2] < hi[2] + 0.1))
            assert not inside.any()
        assert r["x"][0] < bank[:, 0].min() and bank[:, 0].max() < r["x"][1]
        assert r["z"][0] < bank[:, 2].min() and bank[:, 2].max() < r["z"][1]


def test_render_by_seed():
    c, t = tiny.config(), tiny.traffic()
    s = c["sensor"]
    bank = scene.bank_poses(t)
    args = (s["height"], s["width"], s["hfov_deg"], s["sensor_height"],
            "cpu")
    r1, d1 = scene.render(bank[:4], t, 9, *args)
    r2, d2 = scene.render(bank[:4], t, 9, *args)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(d1, d2)
    # a closed room: every ray meets a surface
    assert (d1 > 0).all() and r1.std() > 10
    r4, _ = scene.render(bank[:4], t, 10, *args)
    assert not np.array_equal(r1, r4)


def test_weights_by_seed():
    c = tiny.config()
    specs = W.dinov2_specs(c["encoder"])
    a, b = W.draw(specs, 4, "cpu"), W.draw(specs, 4, "cpu")
    other = W.draw(specs, 5, "cpu")
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["blocks.0.qkv.w"], other["blocks.0.qkv.w"])
    assert abs(float(a["blocks.1.fc1.w"].std()) * 32 ** 0.5 - 1) < 0.1


def test_large_seeds():
    from navbench.drivers.memory_build import seeds
    s = seeds(2 ** 31 + 12345)
    assert s == seeds(2 ** 31 + 12345) and s != seeds(2 ** 31 + 12346)
    assert all(0 <= v < 2 ** 64 for v in s.values())
