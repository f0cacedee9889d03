"""Port parity: the navigation demo (``bsc_nav_tpu_torch/demo.py``) against
the JAX package's root ``demo.py`` on the drivers' fake world, ``--llm
mock``, the port on ``--device cpu``.

``localize`` (two goals, batched) and ``category`` run through both
``main``s on the same argv.  As in tests/test_torch_drivers.py, the port's
world is carried from JAX's (the encoder's weights, the build step's draws
and world points) and each of its queries is held to JAX's same call within
``SCORE_TOL`` (``test_torch_episodes.Queries``) before JAX's result is handed
on.  Then the printed lines, the saved top-K ``.npy`` files, the robot's
``log_data.json`` must be equal, and the top-down PNG must decode to the JAX
memory's cv_map (the JAX package draws it as a matplotlib figure).
``text``, ``image`` (a PNG goal) and a scripted interactive session are
held to the port's own robot driven directly, and the interactive session's
printed poses and saved view to JAX's (its view written by PIL).
"""

import builtins
import json
import os

import numpy as np
import pytest
from PIL import Image

import benchmarks.setup as JS
import bsc_nav_tpu_torch.drivers.setup as TS
import demo as jdemo
from bsc_nav_tpu_torch import demo as tdemo
from bsc_nav_tpu_torch.agents.llm import decode_png
from bsc_nav_tpu_torch.agents.robot import ObjectNavRobot
from bsc_nav_tpu_torch.utils.visualize import read_rgb_png

from test_torch_drivers import in_dir
from test_torch_episodes import Queries, carry, driver_args

JAX_BUILD, PORT_BUILD = JS.build_world, TS.build_world
SCRIPT = ["w", "a", "w", "d", "u", "save", "j", "nope", "w", "save", "q"]


def argv(d, mode, *extra):
    return ["--env", "fake", "--llm", "mock", "--nav-mode", mode,
            "--log-root", str(d / "logs"), "--memory-root", str(d / "mem"),
            "--out-dir", str(d / "out"), *extra]


def lines(text, d):
    """Printed lines with the run's directory taken out."""
    return text.replace(str(d), "<d>").splitlines()


def scripted(monkeypatch, script):
    cmds = iter(script)

    def fake_input(prompt=""):
        try:
            return next(cmds)
        except StopIteration:
            raise EOFError from None
    monkeypatch.setattr(builtins, "input", fake_input)


def run_jax(d, mode, monkeypatch, capsys, *extra):
    """JAX's demo.main; returns (printed lines, its memory, its recorded
    queries)."""
    queries, mems = Queries(), []

    def wrapped(args, task="objnav"):
        cfg, bench, mem, extras = JAX_BUILD(args, task)
        queries.record(mem)
        mems.append(mem)
        return cfg, bench, mem, extras
    capsys.readouterr()
    with monkeypatch.context() as mp, in_dir(d):
        mp.setattr(jdemo.S, "build_world", wrapped)
        jdemo.main(argv(d, mode, *extra))
    return lines(capsys.readouterr().out, d), mems[0], queries


def run_port(d, mode, monkeypatch, capsys, *extra, jax_run=None):
    """The port's demo.main on ``--device cpu``; with ``jax_run`` its world
    is carried from JAX's and its queries held to JAX's and handed on.
    Returns (printed lines, its memory)."""
    mems = []

    def wrapped(args, task="objnav"):
        cfg, bench, mem, extras = PORT_BUILD(args, task)
        if jax_run is not None:
            carry(jax_run[1], mem, cfg)
            jax_run[2].hand_on(mem)
        mems.append(mem)
        return cfg, bench, mem, extras
    capsys.readouterr()
    with monkeypatch.context() as mp, in_dir(d):
        mp.setattr(TS, "build_world", wrapped)
        tdemo.main(argv(d, mode, *extra) + ["--device", "cpu"])
    return lines(capsys.readouterr().out, d), mems[0]


def assert_topdown_is_the_cv_map(path, jmem, grid_size):
    img = decode_png(open(path, "rb").read())
    s = img.shape[0] // grid_size
    want = np.asarray(jmem.state.cv_map)[:grid_size * grid_size].reshape(
        grid_size, grid_size, 3)
    assert img.shape == (grid_size * s, grid_size * s, 3) and s >= 1
    np.testing.assert_array_equal(img[::s, ::s], want)
    np.testing.assert_array_equal(
        img, np.repeat(np.repeat(want, s, 0), s, 1))


@pytest.mark.parametrize("mode,goal", [("localize", "bed,sofa"),
                                       ("category", "bed")])
def test_demo_matches_jax(mode, goal, tmp_path, monkeypatch, capsys):
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    j = run_jax(jd, mode, monkeypatch, capsys, "--goal", goal)
    got, tmem = run_port(td, mode, monkeypatch, capsys, "--goal", goal,
                         jax_run=j)
    jlines, jmem, queries = j
    assert not queries.pending and queries.calls >= (mode == "localize")
    assert got == jlines
    assert got[0].startswith("memory built: ") and \
        int(tmem.state.num_voxels) == int(jmem.state.num_voxels)
    out, jout = td / "out", jd / "out"
    if mode == "localize":
        names = [f"best_pos_topK_text_prompt_{i}_{g}.npy"
                 for i, g in enumerate(goal.split(","))]
        for n in names:
            np.testing.assert_array_equal(np.load(out / n),
                                          np.load(jout / n))
        assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
        for i, g in enumerate(goal.split(",")):
            img = decode_png(open(out / f"localize_{i}_{g}.png",
                                  "rb").read())
            assert img.shape == (880, 1100, 3)
            assert (img == (255, 0, 0)).all(-1).sum() > 0
    else:
        assert json.load(open(out / "log_data.json")) == \
            json.load(open(jout / "log_data.json"))
        assert any(line.startswith("video write skipped") for line in got) \
            or os.path.exists(out / "navigation.mp4")
    assert_topdown_is_the_cv_map(out / "topdown.png", jmem,
                                 tmem.cfg.memory.grid_size)


def port_world(d):
    """The port's fake world, memory built, as demo.main builds it."""
    a = driver_args(TS, ["--env", "fake", "--llm", "mock", "--device", "cpu",
                         "--memory-root", str(d / "mem2")])
    cfg, bench, mem, extras = PORT_BUILD(a, task="objnav")
    obs = bench.reset()
    TS.build_memory_fake(mem, bench)
    robot = ObjectNavRobot(mem, bench, llm_client=extras["llm"],
                           matcher=extras["matcher"])
    robot.reset(obs, log_dir=str(d / "direct"))
    return bench, robot, extras


def test_text_and_image_modes_drive_the_robot(tmp_path, monkeypatch,
                                              capsys):
    """``text`` and ``image`` (a PNG goal written by PIL) give the printed
    result and log of the port's robot driven directly; a goal image that
    is not a PNG raises."""
    goal_png = tmp_path / "goal.png"
    for mode, extra, run in (
            ("text", ["--goal", "the red bed"],
             lambda r, x: r.move2NaturalLanguageprompt("the red bed")),
            ("image", ["--goal-image", str(goal_png)],
             lambda r, x: r.move2imgprompt(
                 np.asarray(Image.open(goal_png).convert("RGB"))))):
        if mode == "image":
            view = port_world(tmp_path)[2]["imagination"]("a sofa")[0]
            Image.fromarray(np.dstack([view, np.full(view.shape[:2], 200,
                                                     np.uint8)])).save(
                goal_png)               # RGBA: the alpha is dropped
        d = tmp_path / mode
        d.mkdir()
        got, _ = run_port(d, mode, monkeypatch, capsys, *extra)
        bench, robot, extras = port_world(d)
        run(robot, extras)
        m = bench.get_metrics()
        assert [line for line in got if line.startswith("done:")] == [(
            f"done: success={m['success']} spl={m['spl']:.3f} "
            f"distance={m['distance_to_goal']:.2f} "
            f"steps={len(robot.action_hist)}")]
        assert json.load(open(d / "out" / "log_data.json")) == \
            json.load(open(d / "direct" / "log_data.json"))
    Image.open(goal_png).convert("RGB").save(tmp_path / "goal.jpg")
    with pytest.raises(ValueError, match="PNG"):
        read_rgb_png(str(tmp_path / "goal.jpg"))


def test_interactive_session_matches_jax(tmp_path, monkeypatch, capsys):
    """A scripted session (moves, looks, an unknown command, two saves):
    the printed poses equal JAX's, and each saved view decodes to the
    pixels JAX's PIL wrote."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    scripted(monkeypatch, SCRIPT)
    jlines, _, _ = run_jax(jd, "interactive", monkeypatch, capsys)
    scripted(monkeypatch, SCRIPT)
    got, _ = run_port(td, "interactive", monkeypatch, capsys)
    assert got == jlines
    assert sum(line.startswith("pos=") for line in got) == 7
    assert "unknown command" in got
    saved = sorted(n for n in os.listdir(td / "out") if n.startswith("view"))
    assert saved == ["view_5.png", "view_7.png"]
    for n in saved:
        np.testing.assert_array_equal(
            decode_png(open(td / "out" / n, "rb").read()),
            np.asarray(Image.open(jd / "out" / n)))
