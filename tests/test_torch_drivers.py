"""Port parity: the episode drivers (``bsc_nav_tpu_torch/drivers/``) against
``benchmarks/`` on the same argv, ``--llm mock`` on the fake world, the port
on ``--device cpu``: the same CSV, byte for byte, the same EQA answers and
question metadata, the same memory bundle, the same ``metric_summ``
numbers, and the resume semantics of tests/test_drivers.py.

Each JAX driver runs once (a module fixture).  Its ``build_world`` is
wrapped so that its memory's query results are recorded; the port
driver's is wrapped so that its memory takes the JAX encoder's weights and
build draws and holds each query to the JAX one before handing the JAX one
on (``test_torch_episodes.carry`` and ``Queries``, whose docstring states
the bounds).
"""

import contextlib
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

import benchmarks.setup as JS
import bsc_nav_tpu_torch.drivers.setup as TS
from benchmarks import (create_memory as jcreate, eqa as jeqa,
                        imagenav as jimagenav, metric_summ as jsumm,
                        objnav as jobjnav, ovnav as jovnav,
                        textnav as jtextnav, vlnce as jvlnce)
from bsc_nav_tpu_torch.drivers import (
    common as TC, create_memory as tcreate, eqa as teqa,
    imagenav as timagenav, metric_summ as tsumm, objnav as tobjnav,
    ovnav as tovnav, textnav as ttextnav, vlnce as tvlnce)
from bsc_nav_tpu.agents.spatial_memory import (
    VoxelTokenMemory as JVoxelTokenMemory)
from bsc_nav_tpu_torch.agents.spatial_memory import (
    VoxelTokenMemory as TVoxelTokenMemory)
from bsc_nav_tpu_torch.memory.persistence import load_reference_format

from test_torch_episodes import Queries, carry, driver_args

ATTRS = {"bed": {"intrinsic_attributes": "a bright red bed",
                 "extrinsic_attributes": "next to the wall"}}

# name -> (JAX main, port main, the driver's argv after the common ones)
DRIVERS = {
    "objnav": (jobjnav.main, tobjnav.main, ["--episodes", "2"]),
    "ovnav": (jovnav.main, tovnav.main, ["--episodes", "1"]),
    "imagenav": (jimagenav.main, timagenav.main, ["--episodes", "1"]),
    "textnav": (jtextnav.main, ttextnav.main,
                ["--episodes", "2", "--attributes-json", "ATTRS"]),
    "vlnce": (jvlnce.main, tvlnce.main, ["--episodes", "1"]),
    "eqa": (jeqa.main, teqa.main, ["--episodes", "1", "--results-json",
                                   "RESULTS"]),
    "create_memory": (jcreate.main, tcreate.main, ["--episodes", "1"]),
}


@contextlib.contextmanager
def in_dir(path):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def argv_in(d, extra):
    """The common argv with every output under ``d``."""
    (d / "attrs.json").write_text(json.dumps(ATTRS))
    extra = [str(d / "attrs.json") if a == "ATTRS"
             else str(d / "eqa.json") if a == "RESULTS" else a
             for a in extra]
    return ["--env", "fake", "--llm", "mock", "--csv", str(d / "r.csv"),
            "--log-root", str(d / "tmp"), "--memory-root",
            str(d / "memory")] + extra


MOVES_CAP = 2           # waypoints a create_memory build walks here


def cap_exploration(mp, memory_cls, budgets):
    """``exploring_create_memory`` walks at most MOVES_CAP waypoints (the
    driver sizes the budget by the island's area, ~25 in the box world);
    ``budgets`` records the budget the driver set."""
    explore = memory_cls.exploring_create_memory

    def capped(self, save=True):
        budgets.append(self.cfg.agent.random_move_num)
        self.cfg = self.cfg.replace(agent=dataclasses.replace(
            self.cfg.agent, random_move_num=min(
                MOVES_CAP, self.cfg.agent.random_move_num)))
        return explore(self, save=save)
    mp.setattr(memory_cls, "exploring_create_memory", capped)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each JAX driver once: its output directory, its return value, the
    encoder weights of its world and its memory's query results."""
    out = {}
    for name, (jmain, _, extra) in DRIVERS.items():
        d = tmp_path_factory.mktemp(f"jax_{name}")
        queries, mems, budgets = Queries(), [], []
        build = JS.build_world

        def wrapped(args, task="objnav"):
            cfg, bench, mem, extras = build(args, task)
            queries.record(mem)
            mems.append(mem)
            return cfg, bench, mem, extras
        with pytest.MonkeyPatch.context() as mp, in_dir(d):
            mp.setattr(JS, "build_world", wrapped)
            cap_exploration(mp, JVoxelTokenMemory, budgets)
            ret = jmain(argv_in(d, extra))
        out[name] = dict(dir=d, ret=ret, queries=queries, mem=mems[0],
                         budgets=budgets)
    return out


PORT_BUILD = TS.build_world


def run_port(name, d, monkeypatch, jax_run=None, extra=None, budgets=None):
    """The port driver on the same argv (+ ``--device cpu``), exploration
    capped as in the JAX runs.  With ``jax_run``, its world is carried
    from the JAX run's and its queries are held to the JAX run's and
    handed on."""
    def wrapped(args, task="objnav"):
        cfg, bench, mem, extras = PORT_BUILD(args, task)
        if jax_run is not None:
            carry(jax_run["mem"], mem, cfg)
            jax_run["queries"].hand_on(mem)
        return cfg, bench, mem, extras
    monkeypatch.setattr(TS, "build_world", wrapped)
    cap_exploration(monkeypatch, TVoxelTokenMemory,
                    [] if budgets is None else budgets)
    with in_dir(d):
        return DRIVERS[name][1](argv_in(d, extra or DRIVERS[name][2])
                                + ["--device", "cpu"])


def assert_same_file(a, b):
    assert open(a).read() == open(b).read(), (a, b)


@pytest.mark.parametrize("name", ["objnav", "ovnav", "imagenav", "textnav",
                                  "vlnce"])
def test_driver_writes_the_jax_csv(name, jax_runs, tmp_path, monkeypatch):
    j = jax_runs[name]
    records = run_port(name, tmp_path, monkeypatch, j)
    assert not j["queries"].pending
    assert [r.metrics for r in records] == [r.metrics for r in j["ret"]]
    assert [r.episode_index for r in records] == \
        [r.episode_index for r in j["ret"]]
    assert_same_file(tmp_path / "r.csv", j["dir"] / "r.csv")
    assert os.path.exists(tmp_path / "tmp" / "trajectory_0" /
                          "log_data.json")
    if name == "textnav":
        goals = [r.metrics["object_goal"] for r in records]
        assert "a bright red bed...... next to the wall" in goals


def test_objnav_resume_and_metric_summ(jax_runs, tmp_path, monkeypatch):
    """A re-run skips the completed rows but the last (row count - 2) and
    re-runs that episode; ``metric_summ`` gives pandas' numbers."""
    j = jax_runs["objnav"]
    run_port("objnav", tmp_path, monkeypatch, j)
    csv_path = str(tmp_path / "r.csv")
    assert TC.get_start_episode(csv_path) == 1
    first = open(csv_path).read().splitlines()
    # the re-run's world is carried again (episode 1 needs no query)
    again = run_port("objnav", tmp_path, monkeypatch,
                     dict(j, queries=Queries()))
    assert [r.episode_index for r in again] == [1]
    rows = open(csv_path).read().splitlines()
    assert rows == first + first[-1:]
    for path in (csv_path, str(j["dir"] / "r.csv")):
        overall, per_cat = tsumm.compute_metrics(path)
        want, want_cat = jsumm.compute_metrics(path)
        assert overall == pytest.approx(
            {k: float(v) for k, v in want.items()}, rel=1e-15, abs=0)
        assert overall["episodes"] == want["episodes"]
        assert [c["object_goal"] for c in per_cat] == \
            list(want_cat["object_goal"])
        for col in ("success_rate", "avg_spl", "avg_distance_to_goal"):
            np.testing.assert_allclose([c[col] for c in per_cat],
                                       want_cat[col].to_numpy(), rtol=1e-15)
    assert tsumm.main([csv_path])["episodes"] == 3


def test_metric_summ_without_header_and_inf_rows(tmp_path):
    """Header-less rows (the reference's COLUMNS), an inf distance
    dropped, an empty cell skipped as pandas skips NaN."""
    rows = ["1.0,0.5,1.25,bed,s,0,9.0,1,0,1",
            "0.0,0.0,inf,bed,s,0,9.0,0,1,1",
            "1.0,,0.75,sofa,s,0,9.0,1,0,1",
            "0.0,0.0,3.5,sofa,s,0,9.0,0,2,2"]
    path = tmp_path / "m.csv"
    path.write_text("\n".join(rows) + "\n")
    got, got_cat = tsumm.compute_metrics(str(path), has_header=False)
    want, want_cat = jsumm.compute_metrics(str(path), has_header=False)
    assert got == pytest.approx({k: float(v) for k, v in want.items()})
    assert got["episodes"] == want["episodes"] == 3
    assert [c["avg_spl"] for c in got_cat] == pytest.approx(
        list(want_cat["avg_spl"]))


def test_eqa_driver_matches_jax_and_resumes(jax_runs, tmp_path,
                                            monkeypatch):
    j = jax_runs["eqa"]
    results = run_port("eqa", tmp_path, monkeypatch, j)
    assert not j["queries"].pending
    assert results == j["ret"]
    for f in ("r.csv", "eqa.json", "eqa_questions_meta.json"):
        assert_same_file(tmp_path / f, j["dir"] / f)
    assert results[0]["answer_4o"] in (
        f"It is {results[0].get('ground_truth')}.",
        "I cannot see it from here.")
    # resume: the finished question is not re-run
    assert run_port("eqa", tmp_path, monkeypatch) == results
    assert_same_file(tmp_path / "r.csv", j["dir"] / "r.csv")


def test_create_memory_driver_matches_jax(jax_runs, tmp_path, monkeypatch):
    """The same bundle path and files, and the parts that do not rest on
    the build's random pixel draws equal: the long-term memory (the
    detector on the same frames), the origin, the mapping heights and the
    map's height range.  The store's rows rest on each package's draws
    (test_torch_episodes builds the same store with JAX's draws injected);
    here both hold the same number of voxels."""
    j = jax_runs["create_memory"]
    budgets = []
    (path,) = run_port("create_memory", tmp_path, monkeypatch,
                       budgets=budgets)
    (jpath,) = j["ret"]
    assert budgets == j["budgets"] and budgets[0] > MOVES_CAP
    assert os.path.relpath(path, tmp_path) == os.path.relpath(jpath, j["dir"])
    assert sorted(os.listdir(path)) == sorted(os.listdir(jpath))
    assert_same_file(os.path.join(path, "long_memory.json"),
                     os.path.join(jpath, "long_memory.json"))
    for f in ("original_pos.npy", "base_height.npy", "map_height.npy",
              "max_id.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(path, f)),
                                      np.load(os.path.join(jpath, f)))
    cfg = TS.fake_config(driver_args(TS, ["--device", "cpu"]))
    store, meta = load_reference_format(path, cfg.memory, device="cpu")
    assert int(store.num_voxels) == int(np.load(os.path.join(jpath,
                                                             "max_id.npy")))
    assert len(meta["long_memory"]) > 0
    assert run_port("create_memory", tmp_path, monkeypatch) == set()


def test_create_memory_eqa_pose_seeded(tmp_path, monkeypatch):
    """The EQA variant: the build starts from the first frame's pose of
    each episode directory, one bundle per scene (tests/test_drivers.py's
    case, on the port)."""
    frames = tmp_path / "frames" / "hm3d-v0"
    ep_dir = frames / "00123-hm3d-abcd1234-q0"
    ep_dir.mkdir(parents=True)
    seed_pos = [0.8, 0.0, -0.6]
    with open(ep_dir / "00000.pkl", "wb") as f:
        pickle.dump({"agent_state": {"position": seed_pos,
                                     "rotation": [0, 0, 0, 1]}}, f)
    extra = ["--task", "eqa", "--eqa-frames-root", str(frames)]
    budgets = []
    (path,) = run_port("create_memory", tmp_path, monkeypatch, extra=extra,
                       budgets=budgets)
    assert budgets[0] > MOVES_CAP
    assert path.endswith(os.path.join("eqa", "abcd1234"))
    assert os.path.exists(os.path.join(path, "feat.h5df"))
    np.testing.assert_allclose(
        np.load(os.path.join(path, "original_pos.npy")), seed_pos, atol=1e-6)
    assert run_port("create_memory", tmp_path, monkeypatch,
                    extra=extra) == set()


def test_build_world_refuses_what_is_not_ported(tmp_path):
    """What the drivers refuse, as the JAX drivers do: --env habitat where
    habitat-sim is not installed raises ImportError naming it, and --llm
    local without --weights-dir raises.  --detector grounding-dino (now
    ported) is not refused on the fake world: there, as in the JAX driver,
    the colour detector serves whatever the flag says."""
    for extra, what, err in (
            (["--env", "habitat"], "habitat-sim", ImportError),
            (["--llm", "local"], "weights-dir", ValueError)):
        with pytest.raises(err, match=what):
            with in_dir(tmp_path):
                tobjnav.main(argv_in(tmp_path, ["--episodes", "1"] + extra)
                             + ["--device", "cpu"])
    dets = []
    for mod, extra in ((JS, []), (TS, ["--device", "cpu"])):
        p = __import__("argparse").ArgumentParser()
        mod.add_common_args(p)
        args = p.parse_args(argv_in(tmp_path, ["--detector",
                                               "grounding-dino"]) + extra)
        dets.append(mod.build_world(args, task="objnav")[2].detector)
    assert [type(d).__name__ for d in dets] == ["ColorPrototypeDetector"] * 2
    assert dets[0].prototypes.keys() == dets[1].prototypes.keys()
    for raw in ("clip,llm,diffusion", "none", " encoder , clip ", ""):
        args = type("A", (), {"int8": raw})()
        assert TS._int8_set(args) == JS._int8_set(args)
