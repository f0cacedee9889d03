"""Port parity: whole episodes of the port's robots (``agents/robot.py``
ObjectNavRobot, ``agents/eqa.py`` EQAAgent) against the JAX robots on the
drivers' fake world (``benchmarks/setup.py`` and its port
``drivers/setup.py``): objnav on the long-term and on the working-memory
path, imagenav, textnav, vlnce and eqa.

Each package builds its own world from the same argv.  The port's memory
takes the JAX encoder's weights (``models.weights.vit_from_jax_params``)
and the JAX build step's draws and world points
(``torch_parity.inject_jax_build``), so both build the same store and the
same long-term memory.  The two robots then walk the same episode in turn.

A working-memory query scores voxels by f32 cosines that the two packages
sum in different orders.  ``Queries`` holds each of the port memory's
queries to the JAX memory's same call: the same number of live voxels, the
sorted scores within ``SCORE_TOL``, each voxel found by both within
``SCORE_TOL`` of its JAX score, and a voxel found by one only within
``SCORE_TOL`` of the K-th score (the top-K boundary is the one float
decision a query takes; a store whose voxels share tokens has groups of
voxels an ulp apart there).  The JAX result is then handed on to the port
robot, as ``inject_jax_build`` hands on JAX's draws, so that everything
downstream -- the clustering, the candidates, the walk, the scans, the
judge's verdicts -- runs on equal inputs and must be equal: the actions,
``nav_log``, ``loc_hist``, the responses, the poses and the metrics.
"""

import argparse
import dataclasses

import numpy as np
import jax
import pytest

from benchmarks import setup as JS
from bsc_nav_tpu.agents.eqa import EQAAgent as JEQAAgent
from bsc_nav_tpu.agents.localize import LocalizeAgent as JLocalizeAgent
from bsc_nav_tpu.agents.robot import ObjectNavRobot as JRobot
from bsc_nav_tpu_torch.agents.eqa import EQAAgent
from bsc_nav_tpu_torch.agents.localize import LocalizeAgent
from bsc_nav_tpu_torch.agents.robot import ObjectNavRobot
from bsc_nav_tpu_torch.drivers import setup as TS
from bsc_nav_tpu_torch.models.weights import vit_from_jax_params

from torch_parity import inject_jax_build, store_fields_equal

SCORE_TOL = 1e-5        # a top-K score, port vs JAX (observed <= 2e-7)


def driver_args(parser_setup, argv):
    p = argparse.ArgumentParser()
    parser_setup.add_common_args(p)
    return p.parse_args(argv)


def carry(jmem, tmem, tcfg):
    """The port memory takes the JAX encoder's weights and its build
    step's draws and world points."""
    tmem.perception.vit_params = vit_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jmem.perception.vit_params),
        tmem.perception.vit_cfg, device="cpu")
    inject_jax_build(tmem, tcfg)


def check_topk(got, want):
    """One query's (best, positions, scores): the port's against JAX's,
    as the module docstring states.  Returns how many ranks differ."""
    _, gp, gs = got
    _, wp, ws = want
    assert len(gs) == len(ws)
    if not len(ws):
        return 0
    assert np.all(np.diff(gs) <= 0), "the port's scores are not sorted"
    np.testing.assert_allclose(np.sort(gs), np.sort(ws), atol=SCORE_TOL,
                               rtol=0)
    g = {tuple(p): s for p, s in zip(np.asarray(gp).tolist(), gs)}
    w = {tuple(p): s for p, s in zip(np.asarray(wp).tolist(), ws)}
    for p in g.keys() & w.keys():
        assert abs(g[p] - w[p]) <= SCORE_TOL, (p, g[p], w[p])
    for p in g.keys() ^ w.keys():
        s = g.get(p, w.get(p))
        assert abs(s - ws[-1]) <= SCORE_TOL, (
            f"{p} on one side only, {abs(s - ws[-1]):.2g} from the K-th "
            f"score")
    return int((np.asarray(gp) != np.asarray(wp)).any(axis=1).sum())


class Queries:
    """Records a JAX memory's query results in call order (``record``);
    holds each of a port memory's queries to the JAX one of the same call
    and hands the JAX one on (``hand_on``; see the module docstring)."""

    NAMES = ("voxel_localized", "voxel_localized_batch")

    def __init__(self):
        self.pending, self.calls, self.ranks_differ = [], 0, 0

    def record(self, jmem):
        for name in self.NAMES:
            fn = getattr(jmem, name)

            def call(*args, _fn=fn, _name=name, **kwargs):
                out = _fn(*args, **kwargs)
                self.pending.append((_name, out))
                return out
            setattr(jmem, name, call)

    def hand_on(self, tmem):
        for name in self.NAMES:
            fn = getattr(tmem, name)

            def call(*args, _fn=fn, _name=name, **kwargs):
                got = _fn(*args, **kwargs)
                assert self.pending, f"the port made a {_name} call JAX " \
                    "did not"
                jname, want = self.pending.pop(0)
                assert jname == _name
                batch = _name.endswith("batch")
                for g, w in (zip(got, want) if batch else [(got, want)]):
                    self.ranks_differ += check_topk(g, w)
                self.calls += 1
                copy = lambda r: tuple(np.array(a) for a in r)
                return [copy(w) for w in want] if batch else copy(want)
            setattr(tmem, name, call)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both packages' drivers' world (objnav), the port's carried; each
    episode also gets the vlnce instruction, the eqa question and the
    textnav attributes; the scene memory built as the drivers build it."""
    root = str(tmp_path_factory.mktemp("memory"))
    argv = ["--env", "fake", "--llm", "mock", "--memory-root", root]
    jcfg, jb, jm, jx = JS.build_world(driver_args(JS, argv), "objnav")
    tcfg, tb, tm, tx = TS.build_world(
        driver_args(TS, argv + ["--device", "cpu"]), "objnav")
    carry(jm, tm, tcfg)
    for bench in (jb, tb):
        for ep, vln, eqa in zip(bench.episodes,
                                TS.fake_episodes(tx["scene"], "vlnce", 0),
                                TS.fake_episodes(tx["scene"], "eqa", 0)):
            ep.instruction, ep.question = vln.instruction, eqa.question
            ep.intrinsic_attributes = f"a {ep.object_category}"
            ep.extrinsic_attributes = "in the corner of the room"
    jrob = JRobot(jm, jb, llm_client=jx["llm"], matcher=jx["matcher"])
    trob = ObjectNavRobot(tm, tb, llm_client=tx["llm"],
                          matcher=tx["matcher"])
    jb.reset()
    tb.reset()
    JS.ensure_memory_fake(jrob, jb)
    TS.ensure_memory_fake(trob, tb)
    queries = Queries()
    queries.record(jm)
    queries.hand_on(tm)
    return dict(j=(jcfg, jb, jm, jx), t=(tcfg, tb, tm, tx), queries=queries)


def _serial(o):
    """Episode records as plain values: poses as lists."""
    if hasattr(o, "position"):
        return (np.asarray(o.position).tolist(),
                np.asarray(o.rotation.as_array()).tolist())
    return o


def assert_same_episode(jr, tr, jb, tb):
    assert tr.action_hist == jr.action_hist
    assert tr.nav_log == jr.nav_log
    assert tr.loc_hist == jr.loc_hist
    assert tr.agent_response_log == jr.agent_response_log
    assert [_serial(s) for s in tr.state_hist] == \
        [_serial(s) for s in jr.state_hist]
    jm, tm = jb.get_metrics(), tb.get_metrics()
    np.testing.assert_array_equal(tm.pop("top_down_map"),
                                  jm.pop("top_down_map"))
    assert tm == jm


def run_both(world, episode, make, run, log_root, only_working_memory=False):
    """One episode (the bench's episode index) on both robots, JAX's
    first, each logging under ``log_root``; returns (JAX robot, port
    robot, JAX bench, port bench)."""
    robots = []
    for side, cls in zip("jt", make):
        cfg, bench, mem, extras = world[side]
        mem.cfg = cfg.replace(agent=dataclasses.replace(
            cfg.agent, use_only_working_memory=only_working_memory))
        bench._ep_idx = episode - 1
        obs = bench.reset()
        robot = cls(mem, bench, llm_client=extras["llm"],
                    matcher=extras["matcher"])
        robot.reset(obs, log_dir=str(log_root / side))
        run(robot, bench.current_episode)
        mem.cfg = cfg
        robots.append(robot)
    assert not world["queries"].pending
    return robots[0], robots[1], world["j"][1], world["t"][1]


def test_the_drivers_worlds_build_the_same_memory(world):
    jcfg, jb, jm, _ = world["j"]
    tcfg, tb, tm, _ = world["t"]
    store_fields_equal(jm.state, tm.state, tcfg)
    assert int(tm.state.num_voxels) > 300
    assert tm.long_memory_dict == jm.long_memory_dict
    assert len({o["label"] for o in tm.long_memory_dict}) >= 3
    assert tm.base_height == jm.base_height
    assert tm.step_count == jm.step_count > 0


def test_objnav_episode_long_term_memory_path(world, tmp_path):
    """Episode 0 ('bed'): stage 1 decides (no working-memory query)."""
    jr, tr, jb, tb = run_both(
        world, 0, (JRobot, ObjectNavRobot),
        lambda r, ep: r.move2textprompt(f"a {ep.object_category}"),
        tmp_path)
    assert_same_episode(jr, tr, jb, tb)
    assert tr.nav_log["long_memory_query"] >= 1
    assert tr.nav_log["working_memory_query"] == 0
    assert tb.get_metrics()["success"] == 1.0
    assert (tmp_path / "t" / "log_data.json").read_text() == \
        (tmp_path / "j" / "log_data.json").read_text()


@pytest.mark.parametrize("episode", [1, 4])
def test_objnav_episode_working_memory_path(world, episode, tmp_path):
    """use_only_working_memory: the text prompt through the scene
    imagination and the store query, the candidates clustered."""
    before = world["queries"].calls
    jr, tr, jb, tb = run_both(
        world, episode, (JRobot, ObjectNavRobot),
        lambda r, ep: r.move2textprompt(f"a {ep.object_category}"),
        tmp_path, only_working_memory=True)
    assert_same_episode(jr, tr, jb, tb)
    assert tr.nav_log["working_memory_query"] >= 1
    assert tr.nav_log["long_memory_query"] == 0
    assert world["queries"].calls == before + 1


def test_imagenav_episode(world, tmp_path):
    """A rendered view of the goal object as the prompt (the image
    query)."""
    _, _, _, jx = world["j"]
    _, _, _, tx = world["t"]
    goals = {}

    def run(robot, ep):
        extras = tx if isinstance(robot, ObjectNavRobot) else jx
        goals[robot.__class__.__module__] = img = extras["imagination"](
            ep.object_category)[0]
        robot.move2imgprompt(img)

    jr, tr, jb, tb = run_both(world, 2, (JRobot, ObjectNavRobot), run,
                              tmp_path)
    a, b = goals.values()
    np.testing.assert_array_equal(a, b)
    assert_same_episode(jr, tr, jb, tb)
    assert tr.nav_log["working_memory_query"] >= 1


def test_textnav_episode(world, tmp_path):
    """Intrinsic + extrinsic attribute texts merged by the LLM."""
    jr, tr, jb, tb = run_both(
        world, 3, (JRobot, ObjectNavRobot),
        lambda r, ep: r.move2text_attributes_prompt(
            ep.intrinsic_attributes, ep.extrinsic_attributes), tmp_path)
    assert_same_episode(jr, tr, jb, tb)
    assert tr.nav_log["working_memory_query"] >= 1


def test_vlnce_episode(world, tmp_path):
    """Subgoals -> anchors -> the growing-radius search: three radii in
    one batched store pass."""
    before = world["queries"].calls
    jr, tr, jb, tb = run_both(
        world, 0, (JRobot, ObjectNavRobot),
        lambda r, ep: r.move2VLNprompt(ep.instruction), tmp_path)
    assert_same_episode(jr, tr, jb, tb)
    assert world["queries"].calls > before
    assert tr.nav_log["search_point"] >= 1


@pytest.mark.parametrize("episode", [2, 4])
def test_eqa_episode(world, episode, tmp_path):
    """Anchor navigation, view collection, the random-walk fallback and
    the answer: the same answer, the same views kept for it."""
    answers, views = [], []

    def run(robot, ep):
        answers.append(robot.main(ep.question)[1])
        views.append(robot.obs_for_qa)

    jr, tr, jb, tb = run_both(world, episode, (JEQAAgent, EQAAgent), run,
                              tmp_path)
    assert_same_episode(jr, tr, jb, tb)
    assert answers[1] == answers[0]
    assert len(views[1]) == len(views[0]) > 0
    for a, b in zip(*views):
        np.testing.assert_array_equal(a, b)


def test_localize_agent_matches_jax(world, tmp_path):
    """LocalizeAgent's text (extended by the LLM), batched text and image
    queries: the same centres and the same top-K files."""
    outs = []
    for side, cls in (("j", JLocalizeAgent), ("t", LocalizeAgent)):
        _, _, mem, extras = world[side]
        agent = cls(mem, save_dir=str(tmp_path / side),
                    llm_client=extras["llm"])
        img = extras["imagination"]("a sofa")
        outs.append((agent.LocalizeTextPrompt("a bed"),
                     agent.LocalizeTextPrompts(["a plant", "a table",
                                                "a plant"]),
                     agent.LocalizeImagePrompt(img)))
    (jt, jts, ji), (tt, tts, ti) = outs
    for a, b in zip([jt, *jts, ji], [tt, *tts, ti]):
        np.testing.assert_array_equal(b, a)
    assert len(tt) > 0
    for f in sorted(p.name for p in (tmp_path / "j").iterdir()):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / f),
                                      np.load(tmp_path / "j" / f))
    assert not world["queries"].pending


def test_query_check_catches_a_fault(world):
    """A port query that returns another voxel set (the top-K shifted by
    one rank) or its voxels in another order must fail the hand-over's
    check."""
    _, _, jm, _ = world["j"]
    want = jm.voxel_localized("a sofa")
    world["queries"].pending.clear()
    best, pos, sc = want
    with pytest.raises(AssertionError):
        check_topk((best, pos[1:], sc[1:]), want)
    with pytest.raises(AssertionError):
        check_topk((best, np.roll(pos, 7, axis=0), sc), want)


def test_stable_top_k_orders_ties_as_lax_top_k():
    """``memory.query.stable_top_k``: lax.top_k's values and indices on
    rows with groups of equal scores and -inf padding (torch.topk orders
    such ties otherwise)."""
    import torch
    from bsc_nav_tpu_torch.memory.query import stable_top_k
    rng = np.random.default_rng(0)
    x = rng.integers(0, 6, (4, 300)).astype(np.float32) / 7
    x[:, rng.integers(0, 300, 40)] = -np.inf
    x[3] = -np.inf
    for k in (1, 16, 100, 300):
        wv, wi = jax.lax.top_k(x, k)
        gv, gi = stable_top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
