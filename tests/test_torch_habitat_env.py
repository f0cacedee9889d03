"""Port parity: env/habitat_env.py (bsc_nav_tpu/env/habitat_env.py) over the
in-memory habitat-sim double (tests/mock_habitat.py).

Each host class is driven through the JAX habitat test's scenarios on both
sides and must give the same record: sensor specs and actions, placement,
island snapping and planning, the episode metrics, the simulator facade and
the scene switch.  ``build_habitat_world`` is held to the JAX test's
assertions on the port's modules, cut to the fake world's size on the CPU
(``torch_worlds.small_habitat``: Config() would build ViT-L and a 5.4 GB
store on the CPU), with the patch detector's absence, Grounding DINO from a
weights directory, and the drivers' flags: ``--env habitat`` without
habitat-sim raises ImportError naming it, the readiness check builds the
habitat world where habitat-sim, scenes and episodes are there.
"""

import importlib.machinery
import math

import numpy as np
import pytest
import torch

import mock_habitat
import torch_worlds as W
from bsc_nav_tpu import config as jconfig
from bsc_nav_tpu.env import habitat_env as JH
from bsc_nav_tpu.env import pathfinding as jpf
from bsc_nav_tpu_torch import config as tconfig
from bsc_nav_tpu_torch.drivers import objnav as tobjnav
from bsc_nav_tpu_torch.drivers import setup as TS
from bsc_nav_tpu_torch.env import habitat_env as TH
from bsc_nav_tpu_torch.env import pathfinding as tpf

SIDES = {"jax": (JH, jconfig, jpf), "port": (TH, tconfig, tpf)}


@pytest.fixture
def hs_mock():
    hs = mock_habitat.install()
    yield hs
    mock_habitat.uninstall()


def _episode(start, goal, yaw=0.0, scene="s.glb"):
    class Ep:
        pass
    ep = Ep()
    ep.start_position = np.asarray(start, np.float32)
    ep.start_yaw = yaw
    ep.goal_positions = [np.asarray(goal, np.float32)]
    ep.scene_id = scene
    ep.object_category = "chair"
    return ep


def _state(nav):
    st = nav.agent.get_state()
    return (np.round(np.asarray(st.position, np.float64), 6).tolist(),
            round(st.rotation.yaw(), 6))


def _make_cfg(H, C, P):
    nav = H.HabitatNavEnv(C.Config(sensor=C.SensorConfig(width=32,
                                                          height=24)),
                          scene_path="scenes/test.glb")
    agent_cfg = nav.sims.config.agents[0]
    return ([(s.uuid, s.sensor_type, s.resolution, s.position,
              s.orientation) for s in agent_cfg.sensor_specifications],
            {k: a.actuation.amount for k, a in
             agent_cfg.action_space.items()},
            nav.sims.config.sim_cfg.scene_id)


def _place(H, C, P):
    init = P.AgentState(np.array([1.0, 0.0, 2.0]), P.Quat.from_yaw(
        math.pi / 2))
    nav = H.HabitatNavEnv(C.Config(), "s.glb", init_state=init,
                          build_map=True)
    out = [_state(nav)]
    nav.reset(init_state=init, build_map=False)
    out.append(_state(nav))
    nav.reset()
    out += [_state(nav), np.asarray(nav.original_state.position).tolist()]
    return out


def _snap(H, C, P):
    nav = H.HabitatNavEnv(C.Config(sensor=C.SensorConfig(width=32,
                                                          height=24)),
                          scene_path="scenes/test.glb")
    goal = np.array([25.0, 0.0, 3.0], np.float32)
    path, g = nav.move2point(goal)
    _, g2 = nav.move2point(np.array([0.5, 0.0, 0.5], np.float32))
    return (nav.get_navigable_point_near(goal).tolist(), path,
            np.asarray(g).tolist(), np.asarray(g2).tolist())


def _episode_success(H, C, P):
    nav = H.HabitatNavEnv(C.Config(), "s.glb")
    bench = H.HabitatEpisodeBenchmarkEnv(
        nav, [_episode([0, 0, 0], [0, 0, -1.0])], success_distance=0.8)
    obs = bench.reset()
    out = [sorted(obs), _state(nav)]
    for a in ("move_forward", "move_forward"):
        bench.step(a)
    out += [bench.episode_over, bench.get_metrics()]
    bench.step("stop")
    return out + [bench.episode_over, bench.get_metrics()]


def _episode_failure(H, C, P):
    nav = H.HabitatNavEnv(C.Config(), "s.glb")
    bench = H.HabitatEpisodeBenchmarkEnv(
        nav, [_episode([0, 0, 0], [0, 0, -1.0])], success_distance=0.3)
    bench.reset()
    out = []
    for a in ["move_forward"] * 3 + ["turn_left"] * 6 + ["move_forward"] * 4:
        bench.step(a)
        out.append(bench.get_metrics())
    bench.step("stop")
    out.append(bench.get_metrics())
    bench.reset()
    return out + [bench.get_metrics(), bench.episode_over]


def _facade(H, C, P):
    nav = H.HabitatNavEnv(C.Config(), "s.glb")
    bench = H.HabitatEpisodeBenchmarkEnv(nav, [_episode([0, 0, 0],
                                                        [1, 0, 0])])
    obs = bench.sim.get_sensor_observations(0)
    return (bench.sim.pathfinder is nav.sims.pathfinder,
            bench.sim.agents[0] is nav.agent, obs["rgb"].shape,
            bench.nav_env is nav)


def _scene_change(H, C, P):
    nav = H.HabitatNavEnv(C.Config(), "scenes/a.glb")
    eps = [_episode([0, 0, 0], [1, 0, 0], scene="a.glb"),
           _episode([0, 0, 0], [1, 0, 0], scene="b.glb")]
    bench = H.HabitatEpisodeBenchmarkEnv(nav, eps, scene_prefix="scenes")
    out = []
    for _ in range(3):
        bench.reset()
        out.append((getattr(nav.sims, "reconfigure_calls", 0),
                    getattr(nav.sims, "recompute_calls", 0),
                    getattr(nav.sims.pathfinder, "scene_id", None),
                    getattr(nav.sims.pathfinder, "recomputed_with", None),
                    nav.plnner.pathfinder is nav.sims.pathfinder))
    return out


@pytest.mark.parametrize("scenario", [
    _make_cfg, _place, _snap, _episode_success, _episode_failure, _facade,
    _scene_change], ids=lambda f: f.__name__.strip("_"))
def test_host_classes_match_jax(hs_mock, scenario):
    """HabitatNavEnv, HabitatEpisodeBenchmarkEnv and the simulator facade
    through the JAX habitat test's scenarios: the same record on both
    sides (positions to 1e-6 m)."""
    want = scenario(*SIDES["jax"])
    got = scenario(*SIDES["port"])
    assert repr(got) == repr(want)


def test_build_habitat_world_factory(hs_mock, monkeypatch, tmp_path):
    """The JAX factory test's assertions on the port (cut to the fake
    world's size): two episodes parsed, reset, the first episode's goal,
    a memory build step (excute, flush), a judge; no weights directory
    means no matcher or detector; --detector grounding-dino without
    --weights-dir raises ValueError."""
    W.small_habitat(monkeypatch)
    args = W.habitat_args(tmp_path)
    cfg, bench, memory, extras = TH.build_habitat_world(args, task="objnav")
    assert len(bench.episodes) == 2
    obs = bench.reset()
    assert "rgb" in obs and "depth" in obs
    assert bench.current_episode.object_category == "sofa"
    assert memory.Env is bench.nav_env
    assert memory.perception.compute_dtype == torch.bfloat16
    memory.excute(obs, ["turn_left", "move_forward"])
    memory.flush()
    assert int(memory.state.num_voxels) > 0
    assert extras["llm"] is not None
    assert memory.detector is None and extras["matcher"] is None
    # the published widths outside the cut: Config()'s detector, agent
    assert cfg.detector == tconfig.Config().detector
    args.detector = "grounding-dino"
    with pytest.raises(ValueError, match="grounding-dino"):
        TH.build_habitat_world(args, task="objnav")


def test_habitat_world_with_grounding_dino(hs_mock, monkeypatch, tmp_path):
    """--env habitat --detector grounding-dino on a weights directory
    (grounding_dino_tiny.npz of a tiny config, the synthetic vocab.txt):
    the memory's long-term detector is Grounding DINO over the 21 HM3D
    classes at the config's confidence, its weights the file's, and a
    flush at confidence 0 feeds the long-term memory."""
    from bsc_nav_tpu_torch.models import grounding_dino as TG
    from bsc_nav_tpu_torch.models.weights import flatten_params

    W.small_habitat(monkeypatch, detector_cfg=W.GDINO_TINY)
    want = W.write_gdino_dir(str(tmp_path))
    args = W.habitat_args(tmp_path, weights_dir=str(tmp_path),
                          detector="grounding-dino")
    cfg, bench, memory, _ = TS.build_world(args, task="objnav")
    det = memory.detector
    assert isinstance(det, TG.GroundingDinoDetector)
    assert det.classes == list(tconfig.HM3D_DETECT_CLASSES)
    assert det.confidence == cfg.detector.confidence
    assert det.image_size == 800 and det.device.type == "cpu"
    got = flatten_params(det.params)
    for k, v in flatten_params(want).items():
        np.testing.assert_array_equal(got[k], v)
    det.confidence = 0.0
    obs = bench.reset()
    memory.excute(obs, ["turn_left", "move_forward"])
    memory.flush()
    labels = {o["label"] for o in memory.long_memory_dict}
    assert labels and labels <= set(tconfig.HM3D_DETECT_CLASSES)


def test_env_habitat_without_habitat_sim_raises(tmp_path):
    """``objnav --env habitat`` where habitat-sim is not installed raises
    ImportError naming it, as the JAX driver does; the module itself
    imports without it."""
    with pytest.raises(ImportError, match="habitat-sim"):
        tobjnav.main(["--env", "habitat", "--episodes", "1", "--device",
                      "cpu", "--csv", str(tmp_path / "r.csv"),
                      "--log-root", str(tmp_path),
                      "--memory-root", str(tmp_path)])


def test_readiness_check_builds_the_habitat_world(hs_mock, monkeypatch,
                                                  tmp_path, capsys):
    """With habitat-sim importable and --scene-prefix / --episode-prefix
    given, the readiness check builds and resets the habitat world (JAX
    ``benchmarks/setup.py:424-439``) and reports the goal distance; a
    failing build is a red row."""
    monkeypatch.setattr(hs_mock, "__spec__",
                        importlib.machinery.ModuleSpec("habitat_sim", None))
    W.small_habitat(monkeypatch)
    rec = type("R", (), {"metrics": {"success": 1.0, "spl": 1.0}})
    monkeypatch.setattr(tobjnav, "main", lambda argv: [rec])
    split = W.habitat_split(str(tmp_path))
    (tmp_path / "a.glb").touch()                  # the first episode's scene
    argv = ["--check", "--device", "cpu", "--scene-prefix", str(tmp_path),
            "--episode-prefix", split, "--memory-root", str(tmp_path)]
    assert TS.main(argv) == 0
    out = capsys.readouterr().out
    assert "[ok     ] habitat_sim importable" in out
    assert ("[ok     ] habitat world builds + resets -- "
            "distance_to_goal=1.00") in out
    assert "READY" in out and "NOT READY" not in out
    monkeypatch.setattr(TS, "habitat_config", None)
    assert TS.main(argv) == 1
    assert "[MISSING] habitat world builds + resets -- TypeError" in (
        capsys.readouterr().out)
