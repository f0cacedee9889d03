"""The port stands alone: it imports nothing of the JAX package, its copies
of the JAX-free host modules behave as the originals, and its entry points
default to the card.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bsc_nav_tpu import config as jconfig
from bsc_nav_tpu.agents.matchers import ColorViewScorer as JColorViewScorer
from bsc_nav_tpu.env.fake import BoxScene as JBoxScene
from bsc_nav_tpu.env.fake import FakeNavEnv as JFakeNavEnv
from bsc_nav_tpu.env.pathfinding import AgentState as JAgentState
from bsc_nav_tpu.env.pathfinding import Quat as JQuat
from bsc_nav_tpu import geometry as jgeometry
from bsc_nav_tpu.memory import floors as jfloors
from bsc_nav_tpu.memory import frontier as jfrontier
from bsc_nav_tpu.models import sentencepiece as jsp
from bsc_nav_tpu.models import tokenizer as jtok
from bsc_nav_tpu.models.detector import (
    ColorPrototypeDetector as JColorDetector)
from bsc_nav_tpu_torch import config as tconfig
from bsc_nav_tpu_torch.agents.matchers import ColorViewScorer
from bsc_nav_tpu_torch.agents.spatial_memory import Perception
from bsc_nav_tpu_torch.env.fake import BoxScene, FakeNavEnv
from bsc_nav_tpu_torch.env.pathfinding import AgentState, Quat
from bsc_nav_tpu_torch import geometry as tgeometry
from bsc_nav_tpu_torch.memory import floors as tfloors
from bsc_nav_tpu_torch.memory import frontier as tfrontier
from bsc_nav_tpu_torch.memory.store import init_store
from bsc_nav_tpu_torch.models import sentencepiece as tsp
from bsc_nav_tpu_torch.models import tokenizer as ttok
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.models.detector import ColorPrototypeDetector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTOTYPES = {"bed": (200, 30, 30), "plant": (30, 180, 40),
              "sofa": (40, 60, 200)}


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of bsc_nav_tpu_torch, imported in a fresh process,
    loads no jax, jaxlib or bsc_nav_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bsc_nav_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'bsc_nav_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'bsc_nav_tpu'))\n"
        "print(len(names), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 25 and bad.strip() == "[]", out.stdout


def test_port_imports_without_sklearn_or_h5py():
    """The card machine has neither: every module of the port imports with
    both blocked, and the floors copy and the npz snapshot still run."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "sys.modules['h5py'] = None\n"
        "import importlib, pkgutil, tempfile, os\n"
        "import bsc_nav_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'bsc_nav_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from bsc_nav_tpu_torch.config import small_test_config\n"
        "from bsc_nav_tpu_torch.memory import floors, persistence, store\n"
        "print(floors.detect_floors([0.0, 0.1, 3.0, 3.1, 3.05]))\n"
        "cfg = small_test_config().memory\n"
        "s = store.init_store(cfg, device='cpu')\n"
        "p = os.path.join(tempfile.mkdtemp(), 's.npz')\n"
        "persistence.save_npz(s, p)\n"
        "persistence.load_npz(p, cfg, device='cpu')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def _height_sets():
    """Seeded base-height samples: one to four floors with jitter, noise
    points, heights exactly eps apart (ties, on both of sklearn's
    neighbour algorithms: brute force up to 11 points, a KD tree beyond),
    a border point within eps of two clusters' cores, and fewer than 5
    samples."""
    rng = np.random.default_rng(0)
    sets = []
    for n_floors in (1, 2, 3, 4):
        for n in (6, 11, 12, 25, 60):
            floors = np.sort(rng.choice(np.arange(-3.0, 9.0, 2.6), n_floors,
                                        replace=False))
            h = rng.choice(floors, n) + rng.normal(0, 0.08, n)
            h[: max(1, n // 10)] = rng.uniform(-4, 10, max(1, n // 10))
            sets.append(h)
    for base in (0.0, 0.3, 1.7, -2.2):
        step = 0.4
        sets.append(base + step * np.arange(8))            # brute, chained
        sets.append(base + step * np.arange(15))           # KD tree
        sets.append(np.r_[base + np.zeros(6), base + step, base + 2 * step
                          + np.zeros(6)])                  # border at eps
        sets.append(np.r_[np.full(7, base), base + 0.4, base + 0.8,
                          np.full(7, base + 1.2)])
    sets += [np.array([1.0]), np.array([0.0, 0.4]), np.array([0.0, 0.5]),
             np.array([2.0, 2.1, 5.0, 5.39]), np.array([])]
    sets.append(np.r_[np.zeros(10), np.full(10, 0.79), [0.4]])
    # 0.0 is a border point (3 neighbours of 4 needed) within eps of a
    # core of each of two clusters: it joins the one expanded first
    a, b = np.r_[np.full(10, -0.5), -0.3], np.r_[np.full(10, 0.5), 0.3]
    sets += [np.r_[a, b, 0.0], np.r_[b, a, 0.0], np.r_[0.0, b, a]]
    return sets


def test_floors_copy_matches_jax():
    """The numpy DBSCAN of the floors copy gives sklearn's labels (the JAX
    module's), so equal floor heights and ranges, on every height set."""
    from sklearn.cluster import DBSCAN
    for i, h in enumerate(_height_sets()):
        h = list(map(float, h))
        if h:
            arr = np.asarray(h).reshape(-1, 1)
            want = DBSCAN(eps=0.4, min_samples=max(1, len(h) // 5)).fit(
                arr).labels_
            np.testing.assert_array_equal(
                tfloors.dbscan_1d(h, 0.4, max(1, len(h) // 5)), want,
                err_msg=f"set {i}")
        assert tfloors.detect_floors(h) == jfloors.detect_floors(h), i
        occ = np.random.default_rng(i).integers(0, 90, size=200)
        for agent_h in (-1.0, 0.05, 3.0, 7.5):
            assert tfloors.current_floor_range(h, agent_h, occ, 0.1) == \
                jfloors.current_floor_range(h, agent_h, occ, 0.1), (i, agent_h)
    assert tfloors.floor_ranges([0.0, 3.0, 6.0], (2, 80), 0.1) == \
        jfloors.floor_ranges([0.0, 3.0, 6.0], (2, 80), 0.1)
    assert tfloors.current_floor_range([], 1.0, np.array([]), 0.1) == \
        jfloors.current_floor_range([], 1.0, np.array([]), 0.1)


@pytest.mark.parametrize("make", ["Config", "small_test_config"])
def test_config_copy_is_field_for_field(make):
    a = getattr(jconfig, make)()
    b = getattr(tconfig, make)()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert jconfig.HM3D_DETECT_CLASSES == tconfig.HM3D_DETECT_CLASSES


def _maps(seed, n=96):
    """A known map grown from blobs of observed cells and a navigable map
    with obstacles, [n, n] bool."""
    rng = np.random.default_rng(seed)
    known = np.zeros((n, n), bool)
    for _ in range(rng.integers(1, 6)):
        r, c = rng.integers(0, n, 2)
        h, w = rng.integers(4, n // 2, 2)
        known[r:r + h, c:c + w] = True
    nav = rng.uniform(size=(n, n)) > 0.15
    nav[rng.integers(0, n, 20), :] = False
    return known, nav


@pytest.mark.parametrize("seed", range(6))
def test_frontier_copy_matches_jax(seed):
    """The frontier copy against the JAX package's: masks, clusters, the
    information-gain map and the chosen target on seeded maps (an
    exhausted map among them), and ``grid_to_world_2d``."""
    known, nav = _maps(seed)
    if seed == 5:
        known[:] = True
    np.testing.assert_array_equal(tfrontier.find_frontiers(known, nav),
                                  jfrontier.find_frontiers(known, nav))
    mask = jfrontier.find_frontiers(known, nav)
    for size in (1, 10):
        a = tfrontier.cluster_frontiers(mask, size)
        b = jfrontier.cluster_frontiers(mask, size)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tfrontier.information_gain_map(known, 5),
                                  jfrontier.information_gain_map(known, 5))
    for size, r in ((10, 5), (3, 2)):
        assert (tfrontier.select_frontier_target(known, nav, size, r)
                == jfrontier.select_frontier_target(known, nav, size, r))
    if seed == 5:
        assert tfrontier.select_frontier_target(known, nav) is None
    origin = np.array([0.3, 1.2, -2.7])
    for rc in ((10.5, 40.0), (0, 0, 3), (999.25, 17.0)):
        np.testing.assert_array_equal(
            tgeometry.grid_to_world_2d(rc, origin, 1000, 0.1),
            jgeometry.grid_to_world_2d(rc, origin, 1000, 0.1))


def test_tokenizer_copies_give_equal_ids():
    texts = ["a photo of a bed", "", "Sofa, chair & TV!"]
    for a, b in ((jtok.HashTokenizer(49408), ttok.HashTokenizer(49408)),
                 (jtok.default_tokenizer(), ttok.default_tokenizer())):
        np.testing.assert_array_equal(jtok.tokenize(texts, a),
                                      ttok.tokenize(texts, b))
        np.testing.assert_array_equal(
            jtok.tokenize(texts, a, pad_id=a.eot),
            ttok.tokenize(texts, b, pad_id=b.eot))
    pieces = [("<pad>", 0.0, jsp.CONTROL), ("</s>", 0.0, jsp.CONTROL),
              ("<unk>", 0.0, jsp.UNKNOWN), (jsp.WS, -3.0, jsp.NORMAL),
              (jsp.WS + "hello", -1.0, jsp.NORMAL), ("lo", -2.5, jsp.NORMAL),
              (jsp.WS + "hel", -2.5, jsp.NORMAL), ("o", -4.0, jsp.NORMAL)]
    assert tsp.serialize_model_proto(pieces) == jsp.serialize_model_proto(
        pieces)
    a = jsp.SentencePieceUnigram.from_model_bytes(
        jsp.serialize_model_proto(pieces))
    b = tsp.SentencePieceUnigram.from_model_bytes(
        tsp.serialize_model_proto(pieces))
    for text in ("hello hello", "helo", "xyz hello"):
        assert a.encode(text) == b.encode(text)


def test_fake_env_copy_renders_equal_frames():
    """One seed, the same actions: equal RGB-D frames and poses."""
    cfg = tconfig.small_test_config()
    envs = [(JFakeNavEnv(jconfig.small_test_config(),
                         scene=JBoxScene.default(), seed=3), JAgentState,
             JQuat),
            (FakeNavEnv(cfg, scene=BoxScene.default(), seed=3), AgentState,
             Quat)]
    frames = []
    for env, state, quat in envs:
        env.reset(init_state=state(np.zeros(3), quat.from_yaw(0.0)),
                  build_map=True)
        seq = [env.sims.get_sensor_observations(0)]
        for action in ("turn_left", "move_forward", "look_down",
                       "turn_right"):
            seq.append(env.step(action))
        frames.append((seq, env.agent_pose_vec()))
    (ja, jpose), (ta, tpose) = frames
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a["rgb"], b["rgb"])
        np.testing.assert_array_equal(a["depth"], b["depth"])
    np.testing.assert_array_equal(jpose, tpose)


def test_detector_and_scorer_copies_agree():
    env = FakeNavEnv(tconfig.small_test_config(), scene=BoxScene.default(),
                     seed=0)
    env.reset(init_state=AgentState(np.zeros(3), Quat.from_yaw(0.0)),
              build_map=True)
    views = [env.step("turn_left")["rgb"] for _ in range(12)]
    a, b = JColorDetector(PROTOTYPES, 0.5), ColorPrototypeDetector(
        PROTOTYPES, 0.5)
    for v in views:
        da, db = a.detect(v), b.detect(v)
        assert [(d.label, d.confidence, d.xyxy) for d in da] == \
            [(d.label, d.confidence, d.xyxy) for d in db]
    sa, sb = JColorViewScorer(PROTOTYPES), ColorViewScorer(PROTOTYPES)
    np.testing.assert_array_equal(sa.score(views, "a bed"),
                                  sb.score(views, "a bed"))
    assert sa.best("sofa", list(PROTOTYPES)) == sb.best("sofa",
                                                        list(PROTOTYPES))


def test_entry_points_default_to_the_card():
    """No ``device`` means the card: without one, the entry points raise
    rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = tconfig.small_test_config()
    vcfg = tv.ViTConfig(img_size=28, dim=32, depth=1, heads=2)
    with pytest.raises(RuntimeError, match="cuda"):
        Perception.create(cfg, vcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_store(cfg.memory)
    with pytest.raises(RuntimeError, match="cuda"):
        tv.init_params(vcfg, torch.Generator())
