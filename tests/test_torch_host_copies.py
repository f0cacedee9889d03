"""The port stands alone: it imports nothing of the JAX package, its copies
of the JAX-free host modules behave as the originals, and its entry points
default to the card.
"""

import argparse
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
from bsc_nav_tpu_torch.drivers import setup as drivers_setup
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


def test_port_imports_without_sklearn_or_h5py(tmp_path):
    """The card machine has none of sklearn, h5py, PIL, pandas, imageio,
    networkx, transformers, tokenizers, regex, matplotlib, cv2 and open3d,
    and neither machine has habitat-sim: every module of the port
    (env/habitat_env, the demos, utils/visualize among them) imports with
    all twelve, habitat_sim and magnum (and jax and bsc_nav_tpu) blocked,
    habitat_env asking for habitat-sim raises ImportError naming it, the
    floors copy and the npz snapshot still run, so does one fake objnav
    episode through the port's driver on the CPU (its VLM judge calls pack
    PNG images), the demo's localize mode (its PNG renders) and the
    detection demo's colour path, and the local judge loads from a
    directory (its own BPE and PNG reader) and answers a chat with a PNG
    view.  The parallel package imports so too, and the two ranks of a
    dry run (``dryrun_all(2)`` on the CPU), each with the same modules
    blocked, run and import none of them."""
    import torch_parity as TP
    judge = tmp_path / "judge"
    judge.mkdir()
    TP.write_tiny_judge(str(judge))
    block = (
        "import sys\n"
        "for m in ('sklearn', 'h5py', 'PIL', 'pandas', 'imageio', "
        "'networkx', 'transformers', 'tokenizers', 'regex', 'matplotlib', "
        "'cv2', 'open3d', 'jax', 'bsc_nav_tpu', 'habitat_sim', 'magnum'):\n"
        "    sys.modules[m] = None\n")
    bad = (
        "bad = sorted(k for k in sys.modules if sys.modules[k] is not None\n"
        "             and k.split('.')[0] in ('jax', 'bsc_nav_tpu', 'PIL',\n"
        "                                     'transformers', 'tokenizers',\n"
        "                                     'regex', 'habitat_sim',\n"
        "                                     'matplotlib', 'cv2', 'open3d',\n"
        "                                     'imageio'))\n"
        "assert not bad, bad\n")
    rank = (block + "from bsc_nav_tpu_torch.parallel.dryrun import "
            "dryrun_all\nimport torch.distributed as dist\n"
            "dryrun_all(2, device='cpu')\n" + bad
            + "dist.destroy_process_group()\n")
    code = (
        block +
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
        "from bsc_nav_tpu_torch.drivers import objnav\n"
        "d = tempfile.mkdtemp()\n"
        "recs = objnav.main(['--env', 'fake', '--episodes', '1', '--llm', "
        "'mock', '--device', 'cpu', '--csv', os.path.join(d, 'r.csv'), "
        "'--log-root', d, '--memory-root', d])\n"
        "assert len(recs) == 1 and recs[0].metrics['search_point'] >= 1\n"
        "from bsc_nav_tpu_torch import demo, demo_detect\n"
        "demo.main(['--env', 'fake', '--llm', 'mock', '--device', 'cpu', "
        "'--nav-mode', 'localize', '--goal', 'bed,sofa', '--log-root', d, "
        "'--memory-root', d, '--out-dir', os.path.join(d, 'demo')])\n"
        "assert sorted(os.listdir(os.path.join(d, 'demo')))[-1] == "
        "'topdown.png'\n"
        "assert demo_detect.main(['--device', 'cpu', '--out', "
        "os.path.join(d, 'a.png')])\n"
        "import dataclasses\n"
        "import numpy as np\n"
        "from bsc_nav_tpu_torch.agents import llm, local_vlm\n"
        "from bsc_nav_tpu_torch.models import qwen_vl as Q\n"
        "from bsc_nav_tpu_torch.models.qwen_tokenizer import QwenTokenizer\n"
        f"d = {str(judge)!r}\n"
        "tok = QwenTokenizer.from_file(os.path.join(d, 'tokenizer.json'))\n"
        "cfg = Q.QwenVLConfig(\n"
        "    text=dataclasses.replace(Q.QWEN_VL_TEST.text,\n"
        "                             vocab=tok.vocab_size),\n"
        "    vision=dataclasses.replace(Q.QWEN_VL_TEST.vision, patch=14,\n"
        "                               window=112),\n"
        "    image_token_id=tok.image_pad_id,\n"
        "    vision_start_token_id=tok.convert_tokens_to_ids(\n"
        "        '<|vision_start|>'), tie_word_embeddings=False)\n"
        "client = local_vlm.load_local_vlm(d, cfg, device='cpu',\n"
        "                                  max_new_tokens=4, quantize=True)\n"
        "view = np.zeros((64, 64, 3), np.uint8)\n"
        "out = llm.succeed_determine_singleview(client, 'a bed', [view])\n"
        "assert isinstance(out, str) and client.last['images'] == 1\n"
        "from bsc_nav_tpu_torch.env import habitat_env\n"
        "try:\n"
        "    habitat_env._require_habitat()\n"
        "    raise SystemExit('habitat_sim imported')\n"
        "except ImportError as e:\n"
        "    assert 'habitat-sim' in str(e)\n"
        "from bsc_nav_tpu_torch.parallel import (dryrun, launch, mesh,\n"
        "                                        sharded_query)\n"
        "launch.spawn(lambda r: [sys.executable, '-c', "
        f"{rank!r}], 2, tempfile.mkdtemp(), 240)\n"
        + bad +
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
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


def test_wordpiece_copy_gives_equal_tokens(tmp_path):
    """models/wordpiece.py against the original: tests/test_wordpiece.py's
    vocabulary and prompts, the 21 HM3D classes' prompt on the synthetic
    BERT vocabulary, and seeded strings over letters, accents, CJK,
    punctuation, controls and whitespace: equal tokens and ids;
    classes_to_prompt equal."""
    from bsc_nav_tpu.models import wordpiece as jwp
    from bsc_nav_tpu_torch.models import wordpiece as twp
    from test_wordpiece import VOCAB
    from torch_worlds import write_vocab

    small = tmp_path / "small.txt"
    small.write_text("\n".join(VOCAB) + "\n")
    bert = write_vocab(str(tmp_path / "vocab.txt"), size=30522)
    rng = np.random.default_rng(0)
    alphabet = list("abcxyz ABC.,?!-'\t\n") + ["\u00e9", "\u00c9", "\u4e2d",
                                                "\u00a0", "\x00", "\u200b",
                                                "\ufffd", "\u2014"]
    hm3d = twp.classes_to_prompt(tconfig.HM3D_DETECT_CLASSES)
    texts = ["sofa. chair. potted plant. television.",
             "Refrigerator, washing machine?  coffee TABLE ... nightstand",
             "the\tweird   spacing\nand CAFÉ accents",
             "unsplittablewordzzz", "a" * 120, hm3d]
    texts += ["".join(rng.choice(alphabet, size=int(rng.integers(1, 40))))
              for _ in range(200)]
    for path in (str(small), bert):
        a = jwp.WordPieceTokenizer.from_vocab_file(path)
        b = twp.WordPieceTokenizer.from_vocab_file(path)
        for text in texts:
            assert a.tokenize(text) == b.tokenize(text), text
            assert a.encode(text) == b.encode(text), text
            assert (a.encode(text, add_special=False)
                    == b.encode(text, add_special=False)), text
    ids = twp.WordPieceTokenizer.from_vocab_file(bert).encode(hm3d)
    assert ids[0] == 101 and ids[-1] == 102 and 100 not in ids
    classes = list(tconfig.HM3D_DETECT_CLASSES) + [" Potted Plant. "]
    assert jwp.classes_to_prompt(classes) == twp.classes_to_prompt(classes)
    assert jwp.basic_tokenize("Ünïcode 中文!", False) == twp.basic_tokenize(
        "Ünïcode 中文!", False)


def test_habitat_config_copy_matches_jax():
    """drivers/setup.habitat_config against benchmarks/setup.py's, field
    for field, on the flags' int8 sets and options."""
    import benchmarks.setup as JS
    for int8, wm, single in (("clip,llm,diffusion", False, False),
                             ("none", True, False), (" encoder , clip ", False,
                                                     True), ("", True, True)):
        args = argparse.Namespace(
            memory_root="/m", weights_dir="/w", int8=int8,
            use_only_working_memory=wm, load_single_floor=single)
        a, b = JS.habitat_config(args), drivers_setup.habitat_config(args)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_navgrid_source_copy_is_byte_equal():
    """The native grid runtime builds from the port's own copy of
    runtime/navgrid.cpp, held byte for byte."""
    from bsc_nav_tpu_torch import runtime_native
    with open(os.path.join(REPO, "runtime", "navgrid.cpp"), "rb") as f:
        want = f.read()
    with open(runtime_native.SRC, "rb") as f:
        assert f.read() == want


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
    p = argparse.ArgumentParser()
    drivers_setup.add_common_args(p)
    args = p.parse_args(["--env", "fake"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        drivers_setup.build_world(args)


@pytest.mark.parametrize("topdown", ["fog", "vlnce"])
def test_benchmark_env_copy_matches_jax(topdown):
    """The env/benchmark and env/vlnce_maps copies: the same episodes, and
    over one action sequence equal frames, metrics and top-down maps (the
    fog-of-war measure, or the VLN-CE one over its sampled connectivity
    graph)."""
    from bsc_nav_tpu.env import benchmark as jbench
    from bsc_nav_tpu_torch.env import benchmark as tbench
    envs = []
    for mod, conf, scene in ((jbench, jconfig, JBoxScene),
                             (tbench, tconfig, BoxScene)):
        eps = mod.episodes_for_scene(scene.default(), seed=2)
        envs.append(mod.FakeBenchmarkEnv(conf.small_test_config(), eps,
                                         scene=scene.default(), seed=3,
                                         topdown=topdown))
    (ja, ta) = envs
    for a, b in zip(ja.episodes, ta.episodes):
        assert (a.object_category, a.start_yaw) == (b.object_category,
                                                    b.start_yaw)
        np.testing.assert_array_equal(a.goal_positions, b.goal_positions)
    actions = (["move_forward"] * 5 + ["turn_left"] * 3 + ["move_forward"] * 4
               + ["look_down", "turn_right", "stop"])
    for ep in range(2):
        np.testing.assert_array_equal(ja.reset()["rgb"], ta.reset()["rgb"])
        for action in actions[ep:]:
            a, b = ja.step(action), ta.step(action)
            np.testing.assert_array_equal(a["depth"], b["depth"])
        ma, mb = ja.get_metrics(), ta.get_metrics()
        np.testing.assert_array_equal(mb.pop("top_down_map"),
                                      ma.pop("top_down_map"))
        assert mb == ma and ma["path_length"] > 0


def test_llm_and_clustering_copies_match_jax():
    """The agents/llm copy sends JAX's messages for a text-only prompt and
    its mock client answers as JAX's; the numpy agents/clustering copy
    gives sklearn's labels and centres (tests/test_torch_agents.py holds
    every prompt function, the PNG payloads and seeded point sets)."""
    from bsc_nav_tpu.agents import clustering as jclust
    from bsc_nav_tpu.agents import llm as jllm
    from bsc_nav_tpu_torch.agents import clustering as tclust
    from bsc_nav_tpu_torch.agents import llm as tllm
    sent = []
    for mod in (jllm, tllm):
        client = mod.MockLLMClient(default="Success: no")
        assert mod.vln_subgoal_planner_with_obs(client, "Go to the bed.") \
            == "Success: no"
        sent.append(client.calls)
    assert sent[0] == sent[1]
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 30, (40, 3)).astype(float)
    sims = rng.uniform(0.1, 1.0, 40)
    a = jclust.weighted_cluster_centers(pts, sims, 6.0, 3)
    b = tclust.weighted_cluster_centers(pts, sims, 6.0, 3)
    np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(b[0], a[0])


def _write_gz(path, obj):
    import gzip
    import json
    with gzip.open(path, "wt", encoding="utf-8") as f:
        json.dump(obj, f)


def test_dataset_loaders_copy_matches_jax(tmp_path):
    """env/datasets: ObjectNav with inline goals and the goals_by_category
    layout (explicit key and the scene_category convention), a goal-less
    category taken from its first goal, R2R with dict and plain
    instructions, the OpenEQA json, ``limit``: the same records."""
    import json
    import math
    from bsc_nav_tpu.env import datasets as JD
    from bsc_nav_tpu_torch.env import datasets as TD
    obj = str(tmp_path / "objnav.json.gz")
    _write_gz(obj, {
        "episodes": [
            {"scene_id": "hm3d/val/00800-x/x.basis.glb",
             "start_position": [1.0, 0.2, -2.0],
             "start_rotation": [0, math.sin(0.5), 0, math.cos(0.5)],
             "object_category": "bed",
             "goals": [{"position": [3.0, 0.2, 4.0]}, "junk"]},
            {"scene_id": "scenes/abc.glb", "start_position": [0, 0, 0],
             "start_rotation": [0, 0, 0, 1], "object_category": "sofa",
             "goals": [], "goals_key": "abc.glb_sofa",
             "scene_dataset_config": "hm3d.json"},
            {"scene_id": "scenes/abc.glb", "start_position": [1, 0, 1],
             "object_category": "tv", "goals": []},
            {"scene_id": "s.glb", "start_position": [2, 0, 2],
             "start_rotation": [0, 0.3, 0, 0.95],
             "goals": [{"object_category": "chair",
                        "position": [1, 0, 1]}]},
        ],
        "goals_by_category": {
            "abc.glb_sofa": [{"position": [5.0, 0.0, 5.0]},
                             {"position": [6.0, 0.0, 5.0]}],
            "abc.glb_tv": [{"position": [7.0, 0.0, 1.0]}]},
    })
    r2r = str(tmp_path / "r2r.json.gz")
    _write_gz(r2r, {"episodes": [
        {"scene_id": "mp3d/XYZ/XYZ.glb", "start_position": [0, 0, 0],
         "start_rotation": [0, 0.6, 0, 0.8],
         "instruction": {"instruction_text": "Walk to the kitchen."},
         "goals": [{"position": [2, 0, 2]}]},
        {"scene_id": "mp3d/Q/Q.glb", "start_position": [1, 0, 0],
         "instruction": "Turn left.", "goals": []}]})
    eqa = str(tmp_path / "eqa.json")
    with open(eqa, "w") as f:
        json.dump([{"question_id": "q1", "question": "What is on the table?",
                    "episode_history": "hm3d-v0/00800-TEEsavR23oF",
                    "answer": "a lamp"},
                   {"question_id": "q2", "question": "Where?"}], f)

    def same(a, b):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert type(y).__module__.startswith("bsc_nav_tpu_torch")
            for k, v in vars(x).items():
                w = getattr(y, k)
                if k == "goal_positions":
                    assert len(v) == len(w)
                    for p, q in zip(v, w):
                        np.testing.assert_array_equal(p, q)
                else:
                    np.testing.assert_array_equal(np.asarray(v, dtype=object)
                                                  if v is None else v, w)

    for limit in (None, 2):
        same(JD.load_objectnav_episodes(obj, limit),
             TD.load_objectnav_episodes(obj, limit))
        same(JD.load_ovon_episodes(obj, limit),
             TD.load_ovon_episodes(obj, limit))
        same(JD.load_r2r_episodes(r2r, limit), TD.load_r2r_episodes(r2r,
                                                                    limit))
        assert JD.load_eqa_questions(eqa, limit) == \
            TD.load_eqa_questions(eqa, limit)


def test_dynamic_world_copy_matches_jax():
    """env/dynamic: the same frames, box moves and mutation counts over a
    run of steps past two mutations, the task iterator's order, goals and
    live success metric (the agent snapped beside a goal)."""
    from bsc_nav_tpu.env.dynamic import (
        DynamicFakeNavEnv as JDyn, DynamicTaskIterator as JTasks)
    from bsc_nav_tpu_torch.env.dynamic import (
        DynamicFakeNavEnv, DynamicTaskIterator)
    envs = (JDyn(jconfig.small_test_config(), mutate_every=4, seed=2),
            DynamicFakeNavEnv(tconfig.small_test_config(), mutate_every=4,
                              seed=2))
    actions = ["turn_left", "move_forward", "move_forward", "turn_right",
               "move_forward", "look_down", "turn_left", "move_forward",
               "move_forward"]
    for a in actions:
        ja, ta = (e.step(a) for e in envs)
        np.testing.assert_array_equal(ja["rgb"], ta["rgb"])
        np.testing.assert_array_equal(ja["depth"], ta["depth"])
        assert [b.center for b in envs[0].scene.boxes] == \
            [b.center for b in envs[1].scene.boxes]
    assert envs[0].mutation_count == envs[1].mutation_count == 2
    jt, tt = JTasks(envs[0]), DynamicTaskIterator(envs[1])
    jtasks, ttasks = list(jt), list(tt)
    assert [dataclasses.astuple(t) for t in jtasks] == \
        [dataclasses.astuple(t) for t in ttasks]
    for a, b in zip(jtasks, ttasks):
        np.testing.assert_array_equal(jt.current_goal_position(a),
                                      tt.current_goal_position(b))
        assert jt.evaluate(a) == tt.evaluate(b)
    goal = tt.current_goal_position(ttasks[1])
    for e in envs:
        e.position = e.pathfinder.snap_point(goal)
    assert jt.evaluate(jtasks[1]) == tt.evaluate(ttasks[1])
    assert tt.evaluate(ttasks[1])["success"] == 1.0


def test_readiness_check_on_the_port(tmp_path, capsys, monkeypatch):
    """``python -m bsc_nav_tpu_torch.drivers.setup --check --device cpu``:
    green offline (every row, the mocked episode through the port's objnav
    driver included); red on a weights directory missing the converted
    checkpoints and on an episode file that does not parse (there with the
    episode stubbed: it ran green above); with ``--llm local`` one judge
    chat; the card row red without a card unless the CPU is asked for."""
    from bsc_nav_tpu_torch.drivers import objnav
    assert drivers_setup.main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "READY" in out and "NOT READY" not in out
    assert "[ok     ] card" in out
    assert "[ok     ] mocked episode end-to-end" in out
    rec = type("R", (), {"metrics": {"success": 1.0, "spl": 1.0}})
    monkeypatch.setattr(objnav, "main", lambda argv: [rec])
    assert drivers_setup.main([
        "--check", "--device", "cpu", "--weights-dir", str(tmp_path / "none"),
        "--episode-prefix", str(tmp_path / "missing.json.gz")]) == 1
    out = capsys.readouterr().out
    assert "NOT READY" in out
    assert "[MISSING] converted weights complete" in out
    assert "[MISSING] episode dataset parses" in out
    assert "[ok     ] mocked episode end-to-end" in out
    # --llm local: one judge chat on a tiny judge directory (the default
    # config swapped for the directory's)
    import torch_parity as TP
    from bsc_nav_tpu_torch.models import qwen_vl as TQ
    judge = tmp_path / "judge"
    judge.mkdir()
    _, tcfg = TP.write_tiny_judge(str(judge))
    monkeypatch.setattr(TQ, "QWEN25_VL_3B", tcfg)
    assert drivers_setup.main(["--check", "--device", "cpu", "--llm",
                               "local", "--weights-dir", str(judge)]) == 1
    out = capsys.readouterr().out
    assert "[ok     ] local judge chat -- " in out, out
    assert "[MISSING] converted weights complete" in out
    # without a card, the default device is red
    args = argparse.Namespace(device="cuda")
    assert drivers_setup._gpu_row(args)[0] is torch.cuda.is_available()
