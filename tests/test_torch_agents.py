"""Port parity: the robots' host layers against the JAX package's --
``agents/clustering.py`` (numpy DBSCAN and k-nearest-neighbour search in
place of sklearn's), ``agents/llm.py`` (the prompt functions, the clients,
``retry``; images packed as PNG where JAX packs JPEG), the robot's grid
conversions and ``move2textprompt``'s stage-2 prefetch (as
tests/test_agents_units.py drives the JAX robot's).

Clustering: labels equal, centres within 1e-12 (they are equal sums of
equal floats; the bound leaves room for numpy's summation order).
"""

import base64
import io
import json
import types

import numpy as np
import pytest

from bsc_nav_tpu.agents import clustering as JC
from bsc_nav_tpu.agents import llm as JL
from bsc_nav_tpu.agents import robot as JR
from bsc_nav_tpu_torch.agents import clustering as TC
from bsc_nav_tpu_torch.agents import llm as TL
from bsc_nav_tpu_torch.agents import robot as TR

CENTRE_TOL = 1e-12


def point_sets(kind, seed):
    """Seeded point sets: integer grid voxels (the robots' top-K, ties at
    exactly eps), Gaussian blobs, points on a half-unit lattice (ties in
    the neighbour distances), sizes on both sides of sklearn's
    brute-force / KD-tree switch, and a border point within eps of two
    clusters' cores."""
    rng = np.random.default_rng(seed)
    if kind == "voxels":
        n = int(rng.integers(2, 120))
        centres = rng.integers(0, 90, (3, 3))
        pts = centres[rng.integers(0, 3, n)] + rng.integers(-9, 10, (n, 3))
        return pts.astype(float), rng.uniform(0.2, 1.0, n)
    if kind == "blobs":
        n = int(rng.integers(2, 150))
        c = rng.normal(0, 10, (4, 3))
        pts = c[rng.integers(0, 4, n)] + rng.normal(0, 1.5, (n, 3))
        return pts, rng.uniform(0.1, 1.0, n)
    if kind == "lattice":
        n = int(rng.integers(3, 60))
        return (np.round(rng.normal(0, 4, (n, 3)) * 2) / 2,
                rng.uniform(0.1, 1.0, n))
    if kind == "small":
        n = int(rng.integers(1, 12))
        return rng.normal(0, 3, (n, 3)), rng.uniform(0.1, 1.0, n)
    # border: 0 is within eps 10 of one core of each of two clusters
    a = np.r_[np.full((6, 3), -12.0), [[-8.0, 0, 0]]]
    b = np.r_[np.full((6, 3), 12.0), [[8.0, 0, 0]]]
    pts = np.r_[a, b, [[0.0, 0.0, 0.0]]]
    if seed % 2:
        pts = pts[::-1].copy()
    return pts, rng.uniform(0.1, 1.0, len(pts))


def assert_same_clusters(a, b):
    centres_a, labels_a, sizes_a = a
    centres_b, labels_b, sizes_b = b
    np.testing.assert_array_equal(labels_b, labels_a)
    assert sizes_b == sizes_a
    np.testing.assert_allclose(centres_b, centres_a, atol=CENTRE_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["voxels", "blobs", "lattice", "small",
                                  "border"])
def test_weighted_cluster_centers_matches_sklearn(kind):
    for seed in range(12):
        pts, sims = point_sets(kind, seed)
        for eps, min_samples in ((10.0, 5), (10.0, 3), (3.0, 2), (1.0, 2)):
            assert_same_clusters(
                TC.weighted_cluster_centers(pts, sims, eps, min_samples),
                JC.weighted_cluster_centers(pts, sims, eps, min_samples))
    assert len(TC.weighted_cluster_centers(np.zeros((0, 3)), [])[0]) == 0


@pytest.mark.parametrize("kind", ["voxels", "blobs", "lattice", "small",
                                  "border"])
def test_adaptive_clustering_matches_sklearn(kind):
    from sklearn.neighbors import NearestNeighbors
    for seed in range(12):
        pts, conf = point_sets(kind, seed)
        a = JC.adaptive_clustering(pts, conf)
        b = TC.adaptive_clustering(pts, conf)
        np.testing.assert_array_equal(b[2], a[2])
        np.testing.assert_allclose(b[0], a[0], atol=CENTRE_TOL, rtol=0)
        np.testing.assert_allclose(b[1], a[1], atol=CENTRE_TOL, rtol=0)
        if len(pts) > 1:
            k = min(len(pts) - 1, max(5, int(np.sqrt(len(pts)))))
            want, _ = NearestNeighbors(n_neighbors=k).fit(pts).kneighbors(
                pts)
            np.testing.assert_array_equal(TC.knn_distances(pts, k), want)
    assert TC._knee_index(np.arange(2.0)) == JC._knee_index(np.arange(2.0))


class Recorder:
    """A chat client that records the messages and answers ``text``."""

    def __init__(self, text="ok"):
        self.text, self.messages = text, []

    def chat(self, model, messages, timeout=500.0):
        self.messages.append((model, messages))
        return self.text


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (9, 7, 3), dtype=np.uint8),
            rng.integers(0, 256, (6, 4, 4), dtype=np.uint8),
            rng.integers(0, 256, (6, 4, 3), dtype=np.uint8)]


# (name, its arguments after the client, the images it sends) from the
# views [v0, v1, v2]
PROMPTS = [
    ("imagenary_helper", lambda v: ("a red bed",), lambda v: []),
    ("imagenary_helper_visaug", lambda v: ("a sofa", v), lambda v: v[:2]),
    ("imagenary_helper_long_text", lambda v: (["a bed", "by a wall"],),
     lambda v: []),
    ("long_memory_localized", lambda v: (
        "a bed", [{"label": "bed", "loc": [1, 2, 3], "confidence": 0.5}]),
     lambda v: []),
    ("succeed_determine_singleview", lambda v: ("a plant", v[:1]),
     lambda v: v[:1]),
    ("succeed_determine_singleview_with_imggoal", lambda v: (v[0], v[1:]),
     lambda v: v[:2]),
    ("succeed_determine", lambda v: ("a plant", v), lambda v: v),
    ("touching_helper", lambda v: ("a table", v), lambda v: v[:1]),
    ("vln_subgoal_planner_with_obs", lambda v: ("Walk to the bed.",),
     lambda v: []),
    ("vln_subgoal_planner_no_object", lambda v: ("Walk to the bed.",),
     lambda v: []),
    ("vln_anchor_planner", lambda v: ("turn left", v), lambda v: v),
    ("vln_anchor_planner_v2", lambda v: ("turn left", v), lambda v: v),
    ("EQA_generate_anchor_object", lambda v: ("What color is the bed?",),
     lambda v: []),
    ("EQA_Answer_4o", lambda v: ("What color is the bed?", v), lambda v: v),
    ("EQA_Answer_o3", lambda v: ("What color is the bed?", v), lambda v: v),
]


def _split_images(messages):
    """(the messages with each image URL blanked, the image URLs)."""
    urls = []

    def walk(o):
        if isinstance(o, dict):
            if o.get("type") == "image_url":
                urls.append(o["image_url"]["url"])
                return {"type": "image_url", "image_url": {"url": "<image>"}}
            return {k: walk(v) for k, v in o.items()}
        if isinstance(o, list):
            return [walk(v) for v in o]
        return o
    return walk(messages), urls


@pytest.mark.parametrize("name,args,sent", PROMPTS,
                         ids=[p[0] for p in PROMPTS])
def test_prompt_functions_match_jax_apart_from_the_image_payload(
        name, args, sent):
    """The same model and message text as JAX's; each image a PNG that
    decodes (PIL, here only) to the exact input pixels, RGB."""
    from PIL import Image
    views = _images(len(name))
    got, want = Recorder("answer"), Recorder("answer")
    assert getattr(TL, name)(got, *args(views)) == "answer"
    getattr(JL, name)(want, *args(views))
    (gmodel, gmsg), (wmodel, wmsg) = got.messages[0], want.messages[0]
    assert gmodel == wmodel
    gtext, gurls = _split_images(gmsg)
    wtext, wurls = _split_images(wmsg)
    assert json.dumps(gtext) == json.dumps(wtext)
    assert len(gurls) == len(wurls) == len(sent(views))
    for url, img in zip(gurls, sent(views)):
        head, payload = url.split(",", 1)
        assert head == "data:image/png;base64"
        dec = np.asarray(Image.open(io.BytesIO(base64.b64decode(payload))))
        np.testing.assert_array_equal(dec, img[:, :, :3])


def test_png_payload_of_grey_and_rgba_images():
    from PIL import Image
    rng = np.random.default_rng(3)
    grey = rng.integers(0, 256, (5, 8), dtype=np.uint8)
    rgba = rng.integers(0, 256, (4, 3, 4), dtype=np.uint8)
    for img, want in ((grey, np.repeat(grey[:, :, None], 3, axis=2)),
                      (rgba, rgba[:, :, :3])):
        dec = np.asarray(Image.open(io.BytesIO(base64.b64decode(
            TL.images_to_base64([img])[0]))))
        np.testing.assert_array_equal(dec, want)


def test_clients_and_retry_match_jax(monkeypatch):
    """MockLLMClient's responders, default and call log; retry's
    attempts, validation and error; OpenAICompatClient's settings."""
    for L in (JL, TL):
        monkeypatch.setattr(L.time, "sleep", lambda s: None)
    outs = []
    for L in (JL, TL):
        client = L.MockLLMClient(responders=[
            (lambda t: "bed" in t, lambda t: "Success: yes")])
        msg = [{"role": "user", "content": "a bed"}]
        seq = iter(["bad", "still bad", "Success: no"])
        outs.append((client.chat("m", msg), client.chat("m", []),
                     client.calls,
                     L.retry(lambda: next(seq),
                             validate=lambda a: "Success" in a),
                     L.OpenAICompatClient("http://localhost:1/v1",
                                          "k").base_url))
        with pytest.raises(RuntimeError, match="after 2 attempts"):
            L.retry(lambda: "x", attempts=2, validate=lambda a: False)
    assert outs[1] == outs[0]


def _geometry_robot(module, origin, agent):
    """A robot with just what ``_grid2loc`` / ``_loc2grid`` read."""
    r = module.ObjectNavRobot.__new__(module.ObjectNavRobot)
    state = types.SimpleNamespace(position=np.asarray(agent, float))
    r.memory = types.SimpleNamespace(
        Env=types.SimpleNamespace(original_state=types.SimpleNamespace(
            position=np.asarray(origin, float))),
        gs=1000, cs=0.1, minh=-32)
    r.benchmark_env = types.SimpleNamespace(sim=types.SimpleNamespace(
        agents=[types.SimpleNamespace(get_state=lambda: state)]))
    return r


def test_grid_conversions_match_jax():
    """``_grid2loc`` and ``_loc2grid`` (truncating ``int()``) on seeded
    grid cells and world points, negative and on cell edges."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        origin = rng.normal(0, 3, 3)
        agent = rng.normal(0, 3, 3)
        a = _geometry_robot(JR, origin, agent)
        b = _geometry_robot(TR, origin, agent)
        for grid in (rng.integers(0, 1000, 3), rng.uniform(0, 1000, 3)):
            np.testing.assert_array_equal(b._grid2loc(grid),
                                          a._grid2loc(grid))
        for loc in (rng.normal(0, 20, 3), np.round(rng.normal(0, 20, 3), 1),
                    origin + 0.1 * rng.integers(-400, 400, 3)):
            got, want = b._loc2grid(loc), a._loc2grid(loc)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


def _prefetch_robot(monkeypatch, stage1_succeeds: bool):
    """tests/test_agents_units.py's control-flow harness for
    move2textprompt's stage-2 prefetch, on the port's robot."""
    calls = {"async": 0, "blocking": 0, "finish": 0}

    class _Im:
        imagine_core = object()          # the card path's marker

    class _Mem:
        imagination = _Im()
        cfg = types.SimpleNamespace(
            agent=types.SimpleNamespace(use_only_working_memory=False),
            query=types.SimpleNamespace(cluster_eps=10.0,
                                        cluster_min_samples=2))
        memory_save_path = None

        def voxel_localized_async(self, prompt, K=100, **kw):
            calls["async"] += 1
            assert prompt.startswith("ENH ")     # extended prompt reached it

            def thunk():
                calls["finish"] += 1
                top = np.array([[3, 4, 5], [3, 4, 6], [3, 5, 5]])
                return top[:1], top, np.array([0.9, 0.8, 0.7])
            return thunk

        def voxel_localized(self, *a, **kw):
            calls["blocking"] += 1
            top = np.array([[3, 4, 5]])
            return top[:1], top, np.array([0.9])

    r = TR.ObjectNavRobot.__new__(TR.ObjectNavRobot)
    r.memory = _Mem()
    r.benchmark_env = types.SimpleNamespace(sim=types.SimpleNamespace(
        get_sensor_observations=lambda _: {"rgb": np.zeros((4, 4, 3))}))
    r.task_over = False
    r.nav_log = {"long_memory_query": 0, "working_memory_query": 0,
                 "search_point": 0, "success": 0}
    monkeypatch.setattr(TR.L, "imagenary_helper",
                        lambda client, t: "ENH " + t)
    r.client = None
    r.long_term_memory_retrival_v2 = lambda prompt: np.array([[1, 2, 3]])
    stage = {"n": 0, "best": []}

    def navigate(best, prompt, max_candidates=3):
        stage["n"] += 1
        stage["best"].append(best)
        if stage["n"] == 1:              # stage-1 candidates
            # the stage-2 query must already be queued here
            assert calls["async"] == 1 and calls["finish"] == 0
            return stage1_succeeds
        return True
    r._navigate_candidates = navigate
    r._finish = lambda: "done"
    return r, calls, stage


def test_move2textprompt_prefetch_consumed_on_stage1_miss(monkeypatch):
    r, calls, stage = _prefetch_robot(monkeypatch, stage1_succeeds=False)
    assert r.move2textprompt("a bed") == "done"
    # stage 2 used the prefetched result: no second dispatch, no
    # blocking re-query -- one device query per retrieval stage
    assert calls == {"async": 1, "blocking": 0, "finish": 1}
    # the prefetched top-3 clustered into one centre (eps 10, 2 samples)
    np.testing.assert_allclose(stage["best"][1][0],
                               [[3.0, 4 + 0.7 / 2.4, 5 + 0.8 / 2.4]])


def test_move2textprompt_prefetch_discarded_on_stage1_hit(monkeypatch):
    r, calls, _ = _prefetch_robot(monkeypatch, stage1_succeeds=True)
    assert r.move2textprompt("a bed") == "done"
    assert calls["finish"] == 0 and calls["blocking"] == 0


def test_no_prefetch_for_a_plain_callable_imagination(monkeypatch):
    """An imagination without ``imagine_core`` renders on the host: no
    prompt extension is paid for a prefetch, stage 2 queries blocking."""
    r, calls, _ = _prefetch_robot(monkeypatch, stage1_succeeds=False)
    r.memory.imagination = lambda text: None
    outcomes = iter([False, True])
    r._navigate_candidates = lambda best, prompt, max_candidates=3: next(
        outcomes)
    assert r._prefetch_working_memory("a bed") is None
    assert r.move2textprompt("a bed") == "done"
    assert calls == {"async": 0, "blocking": 1, "finish": 0}
