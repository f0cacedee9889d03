"""JAX-free helpers of the Grounding DINO and habitat-world tests, shared by
tests/test_torch_{grounding_dino,habitat_env}.py and the card tests in
tests/test_torch_kernels.py (which import no JAX).

- ``GDINO_TINY``: the port's copy of tests/test_grounding_dino.py's TINY;
  ``gdino_numpy_params`` seeded weights at a config as a numpy tree.
- ``write_vocab``: a synthetic BERT ``vocab.txt`` holding every word of the
  given class names, with BERT's special tokens at BERT's ids ([PAD] 0,
  [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, "." 1012, "?" 1029), which
  the text masks and the phrase map rest on.
- ``write_gdino_dir``: a weights directory holding ``grounding_dino_tiny.npz``
  (seeded random weights of a config) and that vocabulary.
- ``small_habitat``: the habitat world cut to the drivers' fake-world size
  (64x64 frames, grid 96, a tiny ViT as the encoder), so that it builds on
  the CPU; ``habitat_split`` / ``habitat_args`` the JAX test's two-episode
  ObjectNav split and flags.
- ``split_traced_run``: a navbench driver's tiny traced run whose window
  holds both an untraced and a traced flush.
"""

import gzip
import json
import os
import types

import numpy as np
import torch

from bsc_nav_tpu_torch.config import HM3D_DETECT_CLASSES
from bsc_nav_tpu_torch.models import grounding_dino as TG
from bsc_nav_tpu_torch.models.wordpiece import basic_tokenize
from bsc_nav_tpu_torch.models.weights import flatten_params

GDINO_TINY = TG.GroundingDinoConfig(
    d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
    num_levels=4, enc_points=2, dec_points=2, num_queries=12,
    max_text_len=32,
    swin=TG.SwinConfig(embed_dim=16, depths=(2, 1, 1, 1),
                       num_heads=(2, 2, 4, 4), window_size=4, patch_size=4,
                       out_stages=(1, 2, 3)),
    text=TG.BertTextConfig(vocab_size=2000, dim=32, layers=2, heads=2,
                           ffn=64, max_pos=64, type_vocab=2))

BERT_SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
                 103: "[MASK]", 1012: ".", 1029: "?"}


def _redraw(tree, rng):
    """Biases, norms and the fusion layer scales redrawn from ``rng``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng)
        elif isinstance(v, list):
            out[k] = [_redraw(x, rng) for x in v]
        elif k in ("b", "bias"):
            out[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k == "scale":
            out[k] = (1 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k in ("vision_param", "text_param"):
            out[k] = rng.uniform(0.2, 1.0, size=v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


def gdino_numpy_params(cfg=GDINO_TINY, seed: int = 0) -> dict:
    """The port's ``init_params`` (the JAX init's tree and distributions)
    as numpy, with every bias, LayerNorm, GroupNorm and fusion layer scale
    redrawn: the init's zeros, ones and 1e-4 would leave the biases, the
    norms and the fusion untested, and its phrase scores saturate."""
    tree = TG.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")
    to_np = lambda n: ({k: to_np(v) for k, v in n.items()}
                       if isinstance(n, dict) else [to_np(v) for v in n]
                       if isinstance(n, list) else n.numpy())
    return _redraw(to_np(tree), np.random.default_rng(seed + 1))


def write_vocab(path, classes=HM3D_DETECT_CLASSES, size: int = 2000,
                first_word: int = 200) -> str:
    """A ``vocab.txt`` of ``size`` lines: BERT's specials at their ids, the
    classes' words from ``first_word`` on, ``[unusedN]`` elsewhere."""
    words = sorted({w for c in classes for w in basic_tokenize(c)})
    vocab = [f"[unused{i}]" for i in range(size)]
    for i, t in BERT_SPECIALS.items():
        vocab[i] = t
    for i, w in enumerate(words):
        vocab[first_word + i] = w
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return str(path)


def write_gdino_dir(path, cfg=GDINO_TINY, seed: int = 0) -> dict:
    """``grounding_dino_tiny.npz`` of seeded random weights at ``cfg`` and
    the synthetic ``vocab.txt`` under ``path``; returns the CPU tree."""
    params = TG.init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    np.savez(os.path.join(path, "grounding_dino_tiny.npz"),
             **flatten_params(params))
    write_vocab(os.path.join(path, "vocab.txt"),
                size=cfg.text.vocab_size)
    return params


def small_habitat(monkeypatch, detector_cfg=None):
    """Cut the habitat world to the fake world's size: ``habitat_config``
    keeps its flags and takes the fake world's sensor, memory and query
    widths; DINOv2 ViT-L is swapped for the drivers' tiny ViT; with
    ``detector_cfg`` Grounding DINO's config for that one (its input stays
    at 800^2)."""
    from bsc_nav_tpu_torch.drivers import setup as S
    from bsc_nav_tpu_torch.models import vit

    full = S.habitat_config

    def habitat_config(args):
        fake = S.fake_config(args)
        return full(args).replace(sensor=fake.sensor, memory=fake.memory,
                                  query=fake.query)

    monkeypatch.setattr(S, "habitat_config", habitat_config)
    monkeypatch.setitem(vit.CONFIGS, "dinov2_vitl14_reg", vit.ViTConfig(
        img_size=56, patch_size=14, dim=32, depth=2, heads=2,
        num_registers=1))
    if detector_cfg is not None:
        monkeypatch.setattr(TG, "GROUNDING_DINO_TINY", detector_cfg)


def habitat_split(path) -> str:
    """The JAX habitat test's two-episode ObjectNav split (json.gz)."""
    split = {"episodes": [
        {"scene_id": "a.glb", "object_category": "sofa",
         "start_position": [0, 0, 0], "start_rotation": [0, 0, 0, 1],
         "goals": [{"position": [1.0, 0.0, 0.0],
                    "object_category": "sofa"}]},
        {"scene_id": "a.glb", "object_category": "bed",
         "start_position": [1, 0, 1], "start_rotation": [0, 0, 0, 1],
         "goals": [{"position": [2.0, 0.0, 0.0],
                    "object_category": "bed"}]},
    ]}
    ep_path = os.path.join(path, "val.json.gz")
    with gzip.open(ep_path, "wt", encoding="utf-8") as f:
        json.dump(split, f)
    return ep_path


def habitat_args(path, device="cpu", **kw):
    """The JAX habitat test's flags, on ``device``."""
    args = dict(
        env="habitat", episodes=2, llm="mock", llm_model="gpt-4o",
        memory_root=str(path), weights_dir=None, batch_size=2,
        seed=0, benchmark_dataset="hm3d", scene_prefix=str(path),
        episode_prefix=habitat_split(path), success_distance=None,
        use_only_working_memory=False, load_single_floor=False,
        detector="auto", csv=None, record_video=False,
        log_root=str(path), device=device)
    args.update(kw)
    return types.SimpleNamespace(**args)


def split_traced_run(once, seconds: float = 2.0, tries: int = 4):
    """``once(seconds, traffic_update)`` runs a navbench driver's tiny
    traced run of a ``seconds`` window and returns a tuple whose first item
    is its ``Outcome``.  The traffic's ``trace_seconds`` (the update) is
    the window less 1 ms: the driver starts tracing at the first flush
    that begins that far into the window, so the first flush is untraced
    (the host-time readers read the flushes before the traced part) and
    every later one traced.  A first flush that outlasts the window (a
    loaded host) leaves none traced, and the run is repeated with the
    window doubled.  It runs on one thread: the tiny models gain nothing
    from more, and the test workers' threads would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(tries):
            got = once(seconds, {"trace_seconds": seconds - 1e-3})
            if 0 < got[0].traced_items < got[0].attempted:
                break
            seconds *= 2
    finally:
        torch.set_num_threads(threads)
    return got
