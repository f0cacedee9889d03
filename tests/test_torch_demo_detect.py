"""Port parity: the detection demo (``bsc_nav_tpu_torch/demo_detect.py``)
against the JAX package's root ``demo_detect.py``.

The colour-prototype path on the fake world's frame: the same detections
and printed lines.  The annotation is drawn with numpy: the box outlines
must be PIL's pixels (``ImageDraw.rectangle(width=2)``, coordinates
truncated, clipped), and each label glyph PIL's bitmap-font character in
its 6 x 11 cell.
YOLO-World (with the MetaCLIP text tower's class embeddings) and Grounding
DINO run through a weights directory of tiny seeded models, the module
constants patched to the tests' tiny configs on both sides (and Grounding
DINO's input size to 64^2): the same detections within the detector tests'
bounds (tests/test_torch_yolo_world.py, tests/test_torch_grounding_dino.py):
labels equal, confidences within 1e-5, boxes within 1e-3 px, and the same
printed lines where no printed digit lies within those bounds of a
rounding boundary.
"""

import re

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw, ImageFont

import demo_detect as jdd
from bsc_nav_tpu.models import clip as JC
from bsc_nav_tpu.models import grounding_dino as JG
from bsc_nav_tpu.models import yolo_world as JY
from bsc_nav_tpu.models.weights import save_params_npz
from bsc_nav_tpu_torch import demo_detect as tdd
from bsc_nav_tpu_torch.agents.llm import decode_png
from bsc_nav_tpu_torch.models import clip as TC
from bsc_nav_tpu_torch.models import grounding_dino as TG
from bsc_nav_tpu_torch.models import yolo_world as TY

from test_grounding_dino import TINY
from torch_parity import randomize_stats
from torch_worlds import GDINO_TINY, gdino_numpy_params, write_vocab

CLIP_TINY = dict(embed_dim=48, image_size=28, patch_size=14, vision_width=32,
                 vision_layers=1, vision_heads=2, context_length=77,
                 vocab_size=49408, text_width=32, text_heads=2,
                 text_layers=2)
LINE = re.compile(r"^\s*(.+?)  conf=([0-9.]+)  box=\((-?\d+),(-?\d+),"
                  r"(-?\d+),(-?\d+)\)$")


def run(main, argv, capsys):
    capsys.readouterr()
    dets = main(argv)
    return dets, capsys.readouterr().out.splitlines()


def assert_same_detections(got, want, conf_tol=1e-5, box_tol=1e-3):
    assert [d.label for d in got] == [d.label for d in want]
    np.testing.assert_allclose([d.confidence for d in got],
                               [d.confidence for d in want], atol=conf_tol,
                               rtol=0)
    np.testing.assert_allclose(np.reshape([d.xyxy for d in got], (-1, 4)),
                               np.reshape([d.xyxy for d in want], (-1, 4)),
                               atol=box_tol, rtol=0)


def assert_same_lines(got, want, dets, out_names, conf_tol=1e-5,
                      box_tol=1e-3):
    """Equal printed lines, except a digit that a value within the bound of
    a rounding boundary may print either way."""
    assert len(got) == len(want)
    for g, w, d in zip(got, want, list(dets) + [None]):
        if d is None:
            assert g.replace(out_names[0], "X") == w.replace(out_names[1],
                                                               "X")
            continue
        near = (abs((d.confidence * 1e3) % 1 - 0.5) < conf_tol * 1e3
                or any(abs(v % 1 - 0.5) < box_tol for v in d.xyxy))
        if not near:
            assert g == w
        gm, wm = LINE.match(g), LINE.match(w)
        assert gm and wm and gm.group(1) == wm.group(1)


def test_colour_path_matches_jax(tmp_path, capsys):
    jout, tout = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    want, wl = run(jdd.main, ["--out", jout, "--confidence", "0.2"], capsys)
    got, gl = run(tdd.main, ["--out", tout, "--confidence", "0.2",
                             "--device", "cpu"], capsys)
    assert len(got) >= 1
    assert [vars(d) for d in got] == [vars(d) for d in want]
    assert [g.replace(tout, "X") for g in gl] == \
        [w.replace(jout, "X") for w in wl]
    img = decode_png(open(tout, "rb").read())
    jimg = np.asarray(Image.open(jout))
    # every outline pixel as PIL drew it; the rest of the frame untouched
    # outside the label boxes
    base = np.asarray(Image.open(jout)).copy()
    mask = np.zeros(img.shape[:2], bool)
    for d in got:
        o = np.zeros(img.shape[:2] + (3,), np.uint8)
        tdd.draw_outline(o, d.xyxy, (1, 1, 1))
        mask |= o[..., 0] == 1
    np.testing.assert_array_equal(img[mask], jimg[mask])
    assert (img[mask] == tdd.BOX_COLOR).all()
    assert base.shape == img.shape


@pytest.mark.parametrize("seed", range(4))
def test_outlines_are_pil_s(seed):
    """Boxes inside, across and past the image's edges, thin, inverted
    and degenerate, at float coordinates."""
    rng = np.random.default_rng(seed)
    H, W = 37, 53
    for _ in range(150):
        b = rng.uniform(-8, 60, 4)
        if rng.random() < 0.2:
            b[2:] = b[:2] + rng.uniform(0, 3, 2)
        b = [min(b[0], b[2]), min(b[1], b[3]), max(b[0], b[2]),
             max(b[1], b[3])]
        im = Image.new("RGB", (W, H))
        ImageDraw.Draw(im).rectangle((tuple(b[:2]), tuple(b[2:])),
                                     outline=(255, 40, 40), width=2)
        got = np.zeros((H, W, 3), np.uint8)
        tdd.draw_outline(got, b)
        np.testing.assert_array_equal(got, np.asarray(im), err_msg=str(b))


def test_glyphs_are_pil_s_bitmap_font_cells():
    """Each glyph is PIL's bitmap-font character drawn alone and cropped to
    its 6 x 11 cell (a run of text is not PIL's: some of its glyphs reach
    past their cells); a string is drawn glyph after glyph."""
    font = ImageFont.load_default_imagefont()
    for c in range(32, 127):
        im = Image.new("L", (tdd.GLYPH_W, tdd.GLYPH_H))
        ImageDraw.Draw(im).text((0, 0), chr(c), fill=255, font=font)
        np.testing.assert_array_equal(tdd.GLYPHS[c - 32],
                                      np.asarray(im) > 0, err_msg=chr(c))
    got = np.zeros((15, 40, 3), np.uint8)
    tdd.draw_text(got, (2.9, 3.5), "Ab\u00e9")
    for i, ch in enumerate("Ab?"):
        np.testing.assert_array_equal(
            got[3:14, 2 + 6 * i:8 + 6 * i, 0] > 0, tdd.GLYPHS[ord(ch) - 32])
    assert tdd.text_box((2.7, 3.2), "ab: 0.50") == (2, 3, 2 + 6 * 8, 14)


class _Small:
    """Grounding DINO's input cut from 800^2 to 64^2 on one side."""

    @staticmethod
    def patch(mp, module, cls):
        class Small(cls):
            def __init__(self, *a, **k):
                super().__init__(*a, image_size=64, **k)
        mp.setattr(module, "GroundingDinoDetector", Small)


def weights_dir(path, detector):
    if detector == "grounding-dino":
        save_params_npz(gdino_numpy_params(GDINO_TINY, 0),
                        str(path / "grounding_dino_tiny.npz"))
        write_vocab(str(path / "vocab.txt"))
        return
    # the port's inits draw the JAX layout in a fraction of the JAX inits'
    # eager time; the files are read by both sides
    tree = TY.init_params(TY.YOLO_TEST, torch.Generator().manual_seed(0),
                          text_dim=48, device="cpu")
    save_params_npz(randomize_stats(host_tree(tree), 0),
                    str(path / "yolov8x_worldv2.npz"))
    clip = TC.init_params(TC.CLIPConfig(**CLIP_TINY),
                          torch.Generator().manual_seed(5), device="cpu")
    np.savez_compressed(str(path / "metaclip_vith14.npz"), **{
        k: v.numpy() for k, v in clip.state_dict().items()})


def host_tree(tree):
    """A port YOLO-World tree as numpy leaves in the JAX layout (K8's
    folded ``w9`` / ``b9`` left out)."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()
                if k not in ("w9", "b9")}
    if isinstance(tree, list):
        return [host_tree(v) for v in tree]
    return tree.numpy().copy()


@pytest.mark.parametrize("detector,conf", [("yolo-world", 0.5),
                                           ("grounding-dino", 0.0)])
def test_weights_dir_detectors_match_jax(detector, conf, tmp_path,
                                         monkeypatch, capsys):
    weights_dir(tmp_path, detector)
    monkeypatch.setattr(JY, "YOLOV8X_WORLDV2", JY.YOLO_TEST)
    monkeypatch.setattr(TY, "YOLOV8X_WORLDV2", TY.YOLO_TEST)
    monkeypatch.setattr(JC, "METACLIP_VITH14", JC.CLIPConfig(**CLIP_TINY))
    monkeypatch.setattr(TC, "METACLIP_VITH14", TC.CLIPConfig(**CLIP_TINY))
    monkeypatch.setattr(JG, "GROUNDING_DINO_TINY", TINY)
    monkeypatch.setattr(TG, "GROUNDING_DINO_TINY", GDINO_TINY)
    _Small.patch(monkeypatch, JG, JG.GroundingDinoDetector)
    _Small.patch(monkeypatch, TG, TG.GroundingDinoDetector)
    argv = ["--weights-dir", str(tmp_path), "--detector", detector,
            "--confidence", str(conf), "--classes", "bed. plant. sofa"]
    jout, tout = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    want, wl = run(jdd.main, argv + ["--out", jout], capsys)
    got, gl = run(tdd.main, argv + ["--out", tout, "--device", "cpu"],
                  capsys)
    assert len(want) >= 2
    assert_same_detections(got, want)
    assert_same_lines(gl, wl, got, (tout, jout))
    assert decode_png(open(tout, "rb").read()).shape == (256, 256, 3)
