"""Open-vocabulary detection demo (the reference's gdino.py role,
gdino.py:44-68: prompt-driven zero-shot detection on one image with an
annotated visualization), served by the port's detectors.

Counterpart of the JAX package's root ``demo_detect.py``, on the card
unless ``--device cpu`` asks for the CPU:

  python -m bsc_nav_tpu_torch.demo_detect --classes "oven. tv. bookcase" \\
      --image frame.png --out annotated.png \\
      [--weights-dir converted/]   # YOLO-World + CLIP text embeddings
      [--detector grounding-dino]  # grounding_dino_tiny.npz + vocab.txt

Without --weights-dir (offline) it detects the fake world's color
prototypes on a rendered frame, so the demo runs anywhere.  Images are
read and written as PNG by ``agents/llm``'s codec, and the boxes and labels
are drawn with numpy: the outlines pixel for pixel as PIL's
``ImageDraw.rectangle(width=2)`` draws them, the label text in a 6 x 11
bitmap font kept below (its glyphs are not PIL's)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from bsc_nav_tpu_torch.utils.visualize import read_rgb_png, write_png

BOX_COLOR = (255, 40, 40)
TEXT_COLOR = (255, 255, 255)
BOX_WIDTH = 2
GLYPH_W, GLYPH_H = 6, 11
# printable ASCII 32-126, 6 x 11 pixels each: 11 rows of 6 bits (bit 5 the
# left column), two hex digits a row; each is PIL's bitmap-font character
# drawn alone and cropped to its cell
_GLYPHS = """
    0000000000000000000000 0000001818181800180000 0000001414140000000000
    000014143e14143e141400 00081e323c1e06363c0800 0000382a3c081e2a0e0000
    0000001c30183e2c3e0000 00000c0810000000000000 0000040818181818080400
    000010080c0c0c0c081000 0000083c18240000000000 00000008083e0808000000
    00000000000000000c0810 00000000003e0000000000 0000000000000000180000
    0000020204040808101000 00001c36363636361c0000 00000c3c0c0c0c0c3f0000
    00001c36060c18363e0000 00001c36061c06361c0000 0000060e16363f06060000
    00003e303c3606263c0000 00001c36303c36361c0000 00003e36060c0c18180000
    00001c36361c36361c0000 00001c36361e06361c0000 0000000000180000180000
    0000000000180000181020 0000000c1830180c000000 000000003c003c00000000
    000000180c060c18000000 0000001c260c1800180000 00001c32262a2a27301c00
    0000003c1c143e36370000 0000003c363c36363c0000 0000001e363030361c0000
    0000003c363636363c0000 0000003e303c30363e0000 0000003e303c3030380000
    0000001c36303e361e0000 00000037363e3636370000 0000003c181818183c0000
    0000001e0c0c2c2c380000 0000003634383c363b0000 00000038303030363e0000
    0000002236363e2a2a0000 000000373a3a3636320000 0000001c363636361c0000
    0000003c36363c30380000 0000001c363636361c0600 0000003c36363c363b0000
    0000001e323c0e263c0000 0000003e1a1818183c0000 00000037363636361c0000
    0000003736141c1c080000 0000002b2a2a3e1c140000 000000331e0c0c1e330000
    00000033331e0c0c1e0000 0000003e360c18363e0000 00001c1818181818181c00
    0000202010100808040400 00001c0c0c0c0c0c0c1c00 0000081c36000000000000
    000000000000000000003f 0000180804000000000000 000000001c361e363f0000
    000030303c3636363c0000 000000001c3630361c0000 00000e061e3636361f0000
    000000001c363e301e0000 00000e183e1818183e0000 000000001b3636361e063c
    000030303c363636360000 00000c003c0c0c0c3f0000 00000c003c0c0c0c0c0c38
    00003030363c383c370000 00003c0c0c0c0c0c3f0000 000000003c3e2a2a2a0000
    000000002c363636360000 000000001c3636361c0000 000000003c3636363c3038
    000000001b3636361e060f 00000000371d18183c0000 000000001e381e073e0000
    000018183e18181b0e0000 00000000363636361f0000 0000000036361c1c080000
    000000002b2a3e1e140000 000000003b1e0c1e370000 00000000373636141c1830
    000000003e2c18363e0000 0000060c0c180c0c0c0600 0000000808080808080800
    00003018180c1818183000 000000001a2c0000000000
""".split()


def _glyph_bits() -> np.ndarray:
    """[95, GLYPH_H, GLYPH_W] bool glyphs of ASCII 32-126."""
    rows = np.array([[int(g[2 * r:2 * r + 2], 16) for r in range(GLYPH_H)]
                     for g in _GLYPHS])
    shifts = np.arange(GLYPH_W - 1, -1, -1)
    return (rows[:, :, None] >> shifts) & 1 == 1


GLYPHS = _glyph_bits()


def _hline(img, xa, y, xb, color):
    H, W = img.shape[:2]
    if xa > xb:
        xa, xb = xb, xa
    if 0 <= y < H and xb >= 0 and xa < W:
        img[y, max(xa, 0):min(xb, W - 1) + 1] = color


def _vline(img, x, ya, yb, color):
    """Rows from ya towards yb, yb itself left out (as PIL's line)."""
    H, W = img.shape[:2]
    lo, hi = (ya, yb - 1) if yb >= ya else (yb + 1, ya)
    if ya != yb and 0 <= x < W and hi >= 0 and lo < H:
        img[max(lo, 0):min(hi, H - 1) + 1, x] = color


def draw_outline(img, xyxy, color=BOX_COLOR, width=BOX_WIDTH) -> None:
    """A box outline of ``width`` pixels inside (x0, y0)-(x1, y1), the
    coordinates truncated to integers, clipped to the image: PIL's
    ``ImageDraw.rectangle(outline=, width=)`` pixel for pixel."""
    x0, y0, x1, y1 = (int(v) for v in xyxy)
    x0, x1 = min(x0, x1), max(x0, x1)
    y0, y1 = min(y0, y1), max(y0, y1)
    for i in range(width):
        _hline(img, x0, y0 + i, x1, color)
        _hline(img, x0, y1 - i, x1, color)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, color)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, color)


def text_box(xy, text: str):
    """(x0, y0, x1, y1) of ``text`` drawn at ``xy`` (PIL's ``textbbox``
    for a 6 x 11 font)."""
    x, y = int(xy[0]), int(xy[1])
    return x, y, x + GLYPH_W * len(text), y + GLYPH_H


def draw_text(img, xy, text: str, color=TEXT_COLOR) -> None:
    """``text`` in the bitmap font with its top-left at ``xy``; a
    character outside printable ASCII is drawn as '?'."""
    H, W = img.shape[:2]
    x, y = int(xy[0]), int(xy[1])
    for ch in text:
        code = ord(ch) if 32 <= ord(ch) < 127 else ord("?")
        rr, cc = np.nonzero(GLYPHS[code - 32])
        rr, cc = rr + y, cc + x
        ok = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        img[rr[ok], cc[ok]] = color
        x += GLYPH_W


def annotate(img: np.ndarray, detections) -> np.ndarray:
    """Draw boxes + labels (headless; the JAX package draws with PIL)."""
    out = np.array(np.asarray(img)[:, :, :3], np.uint8)
    H, W = out.shape[:2]
    for det in detections:
        x1, y1, x2, y2 = det.xyxy
        draw_outline(out, (x1, y1, x2, y2))
        text = f"{det.label}: {det.confidence:.2f}"
        at = (x1, max(0, y1 - 12))
        tx0, ty0, tx1, ty1 = text_box(at, text)
        # a filled box, both ends inclusive, clipped to the image
        out[max(ty0, 0):min(ty1, H - 1) + 1,
            max(tx0, 0):min(tx1, W - 1) + 1] = BOX_COLOR
        draw_text(out, at, text)
    return out


def build_detector(args, classes):
    from bsc_nav_tpu_torch import resolve_device
    from bsc_nav_tpu_torch.models import weights as WT

    dev = resolve_device(args.device)
    if args.detector == "grounding-dino":
        from bsc_nav_tpu_torch.models import grounding_dino as G
        from bsc_nav_tpu_torch.models.wordpiece import WordPieceTokenizer

        if not args.weights_dir:
            raise SystemExit("--detector grounding-dino needs "
                             "--weights-dir with grounding_dino_tiny.npz "
                             "and bert vocab.txt")
        params = WT.load_grounding_dino_npz(
            os.path.join(args.weights_dir, "grounding_dino_tiny.npz"),
            G.GROUNDING_DINO_TINY, device=dev)
        tok = WordPieceTokenizer.from_vocab_file(
            os.path.join(args.weights_dir, "vocab.txt"))
        return G.GroundingDinoDetector(
            params, G.GROUNDING_DINO_TINY, classes, tokenizer=tok,
            confidence=args.confidence)
    if args.weights_dir:
        import torch

        from bsc_nav_tpu_torch.models import clip as C
        from bsc_nav_tpu_torch.models import tokenizer as T
        from bsc_nav_tpu_torch.models import yolo_world as Y

        yparams = WT.load_yolo_world_npz(
            os.path.join(args.weights_dir, "yolov8x_worldv2.npz"),
            Y.YOLOV8X_WORLDV2, device=dev)
        ccfg = C.METACLIP_VITH14
        text = WT.load_clip_text_npz(
            os.path.join(args.weights_dir, "metaclip_vith14.npz"), ccfg,
            device=dev)
        tok = T.default_tokenizer(os.path.join(
            args.weights_dir, "bpe_simple_vocab_16e6.txt.gz"))
        ids = T.tokenize([f"a photo of a {c}" for c in classes], tok)
        emb = C.encode_text(text, torch.from_numpy(
            np.asarray(ids, np.int64)).to(dev), ccfg).cpu().numpy()
        return Y.YoloWorldDetector(yparams, Y.YOLOV8X_WORLDV2, classes,
                                   emb, confidence=args.confidence)
    from bsc_nav_tpu_torch.drivers.setup import FAKE_PROTOTYPES
    from bsc_nav_tpu_torch.models.detector import ColorPrototypeDetector
    return ColorPrototypeDetector(FAKE_PROTOTYPES,
                                  confidence=args.confidence)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image", default=None,
                   help="input image, PNG (default: render a fake-env "
                        "frame)")
    p.add_argument("--classes", default="bed. plant. sofa",
                   help="'. '-separated open-vocab class prompt")
    p.add_argument("--out", default="annotated.png")
    p.add_argument("--confidence", type=float, default=0.3)
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--detector", default="yolo-world",
                   choices=["yolo-world", "grounding-dino"],
                   help="open-vocab detector backend (reference "
                        "gdino.py:44-68 demo role)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the detector (the card unless "
                        "the CPU is asked for)")
    args = p.parse_args(argv)

    classes = [c.strip().rstrip(".") for c in args.classes.split(".")
               if c.strip()]

    if args.image:
        img = read_rgb_png(args.image)
    else:
        from bsc_nav_tpu_torch.config import Config, SensorConfig
        from bsc_nav_tpu_torch.env.fake import BoxScene, FakeNavEnv
        env = FakeNavEnv(Config(sensor=SensorConfig(width=256,
                                                    height=256)),
                         scene=BoxScene.default(), seed=3)
        img = env._observe()["rgb"]

    det = build_detector(args, classes)
    dets = det.detect(np.asarray(img))
    for d in dets:
        print(f"{d.label:>12}  conf={d.confidence:.3f}  "
              f"box=({d.xyxy[0]:.0f},{d.xyxy[1]:.0f},"
              f"{d.xyxy[2]:.0f},{d.xyxy[3]:.0f})")
    write_png(annotate(img, dets), args.out)
    print(f"wrote {args.out} ({len(dets)} detections)")
    return dets


if __name__ == "__main__":
    main()
