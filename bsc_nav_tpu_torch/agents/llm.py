"""LLM cognition layer: prompt/completion functions over a pluggable
chat client.

Copy of ``bsc_nav_tpu/agents/llm.py`` (which imports no JAX) with one
deliberate divergence: images are packed as PNG, encoded with ``zlib`` and
``struct`` from the standard library, where the JAX module encodes JPEG
with PIL.  The card machine has no PIL, and the robots pack images on every
VLM judge call.  PNG is lossless, so the payload decodes to the exact
pixels; the message text around it is the JAX module's, word for word
(``tests/test_torch_agents.py`` holds both).  ``decode_png`` reads them
back for the local judge (``agents/local_vlm.py``), where the JAX module
reads any format through PIL: 8-bit greyscale, RGB and RGBA,
non-interlaced, all five row filters, every chunk's CRC checked; any other
PNG raises.

Covers every LLM role in the reference's LLMAgent.py (14 functions,
SURVEY §2 L4): prompt-to-image enhancement, long-memory localization,
success judging, local stepping, VLN subgoal/anchor planning, EQA anchor
generation and answering.  The OUTPUT CONTRACTS (the regex-parseable
formats the agents match on, reference objnav_benchmark.py:303-307) are
preserved exactly; prompt wording is our own.

Clients:
  - OpenAICompatClient: any OpenAI-compatible chat endpoint; base URL
    and API key come from the environment (the reference hardcodes proxy
    keys, BSCAgent.py:286-300 -- deliberately NOT reproduced).
  - MockLLMClient: deterministic canned responses for tests/offline.

All call sites in the agents go through `retry()` which replaces the
reference's sleep-50s-forever loops (objnav_benchmark.py:766-778) with
bounded exponential backoff.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, Union

import numpy as np


# --------------------------------------------------------------------------
# clients
# --------------------------------------------------------------------------

class ChatClient(Protocol):
    def chat(self, model: str, messages: List[dict],
             timeout: float = 500.0) -> str: ...


class OpenAICompatClient:
    """Minimal OpenAI-compatible chat client over urllib (no SDK dep).

    Config from env: BSC_NAV_LLM_BASE_URL (default api.openai.com),
    BSC_NAV_LLM_API_KEY."""

    def __init__(self, base_url: Optional[str] = None,
                 api_key: Optional[str] = None):
        self.base_url = (base_url
                         or os.environ.get("BSC_NAV_LLM_BASE_URL")
                         or "https://api.openai.com/v1")
        self.api_key = api_key or os.environ.get("BSC_NAV_LLM_API_KEY", "")

    def chat(self, model: str, messages: List[dict],
             timeout: float = 500.0) -> str:
        import urllib.request

        req = urllib.request.Request(
            self.base_url.rstrip("/") + "/chat/completions",
            data=json.dumps({"model": model, "messages": messages}).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = json.loads(resp.read())
        return out["choices"][0]["message"]["content"]


class MockLLMClient:
    """Deterministic test client.  `responders` is an ordered list of
    (predicate(prompt_text) -> bool, response_fn(prompt_text) -> str)."""

    def __init__(self, responders=None, default: str = "Success: no\nmock"):
        self.responders = responders or []
        self.default = default
        self.calls: List[Dict[str, Any]] = []

    def chat(self, model: str, messages: List[dict],
             timeout: float = 500.0) -> str:
        text = json.dumps(messages)
        self.calls.append({"model": model, "messages": messages})
        for pred, fn in self.responders:
            if pred(text):
                return fn(text)
        return self.default


def retry(fn: Callable[[], str], attempts: int = 5, base_delay: float = 2.0,
          validate: Optional[Callable[[str], bool]] = None) -> str:
    """Bounded retry with exponential backoff (replaces the reference's
    unbounded while-True/sleep(50) loops)."""
    last_err: Optional[Exception] = None
    for i in range(attempts):
        try:
            out = fn()
            if validate is None or validate(out):
                return out
            last_err = ValueError(f"invalid response: {out[:200]!r}")
        except Exception as e:          # noqa: BLE001 - network layer
            last_err = e
        if i + 1 < attempts:
            time.sleep(base_delay * (2 ** i))
    raise RuntimeError(f"LLM call failed after {attempts} attempts: {last_err}")


# --------------------------------------------------------------------------
# image packing (reference LLMAgent.py:272-282; PNG, see above)
# --------------------------------------------------------------------------

PNG_LEVEL = 1      # zlib level: the robots pack 680x680 views per call


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """An image [H, W, 3] / [H, W, 4] (the alpha dropped) or [H, W]
    (grey, as RGB) of uint8 as an 8-bit RGB PNG, every row filter 0."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    arr = np.ascontiguousarray(arr[:, :, :3], dtype=np.uint8)
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, 3 * w)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), PNG_LEVEL))
            + _png_chunk(b"IEND", b""))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}     # greyscale, RGB, RGBA


def _png_chunks(data: bytes):
    """(kind, payload) of each chunk, its CRC checked."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG: bad signature")
    i = 8
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError("PNG: truncated chunk")
        (n,) = struct.unpack(">I", data[i:i + 4])
        kind, payload = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if len(payload) != n or i + 12 + n > len(data):
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[i + 8 + n:i + 12 + n])
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: CRC mismatch in the {kind!r} chunk")
        yield kind, payload
        i += 12 + n


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One scanline's bytes with its filter undone (PNG spec 9.2), given
    the previous reconstructed scanline (zeros above the first)."""
    if kind == 0:
        return row
    if kind == 2:                                            # Up
        return row + prev
    if kind == 1:                                            # Sub
        out = row.reshape(-1, bpp).astype(np.uint64).cumsum(axis=0)
        return (out % 256).astype(np.uint8).reshape(-1)
    if kind not in (3, 4):
        raise ValueError(f"PNG: unknown row filter {kind}")
    r, b = row.tolist(), prev.tolist()
    out = [0] * len(r)
    for x in range(len(r)):
        a = out[x - bpp] if x >= bpp else 0
        if kind == 3:                                        # Average
            out[x] = (r[x] + ((a + b[x]) >> 1)) & 0xFF
            continue
        c = b[x - bpp] if x >= bpp else 0                    # Paeth
        p = a + b[x] - c
        pa, pb, pc = abs(p - a), abs(p - b[x]), abs(p - c)
        pred = a if pa <= pb and pa <= pc else b[x] if pb <= pc else c
        out[x] = (r[x] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit greyscale, RGB or RGBA non-interlaced PNG as uint8
    [H, W] / [H, W, 3] / [H, W, 4].  Every chunk's CRC is checked; any
    other bit depth, colour type or interlace raises ``ValueError``."""
    header, idat = None, []
    for kind, payload in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    else:
        raise ValueError("PNG: no IEND chunk")
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, comp, filt, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0 \
            or comp != 0 or filt != 0:
        raise ValueError(
            f"PNG: bit depth {depth}, colour type {color}, interlace "
            f"{interlace} (this reader takes 8-bit greyscale, RGB and RGBA, "
            "non-interlaced)")
    ch = _PNG_CHANNELS[color]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG: {raw.size} bytes of scanlines, the header "
                         f"needs {h * (stride + 1)}")
    lines = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(lines[y, 0]), lines[y, 1:], prev,
                                      ch)
    return out.reshape(h, w) if ch == 1 else out.reshape(h, w, ch)


def images_to_base64(images: Sequence) -> List[str]:
    return [base64.b64encode(encode_png(img)).decode() for img in images]


def _img_content(images) -> List[dict]:
    return [
        {"type": "image_url",
         "image_url": {"url": f"data:image/png;base64,{b}"}}
        for b in images_to_base64(images)
    ]


def _user(content) -> List[dict]:
    return [{"role": "system", "content": "You are a helpful assistant."},
            {"role": "user", "content": content}]


# --------------------------------------------------------------------------
# prompt functions (reference LLMAgent.py roles; fresh wording, identical
# output contracts)
# --------------------------------------------------------------------------

def imagenary_helper(client: ChatClient, text_prompt: str,
                     model: str = "gpt-4o") -> str:
    """Goal text -> enriched text-to-image prompt (LLMAgent.py:70-143).
    Returns the enhanced description directly."""
    content = (
        "Rewrite the following navigation-goal phrase as a rich, concrete "
        "text-to-image prompt.  Add plausible material, color, texture, "
        "lighting and nearby-context details, but keep the named object "
        "unmistakably dominant and centered; do not invent competing "
        "subjects.  Answer with the enhanced description only, at most 70 "
        f"words.\n\nGoal phrase: \"{text_prompt}\""
    )
    return client.chat(model, _user(content))


def imagenary_helper_visaug(client: ChatClient, text_prompt: str,
                            views: Sequence, model: str = "gpt-4o") -> str:
    """Scene-conditioned prompt enhancement (LLMAgent.py:9-67).  Output
    must contain the '**Enhancement Description**:' field the caller
    parses (objnav_benchmark.py:608-615)."""
    content = [
        {"type": "text", "text": (
            "You see snapshots of the scene an agent is exploring.  Using "
            "the scene's style and materials, rewrite the goal phrase "
            f"\"{text_prompt}\" as a vivid text-to-image prompt (max 70 "
            "words) in which the goal object stays the dominant subject.  "
            "Reply in the exact format:\n"
            "**analysis process**: <your reasoning>\n"
            "**Enhancement Description**: <the enhanced description>")},
    ] + _img_content(views[:2])
    return client.chat(model, _user(content))


def imagenary_helper_long_text(client: ChatClient,
                               text_prompt: Sequence[str],
                               model: str = "gpt-4o") -> str:
    """Merge intrinsic+extrinsic attribute descriptions into one
    text-to-image prompt (LLMAgent.py:145-204)."""
    intrinsic, extrinsic = text_prompt[0], text_prompt[1]
    content = (
        "Merge the two descriptions below into one coherent text-to-image "
        "prompt (max 70 words).  Keep the described object the visual "
        "focus; the surroundings may appear but must not contradict or "
        "overshadow it.  Answer with the merged description only.\n\n"
        f"Object appearance: {intrinsic}\n\nSurroundings: {extrinsic}"
    )
    return client.chat(model, _user(content))


def long_memory_localized(client: ChatClient, text_prompt: str,
                          long_memory: List[dict],
                          model: str = "gpt-4o") -> str:
    """Pick matching instance locations from the long-term memory list
    (LLMAgent.py:208-270).  Output contract (parsed at
    objnav_benchmark.py:504-517):
      '**Result**: (Nav Loc 1: [r,c,h], Nav Loc 2: [...], ...)'  or
      '**Result**: (Nav Loc: Unable to find)'."""
    content = (
        "You are given a navigation goal and a memory list of detected "
        "object instances, each {label, loc: [r, c, h], confidence}.  "
        "Select the instances whose label best matches the goal "
        "semantically (accept synonyms); merge near-duplicate locations, "
        "preferring higher confidence; return up to three locations.  "
        "Reply EXACTLY in one of these formats:\n"
        "**Result**: (Nav Loc 1: [r,c,h], Nav Loc 2: [r,c,h], Nav Loc 3: [r,c,h])\n"
        "**Result**: (Nav Loc: Unable to find)\n\n"
        f"Goal: {text_prompt}\nMemory: {json.dumps(long_memory)}"
    )
    return client.chat(model, _user(content))


def succeed_determine_singleview(client: ChatClient, text_prompt: str,
                                 views: Sequence,
                                 model: str = "gpt-4o") -> str:
    """Single-view success judge (LLMAgent.py:388-450).  Contract
    (objnav_benchmark.py:305-306): lines 'Success: yes|no' and, when yes,
    'need forward: yes|no'."""
    content = [
        {"type": "text", "text": (
            "Judge whether the robot's observation shows the navigation "
            "goal close by (within 2 m).  Beware of confusable categories "
            "(e.g. sofa vs chair).  If the goal is visible but more than "
            "about 1 m away, it should still step closer.  Reply EXACTLY:\n"
            "Success: yes OR Success: no\n"
            "need forward: yes OR need forward: no   (only when Success: yes)\n"
            "then your analysis.\n\n"
            f"Goal: {text_prompt}\nObservation:")},
    ] + _img_content(views)
    return client.chat(model, _user(content))


def succeed_determine_singleview_with_imggoal(client: ChatClient, goal_img,
                                              views: Sequence,
                                              model: str = "gpt-4o") -> str:
    """Image-goal success judge (LLMAgent.py:454-524); same contract."""
    content = (
        [{"type": "text", "text": (
            "Compare the goal image with the robot's current observation "
            "and judge whether the robot stands where the goal image was "
            "taken (viewpoints may differ).  Reply EXACTLY:\n"
            "Success: yes OR Success: no\n"
            "need forward: yes OR need forward: no   (only when Success: yes)\n"
            "then your analysis.\nGoal image:")}]
        + _img_content([goal_img])
        + [{"type": "text", "text": "Current observation:"}]
        + _img_content(views[:1])
    )
    return client.chat(model, _user(content))


def succeed_determine(client: ChatClient, text_prompt: str,
                      views: Sequence, model: str = "gpt-4o") -> str:
    """Two-view success judge (LLMAgent.py:331-384).  Contract: first
    line 'Success: yes|no'."""
    content = [
        {"type": "text", "text": (
            "Given observation images from different headings and a goal "
            "description, judge whether the agent has arrived near the "
            "goal.  Reply with the first line EXACTLY 'Success: yes' or "
            f"'Success: no', then your analysis.\nGoal: {text_prompt}")},
    ] + _img_content(views)
    return client.chat(model, _user(content))


def touching_helper(client: ChatClient, text_prompt: str, views: Sequence,
                    model: str = "gpt-4o") -> str:
    """One-step local policy near the goal (LLMAgent.py:528-599).
    Contract (objnav_benchmark.py:674): \"**Strategy**: 'xxx'\" with xxx in
    move_forward/turn_left/turn_right/look_up/look_down/finish_task."""
    content = [
        {"type": "text", "text": (
            "You are finishing a navigation task and must close the last "
            "meters to the goal.  From the observation, decide ONE next "
            "action among ['move_forward', 'turn_left', 'turn_right', "
            "'look_up', 'look_down', 'finish_task'] (finish_task when "
            "within 1 m).  Reply EXACTLY in the format: "
            "**Strategy**: 'xxx'\n\n"
            f"Goal: {text_prompt}\nObservation:")},
    ] + _img_content(views[:1])
    return client.chat(model, _user(content))


def vln_subgoal_planner_with_obs(client: ChatClient, text_prompt: str,
                                 model: str = "gpt-4o") -> str:
    """Instruction -> numbered '{...}' subgoal list (LLMAgent.py:604-656).
    Contract (objnav_benchmark.py:1113-1116): lines like
    '1. Move to the {X}'."""
    content = (
        "Decompose the indoor navigation instruction below into an ordered "
        "list of sub-goals.  Each line must have the exact form\n"
        "N. Move to the {target}\n"
        "where {target} names an object or room area in braces.  Output "
        "only the numbered list.\n\n"
        f"Instruction: \"{text_prompt}\""
    )
    return client.chat(model, _user(content))


def vln_subgoal_planner_no_object(client: ChatClient, text_prompt: str,
                                  model: str = "gpt-4o") -> str:
    """Instruction -> numbered '{...}' step list (LLMAgent.py:660-714)."""
    content = (
        "Split the navigation instruction below into ordered steps.  Each "
        "line must have the exact form\nN. {step description}\n"
        "Output only the numbered list.\n\n"
        f"Instruction: \"{text_prompt}\""
    )
    return client.chat(model, _user(content))


def vln_anchor_planner(client: ChatClient, text_prompt: str,
                       views: Sequence, model: str = "gpt-4o") -> str:
    """Choose a direction and describe the anchor object
    (LLMAgent.py:717-773).  Contract: contains 'Anchor Object:'."""
    content = [
        {"type": "text", "text": (
            "Given the navigation instruction and panoramic observations, "
            "pick the image matching the instructed direction, then "
            "describe in detail the most salient physical object the agent "
            "will reach there.  Reply in the format:\n"
            "Analysis: <your analysis>\n"
            "Anchor Object: <detailed appearance description>\n\n"
            f"Instruction: {text_prompt}\nObservations:")},
    ] + _img_content(views)
    return client.chat(model, _user(content))


def vln_anchor_planner_v2(client: ChatClient, text_prompt: str,
                          views: Sequence, model: str = "o3") -> str:
    """Fine-grained anchor description (LLMAgent.py:779-833, model 'o3').
    Output is the description text directly."""
    content = [
        {"type": "text", "text": (
            "The instruction below names a nearby target only coarsely.  "
            "Look at the observations: if the target is visible, describe "
            "its appearance (shape, color, texture) in detail; if not, "
            "infer a plausible detailed description from the surroundings. "
            "Output the description only.\n\n"
            f"Instruction: {text_prompt}\nObservations:")},
    ] + _img_content(views)
    return client.chat(model, _user(content))


def EQA_generate_anchor_object(client: ChatClient, text_prompt: str,
                               model: str = "o3-mini") -> str:
    """Question -> anchor instance to navigate to (LLMAgent.py:837-888).
    Contract (agent_eqa.py:238-246): either contains '{...}' with the
    anchor description, or says to go around and check."""
    content = (
        "To answer the scene question below, the robot first navigates to "
        "the relevant instance.  If the question implies a concrete target "
        "instance, reply EXACTLY: 'Now, we need to go to {<description of "
        "the instance, with room/context>}'.  If no concrete target can be "
        "inferred, reply EXACTLY: 'We need to go around and check.'\n\n"
        f"Question: {text_prompt}"
    )
    return client.chat(model, _user(content))


def EQA_Answer_4o(client: ChatClient, text_prompt: str, views: Sequence,
                  model: str = "gpt-4o") -> str:
    """Answer the question from collected views (LLMAgent.py:942-991).
    Output is the free-form answer."""
    content = [
        {"type": "text", "text": (
            "Answer the question about this indoor space using the "
            "observation images.  If the images are inconclusive, give the "
            "most plausible answer anyway -- never refuse.  Output the "
            f"answer text only.\n\nQuestion: {text_prompt}\nObservations:")},
    ] + _img_content(views)
    return client.chat(model, _user(content))


def EQA_Answer_o3(client: ChatClient, text_prompt: str, views: Sequence,
                  model: str = "o3-mini") -> str:
    """o3 variant of the EQA answerer (LLMAgent.py:891-940)."""
    return EQA_Answer_4o(client, text_prompt, views, model=model)
