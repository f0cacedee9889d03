"""Load ViT and CLIP weights (the SD3 text towers included) into the torch
modules, and the MMDiT, VAE, T5, YOLO-World, Grounding DINO and Qwen2.5-VL
weights into the port's dict trees.

Two sources, one key scheme: the JAX params tree (nested dicts and lists,
``bsc_nav_tpu/models/vit.py`` layout, linear ``w`` stored
``[fan_in, fan_out]``) and the ``.npz`` that
``bsc_nav_tpu.models.weights.save_params_npz`` writes, whose keys are the
tree's paths joined by dots (``blocks.3.qkv.w``).  Those dotted keys are
exactly the modules' ``state_dict()`` keys, so loading is a strict
``load_state_dict`` and a missing or extra tensor raises.  A CLIP tree may
hold int8 ``w_q`` / ``w_s`` leaves (``clip.quantize_params``); the towers
that do are built quantized.  The MMDiT, VAE and T5 keep the JAX tree
itself (nested dicts and lists of tensors), so their loaders only rebuild
the tree from the dotted keys and move each leaf to the device; the
YOLO-World loader then folds each 3x3 stride-1 conv's BN into K8's
operands (``yolo_world.fold_params``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from bsc_nav_tpu_torch import resolve_device

from bsc_nav_tpu_torch.models.clip import CLIP, CLIPConfig, TextTower
from bsc_nav_tpu_torch.models.grounding_dino import GroundingDinoConfig
from bsc_nav_tpu_torch.models.mmdit import MMDiTConfig
from bsc_nav_tpu_torch.models.qwen_vl import QwenVLConfig
from bsc_nav_tpu_torch.models.t5 import T5Config
from bsc_nav_tpu_torch.models.vae import VAEConfig
from bsc_nav_tpu_torch.models.vit import ViT, ViTConfig
from bsc_nav_tpu_torch.models import yolo_world


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list tree -> {dotted path: numpy array} (the key scheme
    of the JAX package's ``flatten_params``)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}."))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def unflatten_params(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{dotted path: array} -> nested tree; a dict whose keys are all
    digits becomes a list (the JAX package's ``unflatten_params``)."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def _fill(model, flat: Mapping[str, np.ndarray]):
    """Strict load; each tensor takes its parameter's dtype (int8 leaves
    stay int8; floats, bf16 included, pass through f32)."""
    want = model.state_dict()

    def tensor(k, v):
        a = np.asarray(v)
        t = torch.from_numpy(np.array(a, np.int8 if a.dtype == np.int8
                                      else np.float32))       # writable
        return t.to(want[k].dtype) if k in want else t

    sd = {k: tensor(k, v) for k, v in flat.items()}
    model.load_state_dict(sd, strict=True)
    return model


def vit_from_jax_params(params: Any, cfg: ViTConfig, dtype=torch.float32,
                        device="cuda") -> ViT:
    """A ViT holding the weights of a JAX params tree (numpy leaves)."""
    return _fill(ViT(cfg, dtype=dtype, device=device),
                 flatten_params(params))


def load_dinov2_npz(path: str, cfg: ViTConfig, dtype=torch.float32,
                    device="cuda") -> ViT:
    """A ViT holding the weights of a converted ``.npz``."""
    with np.load(path) as z:
        return _fill(ViT(cfg, dtype=dtype, device=device), dict(z.items()))


def _clip(flat: Mapping[str, np.ndarray], cfg: CLIPConfig, dtype,
          device) -> CLIP:
    q = {t for t in ("visual", "text")
         if any(k.startswith(t + ".") and k.endswith(".w_q") for k in flat)}
    quantized = ("both" if len(q) == 2 else q.pop() if q else "none")
    return _fill(CLIP(cfg, dtype=dtype, device=device, quantized=quantized),
                 flat)


def clip_from_jax_params(params: Any, cfg: CLIPConfig, dtype=torch.float32,
                         device="cuda") -> CLIP:
    """A CLIP holding the weights of a JAX ``clip.init_params`` tree (numpy
    leaves), quantized or not."""
    return _clip(flatten_params(params), cfg, dtype, device)


def load_clip_npz(path: str, cfg: CLIPConfig, dtype=torch.float32,
                  device="cuda") -> CLIP:
    """A CLIP holding the weights of the ``.npz`` that
    ``tools/convert_weights.py clip`` writes."""
    with np.load(path) as z:
        return _clip(dict(z.items()), cfg, dtype, device)


def load_clip_text_npz(path: str, cfg: CLIPConfig, dtype=torch.float32,
                       device="cuda") -> TextTower:
    """A CLIP text tower (``clip.TextTower``) holding the weights of the
    ``sd3_clip_l.npz`` / ``sd3_clip_g.npz`` that ``tools/
    convert_weights.py clip-text`` writes (``convert_clip_text_hf``), or
    the text tower of a two-tower CLIP ``.npz`` (``load_clip_npz``'s
    format, e.g. ``metaclip_vith14.npz``): its ``text.`` leaves, the
    vision tower left unread."""
    with np.load(path) as z:
        names = [k for k in z.files if k.startswith("text.")]
        flat = ({k[len("text."):]: z[k] for k in names} if names
                else dict(z.items()))
    return _fill(TextTower(cfg, dtype, resolve_device(device)), flat)


def _tree(params: Any, dtype, device, name: str = "") -> Any:
    """A numpy tree as tensors on ``device``: int8 leaves stay int8, other
    integer leaves (index tables) become int64, the int8 leaves' f32
    scales ``w_s`` stay f32, floats take ``dtype``."""
    if isinstance(params, dict):
        return {k: _tree(v, dtype, device, k) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_tree(v, dtype, device) for v in params]
    a = np.asarray(params)
    if a.dtype == np.int8:
        return torch.from_numpy(np.array(a)).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64)).to(device)
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(device=device,
                dtype=torch.float32 if name == "w_s" else dtype)


def _check_depth(tree, n: int, what: str) -> None:
    if len(tree["blocks"]) != n:
        raise ValueError(f"{what}: {len(tree['blocks'])} blocks, the config "
                         f"has {n}")


def mmdit_from_jax_params(params: Any, cfg: MMDiTConfig,
                          dtype=torch.float32, device="cuda") -> dict:
    """The port's MMDiT tree from a JAX ``mmdit.init_params`` /
    ``convert_sd3`` tree (numpy leaves), quantized or not.  A tree without
    ``q_norm`` / ``k_norm`` leaves (SD3-medium) needs ``cfg.qk_norm``
    False, and one with them True."""
    _check_depth(params, cfg.depth, "mmdit")
    has_norm = {"q_norm" in s for blk in params["blocks"]
                for s in (blk["x"], blk["ctx"])}
    if has_norm - {cfg.qk_norm}:
        raise ValueError(f"mmdit: qk-norm leaves {sorted(has_norm)} in the "
                         f"tree, the config has qk_norm={cfg.qk_norm}")
    return _tree(params, dtype, resolve_device(device))


def vae_from_jax_params(params: Any, cfg: VAEConfig, dtype=torch.float32,
                        device="cuda") -> dict:
    """The port's VAE decoder tree from a JAX ``vae.init_params`` /
    ``convert_vae_decoder`` tree (numpy leaves)."""
    if len(params["stages"]) != len(cfg.channel_mults):
        raise ValueError(f"vae: {len(params['stages'])} stages, the config "
                         f"has {len(cfg.channel_mults)}")
    return _tree(params, dtype, resolve_device(device))


def t5_from_jax_params(params: Any, cfg: T5Config, dtype=torch.float32,
                       device="cuda") -> dict:
    """The port's T5 encoder tree from a JAX ``t5.init_params`` /
    ``convert_t5`` tree or a ``quantize_params_host`` tree (numpy
    leaves)."""
    _check_depth(params, cfg.layers, "t5")
    return _tree(params, dtype, resolve_device(device))


def _npz_tree(path: str) -> dict:
    with np.load(path) as z:
        return unflatten_params(dict(z.items()))


def load_sd35_medium_npz(path: str, cfg: MMDiTConfig, dtype=torch.float32,
                         device="cuda") -> dict:
    """The MMDiT tree of the ``sd35_medium.npz`` that ``save_params_npz``
    writes."""
    return mmdit_from_jax_params(_npz_tree(path), cfg, dtype, device)


def load_sd3_vae_npz(path: str, cfg: VAEConfig, dtype=torch.float32,
                     device="cuda") -> dict:
    """The VAE decoder tree of ``sd3_vae.npz``."""
    return vae_from_jax_params(_npz_tree(path), cfg, dtype, device)


def load_t5_xxl_npz(path: str, cfg: T5Config, dtype=torch.float32,
                    device="cuda") -> dict:
    """The T5 encoder tree of ``t5_xxl.npz``."""
    return t5_from_jax_params(_npz_tree(path), cfg, dtype, device)


def yolo_world_from_jax_params(params: Any, cfg: "yolo_world.YoloWorldConfig",
                               dtype=torch.float32, device="cuda") -> dict:
    """The port's YOLO-World tree from a JAX ``yolo_world.init_params`` /
    ``convert_ultralytics`` tree or a ``quantize_params`` tree (numpy
    leaves; int8 ``w_q`` with f32 ``w_s`` kept), folded for K8."""
    if params["stem0"]["w"].shape[-1] != cfg.ch(64):
        raise ValueError(f"yolo_world: stem width "
                         f"{params['stem0']['w'].shape[-1]}, the config "
                         f"has {cfg.ch(64)}")
    if len(params["c2f_2"]["m"]) != cfg.n(3):
        raise ValueError(f"yolo_world: {len(params['c2f_2']['m'])} "
                         f"bottlenecks in c2f_2, the config has {cfg.n(3)}")
    return yolo_world.fold_params(_tree(params, dtype,
                                        resolve_device(device)))


def load_yolo_world_npz(path: str, cfg: "yolo_world.YoloWorldConfig",
                        dtype=torch.float32, device="cuda") -> dict:
    """The YOLO-World tree of the ``yolov8x_worldv2.npz`` that
    ``save_params_npz`` writes from ``convert_ultralytics``."""
    return yolo_world_from_jax_params(_npz_tree(path), cfg, dtype, device)


def qwen_vl_from_jax_params(params: Any, cfg: QwenVLConfig,
                            dtype=torch.bfloat16, device="cuda") -> dict:
    """The port's Qwen2.5-VL tree from a JAX ``qwen_vl.init_params`` /
    ``convert_hf`` tree or a ``quantize_params`` tree (numpy leaves; int8
    ``w_q`` with f32 ``w_s`` kept)."""
    if len(params["layers"]) != cfg.text.layers:
        raise ValueError(f"qwen_vl: {len(params['layers'])} decoder layers, "
                         f"the config has {cfg.text.layers}")
    if len(params["vision"]["blocks"]) != cfg.vision.depth:
        raise ValueError(f"qwen_vl: {len(params['vision']['blocks'])} "
                         f"vision blocks, the config has {cfg.vision.depth}")
    if tuple(np.shape(params["embed"])) != (cfg.text.vocab,
                                            cfg.text.hidden):
        raise ValueError(f"qwen_vl: embed {np.shape(params['embed'])}, the "
                         f"config has ({cfg.text.vocab}, {cfg.text.hidden})")
    return _tree(params, dtype, resolve_device(device))


def load_qwen_vl_npz(path: str, cfg: QwenVLConfig, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    """The Qwen2.5-VL tree of the flat ``qwen_vl.npz`` that the JAX
    package's ``load_local_vlm`` reads (``save_params_npz`` of a
    ``convert_hf`` tree), in ``dtype`` (bf16, as that loader's default)."""
    return qwen_vl_from_jax_params(_npz_tree(path), cfg, dtype, device)


def grounding_dino_from_jax_params(params: Any, cfg: GroundingDinoConfig,
                                   device="cuda") -> dict:
    """The port's Grounding DINO tree from a JAX ``grounding_dino.
    init_params`` / ``convert_hf`` tree (numpy leaves): f32 leaves, the
    Swin blocks' integer ``rpb_index`` tables as int64 (index) tensors."""
    sw = cfg.swin
    depths = tuple(len(s["blocks"]) for s in params["backbone"]["stages"])
    if depths != tuple(sw.depths):
        raise ValueError(f"grounding_dino: Swin depths {depths}, the config "
                         f"has {sw.depths}")
    n = (len(params["text"]["layers"]), len(params["encoder"]["layers"]),
         len(params["decoder"]["layers"]))
    want = (cfg.text.layers, cfg.encoder_layers, cfg.decoder_layers)
    if n != want:
        raise ValueError(f"grounding_dino: (BERT, encoder, decoder) layers "
                         f"{n}, the config has {want}")
    return _tree(params, torch.float32, resolve_device(device))


def load_grounding_dino_npz(path: str, cfg: GroundingDinoConfig,
                            device="cuda") -> dict:
    """The Grounding DINO tree of the ``grounding_dino_tiny.npz`` that
    ``save_params_npz`` writes from ``convert_hf`` (990 leaves at
    GROUNDING_DINO_TINY)."""
    return grounding_dino_from_jax_params(_npz_tree(path), cfg, device)
