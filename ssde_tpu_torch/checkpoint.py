"""Weights for the port: the JAX package's trees -> torch ``state_dict``s, and
the reference's per-module ``.pth`` folder.

``encoder_from_flax`` (the depth encoder and the pose encoder),
``depth_from_flax`` (also the predictive-mask decoder),
``pose_decoder_from_flax``, ``pose_cnn_from_flax``, ``gru_from_flax``,
``head_from_flax`` and ``fusion_from_flax`` invert
``ssde_tpu/checkpoint.py``'s ``convert_resnet_encoder`` (:132),
``convert_depth_decoder`` (:187), ``convert_pose_decoder`` (:216),
``convert_pose_cnn`` (:229), ``convert_gru_blocks`` (:312),
``convert_head`` (:350) and ``convert_fusion_v2`` (:361): conv kernels
HWIO -> OIHW, ``h0`` and ``c0`` (1, H, W, C) -> (1, C, H, W), BatchNorm
``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/``running_mean``/
``running_var``. ``dpt_from_flax`` and ``attention_encoder_from_flax``
have no JAX converter to invert: the port's modules carry the JAX trees'
names, and they rename and transpose. Trees are nested dicts of numpy
arrays; nothing here imports flax.

The folder layout is the reference's (``ssde_tpu/checkpoint.py:3-8``,
reference trainer.py:711-763): ``weights_<epoch>/`` holds one ``.pth``
state dict per module (``encoder``, ``depth``, ``pose_encoder``, ``pose``,
``gru``, ``head``, ``fusion``, ``dpt``, ``predictive_mask``), ``encoder.pth``
also carries the ``height``, ``width`` and ``use_stereo`` entries, and
``adam.pth`` the optimizer's state dict.
:func:`save_folder` writes it, :func:`load_folder` reads it; one module's
file is read by :func:`read_module` and loaded strictly, so a file whose
keys or shapes do not match raises. A missing file is skipped, as the
reference's ``load_model`` skips it.

The JAX package's own folders hold ``<name>.ckpt`` files instead
(``ssde_tpu/checkpoint.py:30-101``): a pickle of ``{"params": flax msgpack
bytes, "extra": {...}}``, ``extra`` holding ``batch_stats`` as msgpack
bytes and, for the encoder, ``height``/``width``/``use_stereo``; ``adam.ckpt``
holds the optax state. :func:`load_module`, :func:`save_module` and
:func:`save_checkpoint` read and write them (:mod:`.serialization`, no
flax), :func:`read_ckpt_folder` loads such a folder into a bundle through
the converters above, and :func:`load_adam_ckpt` maps ``adam.ckpt``'s
moments onto the port's Adam. A folder that holds any ``.pth`` is read as
``.pth``, otherwise as ``.ckpt`` (the JAX rule, ``ssde_tpu/train/
trainer.py:360-383``). The copies of the JAX converters
(``convert_resnet_encoder`` and the rest, :func:`flax_state`) give the JAX
trees of the port's modules, so the port writes such a folder without JAX.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.depth_decoder import module_order
from .serialization import msgpack_restore, msgpack_serialize

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _oihw(kernel) -> torch.Tensor:
    """(kh, kw, I, O) -> (O, I, kh, kw)."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _bn(sd: StateDict, prefix: str, params, stats) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def encoder_from_flax(params: Mapping, batch_stats: Mapping) -> StateDict:
    """``ssde_tpu.models.ResnetEncoder`` (params, batch_stats) ->
    ``ResnetEncoder`` state_dict (``encoder.*`` keys)."""
    sd: StateDict = {"encoder.conv1.weight": _oihw(params["conv1"]["kernel"])}
    _bn(sd, "encoder.bn1", params["bn1"]["bn"], batch_stats["bn1"]["bn"])
    blocks = sorted((k for k in params if k.startswith("layer")),
                    key=lambda k: tuple(int(n) for n in k[5:].split("_")))
    for name in blocks:
        stage, idx = name[5:].split("_")
        base = f"encoder.layer{stage}.{idx}"
        p, s = params[name], batch_stats[name]
        for sub in sorted(p):
            if sub.startswith("conv"):
                sd[f"{base}.{sub}.weight"] = _oihw(p[sub]["kernel"])
            elif sub.startswith("bn"):
                _bn(sd, f"{base}.{sub}", p[sub]["bn"], s[sub]["bn"])
        if "downsample_conv" in p:
            sd[f"{base}.downsample.0.weight"] = _oihw(p["downsample_conv"]["kernel"])
            _bn(sd, f"{base}.downsample.1", p["downsample_bn"]["bn"],
                s["downsample_bn"]["bn"])
    return sd


def depth_from_flax(params: Mapping, scales=(0, 1, 2, 3)) -> StateDict:
    """``ssde_tpu.models.DepthDecoder`` params -> ``DepthDecoder`` state_dict.

    A tree built with ``pre_disp=True`` has no ``dispconv_*`` entries
    (ssde_tpu/train/steps_gru.py:278-279); their keys are then absent here,
    and :func:`load_depth` keeps the module's own dispconv weights.
    """
    sd: StateDict = {}
    for idx, name in enumerate(module_order(scales)):
        if name not in params:
            if name.startswith("dispconv"):
                continue
            raise KeyError(f"decoder tree has no {name!r}")
        leaf = params[name]["conv"]
        if name.startswith("upconv"):  # ConvBlock -> Conv3x3 -> nn.Conv
            leaf, prefix = leaf["conv"], f"decoder.{idx}.conv.conv"
        else:
            prefix = f"decoder.{idx}.conv"
        sd[f"{prefix}.weight"] = _oihw(leaf["kernel"])
        sd[f"{prefix}.bias"] = _t(leaf["bias"])
    return sd


def pose_decoder_from_flax(params: Mapping) -> StateDict:
    """``ssde_tpu.models.PoseDecoder`` params -> ``PoseDecoder`` state_dict
    (inverse of ``convert_pose_decoder``, :216: ``net.0`` squeeze,
    ``net.1``..``net.3`` pose_0..pose_2)."""
    sd: StateDict = {}
    for idx, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        sd[f"net.{idx}.weight"] = _oihw(params[name]["kernel"])
        sd[f"net.{idx}.bias"] = _t(params[name]["bias"])
    return sd


def pose_cnn_from_flax(params: Mapping) -> StateDict:
    """``ssde_tpu.models.PoseCNN`` params -> ``PoseCNN`` state_dict (inverse
    of ``convert_pose_cnn``, :229-240: ``conv_N`` -> ``net.N``,
    ``pose_conv`` as it is)."""
    sd: StateDict = {}
    for name in sorted(params):
        if name.startswith("conv_"):
            _conv(sd, f"net.{name[5:]}", params[name])
        elif name == "pose_conv":
            _conv(sd, name, params[name])
        else:
            raise KeyError(f"unexpected PoseCNN tree entry {name!r}")
    return sd


def _attention_conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    """Inverse of ``_convert_attention_conv`` (:279-296): the q/k/v 1x1
    kernels and biases, and the relative embeddings back to the reference's
    shapes, (C/2, k) -> (C/2, 1, 1, k, 1) and (C/2, 1, 1, 1, k), a shared
    (k,) -> (1, 1, 1, k, 1) and (1, 1, 1, 1, k). ``prefix`` is '' or ends
    in a dot."""
    for conv in ("key_conv", "query_conv", "value_conv"):
        sd[f"{prefix}{conv}.weight"] = _oihw(p[conv]["kernel"])
        if "bias" in p[conv]:
            sd[f"{prefix}{conv}.bias"] = _t(p[conv]["bias"])
    for rel, shape in (("rel_h", (1, 1, -1, 1)), ("rel_w", (1, 1, 1, -1))):
        r = np.asarray(p[rel])
        sd[f"{prefix}{rel}"] = _t(r.reshape((r.shape[0] if r.ndim == 2 else 1,) + shape))


def _conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    """A flax conv's ``kernel`` and ``bias`` -> ``prefix.weight``/``.bias``."""
    sd[f"{prefix}.weight"] = _oihw(p["kernel"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _residual_units(sd: StateDict, prefix: str, p: Mapping) -> None:
    """The ``resConfUnit{n}`` entries of a fusion block's tree ``p``, conv
    or attention units (``_convert_rcu``, :299-309), under ``prefix``."""
    for rcu in sorted(k for k in p if k.startswith("resConfUnit")):
        for i in (1, 2):
            if f"atten{i}" in p[rcu]:
                _attention_conv(sd, f"{prefix}{rcu}.atten{i}.", p[rcu][f"atten{i}"])
            else:
                _conv(sd, f"{prefix}{rcu}.conv{i}", p[rcu][f"conv{i}"])


def gru_from_flax(params: Mapping) -> StateDict:
    """``ssde_tpu.models.ConvGRUBlocks`` params -> ``ConvGRUBlocks``
    state_dict, every version: the units' ``h0`` and ``c0`` and their GRU
    (``cgru_1``) or LSTM (``clstm_1``) cell, the block's own ``conv3x3_{s}``
    heads (v1, v3), and the fusion blocks (``GRUFusionBlock``'s three
    residual units or ``GRUFusionBlock_v2``'s two, conv or attention units,
    ``_convert_rcu`` :299-309, and the ``conv3x3`` head)."""
    sd: StateDict = {}
    for name in sorted(params):
        p = params[name]
        if name.startswith("cgru_"):
            for init in ("h0", "c0"):
                if init in p:
                    sd[f"{name}.{init}_layer1"] = _t(np.transpose(np.asarray(p[init]),
                                                                  (0, 3, 1, 2)))
            cell = "clstm_1" if "conv" in p["cell"] else "cgru_1"
            for conv in sorted(p["cell"]):
                _conv(sd, f"{name}.{cell}.{conv}", p["cell"][conv])
        elif name.startswith("conv3x3_"):
            _conv(sd, f"{name}.conv", p["conv"])
        elif name.startswith("fusion_"):
            _residual_units(sd, f"{name}.", p)
            _conv(sd, f"{name}.conv3x3.conv", p["conv3x3"]["conv"])
        else:
            raise KeyError(f"unexpected GRU tree entry {name!r}")
    return sd


def head_from_flax(params: Mapping) -> StateDict:
    """``ssde_tpu.models.Head`` params -> ``Head`` state_dict
    (``conv3x3_{s}.conv``; inverse of ``convert_head``, :350-358)."""
    sd: StateDict = {}
    for name in sorted(params):
        if not name.startswith("conv3x3_"):
            raise KeyError(f"unexpected head tree entry {name!r}")
        _conv(sd, f"{name}.conv", params[name]["conv"])
    return sd


def fusion_from_flax(params: Mapping) -> StateDict:
    """``ssde_tpu.models`` ``Fusion``/``Fusion_v3`` params (blocks
    ``fusion_block_{n}``) or a bare ``FeatureFusionBlock``'s (the
    scale-loop block, units at the root) -> the port's module's state_dict;
    the inverse of ``convert_fusion_v2`` (:361-397): the residual units,
    ``conv_init``/``conv_1``, the ``conv3x3`` depth head and the
    ``upscale``/``upscale_1``/``upscale_2`` convs."""
    def block(sd, prefix, p):
        _residual_units(sd, prefix, p)
        for name in sorted(p):
            if name in ("conv_init", "conv_1"):
                _conv(sd, f"{prefix}{name}", p[name])
            elif name == "conv3x3" or name.startswith("upscale"):
                _conv(sd, f"{prefix}{name}.conv", p[name]["conv"])
            elif not name.startswith("resConfUnit"):
                raise KeyError(f"unexpected fusion tree entry {prefix}{name!r}")

    sd: StateDict = {}
    blocks = sorted(k for k in params if k.startswith("fusion_block_"))
    if not blocks:
        block(sd, "", params)
    elif len(blocks) != len(params):
        raise KeyError(f"unexpected fusion tree entries {sorted(set(params) - set(blocks))}")
    for name in blocks:
        block(sd, f"{name}.", params[name])
    return sd


# flax submodule names whose port counterparts sit elsewhere: a Bottleneck's
# shortcut is the torchvision-style ``downsample`` Sequential
_RENAMES = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _flax_tree(sd: StateDict, prefix: str, params: Mapping, stats: Mapping) -> None:
    """A module tree whose port counterpart carries the flax names, under
    ``prefix``: a conv or Dense ``kernel`` HWIO -> OIHW or (in, out) ->
    (out, in), ``bias`` as it is, a LayerNorm's ``scale`` -> ``weight``, a
    BatchNorm (``<name>/bn``) through :func:`_bn`, an AttentionConv (a node
    with ``rel_h``) through :func:`_attention_conv`, any other leaf (the
    DPT's ``cls_token``, ``pos_embed``) as it is."""
    if "rel_h" in params:
        _attention_conv(sd, prefix, params)
        return
    for name in sorted(params):
        p, key = params[name], f"{prefix}{_RENAMES.get(name, name)}"
        if not isinstance(p, Mapping):
            a = np.asarray(p)
            if name == "kernel":
                sd[f"{prefix}weight"] = _oihw(a) if a.ndim == 4 else _t(a.T)
            else:
                sd[f"{prefix}weight" if name == "scale" else key] = _t(a)
        elif set(p) == {"bn"}:
            _bn(sd, key, p["bn"], stats[name]["bn"])
        else:
            _flax_tree(sd, f"{key}.", p, stats.get(name, {}))


def dpt_from_flax(params: Mapping, batch_stats: Mapping) -> StateDict:
    """``ssde_tpu.models.dpt.DPTDepthModel`` (params, batch_stats) ->
    ``DPTDepthModel`` state_dict. The JAX package has no converter for this
    model, nor the reference a ``.pth`` (its ``dpt`` package is not
    vendored), so the keys are the JAX tree's names and this is a rename
    plus transposes (:func:`_flax_tree`)."""
    sd: StateDict = {}
    _flax_tree(sd, "", params, batch_stats)
    return sd


def attention_encoder_from_flax(params: Mapping, batch_stats: Mapping) -> StateDict:
    """``ssde_tpu.models`` ``ResnetEncoderAttention`` (params, batch_stats)
    -> its port's state_dict: the ResNet part through
    :func:`encoder_from_flax`, ``atten1`` .. ``atten4`` through
    :func:`_attention_conv`. An ``AttentionResNet`` tree, or a bare
    ``AttentionConv``'s (no ``encoder`` entry), goes through
    :func:`_flax_tree`, whose names the port's modules carry. The JAX
    package has no converter for these."""
    if "encoder" not in params:
        sd: StateDict = {}
        _flax_tree(sd, "", params, batch_stats)
        return sd
    sd = encoder_from_flax(params["encoder"], batch_stats["encoder"])
    for name in sorted(params):
        if name.startswith("atten"):
            _attention_conv(sd, f"{name}.", params[name])
        elif name != "encoder":
            raise KeyError(f"unexpected attention encoder tree entry {name!r}")
    return sd


def load_resnet_part(encoder: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Load a plain ResNet encoder's state_dict (a Monodepth2 ``encoder.pth``)
    into ``ResnetEncoderAttention``: every ``encoder.*`` key strictly, the
    attention convs left as they are."""
    res = encoder.load_state_dict(sd, strict=False)
    bad = [k for k in res.missing_keys if not k.startswith("atten")]
    if bad or res.unexpected_keys:
        raise KeyError(f"encoder state_dict mismatch: missing {bad}, "
                       f"unexpected {res.unexpected_keys}")


def load_depth(decoder: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Strict load, except that the dispconv heads may be absent."""
    res = decoder.load_state_dict(sd, strict=False)
    dispconv = {f"decoder.{i}." for i, n in enumerate(module_order(decoder.scales))
                if n.startswith("dispconv")}
    bad = [k for k in res.missing_keys if not any(k.startswith(p) for p in dispconv)]
    if bad or res.unexpected_keys:
        raise KeyError(f"depth state_dict mismatch: missing {bad}, "
                       f"unexpected {res.unexpected_keys}")


# the module files of a folder, in the reference's order, and the entries
# that encoder.pth carries beside its weights
MODULE_NAMES = ("encoder", "depth", "pose_encoder", "pose", "gru", "head", "fusion", "dpt",
                "predictive_mask")
# the module files of a Monodepth2 warm start (``--mono_pretrained``): those
# that ``ssde_tpu/checkpoint.py`` ``load_monodepth2_checkpoint`` (:243-276) reads
WARM_START_NAMES = ("encoder", "depth", "pose_encoder", "pose", "gru", "head", "fusion")
ENCODER_META = ("height", "width", "use_stereo")


def _load_pth(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _cpu(obj):
    """``obj`` with every tensor detached and on the CPU (dicts and lists
    walked), so that a folder saved on the card loads anywhere."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def read_module(path: str) -> Tuple[StateDict, Dict[str, int]]:
    """One module's ``.pth``: (state dict, embedded entries). The encoder's
    ``height``/``width``/``use_stereo`` are returned, not loaded (reference
    trainer.py:717-721), and its classifier (``encoder.fc.*``) is dropped."""
    sd = _load_pth(path)
    meta = {k: int(sd.pop(k)) for k in ENCODER_META if k in sd}
    return {k: v for k, v in sd.items() if not k.startswith("encoder.fc.")}, meta


def folder_format(folder: str) -> str:
    """``".pth"`` when ``folder`` holds any ``.pth`` file, else ``".ckpt"``:
    the JAX package's rule (``ssde_tpu/train/trainer.py:364``,
    ``scripts/evaluate_depth.py:76``)."""
    return ".pth" if any(f.endswith(".pth") for f in os.listdir(folder)) else ".ckpt"


def load_folder(folder: str, models, names: Sequence[str] = MODULE_NAMES
                ) -> Tuple[Dict[str, int], List[str]]:
    """Load ``<folder>/<name>.pth`` into ``models.<name>`` for each of
    ``names`` that the bundle has (``MonoModels``, ``GRUModels``,
    ``FusionModels`` or ``DPTModels``); a missing file is skipped. A folder
    without ``.pth`` files is read as the JAX package's ``.ckpt`` folder
    (:func:`read_ckpt_folder`). Returns (the encoder's embedded entries, the
    names loaded). Strict: a key or shape that does not match raises (the
    depth decoder may lack its dispconv heads, :func:`load_depth`)."""
    if folder_format(folder) == ".ckpt":
        return read_ckpt_folder(folder, models, names)
    meta: Dict[str, int] = {}
    loaded = []
    for name in names:
        module = getattr(models, name, None)
        path = os.path.join(folder, f"{name}.pth")
        if module is None or not os.path.exists(path):
            continue
        sd, m = read_module(path)
        meta.update(m)
        _load_module_sd(name, module, sd)
        loaded.append(name)
    return meta, loaded


def _load_module_sd(name: str, module: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    if name == "depth":
        load_depth(module, sd)
    else:
        module.load_state_dict(sd)


def load_reference_folder(folder: str, models) -> Dict[str, int]:
    """Load a serving folder of the GRU family (encoder, depth and gru, and
    head for the versions with a ``Head``), ``.pth`` or ``.ckpt``, into
    ``models`` (a :class:`ssde_tpu_torch.train.steps_gru.GRUModels`) through
    :func:`load_eval_folder`: a missing folder or file raises. Returns the
    encoder's embedded entries."""
    names = ("encoder", "depth", "gru") + (("head",) if models.head is not None else ())
    return load_eval_folder(folder, models, names)


def load_eval_folder(folder: str, models, names: Sequence[str]) -> Dict[str, int]:
    """Load the modules ``names`` that an evaluation script reads from
    ``folder`` (:func:`load_folder`, strict, ``.pth`` or ``.ckpt``) and
    return the encoder's embedded entries. Unlike training, evaluation needs
    every one of them: a missing file raises and names it."""
    if not os.path.isdir(folder):
        raise FileNotFoundError(
            f"Cannot find a folder at {folder} (the Monodepth2 model-zoo download "
            "is not ported: unzip a published model into that folder first)")
    meta, loaded = load_folder(folder, models, names)
    missing = [n for n in names if n not in loaded]
    if missing:
        ext = folder_format(folder)
        raise FileNotFoundError(f"{folder} has no {', '.join(n + ext for n in missing)}"
                                + ("" if os.listdir(folder) else " (the folder is empty)"))
    return meta


def save_folder(folder: str, models, optimizer=None, *, height: int, width: int,
                use_stereo: bool = False) -> None:
    """Write every module of ``models`` that exists as ``<name>.pth`` (CPU
    tensors), the encoder with its embedded entries, and the optimizer's
    state dict as ``adam.pth``."""
    os.makedirs(folder, exist_ok=True)
    for name in MODULE_NAMES:
        module = getattr(models, name, None)
        if module is None:
            continue
        sd = _cpu(module.state_dict())
        if name == "encoder":
            sd.update(height=height, width=width, use_stereo=use_stereo)
        torch.save(sd, os.path.join(folder, f"{name}.pth"))
    if optimizer is not None:
        torch.save(_cpu(optimizer.state_dict()), os.path.join(folder, "adam.pth"))


def _adam_mismatch(sd, optimizer) -> str:
    """Why ``sd`` does not fit ``optimizer`` ('' when it does): the number
    of groups and parameters, and each moment's shape against its
    parameter's (``load_state_dict`` checks only the counts)."""
    groups = sd.get("param_groups", [])
    if len(groups) != len(optimizer.param_groups):
        return f"{len(groups)} parameter groups, the optimizer has {len(optimizer.param_groups)}"
    for g_sd, g in zip(groups, optimizer.param_groups):
        if len(g_sd["params"]) != len(g["params"]):
            return f"{len(g_sd['params'])} parameters, the optimizer has {len(g['params'])}"
        for idx, p in zip(g_sd["params"], g["params"]):
            for k, v in sd["state"].get(idx, {}).items():
                if k != "step" and tuple(v.shape) != tuple(p.shape):
                    return f"{k} of parameter {idx} is {tuple(v.shape)}, not {tuple(p.shape)}"
    return ""


def load_adam(path: str, optimizer) -> bool:
    """Load ``adam.pth`` into ``optimizer``. If it does not fit, warn and
    keep the fresh moments (``ssde_tpu/checkpoint.py:85-99``); returns
    whether it loaded."""
    sd = _load_pth(path)
    why = _adam_mismatch(sd, optimizer)
    if why:
        warnings.warn(f"{path} does not match the optimizer ({why}); "
                      "optimizer state freshly initialized")
        return False
    optimizer.load_state_dict(sd)
    return True


# ------------------------------------------------ the JAX package's .ckpt

class _NoGlobals(pickle.Unpickler):
    """A JAX ``.ckpt`` payload holds only dicts, str, bytes, ints and bools:
    a file that names any global is refused, so reading one runs no code."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"it names the global {module}.{name}")


def load_module(path: str) -> Tuple[Any, Dict[str, Any]]:
    """One JAX ``.ckpt`` file (``ssde_tpu/checkpoint.py:37-41``): (its params
    tree of numpy arrays, its ``extra`` dict with ``batch_stats`` still
    msgpack bytes). A file that is not one raises ``ValueError`` naming it."""
    try:
        with open(path, "rb") as f:
            payload = _NoGlobals(f).load()
        if not isinstance(payload, dict) or not isinstance(payload.get("params"), bytes):
            raise ValueError("not a dict with 'params' bytes")
        tree = msgpack_restore(payload["params"])
    except (pickle.UnpicklingError, EOFError, ValueError) as e:
        raise ValueError(f"{path} is not a JAX .ckpt file: {e}") from e
    return tree, dict(payload.get("extra") or {})


def save_module(path: str, params, extra: Optional[dict] = None) -> None:
    """``ssde_tpu/checkpoint.py:30-34``: ``params`` (nested dicts of numpy
    arrays) as flax msgpack bytes beside ``extra``, pickled."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"params": msgpack_serialize(params), "extra": extra or {}}
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def save_checkpoint(folder: str, params: Dict[str, Any], batch_stats: Dict[str, Any],
                    opt_state=None, *, height: int, width: int,
                    use_stereo: bool = False) -> None:
    """``ssde_tpu/checkpoint.py:44-56``: ``<name>.ckpt`` per entry of
    ``params`` with its ``batch_stats`` (the encoder also with ``height``,
    ``width`` and ``use_stereo``), and ``opt_state`` as ``adam.ckpt``. Trees
    of numpy arrays (:func:`flax_state` gives them for the port's modules)."""
    os.makedirs(folder, exist_ok=True)
    for name, p in params.items():
        extra = {"batch_stats": msgpack_serialize(batch_stats.get(name, {}))}
        if name == "encoder":
            extra.update({"height": int(height), "width": int(width),
                          "use_stereo": bool(use_stereo)})
        save_module(os.path.join(folder, f"{name}.ckpt"), p, extra)
    if opt_state is not None:
        save_module(os.path.join(folder, "adam.ckpt"), opt_state)


def _module_from_flax(name: str, module: torch.nn.Module, params, stats) -> StateDict:
    """The state_dict of the JAX tree (``params``, ``batch_stats``) of
    ``models.<name>``, by the converter its module needs."""
    from .models import PoseCNN, ResnetEncoderAttention

    if name in ("encoder", "pose_encoder"):
        if isinstance(module, ResnetEncoderAttention):
            return attention_encoder_from_flax(params, stats)
        return encoder_from_flax(params, stats)
    if name in ("depth", "predictive_mask"):
        return depth_from_flax(params, module.scales)
    if name == "pose" and isinstance(module, PoseCNN):
        return pose_cnn_from_flax(params)
    if name == "dpt":
        return dpt_from_flax(params, stats)
    convert = {"pose": pose_decoder_from_flax, "gru": gru_from_flax, "head": head_from_flax,
               "fusion": fusion_from_flax}
    if name not in convert:
        raise KeyError(f"no converter for a module named {name!r}")
    return convert[name](params)


def read_ckpt_folder(folder: str, models, names: Sequence[str] = MODULE_NAMES
                     ) -> Tuple[Dict[str, int], List[str]]:
    """:func:`load_folder` for the JAX package's ``.ckpt`` folder: each of
    ``names`` that the bundle has and the folder holds, its params and
    ``extra["batch_stats"]`` through its module's converter, loaded strictly
    (a missing file is skipped). Returns (the encoder's ``height``/``width``/
    ``use_stereo``, the names loaded)."""
    meta: Dict[str, int] = {}
    loaded = []
    for name in names:
        module = getattr(models, name, None)
        path = os.path.join(folder, f"{name}.ckpt")
        if module is None or not os.path.exists(path):
            continue
        params, extra = load_module(path)
        stats = msgpack_restore(extra["batch_stats"]) if "batch_stats" in extra else {}
        try:
            sd = _module_from_flax(name, module, params, stats)
            _load_module_sd(name, module, sd)
        except (KeyError, RuntimeError) as e:
            raise type(e)(f"{path} does not fit the {name} module: {e}") from e
        meta.update(_ckpt_meta(extra))
        loaded.append(name)
    return meta, loaded


def read_meta(folder: str) -> Dict[str, int]:
    """The ``height``/``width``/``use_stereo`` that the folder's encoder file
    carries (``encoder.pth`` or, in a ``.ckpt`` folder, ``encoder.ckpt``'s
    ``extra``); {} where there is none."""
    if folder_format(folder) == ".pth":
        path = os.path.join(folder, "encoder.pth")
        return read_module(path)[1] if os.path.exists(path) else {}
    path = os.path.join(folder, "encoder.ckpt")
    if not os.path.exists(path):
        return {}
    return _ckpt_meta(load_module(path)[1])


def _ckpt_meta(extra: Mapping) -> Dict[str, int]:
    return {k: int(extra[k]) for k in ENCODER_META if k in extra}


# ----------------------------------------------------------- adam.ckpt

def _stats_like(params):
    """A batch_stats tree for a moments tree: each BatchNorm node (a ``bn``
    entry with ``scale``) gets ``mean``/``var`` placeholders, so the
    converters that read statistics take a tree of moments; the statistics
    they give are dropped."""
    if not isinstance(params, Mapping):
        return {}
    out = {}
    for k, v in params.items():
        if k == "bn" and isinstance(v, Mapping) and "scale" in v:
            out[k] = {"mean": v["scale"], "var": v["scale"]}
        elif isinstance(v, Mapping):
            out[k] = _stats_like(v)
    return out


def _bundle_modules(models):
    return [(n, getattr(models, n, None)) for n in MODULE_NAMES
            if getattr(models, n, None) is not None]


def _adam_moments(tree, models, optimizer):
    """(count, {id(parameter): (exp_avg, exp_avg_sq)}) of every parameter the
    optimizer trains, from a JAX ``create_optimizer`` state
    (``ssde_tpu/train/state.py:145-165``: ``{"0": {}, "1": {"0": {"count",
    "mu", "nu"}, "1": {"count"}}, "2": {}}``, ``mu`` and ``nu`` mirroring the
    params tree). A layout that does not fit raises ``ValueError`` saying why."""
    try:
        adam, sched = tree["1"]["0"], tree["1"]["1"]
        count, mu, nu = int(adam["count"]), adam["mu"], adam["nu"]
        sched_count = int(sched["count"])
    except (KeyError, TypeError, ValueError):
        raise ValueError("not the layout of create_optimizer's optax.adam chain") from None
    if sched_count != count:
        raise ValueError(f"the schedule's count {sched_count} is not Adam's {count}")
    if not isinstance(mu, Mapping) or not isinstance(nu, Mapping):
        raise ValueError("mu and nu are not trees of modules (SSDE_FUSED_ADAM's raveled state?)")
    moments, names = {}, {}
    for name, module in _bundle_modules(models):
        names.update({id(p): f"{name}.{k}" for k, p in module.named_parameters()})
        if name not in mu or name not in nu:
            continue
        try:
            m, v = (_module_from_flax(name, module, t[name], _stats_like(t[name]))
                    for t in (mu, nu))
        except (KeyError, TypeError, IndexError) as e:
            raise ValueError(f"the moments of {name} do not fit its module ({e})") from None
        moments.update({id(p): (m[k], v[k]) for k, p in module.named_parameters()
                        if k in m and k in v})
    for group in optimizer.param_groups:
        for p in group["params"]:
            if id(p) not in moments:
                raise ValueError(f"no moments for {names.get(id(p), 'a parameter')}")
            shape = tuple(moments[id(p)][0].shape)
            if shape != tuple(p.shape):
                raise ValueError(f"moments of shape {shape} for {names.get(id(p))} "
                                 f"{tuple(p.shape)}")
    return count, moments


def load_adam_ckpt(path: str, models, optimizer) -> Optional[int]:
    """Load a JAX ``adam.ckpt`` into the port's Adam: each moment onto the
    parameter of the same module and name, through its parameter's
    converter (transposes, ``h0``/``c0``), and every parameter's ``step`` set
    to the state's ``count``. Returns the count, or None, after a warning,
    when the layout does not fit (a module missing from the tree, the raveled
    ``FusedAdamState``, a shape): the optimizer keeps fresh moments then, as
    ``ssde_tpu/checkpoint.py:85-99`` does."""
    tree, _ = load_module(path)
    try:
        count, moments = _adam_moments(tree, models, optimizer)
    except ValueError as e:
        warnings.warn(f"{path} does not match the optimizer ({e}); "
                      "optimizer state freshly initialized")
        return None
    for group in optimizer.param_groups:
        for p in group["params"]:
            m, v = moments[id(p)]
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": m.to(p.device, p.dtype), "exp_avg_sq": v.to(p.device, p.dtype)}
    return count


# -------------------------------- the JAX converters (port state -> JAX tree)
# Copies of ``ssde_tpu/checkpoint.py``'s torch -> flax converters (:112-397),
# so that the port writes a ``.ckpt`` folder without JAX; tests hold each to
# its original on the same inputs.

def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I, kh, kw) -> (kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def _set(tree: dict, path: str, value):
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _bn_assign(params, stats, base, field, v):
    if field == "weight":
        _set(params, f"{base}/scale", v)
    elif field == "bias":
        _set(params, f"{base}/bias", v)
    elif field == "running_mean":
        _set(stats, f"{base}/mean", v)
    elif field == "running_var":
        _set(stats, f"{base}/var", v)
    # num_batches_tracked: dropped


def convert_resnet_encoder(sd: Dict[str, np.ndarray]):
    """ResnetEncoder state_dict -> (params, batch_stats, meta) (:132-172):
    ``encoder.`` or bare torchvision keys, ``fc.`` dropped, the embedded
    height/width/use_stereo returned as meta."""
    params: dict = {}
    stats: dict = {}
    meta = {}
    for key, v in sd.items():
        if key in ENCODER_META:
            meta[key] = v
            continue
        k = key[len("encoder."):] if key.startswith("encoder.") else key
        if k.startswith("fc."):
            continue
        parts = k.split(".")
        if parts[0] in ("conv1", "bn1"):
            if parts[0] == "conv1":
                _set(params, "conv1/kernel", _conv_kernel(v))
            else:
                _bn_assign(params, stats, "bn1/bn", parts[1], v)
        elif parts[0].startswith("layer"):
            name = f"{parts[0]}_{parts[1]}"
            sub = parts[2]
            if sub == "downsample":
                if parts[3] == "0":
                    _set(params, f"{name}/downsample_conv/kernel", _conv_kernel(v))
                else:
                    _bn_assign(params, stats, f"{name}/downsample_bn/bn", parts[4], v)
            elif sub.startswith("conv"):
                _set(params, f"{name}/{sub}/kernel", _conv_kernel(v))
            elif sub.startswith("bn"):
                _bn_assign(params, stats, f"{name}/{sub}/bn", parts[3], v)
    return params, stats, meta


def convert_depth_decoder(sd: Dict[str, np.ndarray], scales=(0, 1, 2, 3)):
    """DepthDecoder state_dict (``decoder.N``, :func:`module_order`) -> params
    (:187-213)."""
    order = module_order(scales)
    params: dict = {}
    for key, v in sd.items():
        parts = key.split(".")
        if parts[0] != "decoder":
            raise KeyError(f"unexpected depth decoder key {key!r}")
        name = order[int(parts[1])]
        field = "kernel" if parts[-1] == "weight" else "bias"
        value = _conv_kernel(v) if parts[-1] == "weight" else v
        if name.startswith("upconv"):
            _set(params, f"{name}/conv/conv/{field}", value)
        else:
            _set(params, f"{name}/conv/{field}", value)
    return params


def _convert_layers(sd: Dict[str, np.ndarray], name_of) -> dict:
    """Convs whose key's first parts ``name_of`` maps to a tree node
    (``kernel`` HWIO, ``bias``)."""
    params: dict = {}
    for key, v in sd.items():
        parts = key.split(".")
        field = "kernel" if parts[-1] == "weight" else "bias"
        value = _conv_kernel(v) if parts[-1] == "weight" else v
        _set(params, f"{name_of(parts)}/{field}", value)
    return params


def convert_pose_decoder(sd: Dict[str, np.ndarray]):
    """PoseDecoder state_dict -> params (:216-226; ``net.0`` squeeze,
    ``net.1``..``net.3`` pose_0..pose_2)."""
    names = {"0": "squeeze", "1": "pose_0", "2": "pose_1", "3": "pose_2"}
    return _convert_layers(sd, lambda parts: names[parts[1]])


def convert_pose_cnn(sd: Dict[str, np.ndarray]):
    """PoseCNN state_dict -> params (:229-240)."""
    return _convert_layers(sd, lambda parts: f"conv_{parts[1]}" if parts[0] == "net"
                           else "pose_conv")


def _convert_attention_conv(sd, prefix, out, out_prefix):
    """AttentionConv params -> its flax tree (:279-296); rel_h (C/2,1,1,k,1)
    or (1,1,1,k,1) -> (C/2, k) or (k,)."""
    for name in ("key_conv", "query_conv", "value_conv"):
        w = sd.get(f"{prefix}.{name}.weight")
        if w is not None:
            _set(out, f"{out_prefix}/{name}/kernel", _conv_kernel(w))
        b = sd.get(f"{prefix}.{name}.bias")
        if b is not None:
            _set(out, f"{out_prefix}/{name}/bias", b)
    for rel in ("rel_h", "rel_w"):
        r = sd.get(f"{prefix}.{rel}")
        if r is not None:
            r = np.asarray(r)
            r = r.reshape(r.shape[0], -1) if r.shape[0] > 1 else r.reshape(-1)
            _set(out, f"{out_prefix}/{rel}", r)


def _convert_conv(sd, prefix, out, out_prefix):
    """``prefix.weight``/``.bias`` -> ``out_prefix/kernel``/``bias``."""
    _set(out, f"{out_prefix}/kernel", _conv_kernel(sd[f"{prefix}.weight"]))
    _set(out, f"{out_prefix}/bias", sd[f"{prefix}.bias"])


def _convert_rcu(sd, prefix, out, out_prefix):
    """ResidualConvUnit or ResidualAttentionUnit under ``prefix`` (:299-309)."""
    if f"{prefix}.conv1.weight" in sd:
        for i in (1, 2):
            _convert_conv(sd, f"{prefix}.conv{i}", out, f"{out_prefix}/conv{i}")
    else:
        for i in (1, 2):
            _convert_attention_conv(sd, f"{prefix}.atten{i}", out, f"{out_prefix}/atten{i}")


def _convert_units(sd, prefix, out, out_prefix):
    """A fusion block's ``resConfUnit1..3`` under ``prefix`` (a dot-ended
    prefix or ''), and its ``conv3x3.conv`` head."""
    for rcu in ("resConfUnit1", "resConfUnit2", "resConfUnit3"):
        if any(k.startswith(f"{prefix}{rcu}.") for k in sd):
            _convert_rcu(sd, f"{prefix}{rcu}", out, f"{out_prefix}{rcu}")
    if f"{prefix}conv3x3.conv.weight" in sd:
        _convert_conv(sd, f"{prefix}conv3x3.conv", out, f"{out_prefix}conv3x3/conv")


def convert_gru_blocks(sd: Dict[str, np.ndarray], cell: str = "gru"):
    """ConvGRUBlocks state_dict -> params (:312-347): ``cgru_{s}.h0_layer1``
    (1, C, H, W) -> ``h0`` (1, H, W, C) (``c0`` alike), the GRU or LSTM cell's
    convs, the ``conv3x3_{s}`` heads and the ``fusion_{s}`` blocks."""
    params: dict = {}
    for key, v in sd.items():
        parts = key.split(".")
        if parts[0].startswith("cgru_"):
            unit = parts[0]
            if parts[1] in ("h0_layer1", "c0_layer1"):
                name = "h0" if parts[1] == "h0_layer1" else "c0"
                _set(params, f"{unit}/{name}", np.transpose(v, (0, 2, 3, 1)))
            elif parts[1] in ("cgru_1", "clstm_1"):
                field = "kernel" if parts[-1] == "weight" else "bias"
                value = _conv_kernel(v) if parts[-1] == "weight" else v
                _set(params, f"{unit}/cell/{parts[2]}/{field}", value)
        elif parts[0].startswith("conv3x3_"):
            field = "kernel" if parts[-1] == "weight" else "bias"
            value = _conv_kernel(v) if parts[-1] == "weight" else v
            _set(params, f"{parts[0]}/conv/{field}", value)
    for fp in sorted({k.split(".")[0] for k in sd if k.startswith("fusion_")}):
        _convert_units(sd, f"{fp}.", params, f"{fp}/")
    return params


def convert_head(sd: Dict[str, np.ndarray]):
    """Head state_dict -> params (:350-358)."""
    return _convert_layers(sd, lambda parts: f"{parts[0]}/conv")


def convert_fusion_v2(sd: Dict[str, np.ndarray]):
    """Fusion / Fusion_v3 state_dict (``fusion_block_{n}``) or a bare
    FeatureFusionBlock's (the scale-loop block, at the root) -> params
    (:361-397)."""
    params: dict = {}
    blocks = sorted({k.split(".")[0] for k in sd if k.startswith("fusion_block")})
    if not blocks and any(k.startswith("resConfUnit") for k in sd):
        _convert_units(sd, "", params, "")
        return params
    for bp in blocks:
        _convert_units(sd, f"{bp}.", params, f"{bp}/")
        for conv in ("conv_init", "conv_1"):
            if f"{bp}.{conv}.weight" in sd:
                _convert_conv(sd, f"{bp}.{conv}", params, f"{bp}/{conv}")
        for ups in ("upscale", "upscale_1", "upscale_2"):
            if f"{bp}.{ups}.conv.weight" in sd:
                _convert_conv(sd, f"{bp}.{ups}.conv", params, f"{bp}/{ups}/conv")
    return params


def _module_to_flax(name: str, module: torch.nn.Module, sd: Dict[str, np.ndarray],
                    pre_disp: bool):
    """(params, batch_stats) of ``models.<name>`` from a numpy state_dict
    ``sd`` (of the module's tensors, or of its parameters' moments), by the
    copied converter; under ``pre_disp`` the depth decoder's dispconv heads
    are left out, as the JAX tree has none."""
    from .models import PoseCNN, ResnetEncoderAttention
    from .models.dpt import DPTDepthModel

    if isinstance(module, (ResnetEncoderAttention, DPTDepthModel)):
        raise NotImplementedError(f"{type(module).__name__} has no JAX converter to copy")
    if name in ("encoder", "pose_encoder"):
        return convert_resnet_encoder(sd)[:2]
    if name in ("depth", "predictive_mask"):
        if name == "depth" and pre_disp:
            heads = {f"decoder.{i}." for i, n in enumerate(module_order(module.scales))
                     if n.startswith("dispconv")}
            sd = {k: v for k, v in sd.items() if not any(k.startswith(h) for h in heads)}
        return convert_depth_decoder(sd, module.scales), {}
    if name == "pose":
        return (convert_pose_cnn if isinstance(module, PoseCNN) else convert_pose_decoder)(sd), {}
    convert = {"gru": convert_gru_blocks, "head": convert_head, "fusion": convert_fusion_v2}
    if name not in convert:
        raise KeyError(f"no converter for a module named {name!r}")
    return convert[name](sd), {}


def flax_state(models, optimizer=None, step: int = 0):
    """The JAX trees of a bundle, for :func:`save_checkpoint`: (params,
    batch_stats) by module name and, with ``optimizer`` (the port's Adam),
    the optax state of ``create_optimizer`` with its moments and ``step``
    as the count (a parameter Adam has not stepped yet gets zero moments).
    DPT and the attention encoder have no JAX converter and raise."""
    pre_disp = bool(getattr(models, "pre_disp", False))
    params, stats, mu, nu = {}, {}, {}, {}
    for name, module in _bundle_modules(models):
        sd = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
        params[name], stats[name] = _module_to_flax(name, module, sd, pre_disp)
        if optimizer is not None:
            for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                moments = {k: (optimizer.state[p][key] if p in optimizer.state
                               else torch.zeros_like(p)).detach().float().cpu().numpy()
                           for k, p in module.named_parameters()}
                tree[name] = _module_to_flax(name, module, moments, pre_disp)[0]
    if optimizer is None:
        return params, stats, None
    count = np.asarray(step, np.int32)
    opt_state = {"0": {}, "1": {"0": {"count": count, "mu": mu, "nu": nu},
                                "1": {"count": count}}, "2": {}}
    return params, stats, opt_state
