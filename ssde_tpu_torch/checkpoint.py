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
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .models.depth_decoder import module_order

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


def load_folder(folder: str, models, names: Sequence[str] = MODULE_NAMES
                ) -> Tuple[Dict[str, int], List[str]]:
    """Load ``<folder>/<name>.pth`` into ``models.<name>`` for each of
    ``names`` that the bundle has (``MonoModels``, ``GRUModels`` or
    ``FusionModels``); a missing file is skipped. Returns (the encoder's embedded entries, the
    names loaded). Strict: a key or shape that does not match raises (the
    depth decoder may lack its dispconv heads, :func:`load_depth`)."""
    meta: Dict[str, int] = {}
    loaded = []
    for name in names:
        module = getattr(models, name, None)
        path = os.path.join(folder, f"{name}.pth")
        if module is None or not os.path.exists(path):
            continue
        sd, m = read_module(path)
        meta.update(m)
        if name == "depth":
            load_depth(module, sd)
        else:
            module.load_state_dict(sd)
        loaded.append(name)
    return meta, loaded


def load_reference_folder(folder: str, models) -> Dict[str, int]:
    """Load a reference-format serving folder ({encoder,depth,gru}.pth, and
    head.pth for the versions with a ``Head``) into ``models`` (a
    :class:`ssde_tpu_torch.train.steps_gru.GRUModels`); returns the
    encoder's embedded entries."""
    return load_folder(folder, models, ("encoder", "depth", "gru", "head"))[0]


def load_eval_folder(folder: str, models, names: Sequence[str]) -> Dict[str, int]:
    """Load the modules ``names`` that an evaluation script reads from
    ``folder`` (:func:`load_folder`, strict) and return the encoder's
    embedded entries. Unlike training, evaluation needs every one of them:
    a missing file raises. A folder of the JAX package's native ``.ckpt``
    files (flax msgpack, ``ssde_tpu/checkpoint.py:44-56``) raises
    ``NotImplementedError``: the port reads only ``.pth`` folders."""
    if not os.path.isdir(folder):
        raise FileNotFoundError(
            f"Cannot find a folder at {folder} (the Monodepth2 model-zoo download "
            "is not ported: unzip a published model into that folder first)")
    files = os.listdir(folder)
    if not any(f.endswith(".pth") for f in files) and any(f.endswith(".ckpt") for f in files):
        raise NotImplementedError(
            f"{folder} holds the JAX package's native .ckpt files (flax msgpack), which "
            "the port does not read; convert them to the reference's .pth layout")
    meta, loaded = load_folder(folder, models, names)
    missing = [n for n in names if n not in loaded]
    if missing:
        raise FileNotFoundError(f"{folder} has no {', '.join(n + '.pth' for n in missing)}")
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
