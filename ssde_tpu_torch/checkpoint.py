"""Weights for the port: the JAX package's trees -> torch ``state_dict``s, and
the reference's per-module ``.pth`` folder.

``encoder_from_flax`` (the depth encoder and the 6-channel pose encoder),
``depth_from_flax``, ``pose_decoder_from_flax`` and ``gru_from_flax`` invert
``ssde_tpu/checkpoint.py``'s ``convert_resnet_encoder`` (:132),
``convert_depth_decoder`` (:187), ``convert_pose_decoder`` (:216) and
``convert_gru_blocks`` (:312): conv
kernels HWIO -> OIHW, ``h0`` (1, H, W, C) -> (1, C, H, W), BatchNorm
``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/``running_mean``/
``running_var``. Trees are nested dicts of numpy arrays; nothing here
imports flax.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

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


def _attention_conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    """Inverse of ``_convert_attention_conv`` (:279-296): the q/k/v 1x1
    kernels and biases, and the relative embeddings back to the reference's
    shapes, (C/2, k) -> (C/2, 1, 1, k, 1) and (C/2, 1, 1, 1, k), a shared
    (k,) -> (1, 1, 1, k, 1) and (1, 1, 1, 1, k)."""
    for conv in ("key_conv", "query_conv", "value_conv"):
        sd[f"{prefix}.{conv}.weight"] = _oihw(p[conv]["kernel"])
        if "bias" in p[conv]:
            sd[f"{prefix}.{conv}.bias"] = _t(p[conv]["bias"])
    for rel, shape in (("rel_h", (1, 1, -1, 1)), ("rel_w", (1, 1, 1, -1))):
        r = np.asarray(p[rel])
        sd[f"{prefix}.{rel}"] = _t(r.reshape((r.shape[0] if r.ndim == 2 else 1,) + shape))


def gru_from_flax(params: Mapping) -> StateDict:
    """``ssde_tpu.models.ConvGRUBlocks`` params -> ``ConvGRUBlocks``
    state_dict (GRU cells; fusion blocks with residual conv units, or with
    residual attention units, ``_convert_rcu`` :299-309)."""
    sd: StateDict = {}
    for name in sorted(params):
        p = params[name]
        if name.startswith("cgru_"):
            sd[f"{name}.h0_layer1"] = _t(np.transpose(np.asarray(p["h0"]), (0, 3, 1, 2)))
            for conv in sorted(p["cell"]):
                sd[f"{name}.cgru_1.{conv}.weight"] = _oihw(p["cell"][conv]["kernel"])
                sd[f"{name}.cgru_1.{conv}.bias"] = _t(p["cell"][conv]["bias"])
        elif name.startswith("fusion_"):
            for rcu in sorted(k for k in p if k.startswith("resConfUnit")):
                for i in (1, 2):
                    if f"atten{i}" in p[rcu]:
                        _attention_conv(sd, f"{name}.{rcu}.atten{i}", p[rcu][f"atten{i}"])
                        continue
                    c = p[rcu][f"conv{i}"]
                    sd[f"{name}.{rcu}.conv{i}.weight"] = _oihw(c["kernel"])
                    sd[f"{name}.{rcu}.conv{i}.bias"] = _t(c["bias"])
            head = p["conv3x3"]["conv"]
            sd[f"{name}.conv3x3.conv.weight"] = _oihw(head["kernel"])
            sd[f"{name}.conv3x3.conv.bias"] = _t(head["bias"])
        else:
            raise KeyError(f"unexpected GRU tree entry {name!r}")
    return sd


def load_depth(decoder: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Strict load, except that the dispconv heads may be absent."""
    res = decoder.load_state_dict(sd, strict=False)
    dispconv = {f"decoder.{i}." for i, n in enumerate(module_order(decoder.scales))
                if n.startswith("dispconv")}
    bad = [k for k in res.missing_keys if not any(k.startswith(p) for p in dispconv)]
    if bad or res.unexpected_keys:
        raise KeyError(f"depth state_dict mismatch: missing {bad}, "
                       f"unexpected {res.unexpected_keys}")


def _load_pth(path: str) -> StateDict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_folder(folder: str, models) -> Dict[str, int]:
    """Load a reference-format folder ({encoder,depth,gru}.pth) into
    ``models`` (a :class:`ssde_tpu_torch.train.steps_gru.GRUModels`).

    The encoder's embedded ``height``/``width``/``use_stereo`` entries are
    returned, not loaded (reference trainer.py:717-721); its classifier
    (``encoder.fc.*``) is dropped. Missing files are skipped, as the
    reference's load_model does.
    """
    meta: Dict[str, int] = {}
    path = os.path.join(folder, "encoder.pth")
    if os.path.exists(path):
        sd = _load_pth(path)
        for k in ("height", "width", "use_stereo"):
            if k in sd:
                meta[k] = int(sd.pop(k))
        sd = {k: v for k, v in sd.items() if not k.startswith("encoder.fc.")}
        models.encoder.load_state_dict(sd)
    path = os.path.join(folder, "depth.pth")
    if os.path.exists(path):
        load_depth(models.depth, _load_pth(path))
    path = os.path.join(folder, "gru.pth")
    if os.path.exists(path):
        models.gru.load_state_dict(_load_pth(path))
    return meta
