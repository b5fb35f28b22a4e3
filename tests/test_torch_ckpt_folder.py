"""The JAX package's native ``.ckpt`` folders in the port.

Each module family's trees come from ``jax.eval_shape`` of the JAX trainer's
own init (``init_mono_params``, ``init_gru_params``, ``init_fusion_params``,
``init_dpt_params``; a JAX ``init`` run eagerly takes minutes here), filled
with seeded float32 values, and are saved with the JAX ``save_checkpoint``:

- the port's bundle, read from that folder, holds exactly the
  ``*_from_flax`` of those trees: PoseCNN and the predictive mask, GRU v2,
  v8 (ConvLSTM, ``c0``), v9 and v10, and the DPT here; the mono modules, the
  attention encoder, GRU v4 (``Head``) and the pyramid and v3 fusion in
  ``tests/test_torch_ckpt_resume.py``, through the trainers' resume;
- each copied converter gives its original's tree;
- the GRU evaluator raises on a folder that lacks a module it needs.

``tests/test_torch_ckpt_resume.py`` also holds the disparity served from
such a folder against the JAX package, and the port's writer against the
JAX reader.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssde_tpu.checkpoint as jax_ckpt
from ssde_tpu.config import Options as JaxOptions
from ssde_tpu.data.pipeline import collate as jax_collate
from ssde_tpu.data.synthetic import SyntheticSeqDataset as JaxSeqDataset
from ssde_tpu.train import state as jax_state
from ssde_tpu.train import steps as jax_steps
from ssde_tpu.train import steps_dpt as jax_steps_dpt
from ssde_tpu.train import steps_fusion as jax_steps_fusion
from ssde_tpu.train import steps_gru as jax_steps_gru
from ssde_tpu_torch import checkpoint
from ssde_tpu_torch.config import Options
from ssde_tpu_torch.models import PoseCNN, ResnetEncoderAttention
from ssde_tpu_torch.models.depth_decoder import module_order
from ssde_tpu_torch.scripts import evaluate_depth_gru_fusion
from ssde_tpu_torch.train import steps, steps_dpt, steps_fusion, steps_gru

H, W = 64, 96

# label -> (family, options both sides take)
FAMILIES = {
    "mono": ("mono", {}),
    "posecnn_mask": ("mono", dict(pose_model_type="posecnn", predictive_mask=True,
                                  disable_automasking=True)),
    "attention": ("attention", {}),
    "gru_v2": ("gru", dict(gru_version="v2")),
    "gru_v4": ("gru", dict(gru_version="v4")),
    "gru_v8": ("gru", dict(gru_version="v8")),
    "gru_v9": ("gru", dict(gru_version="v9")),
    "gru_v10": ("gru", dict(gru_version="v10")),
    "fusion_pyramid": ("pyramid", {}),
    "fusion_v3": ("v3", {}),
    "dpt": ("dpt", {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_mono_step.py (which says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _remove_written_folders(tmp_path):
    """Each test's folders (the DPT's .ckpt alone is ~0.5 GB) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _fill(shapes, seed):
    """An eval_shape tree filled with seeded float32 numpy: variances in
    [0.5, 1.5), everything else N(0, 0.1^2) around 1 for BatchNorm scales
    and 0 elsewhere."""
    rs = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        v = 0.1 * rs.standard_normal(s.shape, dtype=np.float32)
        return v + 1 if name.endswith("['scale']") else v

    return jax.tree_util.tree_map_with_path(fill, shapes)


_TREES = {}


def _native(label):
    """(JAX bundle, params, batch_stats) of ``label``, as numpy."""
    if label in _TREES:
        return _TREES[label]
    kind, kw = FAMILIES[label]
    jopts = JaxOptions(height=H, width=W, batch_size=1, len_sequence=2,
                       compute_dtype="float32", **kw)
    key = jax.random.PRNGKey(0)
    if kind == "gru":
        jm = jax_steps_gru.build_gru_models(jopts)
        batch = jax_collate([JaxSeqDataset(H, W, n=2, length=1)[0]])
        shapes = jax.eval_shape(lambda: jax_steps_gru.init_gru_params(jm, key, batch))
    else:  # these inits read the batch's color_aug/0/0 alone
        if kind in ("mono", "attention"):
            jm = jax_steps.build_mono_models(jopts, attention_encoder=kind == "attention")
            init = jax_steps.init_mono_params
        elif kind == "dpt":
            jm = jax_steps_dpt.build_dpt_models(jopts)
            init = jax_steps_dpt.init_dpt_params
        else:
            jm = jax_steps_fusion.build_fusion_models(jopts, kind)
            init = jax_steps_fusion.init_fusion_params
        x = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
        shapes = jax.eval_shape(lambda x: init(jm, key, {"color_aug/0/0": x}), x)
    params, stats = _fill(shapes, sorted(FAMILIES).index(label))
    _TREES[label] = (jm, params, stats)
    return _TREES[label]


def _port_options(label, **extra):
    kind, kw = FAMILIES[label]
    return Options(height=H, width=W, batch_size=1, len_sequence=2, compute_dtype="float32",
                   num_workers=1, mono_pretrained=0, **kw, **extra)


def _port_bundle(label):
    kind, _ = FAMILIES[label]
    opts, gen = _port_options(label), torch.Generator().manual_seed(0)
    if kind in ("mono", "attention"):
        return steps.build_mono_models(opts, "cpu", gen, attention_encoder=kind == "attention")
    if kind == "gru":
        return steps_gru.build_gru_models(opts, "cpu", gen)
    if kind == "dpt":
        return steps_dpt.build_dpt_models(opts, "cpu", gen)
    return steps_fusion.build_fusion_models(opts, kind, "cpu", gen)


def _want(name, module, params, stats):
    """The state_dict of one module's JAX tree, by the converter this
    module needs."""
    if name in ("encoder", "pose_encoder"):
        if isinstance(module, ResnetEncoderAttention):
            return checkpoint.attention_encoder_from_flax(params, stats)
        return checkpoint.encoder_from_flax(params, stats)
    if name in ("depth", "predictive_mask"):
        return checkpoint.depth_from_flax(params, module.scales)
    if name == "pose" and isinstance(module, PoseCNN):
        return checkpoint.pose_cnn_from_flax(params)
    return {"pose": checkpoint.pose_decoder_from_flax, "gru": checkpoint.gru_from_flax,
            "head": checkpoint.head_from_flax, "fusion": checkpoint.fusion_from_flax,
            "dpt": lambda p: checkpoint.dpt_from_flax(p, stats)}[name](params)


def _assert_holds(module, want):
    """``module`` holds ``want`` exactly; what ``want`` lacks may only be
    the depth decoder's dispconv heads (a pre-disp tree has none)."""
    got = module.state_dict()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    heads = tuple(f"decoder.{i}." for i, n in enumerate(module_order(getattr(module, "scales", ())))
                  if n.startswith("dispconv"))
    assert all(k.startswith(heads) for k in set(got) - set(want)), sorted(set(got) - set(want))


# the other families load in tests/test_torch_ckpt_resume.py, through the
# trainers' load_model
@pytest.mark.parametrize("label", ["posecnn_mask", "gru_v2", "gru_v8", "gru_v9", "gru_v10",
                                   "dpt"])
def test_every_family_loads_from_a_native_folder(label, tmp_path):
    _, params, stats = _native(label)
    jax_ckpt.save_checkpoint(str(tmp_path), params, stats, height=H, width=W)
    models = _port_bundle(label)
    meta = checkpoint.load_eval_folder(str(tmp_path), models, list(params))
    assert meta == ({"height": H, "width": W, "use_stereo": 0} if "encoder" in params else {})
    assert {n for n, _ in checkpoint._bundle_modules(models)} == set(params)
    for name in params:
        module = getattr(models, name)
        _assert_holds(module, _want(name, module, params[name], stats.get(name, {})))


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _copies():
    """(converter name, its arguments) for each copied converter, on
    state_dicts of the port's modules that exercise every branch."""
    mono = _port_bundle("posecnn_mask")
    enc = _np_sd(mono.encoder)
    enc.update(height=np.int64(H), width=np.int64(W), use_stereo=np.bool_(False))
    enc["encoder.fc.weight"] = np.zeros((2, 512), np.float32)
    cases = [("convert_resnet_encoder", (enc,)),
             ("convert_resnet_encoder", (_np_sd(_port_bundle("mono").pose_encoder),)),
             ("convert_depth_decoder", (_np_sd(mono.depth),)),
             ("convert_depth_decoder", (_np_sd(mono.predictive_mask), (0, 1, 2, 3))),
             ("convert_pose_cnn", (_np_sd(mono.pose),)),
             ("convert_pose_decoder", (_np_sd(_port_bundle("mono").pose),))]
    for v in ("gru_v2", "gru_v4", "gru_v8", "gru_v9", "gru_v10"):
        gru = _port_bundle(v)
        cases.append(("convert_gru_blocks", (_np_sd(gru.gru),)))
        if gru.head is not None:
            cases.append(("convert_head", (_np_sd(gru.head),)))
    opts = _port_options("fusion_v3", disable_attention=True)
    for variant, o in (("pyramid", _port_options("fusion_pyramid")),
                       ("v3", _port_options("fusion_v3")), ("v3", opts), ("scale_loop", opts)):
        fusion = steps_fusion.build_fusion_models(o, variant, "cpu",
                                                  torch.Generator().manual_seed(0)).fusion
        cases.append(("convert_fusion_v2", (_np_sd(fusion),)))
    return cases


def _assert_same_tree(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same_tree(a, b)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


def test_converter_copies_equal_their_originals():
    cases = _copies()
    assert {n for n, _ in cases} == {
        "convert_resnet_encoder", "convert_depth_decoder", "convert_pose_decoder",
        "convert_pose_cnn", "convert_gru_blocks", "convert_head", "convert_fusion_v2"}
    for name, args in cases:
        _assert_same_tree(getattr(checkpoint, name)(*args), getattr(jax_ckpt, name)(*args))


@pytest.mark.parametrize("case", ["empty", "no gru.pth", "v4 without head.pth",
                                  "no gru.ckpt"])
def test_gru_evaluator_refuses_a_folder_without_its_modules(case, tmp_path):
    version = "v4" if "v4" in case else "v10"
    label = f"gru_{version}"
    folder = tmp_path / "weights"
    if case == "no gru.ckpt":
        _, params, stats = _native(label)
        jax_ckpt.save_checkpoint(str(folder), params, stats, height=H, width=W)
        missing = "gru.ckpt"
    else:
        checkpoint.save_folder(str(folder), _port_bundle(label), height=H, width=W)
        missing = {"empty": "encoder", "no gru.pth": "gru", "v4 without head.pth": "head"}[case]
        missing = missing + (".ckpt" if case == "empty" else ".pth")
        if case == "empty":
            shutil.rmtree(folder)
            folder.mkdir()
    if case != "empty":
        os.remove(folder / missing)
    opts = Options(height=H, width=W, gru_version=version, load_weights_folder=str(folder))
    with pytest.raises(FileNotFoundError, match=missing.replace(".", r"\.")):
        evaluate_depth_gru_fusion.build_evaluator(opts, "cpu")
    # and a whole folder serves
    if case == "v4 without head.pth":
        checkpoint.save_folder(str(folder), _port_bundle(label), height=H, width=W)
        evaluate_depth_gru_fusion.build_evaluator(opts, "cpu")
