"""The rest of the recurrent family of the port against the JAX package:
GRU v1, v2 (attention fusion), v2_wo_att, v3, v4, v5 (the ``Options``
default), v6 (v4's wiring), v7 and v8 (ConvLSTM). v9 and v10 have their own
files (tests/test_torch_gru_v9.py, tests/test_torch_gru_step.py).

* One block step per version at 32x64, B=1, float32, the weights carried
  across by ``convert_gru_blocks``/``convert_head``: outputs and hidden
  states (h and c) 1e-4 absolute; the gradients of a scalar of them with
  respect to every parameter (h0 and c0 included) and to the block's
  inputs 1e-4 of each tensor's max, tests/test_torch_gru_step.py's bound;
  an attention conv's key bias, whose true gradient is 0, against the
  largest gradient of its conv (tests/test_torch_gru_v9.py says why). v4,
  v6 and v7 add their ``Head`` on the new hidden states. The JAX
  attention of v2 and v8 runs its plain streaming path (its Pallas kernel
  in interpret mode takes minutes at this size; tests/test_torch_gru_v9.py
  holds the port's attention to that kernel).
* One whole train step in float64 at 64x128, B=1, T=2, for one version of
  each path of ``gru_unroll``: v5 (the decoder after the block), v4 (the
  --fuse mean and the Head), v7 (the (current, previous) carry and the
  Head) and v8 (the block's own disparity, LSTM cells, attention). Bounds
  as tests/test_torch_gru_step.py: the losses 1e-9 relative, every
  gradient and ``batch_stats`` 1e-6 of its tensor's max.
* The evaluator's streamed disparity for v5, v4 and v7 against the JAX
  ``GRUStreamEvaluator`` on the same weights, 64x128, B=2, 3 frames, 1e-4.
* ``gru_from_flax``/``head_from_flax`` round trips (c0, ``clstm_1``, the
  block's ``conv3x3_{s}`` and ``GRUFusionBlock``'s three units); the
  freeze of h0 and c0; the entry point's default (v5) on the CPU; head.pth
  saved and loaded; the monodepth2 warm start of v5.

A fault of the JAX converter shows at v2 with attention: its fusion units
have C = 2 channels, so their per-channel relative embeddings are (C/2, k)
= (1, 3), and ``_convert_attention_conv`` (ssde_tpu/checkpoint.py:292-295)
flattens any (1, ...) tensor to the shared (k,) shape, which the flax
module then refuses. The tests give those leaves back their (1, 3) shape
(:func:`_per_channel_rel`).
"""

import copy
import functools
import os
import re

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.checkpoint import (convert_depth_decoder, convert_gru_blocks, convert_head,
                                 convert_pose_decoder, convert_resnet_encoder)
from ssde_tpu.config import Options
from ssde_tpu.eval.gru_runners import GRUStreamEvaluator as JaxEvaluator
from ssde_tpu.models.recurrent import ConvGRUBlocks as FlaxBlocks
from ssde_tpu.models.recurrent import Head as FlaxHead
from ssde_tpu.models.recurrent import make_gru as flax_make_gru
from ssde_tpu.train.steps_gru import build_gru_models as jax_build_gru_models
from ssde_tpu.train.steps_gru import gru_loss_fn as jax_gru_loss_fn
from ssde_tpu.train.steps_gru import preprocess_gru_batch as jax_preprocess_gru_batch
from ssde_tpu_torch import checkpoint
from ssde_tpu_torch.data.kitti import KITTI_K
from ssde_tpu_torch.data.synthetic import scene_frames
from ssde_tpu_torch.models import Head, make_gru
from ssde_tpu_torch.models.common import init_weights_, sample_
from ssde_tpu_torch.models.recurrent import (GRU_HIDDEN_SPECS, block_version, kernel_scales,
                                             scale_shift)
from ssde_tpu_torch.models.resnet import randomize_bn_stats_
from ssde_tpu_torch.scripts import train_gru
from ssde_tpu_torch.scripts.evaluate_depth_gru_fusion import build_evaluator
from ssde_tpu_torch.train import steps, steps_gru
from ssde_tpu_torch.train.state import TrainState
from ssde_tpu_torch.train.steps_gru import HEAD_VERSIONS

VERSIONS = ("v1", "v2", "v2_wo_att", "v3", "v4", "v5", "v6", "v7", "v8")
DEC_CH = (16, 32, 64, 128)  # the decoder's pre-disp channels at scales 0-3
ENC_CH = (64, 64, 128, 256, 512)  # ResNet18's feature maps at H/2 .. H/32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_gru_step.py (which says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_plain_paths(monkeypatch):
    """The JAX modules on their plain CPU paths."""
    for env in ("SSDE_PLANAR_GRU", "SSDE_CONV_INTERPRET", "SSDE_ATTN_KERNEL"):
        monkeypatch.delenv(env, raising=False)


def _np(t):
    return t.detach().numpy().copy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return _np(t).transpose(0, 2, 3, 1)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _per_channel_rel(tree):
    """``tree`` with every 1-D ``rel_h``/``rel_w`` leaf reshaped to (1, k):
    the per-channel embeddings of a 2-channel attention conv, which the JAX
    converter flattens (the module docstring says why). Every attention
    conv of the GRU blocks has per-channel embeddings."""
    if not isinstance(tree, dict):
        return tree
    return {k: (np.asarray(v).reshape(1, -1) if k in ("rel_h", "rel_w") and np.ndim(v) == 1
                else _per_channel_rel(v)) for k, v in tree.items()}


# the gradients that are 0 on both sides: a 2-channel attention unit of v2
# (fusion blocks of 2 channels) whose first conv's output is negative
# everywhere in one channel passes no gradient back through its relu to
# that channel's relative embedding (1 row of 3 taps)
ZERO_LEAF = re.compile(r"\['fusion_\d'\]\['resConfUnit\d'\]\['atten1'\]\['rel_[hw]'\]$")


def _close_rel(got, want, tol, what, zero_ok=None):
    """Each leaf within ``tol`` of its max; an attention conv's key bias
    within ``tol`` of the largest gradient of its conv. A leaf that
    ``zero_ok`` matches may be 0 in ``want``, and must then be 0 in
    ``got``."""
    assert got.keys() == want.keys(), what
    conv = lambda k: re.match(r".*\['atten\d'\]", k)[0]  # noqa: E731
    conv_max = {}
    for k, w in want.items():
        if "['atten" in k:
            conv_max[conv(k)] = max(conv_max.get(conv(k), 0.0), np.abs(w).max())
    for k, w in want.items():
        scale = conv_max[conv(k)] if "['key_conv']['bias']" in k else np.abs(w).max()
        if scale == 0 and zero_ok is not None and zero_ok.search(k):
            assert not np.any(got[k]), f"{what}{k}"
            continue
        assert scale > 0, f"{what}{k}"
        np.testing.assert_allclose(got[k], w, atol=tol * scale, rtol=0, err_msg=f"{what}{k}")


def _states(new):
    """Every tensor of a per-scale state list: h, or h and c of an LSTM."""
    return [t for s in new for t in (s if isinstance(s, (tuple, list)) else (s,))]


def _block_inputs(version, h, w, b, rng):
    """NHWC numpy inputs of one block step, N(0, 1): the decoder's
    ``disp/{s}`` (1 channel for v1/v2, which read the disparities, else the
    pre-disp features), or for v5 the encoder's 5 feature maps. (Inputs of
    one sign, as disparities have, can leave a 2-channel attention unit of
    v2 with a relu that is 0 everywhere, and so gradients that are 0 on
    both sides.)"""
    v = block_version(version)
    if v == "v5":
        return [rng.randn(b, h >> (s + 1), w >> (s + 1), c).astype(np.float32)
                for s, c in enumerate(ENC_CH)]
    ch = (1,) * 4 if v in ("v1", "v2") else DEC_CH
    return {f"disp/{s}": rng.randn(b, h >> s, w >> s, c).astype(np.float32)
            for s, c in enumerate(ch)}


def _seeded_block(version, h, w, seed):
    """The port's block (and Head) with seeded weights and a non-zero
    learned initial state."""
    block = make_gru(version, h, w)
    g = torch.Generator().manual_seed(seed)
    init_weights_(block, g)
    for p in block.initial_parameters():
        sample_(p, g, lambda t: t.normal_(0, 0.5, generator=g))
    head = None
    if version in HEAD_VERSIONS:
        head = Head(HEAD_VERSIONS[version], kernel_scales(version))
        init_weights_(head, g)
    return block, head


# ------------------------------------------------------------- the block


@pytest.mark.parametrize("version", VERSIONS)
def test_block_step_matches_jax(version):
    h, w, b = 32, 64, 1
    block, head = _seeded_block(version, h, w, seed=11)
    rng = np.random.RandomState(12)
    dec = _block_inputs(version, h, w, b, rng)
    spec = GRU_HIDDEN_SPECS[block_version(version)]
    r = {f"disp/{s}": rng.randn(b, h >> s, w >> s, 1).astype(np.float32) for s in range(4)}
    per_cell = 2 if spec["cell"] == "lstm" else 1
    q = [rng.randn(b, h >> scale_shift(version, s), w >> scale_shift(version, s),
                   c).astype(np.float32) for s, c in enumerate(spec["hid"]) for _ in range(per_cell)]

    jblock = flax_make_gru(version, h, w)
    params = _per_channel_rel(convert_gru_blocks(
        {k: _np(v) for k, v in block.state_dict().items()}))
    hparams = None if head is None else convert_head(
        {k: _np(v) for k, v in head.state_dict().items()})
    jhead = None if head is None else FlaxHead(HEAD_VERSIONS[version])

    def jax_loss(p, hp, d):
        h0 = jblock.apply({"params": p}, b, method=FlaxBlocks.initial_state)
        new, disp = jblock.apply({"params": p}, d, h0)
        if jhead is not None:
            disp = jhead.apply({"params": hp}, list(new))
        states = _states(new)
        loss = sum(jnp.sum(st * q[i]) for i, st in enumerate(states))
        if disp is not None:
            loss = loss + sum(jnp.sum(disp[k] * r[k]) for k in disp)
        return loss, (states, disp)

    jd = jax.tree.map(jnp.asarray, dec)
    (_, (jstates, jdisp)), (jgp, jgh, jgd) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(params, hparams, jd)

    dt = ([_nchw(v).requires_grad_() for v in dec] if isinstance(dec, list)
          else {k: _nchw(v).requires_grad_() for k, v in dec.items()})
    new, disp = block(dt, block.initial_state(b))
    if head is not None:
        disp = head(new)
    states = _states(new)
    loss = sum((st * _nchw(q[i])).sum() for i, st in enumerate(states))
    assert (disp is None) == (jdisp is None)
    if disp is not None:
        assert disp.keys() == jdisp.keys()
        loss = loss + sum((disp[k] * _nchw(r[k])).sum() for k in disp)
    loss.backward()

    assert len(states) == len(jstates) == per_cell * len(spec["hid"])
    for i, (a, want) in enumerate(zip(states, jstates)):
        np.testing.assert_allclose(_nhwc(a), np.asarray(want), atol=1e-4, rtol=0,
                                   err_msg=f"state {i}")
    for k in disp or {}:
        np.testing.assert_allclose(_nhwc(disp[k]), np.asarray(jdisp[k]), atol=1e-4, rtol=0,
                                   err_msg=k)
    got = _per_channel_rel(convert_gru_blocks(
        {k: _np(p.grad) for k, p in block.named_parameters()}))
    _close_rel(_leaves(got), _leaves(jgp), 1e-4, "params",
               ZERO_LEAF if version == "v2" else None)
    if head is not None:
        _close_rel(_leaves(convert_head({k: _np(p.grad) for k, p in head.named_parameters()})),
                   _leaves(jgh), 1e-4, "head")
    gd = [_nhwc(t.grad) for t in dt] if isinstance(dt, list) else \
        {k: _nhwc(t.grad) for k, t in dt.items()}
    _close_rel(_leaves(gd), _leaves(jgd), 1e-4, "d ")


# -------------------------------------------------------- the whole step

H, W, B, T = 64, 128, 1, 2


def _opts(version, **kw):
    return Options(height=H, width=W, batch_size=B, len_sequence=T, gru_version=version,
                   compute_dtype="float32", **kw)


def _tree(models, grads=False):
    """(params, batch_stats) of the port's modules as the JAX GRU trees."""
    get = (lambda m: {k: _np(p.grad) for k, p in m.named_parameters()
                      if p.grad is not None}) if grads else \
        (lambda m: {k: _np(v) for k, v in m.state_dict().items()})
    enc_p, enc_s, _ = convert_resnet_encoder(get(models.encoder))
    pe_p, pe_s, _ = convert_resnet_encoder(get(models.pose_encoder))
    depth = convert_depth_decoder(get(models.depth))
    if models.pre_disp:  # the block makes the disparity: no heads in the JAX tree
        depth = {k: v for k, v in depth.items() if not k.startswith("dispconv")}
    params = {"encoder": enc_p, "depth": depth,
              "gru": _per_channel_rel(convert_gru_blocks(get(models.gru))),
              "pose_encoder": pe_p, "pose": convert_pose_decoder(get(models.pose))}
    if models.head is not None:
        params["head"] = convert_head(get(models.head))
    return params, {"encoder": enc_s, "pose_encoder": pe_s}


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64`` (as in
    tests/test_torch_gru_step.py)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("version", ["v5", "v4", "v7", "v8"])
def test_train_step_matches_jax_in_float64(version, monkeypatch):
    import ssde_tpu.ops.warp
    import ssde_tpu.train.steps
    import ssde_tpu.train.steps_gru

    models = steps_gru.build_gru_models(_opts(version), "cpu", torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    for p in models.h0_parameters():
        sample_(p, g, lambda t: t.normal_(0, 0.1, generator=g))
    for m in models.modules():
        m.double()
    # the plain convs: conv3x3 takes no float64
    models.gru.kernel_scales = (False,) * models.gru.n_scales
    if models.head is not None:
        models.head.kernel_scales = (False,) * 4
    params, stats = _tree(models)
    rng = np.random.RandomState(5)
    batch = {f"color/{i}": rng.rand(B, T, H, W, 3) for i in (0, -1, 1)}
    batch["K"] = np.stack([KITTI_K] * B).astype(np.float64)
    batch["jitter"] = np.array([[1.1, 0.9, 1.15, 0.05]], np.float64)

    monkeypatch.setattr(flax.linen, "BatchNorm",
                        functools.partial(flax.linen.BatchNorm, use_fast_variance=False))
    for mod in (ssde_tpu.train.steps, ssde_tpu.train.steps_gru, ssde_tpu.ops.warp):
        monkeypatch.setattr(mod, "jnp", _Float64Numpy())
    with jax.enable_x64(True):
        jm = jax_build_gru_models(_opts(version))
        inputs, jb, jt = jax_preprocess_gru_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, _opts(version), is_train=True)
        fn = jax.jit(jax.value_and_grad(
            lambda p: jax_gru_loss_fn(jm, p, stats, inputs, jb, jt, None, True), has_aux=True))
        (_, (jstats, jlosses, _)), jgrads = fn(params)
        jstats, jlosses, jgrads = jax.tree.map(np.asarray, (jstats, jlosses, jgrads))
        inputs = {k: torch.from_numpy(np.ascontiguousarray(
            np.asarray(v).transpose(0, 3, 1, 2) if k.startswith("color") else np.asarray(v)))
            for k, v in inputs.items()}
    monkeypatch.undo()
    assert inputs["color_aug/0/0"].dtype == torch.float64
    models.train()
    _, losses, _ = steps_gru.gru_loss_fn(models, inputs, B, T)
    losses["loss"].backward()

    assert set(losses) == set(jlosses) == {"loss"} | {f"loss/{s}" for s in range(4)}
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=1e-9,
                                   err_msg=k)
    got = _tree(models, grads=True)[0]
    assert got.keys() == jgrads.keys()
    for group in jgrads:
        _close_rel(_leaves(got[group]), _leaves(jgrads[group]), 1e-6, group)
    _close_rel(_leaves(_tree(models)[1]), _leaves(jstats), 1e-6, "batch_stats")


# ----------------------------------------------------- streamed disparity


@pytest.mark.parametrize("version", ["v5", "v4", "v7"])
def test_streamed_disparity_matches_jax(version):
    opt = Options(gru_version=version, height=H, width=W, compute_dtype="float32")
    ev = build_evaluator(opt, "cpu", seed=0)
    m = ev.models
    g = torch.Generator().manual_seed(1)
    randomize_bn_stats_(m.encoder, g)
    for p in m.h0_parameters():  # a non-zero learned initial state
        sample_(p, g, lambda t: t.normal_(0, 0.5, generator=g))
    sd = lambda mod: {k: v.detach().numpy() for k, v in mod.state_dict().items()}  # noqa
    enc_p, enc_s, _ = convert_resnet_encoder(sd(m.encoder))
    params = {"encoder": enc_p, "depth": convert_depth_decoder(sd(m.depth)),
              "gru": convert_gru_blocks(sd(m.gru))}
    if m.head is not None:
        params["head"] = convert_head(sd(m.head))
    jev = JaxEvaluator(jax_build_gru_models(opt), params, {"encoder": enc_s})
    frames = scene_frames(H, W, 3, batch=2, seed=3)
    got, want = ev.predict_scene(frames), jev.predict_scene(frames)
    assert len(got) == len(want) == 3
    for t, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (2, H, W) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f"frame {t}")
    # the recurrence carries state: the frames differ from a fresh start
    assert np.abs(got[2] - ev.predict_single(frames[2])).max() > 1e-4


# ---------------------------------------------------------- checkpoints


@pytest.mark.parametrize("version", VERSIONS)
def test_converters_round_trip(version):
    """flax params -> ``gru_from_flax``/``head_from_flax`` -> a strict load
    into the port's modules -> the JAX converters give them back; and the
    port's state dicts through the JAX converters and back are themselves."""
    h, w, b = 32, 64, 1
    spec = GRU_HIDDEN_SPECS[block_version(version)]
    shapes = [(b, h >> scale_shift(version, s), w >> scale_shift(version, s), c)
              for s, c in enumerate(spec["hid"])]
    zeros = [(jnp.zeros(sh), jnp.zeros(sh)) if spec["cell"] == "lstm" else jnp.zeros(sh)
             for sh in shapes]
    dec = jax.tree.map(jnp.asarray, _block_inputs(version, h, w, b, np.random.RandomState(0)))
    rng = np.random.RandomState(4)

    def random_params(module, *args):
        """The flax module's parameter tree (its names and shapes, traced
        abstractly) filled with N(0, 1) values: every leaf differs, so a
        swap of two leaves of one shape shows."""
        tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
        return jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), tree)

    fparams = random_params(flax_make_gru(version, h, w), dec, zeros)
    block, head = _seeded_block(version, h, w, seed=2)
    block.load_state_dict(checkpoint.gru_from_flax(fparams))
    back = _per_channel_rel(convert_gru_blocks({k: _np(v) for k, v in block.state_dict().items()}))
    want = _leaves(fparams)
    assert _leaves(back).keys() == want.keys()
    for k, v in _leaves(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    if spec["cell"] == "lstm":
        assert {n for n, _ in block.named_parameters() if "c0_layer1" in n or "clstm_1" in n}
    sd = block.state_dict()
    again = checkpoint.gru_from_flax(convert_gru_blocks({k: _np(v) for k, v in sd.items()}))
    assert again.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(again[k], v), k
    if head is not None:
        hp = random_params(FlaxHead(HEAD_VERSIONS[version]), [jnp.zeros(sh) for sh in shapes])
        head.load_state_dict(checkpoint.head_from_flax(hp))
        back = convert_head({k: _np(v) for k, v in head.state_dict().items()})
        want = _leaves(hp)
        assert _leaves(back).keys() == want.keys()
        for k, v in _leaves(back).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_h0_and_c0_freeze_is_exact():
    """v8's learned initial states are h0 and c0 at every scale; from the
    freeze on both stay bit-identical while everything else trains."""
    models = steps_gru.build_gru_models(_opts("v8"), "cpu", torch.Generator().manual_seed(1))
    init = models.h0_parameters()
    names = {n for n, p in models.gru.named_parameters() if any(p is q for q in init)}
    assert names == {f"cgru_{s}.{k}_layer1" for s in range(4) for k in ("h0", "c0")}
    state = TrainState(models.parameters(), 1e-4, 0, 4)
    g = torch.Generator().manual_seed(2)
    for step_i in range(3):
        if step_i == 1:
            state.freeze(models.h0_parameters())
            frozen = [p.detach().clone() for p in init]
            rest = [p.detach().clone() for p in models.parameters()
                    if not any(p is q for q in init)]
        for p in models.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        state.apply_gradients()
    assert all(torch.equal(a, b) for a, b in zip(init, frozen))
    moved = [p for p in models.parameters() if not any(p is q for q in init)]
    assert not any(torch.equal(a, b) for a, b in zip(moved, rest))


# --------------------------------------------------------- entry points


def _argv(*extra):
    return ["--synthetic_data", "--height", str(H), "--width", str(W), "--batch_size", "1",
            "--len_sequence", "2", "--num_epochs", "1", "--num_workers", "1",
            "--log_frequency", "2", "--compute_dtype", "float32", "--no_cuda", *extra]


def test_entry_point_trains_v5_by_default(tmp_path, capsys):
    """scripts/train_gru without --gru_version trains v5 on the CPU: one
    synthetic epoch (4 steps), finite losses, every trained parameter
    moved, weights_0 written."""
    tr = train_gru.main(_argv("--log_dir", str(tmp_path), "--save_frequency", "1"))
    assert tr.opt.gru_version == "v5" and tr.models.gru.version == "v5"
    assert tr.models.head is None and tr.step == 4
    losses = [float(ln.split("loss:")[1].split("|")[0])
              for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    folder = tmp_path / "mdp" / "models" / "weights_0"
    assert sorted(os.listdir(folder)) == sorted(
        f"{n}.pth" for n in ("encoder", "depth", "pose_encoder", "pose", "gru", "adam"))
    fresh = steps_gru.build_gru_models(tr.opt, "cpu", torch.Generator().manual_seed(9))
    assert not any(torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                                     tr.models.parameters()))


def test_head_is_saved_trained_and_loaded(tmp_path):
    """v7's Head is among the trained modules, saved as head.pth and read
    back by --load_weights_folder (head is in --models_to_load)."""
    parse = train_gru.MonodepthOptions().parse
    tr = train_gru.build_trainer(parse(_argv("--gru_version", "v7", "--log_dir", str(tmp_path))))
    head_params = {id(p) for p in tr.models.head.parameters()}
    assert head_params <= {id(p) for p in tr.models.parameters()}
    assert tr.models.head in tr.models.modules()
    with torch.no_grad():
        for p in tr.models.head.parameters():
            p.add_(1.0)
    folder = tr.save_model()
    assert os.path.isfile(os.path.join(folder, "head.pth"))
    loaded = train_gru.build_trainer(parse(_argv("--gru_version", "v7", "--log_dir",
                                                 str(tmp_path), "--load_weights_folder",
                                                 folder)))
    for a, b in zip(loaded.models.head.state_dict().values(),
                    tr.models.head.state_dict().values()):
        assert torch.equal(a, b)


def test_v5_warm_starts_from_monodepth2(tmp_path, monkeypatch):
    """--mono_pretrained (on by default) loads models/mono_640x192's module
    files into v5's encoders and decoders, dispconv heads included: v5's
    decoder makes the disparity."""
    mono = steps.build_mono_models(Options(height=H, width=W), "cpu",
                                   torch.Generator().manual_seed(7))
    checkpoint.save_folder(str(tmp_path / "models" / "mono_640x192"), mono, height=H, width=W)
    monkeypatch.chdir(tmp_path)
    tr = train_gru.build_trainer(train_gru.MonodepthOptions().parse(
        _argv("--log_dir", str(tmp_path / "log"))))
    assert tr.opt.gru_version == "v5" and tr.opt.mono_pretrained
    for name in ("encoder", "depth", "pose_encoder", "pose"):
        for k, v in getattr(mono, name).state_dict().items():
            assert torch.equal(getattr(tr.models, name).state_dict()[k], v), (name, k)
    dispconv = {id(p) for p in tr.models.depth.dispconv_parameters()}
    assert dispconv <= {id(p) for p in tr.models.parameters()}
