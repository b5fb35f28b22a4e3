"""Fusion training of the port against the JAX package, in float64 on the
CPU.

* The gradient of each fusion chain, ``Fusion`` (the pyramid),
  ``Fusion_v3`` with attention units and with conv units, and the
  scale-loop ``FeatureFusionBlock`` run coarse to fine from a zero carry as
  the step runs it, at 32x64, B=1: the scalar sum(disp * r) over every
  output scale, its gradient with respect to every parameter (the
  channel-shared relative embeddings included) and to the three per-frame
  inputs against ``jax.grad`` of the JAX chain, each within 1e-6 of its
  tensor's max (an attention conv's key bias, whose true gradient is 0,
  within 1e-6 of its conv's largest).
* One whole ``fusion_loss_fn`` at 64x128, B=1, with ``rng=None``: v3 with
  attention, and as ``slow`` cases the pyramid and the scale loop. The
  loss and each ``loss/{s}`` 1e-9 relative; every module's gradient and
  the encoders' new BatchNorm statistics 1e-6 of each tensor's max.

Float64 on both sides: the port's modules in float64 (attend3 takes it on
the CPU), the JAX step with x64 on and its float32 casts read as float64
(tests/test_torch_gru_step.py's recipe), flax's two-pass batch variance,
per-pixel noise frames (flat blocks tie the identity and reprojection
errors exactly; tests/test_torch_mono_step.py says why). The weights of
every case are the port's seeded init, carried to JAX by the JAX package's
converters (``convert_fusion_v2`` for ``fusion.pth``).

No fusion model ends in a sigmoid: the pyramid's disparities come from
tanh, or from a raw conv at its last block, and the scale-loop block's from
a raw conv, so seeded weights give some negative disparities and depths,
which the warp and the loss take as the reference does. The weights are
seed 0 of the port's init, the first tried; the test asserts that the JAX
loss is finite, so a seed whose loss were not would fail rather than
compare nothing. A seeded 2-channel attention unit often passes nothing
through one channel's relu; the gradients that this leaves 0 in JAX must
be 0 in the port (``ZERO_LEAF``).
"""

import functools
import re

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.checkpoint import (convert_depth_decoder, convert_fusion_v2,
                                 convert_pose_decoder, convert_resnet_encoder)
from ssde_tpu.config import Options
from ssde_tpu.data.transforms import preprocess_batch as jax_preprocess
from ssde_tpu.models import fusion as jax_fusion
from ssde_tpu.train.steps_fusion import build_fusion_models as jax_build_fusion_models
from ssde_tpu.train.steps_fusion import fusion_loss_fn as jax_fusion_loss_fn
from ssde_tpu_torch.data.kitti import KITTI_K
from ssde_tpu_torch.models import fusion
from ssde_tpu_torch.models.common import init_weights_
from ssde_tpu_torch.train import steps_fusion

DEC_CH = (16, 32, 64, 128)  # the decoder's pre-disp channels at scales 0-3


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
    for env in ("SSDE_CONV_INTERPRET", "SSDE_ATTN_KERNEL"):
        monkeypatch.delenv(env, raising=False)


def _np(t):
    return t.detach().numpy().copy()


def _grads(module):
    """The gradient of every parameter of ``module``, 0 where none reached it."""
    return {k: np.zeros(tuple(p.shape)) if p.grad is None else _np(p.grad)
            for k, p in module.named_parameters()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return _np(t).transpose(0, 2, 3, 1)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# the leaves whose gradient may be 0: Fusion_v3's last block's upscale conv,
# whose x2 carry no later block reads, and the attention convs' own. A
# seeded 2-channel attention unit often has a channel whose relu passes
# nothing (its value conv's weights and bias all negative on a non-negative
# input), and then that channel's shared embedding, and the conv that feeds
# only it, get none; Fusion_v3's 24 such convs have one at every seed tried
ZERO_LEAF = re.compile(r"\['fusion_block_4'\]\['upscale'\]|\['atten\d'\]")
# a gradient that is 0 in exact arithmetic comes out as rounding noise where
# it is a sum of cancelling terms (the biases of a unit whose input is 0
# everywhere): 0 means at most this much of the tree's largest gradient
ZERO_FLOOR = 1e-12


def _close_rel(got, want, tol, what):
    """Each leaf within ``tol`` of its max; an attention conv's key bias,
    whose true gradient is 0 (it shifts all 9 logits of a pixel alike),
    within ``tol`` of the largest gradient of its conv. A ZERO_LEAF that is
    0 in ``want`` is 0 in ``got``."""
    assert got.keys() == want.keys(), what
    conv = lambda k: re.match(r".*\['atten\d'\]", k)[0]  # noqa: E731
    conv_max = {}
    for k, w in want.items():
        if "['atten" in k:
            conv_max[conv(k)] = max(conv_max.get(conv(k), 0.0), np.abs(w).max())
    floor = ZERO_FLOOR * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        scale = conv_max[conv(k)] if "['key_conv']['bias']" in k else np.abs(w).max()
        if scale <= floor and ZERO_LEAF.search(k):
            assert np.abs(got[k]).max() <= floor, f"{what}{k}"
            continue
        assert scale > 0, f"{what}{k}"
        np.testing.assert_allclose(got[k], w, atol=tol * scale, rtol=0, err_msg=f"{what}{k}")


def _compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with XLA's backend optimisations
    off: a chain's graph runs once, and its CPU compile is most of its cost
    (the same arithmetic; the whole loss, whose convolutions then run
    slower than the compile saves, takes the default)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64`` (as in
    tests/test_torch_gru_step.py)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


# ------------------------------------------------------------ the chains

BH, BW = 32, 64
# the chains: (JAX module, port module)
CHAINS = {"pyramid": (lambda: jax_fusion.Fusion(), lambda: fusion.Fusion()),
          "v3": (lambda: jax_fusion.Fusion_v3(attention=True),
                 lambda: fusion.Fusion_v3(attention=True)),
          "v3_conv": (lambda: jax_fusion.Fusion_v3(attention=False),
                      lambda: fusion.Fusion_v3(attention=False)),
          "scale_loop": (lambda: jax_fusion.FeatureFusionBlock(2),
                         lambda: fusion.FeatureFusionBlock(2))}


def _run_chain(chain, apply, frames, zeros):
    """The chain on three per-frame dicts; the scale loop from a zero carry
    at the coarsest scale (``steps_fusion.fuse``)."""
    if chain != "scale_loop":
        return apply(*frames)
    out, upt = {}, zeros(frames[0]["disp/3"])
    for s in range(3, -1, -1):
        out[f"disp/{s}"], upt = apply(frames[0][f"disp/{s}"], upt, frames[1][f"disp/{s}"],
                                      frames[2][f"disp/{s}"])
    return out


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chain_gradient_matches_jax_in_float64(chain, monkeypatch):
    import ssde_tpu.ops.image

    make_jax, make_port = CHAINS[chain]
    module = make_port()
    init_weights_(module, torch.Generator().manual_seed(21))
    module.double().train()
    # N(0, 1) inputs: inputs of one sign, as disparities have, can leave a
    # 2-channel attention unit with a relu that passes nothing, and so
    # gradients that are 0 on both sides
    rs = np.random.RandomState(22)
    ch = DEC_CH if chain == "pyramid" else (1,) * 4
    frames = [{f"disp/{s}": rs.randn(1, BH >> s, BW >> s, ch[s]) for s in range(4)}
              for _ in range(3)]
    tfr = [{k: _nchw(v).requires_grad_() for k, v in f.items()} for f in frames]
    out = _run_chain(chain, module, tfr, torch.zeros_like)
    assert sorted(out) == [f"disp/{s}" for s in range(4)]
    r = {k: rs.randn(*_nhwc(v).shape) for k, v in out.items()}
    sum((v * _nchw(r[k])).sum() for k, v in out.items()).backward()

    params = convert_fusion_v2({k: _np(v) for k, v in module.state_dict().items()})
    # the JAX resize's float32 casts (the scale loop's x2 upsampling) read as float64
    monkeypatch.setattr(ssde_tpu.ops.image, "jnp", _Float64Numpy())
    with jax.enable_x64(True):
        jmod = make_jax()

        def jax_loss(p, fr):
            o = _run_chain(chain, functools.partial(jmod.apply, {"params": p}), fr,
                           jnp.zeros_like)
            return sum(jnp.sum(v * r[k]) for k, v in o.items()), o

        jfr = jax.tree.map(jnp.asarray, frames)
        fn = _compile(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True), params, jfr)
        (_, jout), (jgp, jgf) = fn(params, jfr)
        jout, jgp, jgf = jax.tree.map(np.asarray, (jout, jgp, jgf))

    assert sorted(jout) == sorted(out)
    for k in jout:
        assert out[k].dtype == torch.float64
        np.testing.assert_allclose(_nhwc(out[k]), jout[k], atol=1e-9 * np.abs(jout[k]).max(),
                                   rtol=0, err_msg=k)
    _close_rel(_leaves(convert_fusion_v2(_grads(module))), _leaves(jgp), 1e-6, "params")
    if chain != "v3_conv":  # the channel-shared embeddings are among them, most not 0
        rel = [v for k, v in _leaves(jgp).items() if k.endswith(("['rel_h']", "['rel_w']"))]
        assert sum(map(np.any, rel)) > len(rel) / 2
    got = [{k: _nhwc(t.grad) for k, t in f.items()} for f in tfr]
    _close_rel(_leaves(got), _leaves(jgf), 1e-6, "d ")


# ------------------------------------------------------ the whole loss

H, W, B = 64, 128, 1
OPTS = Options(height=H, width=W, batch_size=B, compute_dtype="float32")


def _tree(models, grads=False):
    """(params, batch_stats) of the port's modules as the JAX fusion trees."""
    get = _grads if grads else (lambda m: {k: _np(v) for k, v in m.state_dict().items()})
    enc_p, enc_s, _ = convert_resnet_encoder(get(models.encoder))
    pe_p, pe_s, _ = convert_resnet_encoder(get(models.pose_encoder))
    depth = convert_depth_decoder(get(models.depth))
    if models.pre_disp:  # the pyramid's dispconv heads never run: no JAX entries
        depth = {k: v for k, v in depth.items() if not k.startswith("dispconv")}
    params = {"encoder": enc_p, "depth": depth, "fusion": convert_fusion_v2(get(models.fusion)),
              "pose_encoder": pe_p, "pose": convert_pose_decoder(get(models.pose))}
    return params, {"encoder": enc_s, "pose_encoder": pe_s}


@pytest.mark.parametrize("variant", [
    "v3", pytest.param("pyramid", marks=pytest.mark.slow),
    pytest.param("scale_loop", marks=pytest.mark.slow)])
def test_fusion_loss_matches_jax_in_float64(variant, monkeypatch):
    import ssde_tpu.ops.image
    import ssde_tpu.ops.warp
    import ssde_tpu.train.steps
    import ssde_tpu.train.steps_fusion

    models = steps_fusion.build_fusion_models(OPTS, variant, "cpu",
                                              torch.Generator().manual_seed(0))
    for m in models.modules():
        m.double()
    params, stats = _tree(models)
    rng = np.random.RandomState(5)
    batch = {f"color/{i}": rng.rand(B, H, W, 3) for i in steps_fusion.TRAIN_FRAMES}
    batch["K"] = np.stack([KITTI_K] * B).astype(np.float64)
    batch["jitter"] = np.array([[1.1, 0.9, 1.15, 0.05]], np.float64)

    monkeypatch.setattr(flax.linen, "BatchNorm",
                        functools.partial(flax.linen.BatchNorm, use_fast_variance=False))
    for mod in (ssde_tpu.train.steps, ssde_tpu.train.steps_fusion, ssde_tpu.ops.warp,
                ssde_tpu.ops.image):
        monkeypatch.setattr(mod, "jnp", _Float64Numpy())
    with jax.enable_x64(True):
        jm = jax_build_fusion_models(OPTS, variant)
        # the JAX train step's preprocessing (steps_fusion.py:164-168)
        inputs = jax_preprocess({k: jnp.asarray(v) for k, v in batch.items()}, H, W, 4,
                                [0, -1, -2, 1], is_train=True, pyramid_frames=[0],
                                aug_num_scales=1)
        fn = jax.jit(jax.value_and_grad(
            lambda p: jax_fusion_loss_fn(jm, p, stats, inputs, None, True), has_aux=True))
        (_, (jstats, jlosses, _)), jgrads = fn(params)
        jstats, jlosses, jgrads = jax.tree.map(np.asarray, (jstats, jlosses, jgrads))
    monkeypatch.undo()

    inputs = steps_fusion.preprocess_fusion_train(
        {k: torch.from_numpy(v) for k, v in batch.items()}, OPTS)
    assert inputs["color_aug/0/0"].dtype == torch.float64
    models.train()
    _, losses, _ = steps_fusion.fusion_loss_fn(models, inputs)
    losses["loss"].backward()

    assert set(losses) == set(jlosses) == {"loss"} | {f"loss/{s}" for s in range(4)}
    for k in jlosses:
        assert np.isfinite(jlosses[k]), k
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=1e-9,
                                   err_msg=k)
    got = _tree(models, grads=True)[0]
    assert got.keys() == jgrads.keys()
    for group in jgrads:
        _close_rel(_leaves(got[group]), _leaves(jgrads[group]), 1e-6, group)
    _close_rel(_leaves(_tree(models)[1]), _leaves(jstats), 1e-6, "batch_stats")
