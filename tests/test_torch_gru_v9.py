"""GRU v9 (attention fusion) of the port against the JAX package.

* One v9 block step: outputs and the gradients of every parameter (h0
  included) and of the decoder inputs, against ``jax.grad`` of the JAX
  block on its planar path with the Pallas kernels in interpret mode
  (``SSDE_PLANAR_GRU=1 SSDE_CONV_INTERPRET=1``), so that ``attend3``'s
  custom VJP and the conv VJPs run, at 16x32 in float32. Bounds: outputs
  1e-4 absolute; gradients 1e-4 of each tensor's max (tests/
  test_torch_gru_step.py's v10 bound), where an attention conv's key bias
  is held to 1e-4 of the largest gradient of its conv: its true gradient is
  0 (it shifts all 9 logits of a pixel alike), so both sides give rounding.
* One whole v9 train step at 64x128, B=1, T=2, both sides in float64, by
  tests/test_torch_gru_step.py's recipe (which says why float64): the
  losses 1e-9 relative, ``batch_stats`` and every gradient 1e-6 of its
  tensor's max (key biases as above).
* v9 streamed disparity of the port's evaluator (``build_evaluator``,
  float32 at 64x128, B=2) against the JAX ``GRUStreamEvaluator`` on the
  same weights over 3 frames, 1e-4 absolute, as tests/test_torch_slice.py
  holds v10.
"""

import functools
import re

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.checkpoint import (convert_depth_decoder, convert_gru_blocks,
                                 convert_pose_decoder, convert_resnet_encoder)
from ssde_tpu.config import Options
from ssde_tpu.eval.gru_runners import GRUStreamEvaluator as JaxEvaluator
from ssde_tpu.models.recurrent import ConvGRUBlocks as FlaxBlocks
from ssde_tpu.models.recurrent import make_gru as flax_make_gru
from ssde_tpu.train.steps_gru import build_gru_models as jax_build_gru_models
from ssde_tpu.train.steps_gru import gru_loss_fn as jax_gru_loss_fn
from ssde_tpu.train.steps_gru import preprocess_gru_batch as jax_preprocess_gru_batch
from ssde_tpu_torch.data.kitti import KITTI_K
from ssde_tpu_torch.data.synthetic import scene_frames
from ssde_tpu_torch.models import make_gru
from ssde_tpu_torch.models.common import init_weights_, sample_
from ssde_tpu_torch.models.resnet import randomize_bn_stats_
from ssde_tpu_torch.scripts.evaluate_depth_gru_fusion import build_evaluator
from ssde_tpu_torch.train import steps_gru

DEC_CH, HID = (16, 32, 64, 128), (32, 64, 128, 256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_gru_step.py (which says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy().copy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close_rel(got, want, tol, what):
    """Each leaf within ``tol`` of its max; an attention conv's key bias
    within ``tol`` of the largest gradient of its conv."""
    assert got.keys() == want.keys(), what
    conv = lambda k: re.match(r".*\['atten\d'\]", k)[0]  # noqa: E731
    conv_max = {}
    for k, w in want.items():
        if "['atten" in k:
            conv_max[conv(k)] = max(conv_max.get(conv(k), 0.0), np.abs(w).max())
    for k, w in want.items():
        scale = conv_max[conv(k)] if "['key_conv']['bias']" in k else np.abs(w).max()
        assert scale > 0, f"{what}{k}"
        np.testing.assert_allclose(got[k], w, atol=tol * scale, rtol=0, err_msg=f"{what}{k}")


# ------------------------------------------------------------- the block


def test_v9_block_step_matches_pallas_vjp(monkeypatch):
    monkeypatch.setenv("SSDE_PLANAR_GRU", "1")
    monkeypatch.setenv("SSDE_CONV_INTERPRET", "1")
    monkeypatch.delenv("SSDE_ATTN_KERNEL", raising=False)
    h, w, b = 16, 32, 1
    block = make_gru("v9", h, w)
    g = torch.Generator().manual_seed(16)
    init_weights_(block, g)
    for s in range(4):
        sample_(block.unit(s).h0_layer1, g, lambda t: t.normal_(0, 0.5, generator=g))
    rng = np.random.RandomState(17)
    shape = lambda s, c: (b, h >> s, w >> s, c)  # noqa: E731  (NHWC)
    dec = {f"disp/{s}": rng.randn(*shape(s, c)).astype(np.float32) for s, c in enumerate(DEC_CH)}
    r = {f"disp/{s}": rng.randn(*shape(s, 1)).astype(np.float32) for s in range(4)}
    q = [rng.randn(*shape(s, c)).astype(np.float32) for s, c in enumerate(HID)]

    jblock = flax_make_gru("v9", h, w)
    params = convert_gru_blocks({k: _np(v) for k, v in block.state_dict().items()})
    cfg = jblock.apply({"params": params}, method=lambda m: m.planar_cfg)
    assert [c[0] for c in cfg] == [True, True, True, False]  # planar attend3 at scales 0-2

    def jax_loss(p, d):
        h0 = jblock.apply({"params": p}, b, method=FlaxBlocks.initial_state)
        new, disp = jblock.apply({"params": p}, d, h0)
        news = [hs.transpose(0, 1, 3, 2)[:, :, :w >> s] if cfg[s][0] else hs
                for s, hs in enumerate(new)]  # planar carries are (B, H, C, wp)
        loss = sum(jnp.sum(disp[k] * r[k]) for k in r)
        return loss + sum(jnp.sum(hs * q[s]) for s, hs in enumerate(news)), (news, disp)

    (_, (jnew, jdisp)), (jgp, jgd) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(params, {k: jnp.asarray(v) for k, v in dec.items()})

    dt = {k: _nchw(v).requires_grad_() for k, v in dec.items()}
    new, disp = block(dt, block.initial_state(b))
    loss = sum((disp[k] * _nchw(r[k])).sum() for k in r)
    loss = loss + sum((hs * _nchw(q[s])).sum() for s, hs in enumerate(new))
    loss.backward()

    for s in range(4):
        np.testing.assert_allclose(_np(new[s]).transpose(0, 2, 3, 1), np.asarray(jnew[s]),
                                   atol=1e-4, rtol=0, err_msg=f"hidden {s}")
        k = f"disp/{s}"
        np.testing.assert_allclose(_np(disp[k]).transpose(0, 2, 3, 1), np.asarray(jdisp[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    got = convert_gru_blocks({k: _np(p.grad) for k, p in block.named_parameters()})
    _close_rel(_leaves(got), _leaves(jgp), 1e-4, "params")
    _close_rel({k: _np(v.grad).transpose(0, 2, 3, 1) for k, v in dt.items()},
               {k: np.asarray(v) for k, v in jgd.items()}, 1e-4, "d ")


# -------------------------------------------------------- the whole step

H, W, B, T = 64, 128, 1, 2


def _opts():
    return Options(height=H, width=W, batch_size=B, len_sequence=T, gru_version="v9",
                   compute_dtype="float32")


def _tree(models, grads=False):
    """(params, batch_stats) of the port's modules as the JAX GRU trees."""
    get = (lambda m: {k: _np(p.grad) for k, p in m.named_parameters()
                      if p.grad is not None}) if grads else \
        (lambda m: {k: _np(v) for k, v in m.state_dict().items()})
    enc_p, enc_s, _ = convert_resnet_encoder(get(models.encoder))
    pe_p, pe_s, _ = convert_resnet_encoder(get(models.pose_encoder))
    depth = {k: v for k, v in convert_depth_decoder(get(models.depth)).items()
             if not k.startswith("dispconv")}  # pre_disp: no heads in the JAX tree
    params = {"encoder": enc_p, "depth": depth, "gru": convert_gru_blocks(get(models.gru)),
              "pose_encoder": pe_p, "pose": convert_pose_decoder(get(models.pose))}
    return params, {"encoder": enc_s, "pose_encoder": pe_s}


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64`` (as in
    tests/test_torch_gru_step.py)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_v9_train_step_matches_jax_in_float64(monkeypatch):
    import ssde_tpu.ops.warp
    import ssde_tpu.train.steps
    import ssde_tpu.train.steps_gru

    for env in ("SSDE_PLANAR_GRU", "SSDE_CONV_INTERPRET", "SSDE_ATTN_KERNEL"):
        monkeypatch.delenv(env, raising=False)  # JAX on its plain CPU paths
    models = steps_gru.build_gru_models(_opts(), "cpu", torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    for p in models.h0_parameters():
        sample_(p, g, lambda t: t.normal_(0, 0.1, generator=g))
    for m in models.modules():
        m.double()
    models.gru.kernel_scales = (False,) * 4  # the plain convs: conv3x3 takes no float64
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
        jm = jax_build_gru_models(_opts())
        inputs, jb, jt = jax_preprocess_gru_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, _opts(), is_train=True)
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
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-9, err_msg=k)
    got = _tree(models, grads=True)[0]
    for group in ("encoder", "depth", "gru", "pose_encoder", "pose"):
        _close_rel(_leaves(got[group]), _leaves(jgrads[group]), 1e-6, group)
    _close_rel(_leaves(_tree(models)[1]), _leaves(jstats), 1e-6, "batch_stats")


# ----------------------------------------------------- streamed disparity


def test_v9_streamed_disparity_matches_jax():
    opt = Options(gru_version="v9", height=H, width=W, compute_dtype="float32")
    ev = build_evaluator(opt, "cpu", seed=0)
    m = ev.models
    g = torch.Generator().manual_seed(1)
    randomize_bn_stats_(m.encoder, g)
    for s in range(4):  # a non-zero learned initial state
        sample_(m.gru.unit(s).h0_layer1, g, lambda t: t.normal_(0, 0.5, generator=g))
    sd = lambda mod: {k: v.detach().numpy() for k, v in mod.state_dict().items()}  # noqa
    enc_p, enc_s, _ = convert_resnet_encoder(sd(m.encoder))
    params = {"encoder": enc_p, "depth": convert_depth_decoder(sd(m.depth)),
              "gru": convert_gru_blocks(sd(m.gru))}
    jev = JaxEvaluator(jax_build_gru_models(opt), params, {"encoder": enc_s})
    frames = scene_frames(H, W, 3, batch=2, seed=3)
    got, want = ev.predict_scene(frames), jev.predict_scene(frames)
    assert len(got) == len(want) == 3
    for t, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (2, H, W) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f"frame {t}")
    # the recurrence carries state: the frames differ from a fresh start
    assert np.abs(got[2] - ev.predict_single(frames[2])).max() > 1e-4
