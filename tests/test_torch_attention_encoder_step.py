"""The mono loss with the attention encoder (``--model
rn_encoder_with_attention``) of the port against the JAX package's, on the
CPU, in float64 on both sides.

``build_mono_models(opts, attention_encoder=True)`` and ``mono_loss_fn``
against the JAX ``build_mono_models(opts, attention_encoder=True)`` and
``mono_loss_fn``, one step at 64x128, B=2, ``rng=None``, per-pixel noise
frames, flax's two-pass batch variance, the JAX step's float32 casts read
as float64 (tests/test_torch_fusion_step.py's recipe): the encoder from a
filled JAX tree carried by ``attention_encoder_from_flax``, the decoders
and pose networks from the port's seeded init through the JAX package's
converters. The loss and each ``loss/{s}`` within 1e-9 relative, every
gradient within 1e-6 of its tensor's max (an attention conv's key weight
within 1e-6 of its conv's largest).
"""

import functools

import flax.linen
import numpy as np
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.checkpoint import (convert_depth_decoder, convert_pose_decoder,
                                 convert_resnet_encoder)
from ssde_tpu.config import Options
from ssde_tpu.data.transforms import preprocess_batch as jax_preprocess
from ssde_tpu.models.attention_resnet import ResnetEncoderAttention as FlaxEncoderAttention
from ssde_tpu.train.steps import build_mono_models as jax_build_mono_models
from ssde_tpu.train.steps import mono_loss_fn as jax_mono_loss_fn
from ssde_tpu_torch.checkpoint import attention_encoder_from_flax
from ssde_tpu_torch.data.kitti import KITTI_K
from ssde_tpu_torch.models import ResnetEncoderAttention
from ssde_tpu_torch.train import steps
from test_torch_attention_encoder import (B, _close, _compile, _filled,  # noqa: F401
                                          _Float64Numpy, _in_port_layout, _jax_plain_paths,
                                          _np, _one_torch_thread)

LH, LW = 64, 128


def test_attention_mono_loss_matches_jax_in_float64(monkeypatch):
    import ssde_tpu.models.attention
    import ssde_tpu.ops.image
    import ssde_tpu.ops.warp
    import ssde_tpu.train.steps

    opts = Options(height=LH, width=LW, batch_size=B, compute_dtype="float32")
    models = steps.build_mono_models(opts, "cpu", torch.Generator().manual_seed(0),
                                     attention_encoder=True)
    assert type(models.encoder) is ResnetEncoderAttention
    rng = np.random.RandomState(5)
    enc_p, enc_s = _filled(FlaxEncoderAttention(18), rng.rand(1, LH, LW, 3), 13)
    models.encoder.load_state_dict(attention_encoder_from_flax(enc_p, enc_s))
    for m in models.modules():
        m.double()
    get = lambda m: {k: _np(v) for k, v in m.state_dict().items()}  # noqa: E731
    pe_p, pe_s, _ = convert_resnet_encoder(get(models.pose_encoder))
    params = {"encoder": enc_p, "depth": convert_depth_decoder(get(models.depth)),
              "pose_encoder": pe_p, "pose": convert_pose_decoder(get(models.pose))}
    stats = {"encoder": enc_s, "pose_encoder": pe_s}
    batch = {f"color/{i}": rng.rand(B, LH, LW, 3) for i in (0, -1, 1)}
    batch["K"] = np.stack([KITTI_K] * B).astype(np.float64)
    batch["jitter"] = np.array([[1.1, 0.9, 1.15, 0.05], [0.85, 1.1, 0.9, -0.07]])

    monkeypatch.setattr(flax.linen, "BatchNorm",
                        functools.partial(flax.linen.BatchNorm, use_fast_variance=False))
    for mod in (ssde_tpu.train.steps, ssde_tpu.ops.warp, ssde_tpu.ops.image,
                ssde_tpu.models.attention):
        monkeypatch.setattr(mod, "jnp", _Float64Numpy())
    with jax.enable_x64(True):
        jm = jax_build_mono_models(opts, attention_encoder=True)
        # the JAX mono step's preprocessing (steps.py:633-640)
        inputs = jax_preprocess({k: jnp.asarray(v) for k, v in batch.items()}, LH, LW, 4,
                                [0, -1, 1], is_train=True, pyramid_frames=[0],
                                aug_num_scales=1)
        jparams = jax.tree.map(jnp.asarray, params)
        fn = _compile(jax.value_and_grad(
            lambda p: jax_mono_loss_fn(jm, p, stats, inputs, None, True), has_aux=True), jparams)
        (_, (_, jlosses, _)), jgrads = fn(jparams)
        jlosses, jgrads = jax.tree.map(np.asarray, (jlosses, jgrads))
    monkeypatch.undo()

    inputs = steps.preprocess_train({k: torch.from_numpy(v) for k, v in batch.items()}, opts)
    models.train()
    _, losses, _ = steps.mono_loss_fn(models, inputs)
    losses["loss"].backward()

    assert set(losses) == set(jlosses) == {"loss"} | {f"loss/{s}" for s in range(4)}
    for k in jlosses:
        assert np.isfinite(jlosses[k]), k
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=1e-9,
                                   err_msg=k)
    grads = lambda m: {k: _np(p.grad) for k, p in m.named_parameters()}  # noqa: E731
    got = grads(models.encoder)
    _close(got, {k: v for k, v in _in_port_layout(jgrads["encoder"], enc_s, monkeypatch).items()
                 if k in got}, 1e-6, "encoder ")
    leaves = lambda t: {jax.tree_util.keystr(p): np.asarray(v)  # noqa: E731
                        for p, v in jax.tree_util.tree_leaves_with_path(t)}
    for name, conv in (("depth", convert_depth_decoder), ("pose", convert_pose_decoder)):
        _close(leaves(conv(grads(getattr(models, name)))), leaves(jgrads[name]), 1e-6,
               f"{name} ")
    _close(leaves(convert_resnet_encoder(grads(models.pose_encoder))[0]),
           leaves(jgrads["pose_encoder"]), 1e-6, "pose_encoder ")
