"""The DPT train step's loss of the port against the JAX package's, on the
CPU, in float64 on both sides.

``dpt_loss_fn`` (the DPT, the pose networks, the warp and the loss at
scale 0) at 64x128, B=2, ``rng=None``, per-pixel noise frames, flax's
two-pass batch variance and the JAX step's float32 casts read as float64,
as tests/test_torch_fusion_step.py runs the fusion loss. The DPT's weights
are tests/test_torch_dpt.py's filled tree carried by ``dpt_from_flax``, the
pose networks' the port's seeded init carried to JAX by the JAX package's
converters. The loss and ``loss/0`` within 1e-4 relative, every gradient
within 1e-4 of its tensor's max; a tensor that is 0 in JAX is 0 in the
port.
"""

import functools

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.checkpoint import convert_pose_decoder, convert_resnet_encoder
from ssde_tpu.config import Options
from ssde_tpu.data.transforms import preprocess_batch as jax_preprocess
from ssde_tpu.train.steps_dpt import build_dpt_models as jax_build_dpt_models
from ssde_tpu.train.steps_dpt import dpt_loss_fn as jax_dpt_loss_fn
from ssde_tpu_torch.checkpoint import dpt_from_flax
from ssde_tpu_torch.data.kitti import KITTI_K
from ssde_tpu_torch.train import steps, steps_dpt
from test_torch_dpt import (_Float64Numpy, _close, _in_port_layout, _leaves, _np,  # noqa: F401
                            _one_torch_thread, tree)

LH, LW, LB = 64, 128, 2
OPTS = dict(height=LH, width=LW, batch_size=LB, compute_dtype="float32", frame_ids=[0, -1, 1],
            scales=[0])


@pytest.fixture
def _jax_plain_paths(monkeypatch):
    """The JAX step on its plain CPU paths."""
    for env in ("SSDE_CONV_INTERPRET", "SSDE_ATTN_KERNEL"):
        monkeypatch.delenv(env, raising=False)


def test_dpt_loss_matches_jax_in_float64(tree, monkeypatch, _jax_plain_paths):
    """One ``dpt_loss_fn`` forward and backward in train mode, float64 on
    both sides: the DPT from the filled tree, the pose networks from the
    port's seeded init carried to JAX by the JAX package's converters."""
    import ssde_tpu.models.dpt
    import ssde_tpu.ops.image
    import ssde_tpu.ops.warp
    import ssde_tpu.train.steps
    import ssde_tpu.train.steps_dpt

    opts = Options(**OPTS)
    models = steps_dpt.build_dpt_models(opts, "cpu", torch.Generator().manual_seed(0))
    models.dpt.load_state_dict(dpt_from_flax(*tree))
    for m in models.modules():
        m.double()
    get = lambda m: {k: _np(v) for k, v in m.state_dict().items()}  # noqa: E731
    pe_p, pe_s, _ = convert_resnet_encoder(get(models.pose_encoder))
    params = {"dpt": tree[0], "pose_encoder": pe_p, "pose": convert_pose_decoder(get(models.pose))}
    stats = {"dpt": tree[1], "pose_encoder": pe_s}
    rng = np.random.RandomState(5)
    batch = {f"color/{i}": rng.rand(LB, LH, LW, 3) for i in (0, -1, 1)}
    batch["K"] = np.stack([KITTI_K] * LB).astype(np.float64)
    batch["jitter"] = np.array([[1.1, 0.9, 1.15, 0.05], [0.85, 1.1, 0.9, -0.07]])

    monkeypatch.setattr(flax.linen, "BatchNorm",
                        functools.partial(flax.linen.BatchNorm, use_fast_variance=False))
    for mod in (ssde_tpu.train.steps, ssde_tpu.train.steps_dpt, ssde_tpu.ops.warp,
                ssde_tpu.ops.image, ssde_tpu.models.dpt):
        monkeypatch.setattr(mod, "jnp", _Float64Numpy())
    with jax.enable_x64(True):
        jm = jax_build_dpt_models(opts)
        # the JAX DPT step's preprocessing (steps_dpt.py:97-114)
        inputs = jax_preprocess({k: jnp.asarray(v) for k, v in batch.items()}, LH, LW, 1,
                                [0, -1, 1], is_train=True, pyramid_frames=[0],
                                aug_num_scales=1)
        jparams = jax.tree.map(jnp.asarray, params)
        fn = jax.jit(jax.value_and_grad(
            lambda p: jax_dpt_loss_fn(jm, p, stats, inputs, None, True), has_aux=True))
        (_, (_, jlosses, _)), jgrads = fn(jparams)
        jlosses, jgrads = jax.tree.map(np.asarray, (jlosses, jgrads))
    monkeypatch.undo()

    inputs = steps.preprocess_train({k: torch.from_numpy(v) for k, v in batch.items()}, opts)
    assert inputs["color_aug/0/0"].dtype == torch.float64
    models.train()
    _, losses, _ = steps_dpt.dpt_loss_fn(models, inputs)
    losses["loss"].backward()

    assert set(losses) == set(jlosses) == {"loss", "loss/0"}
    for k in jlosses:
        assert np.isfinite(jlosses[k]), k
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=1e-4,
                                   err_msg=k)
    grads = lambda m: {k: _np(p.grad) for k, p in m.named_parameters()}  # noqa: E731
    got = grads(models.dpt)
    want = _in_port_layout(jgrads["dpt"], tree[1], monkeypatch)
    _close(got, {k: want[k] for k in got}, 1e-4, "dpt ")
    _close(_leaves(convert_resnet_encoder(grads(models.pose_encoder))[0]),
           _leaves(jgrads["pose_encoder"]), 1e-4, "pose_encoder ")
    _close(_leaves(convert_pose_decoder(grads(models.pose))), _leaves(jgrads["pose"]), 1e-4,
           "pose ")
