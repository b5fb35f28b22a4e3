"""One data-parallel mono step of the port over 2 gloo ranks against the
JAX step over a 2-device mesh, and against the port's one-process step,
in float64.

The JAX side follows ``__graft_entry__.py``'s recipe (``:100-140``): the
batch sharded over ``ssde_tpu.parallel.make_mesh(2)`` with ``shard_batch``,
the parameters and statistics replicated, ``jax.value_and_grad`` of
``mono_loss_fn`` jitted over it (XLA's gradient AllReduce and global-batch
BatchNorm). The port runs two ranks of one sample each
(``ssde_tpu_torch.parallel.launch``), each through ``steps.train_step``
(the gradient mean over the ranks in ``TrainState.apply_gradients``,
BatchNorm over the global batch).

The pins are the single-device parity's (tests/test_torch_mono_step.py,
which says why): 64x128 (at 32x64 the JAX reflect conv's gradient on the
one-pixel-high last map is wrong), B=2, per-pixel noise frames, jitter on,
``rng=None`` (no automask noise), flax's two-pass batch variance, the
port's seed-0 weights carried across by the JAX package's converters. Its
float32 bounds do not hold here: at scales (0, 1) the float32 step is too
ill-conditioned: the JAX 2-device float32 step's encoder gradients exceed
them against the JAX 1-device float32 step's, and the port's float64
pose-encoder gradients against either. So both sides run in float64 by
tests/test_torch_mono_options.py's recipe (JAX with
x64 on, the step's float32 casts and grayscale weights read as float64,
the automask argmin pinned to the port's) and take its bounds: the loss
and each ``loss/{s}`` 1e-9 relative, every gradient and BatchNorm running
statistic 1e-6 of its tensor's max. Against the port's one-process step:
losses, gradients, parameters after Adam and buffers 1e-9 of each tensor's
max. The two ranks' parameters, Adam moments and buffers are bit-identical.
"""

import functools

import numpy as np
import pytest
import torch

from ssde_tpu_torch import parallel
from ssde_tpu_torch.config import Options
from ssde_tpu_torch.data.synthetic import make_synthetic_batch
from ssde_tpu_torch.train import steps
from ssde_tpu_torch.train.state import TrainState
from test_torch_parallel import CPU2, _one_torch_thread, check_against_one_process, summary  # noqa: F401

H, W, B = 64, 128, 2
SCALES = [0, 1]


def _opts():
    return Options(height=H, width=W, batch_size=B, compute_dtype="float32", scales=SCALES)


def _batch():
    """tests/test_torch_mono_step.py's batch, as float64."""
    batch = make_synthetic_batch(B, H, W, seed=0)
    rng = np.random.RandomState(5)
    for i in (0, -1, 1):
        batch[f"color/{i}"] = rng.rand(B, H, W, 3).astype(np.float32)
    batch["jitter"] = np.array([[1.1, 0.9, 1.15, 0.05], [0.85, 1.1, 0.9, -0.07]], np.float32)
    return {k: v.astype(np.float64) for k, v in batch.items()}


def _models():
    return steps.build_mono_models(_opts(), "cpu", torch.Generator().manual_seed(0))


def mono_step(batch):
    """One mono train step of this process's rows of ``batch`` (all of them
    outside a group), the networks in float64, no automask noise."""
    models = _models()
    for m in models.modules():
        m.double()
    state = TrainState(models.parameters(), 1e-4, 15, 1)
    parallel.replicate_(models.modules())
    rows = parallel.shard_batch(batch, parallel.rank(), parallel.world_size())
    losses = steps.train_step(models, state, {k: torch.from_numpy(v) for k, v in rows.items()},
                              None)
    parallel.all_reduce_mean_(list(losses.values()))
    return summary(models, state, losses)


@pytest.fixture(scope="module")
def runs():
    """(the 2 ranks' summaries, the one-process summary, the automask
    argmin of the one-process step at each scale)."""
    from test_torch_mono_options import _recording

    batch = _batch()
    picked = []
    mp = pytest.MonkeyPatch()
    mp.setattr(steps, "min_reprojection", _recording(picked))
    try:
        want = mono_step(batch)
    finally:
        mp.undo()
    return parallel.launch(mono_step, CPU2, batch), want, picked


def _jax_step(picked):
    """The JAX step over the 2-device mesh on the port's seed-0 weights, in
    float64, the automask argmin pinned to ``picked``: (losses, gradients
    and new batch_stats as flax trees, the pixels where its own argmin
    differs, of how many)."""
    import flax.linen
    import jax
    import jax.numpy as jnp

    import ssde_tpu.data.transforms
    import ssde_tpu.ops.image
    import ssde_tpu.ops.losses
    import ssde_tpu.ops.warp
    import ssde_tpu.train.steps
    from ssde_tpu.config import Options as JaxOptions
    from ssde_tpu.parallel import host_to_device, make_mesh, replicated, shard_batch
    from test_torch_attention_encoder import _Float64Numpy
    from test_torch_mono_options import _PinnedNumpy
    from test_torch_mono_step import _tree

    params, stats = jax.tree.map(lambda a: np.asarray(a, np.float64), _tree(_models()))
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "BatchNorm",
               functools.partial(flax.linen.BatchNorm, use_fast_variance=False))
    mp.setattr(ssde_tpu.data.transforms, "_GRAY_W", np.array([0.2989, 0.5870, 0.1140]))
    pinned = _PinnedNumpy(picked)
    for mod in (ssde_tpu.train.steps, ssde_tpu.ops.losses):
        mp.setattr(mod, "jnp", pinned)
    for mod in (ssde_tpu.ops.warp, ssde_tpu.ops.image):
        mp.setattr(mod, "jnp", _Float64Numpy())
    try:
        with jax.enable_x64(True):
            jm = ssde_tpu.train.steps.build_mono_models(JaxOptions(
                height=H, width=W, batch_size=B, compute_dtype="float32", scales=SCALES))
            mesh = make_mesh(2)
            assert mesh.devices.size == 2
            batch = shard_batch({k: jnp.asarray(v) for k, v in _batch().items()}, mesh)
            params, stats = (host_to_device(t, replicated(mesh)) for t in (params, stats))

            def loss(p, batch):
                pinned.natural.clear()
                inputs = ssde_tpu.data.transforms.preprocess_batch(
                    batch, H, W, len(SCALES), [0, -1, 1], is_train=True, pyramid_frames=[0],
                    aug_num_scales=1)
                loss, (new_stats, jlosses, _) = ssde_tpu.train.steps.mono_loss_fn(
                    jm, p, stats, inputs, None, True)
                return loss, (new_stats, jlosses, list(pinned.natural))

            (_, (jstats, jlosses, natural)), jgrads = jax.jit(
                jax.value_and_grad(loss, has_aux=True))(params, batch)
            assert jax.tree.leaves(jgrads)[0].sharding.is_fully_replicated
            out = jax.tree.map(np.asarray, (jlosses, jgrads, jstats, natural))
    finally:
        mp.undo()
        jax.clear_caches()
    assert len(out[3]) == len(picked) and next(pinned.pinned, None) is None
    flips = sum(int((a != b).sum()) for a, b in zip(out[3], picked))
    return out[:3] + (flips, sum(a.size for a in picked))


def test_ranks_match_the_one_process_step(runs):
    ranks, want, _ = runs
    check_against_one_process(ranks, want)
    assert all(np.isfinite(v) for v in want["losses"].values())


def test_matches_the_jax_two_device_mesh(runs):
    from test_torch_mono_step import _leaves, _tree

    ranks, _, picked = runs
    jlosses, jgrads, jstats, flips, pixels = _jax_step(picked)
    got = ranks[0]
    assert set(got["losses"]) == set(jlosses) == {"loss", "loss/0", "loss/1"}
    for k, v in jlosses.items():
        assert np.isfinite(v)
        assert got["losses"][k] == pytest.approx(float(v), rel=1e-9, abs=0), k
    # the JAX step's own argmin differs from the port's at near-ties only
    assert pixels and flips <= 1e-4 * pixels, (flips, pixels)
    # rank 0's averaged gradients and statistics, in flax's layout, float64
    models = _models()
    for m in models.modules():
        m.double()
    params = [p for m in models.modules() for p in m.parameters()]
    buffers = [b for m in models.modules() for b in m.buffers()]
    with torch.no_grad():
        for p, g in zip(params, got["grads"]):
            p.grad = g
        for b, v in zip(buffers, got["buffers"]):
            b.copy_(v)
    grads, stats = _tree(models, grads=True)[0], _tree(models)[1]
    for group in ("encoder", "depth", "pose_encoder", "pose"):
        have, want = _leaves(grads[group]), _leaves(jgrads[group])
        assert have.keys() == want.keys()
        for k, w in want.items():
            assert w.dtype == np.float64 and np.abs(w).max() > 0, k
            np.testing.assert_allclose(have[k], w, atol=1e-6 * np.abs(w).max(), rtol=0,
                                       err_msg=f"{group}{k}")
    have, want = _leaves(stats), _leaves(jstats)
    assert have.keys() == want.keys() and len(want) > 0
    for k, w in want.items():
        np.testing.assert_allclose(have[k], w, atol=1e-6 * np.abs(w).max(), rtol=0, err_msg=k)
