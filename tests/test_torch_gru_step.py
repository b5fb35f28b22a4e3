"""The GRU v10 sequence training slice of the port against the JAX package.

* One v10 block step's gradients (every parameter, h0 included, and the
  decoder inputs) against ``jax.grad`` of the JAX block on its planar path,
  with the Pallas conv kernels in interpret mode (so their custom VJPs,
  ``_conv_rows`` as dx and ``_dw_call``, run), at 16x32, float32. Bound
  1e-4 of each gradient's max: the JAX package holds its planar block to
  its NHWC one at 3e-5 in the forward (tests/test_recurrent.py), and the
  backward sums three times as many float32 products.
* One whole GRU train step at 64x128, B=1, T=2, ``rng=None``: the port's
  ``gru_loss_fn`` + backward against JAX ``gru_loss_fn`` + ``jax.grad`` on
  the same converted weights and the same preprocessed inputs, with
  per-pixel noise frames and flax's two-pass batch variance, as in
  tests/test_torch_mono_step.py (which says why). Both sides run in
  float64 (JAX with x64 on, and its step's float32 casts read as float64).
  In float32 this step is ill-conditioned: the port's own float32
  gradients are 3.8e-2 (encoder), 4.3e-2 (pose encoder) and 5.4e-2 (the
  scale-0 h0) of a tensor's max off its float64 run, from the encoders'
  float32 arithmetic, from 3 relu masks of the block that float32 rounding
  flips (h0: 5.4e-2 -> 4.3e-4 with them pinned), and, in the per-pixel h0
  gradients, from the float32 loss's per-pixel rounding. The same
  amplification takes float64's rounding to 3.6e-8 of a tensor's max.
  Bounds: the losses 1e-9 relative (1.1e-10 seen), ``batch_stats`` and
  every gradient 1e-6 of its tensor's max, both optimizers on the same
  gradients 1e-12 relative. The port's
  ``preprocess_gru_batch`` is held to JAX's on its own, in float32, at 1e-6.
* The h0 freeze, the entry point on the CPU, and the device rules.
"""

import copy
import functools
import inspect

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.checkpoint import (convert_depth_decoder, convert_gru_blocks,
                                 convert_pose_decoder, convert_resnet_encoder)
from ssde_tpu.config import Options
from ssde_tpu.models.recurrent import ConvGRUBlocks as FlaxBlocks
from ssde_tpu.models.recurrent import make_gru as flax_make_gru
from ssde_tpu.train.state import TrainState as JaxTrainState
from ssde_tpu.train.state import create_optimizer
from ssde_tpu.train.steps_gru import build_gru_models as jax_build_gru_models
from ssde_tpu.train.steps_gru import gru_loss_fn as jax_gru_loss_fn
from ssde_tpu.train.steps_gru import preprocess_gru_batch as jax_preprocess_gru_batch
from ssde_tpu_torch.data.kitti import KITTI_K
from ssde_tpu_torch.data.sequence import KITTISeqDataset
from ssde_tpu_torch.data.pipeline import to_device
from ssde_tpu_torch.models import make_gru
from ssde_tpu_torch.models.common import init_weights_, sample_
from ssde_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_dw, conv3x3_dx
from ssde_tpu_torch.ops.photometric import photometric_bwd, photometric_fwd
from ssde_tpu_torch.ops.warp_banded import warp_family_bwd, warp_family_fwd
from ssde_tpu_torch.scripts import train_gru
from ssde_tpu_torch.train import steps, steps_gru, trainer
from ssde_tpu_torch.train.state import TrainState
from test_kitti_tree import kitti_tree  # noqa: F401

H, W, B, T = 64, 128, 1, 2
GROUPS = ("encoder", "depth", "gru", "pose_encoder", "pose")
DEC_CH = (16, 32, 64, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The small-size runs here take one torch thread. Beside the other
    workers of a parallel pytest run, a thread pool in every process
    oversubscribes the cores, and their many small ops then wait minutes in
    its barriers instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy().copy()


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close_rel(got, want, tol, what):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        assert np.abs(w).max() > 0, f"{what}{k}"
        np.testing.assert_allclose(got[k], w, atol=tol * np.abs(w).max(), rtol=0,
                                   err_msg=f"{what}{k}")


# ------------------------------------------------------------- the block


def test_v10_block_step_gradients_match_pallas_vjp(monkeypatch):
    monkeypatch.setenv("SSDE_PLANAR_GRU", "1")
    monkeypatch.setenv("SSDE_CONV_INTERPRET", "1")
    h, w, b = 16, 32, 1
    block = make_gru("v10", h, w)
    g = torch.Generator().manual_seed(6)
    init_weights_(block, g)
    for s in range(4):
        sample_(block.unit(s).h0_layer1, g, lambda t: t.normal_(0, 0.5, generator=g))
    rng = np.random.RandomState(7)
    shape = lambda s, c: (b, h >> s, w >> s, c)  # noqa: E731  (NHWC)
    dec = {f"disp/{s}": rng.randn(*shape(s, c)).astype(np.float32) for s, c in enumerate(DEC_CH)}
    r = {f"disp/{s}": rng.randn(*shape(s, 1)).astype(np.float32) for s in range(4)}
    q = [rng.randn(*shape(s, c)).astype(np.float32) for s, c in enumerate((32, 64, 128, 256))]

    jblock = flax_make_gru("v10", h, w)
    params = convert_gru_blocks({k: _np(v) for k, v in block.state_dict().items()})
    cfg = jblock.apply({"params": params}, method=lambda m: m.planar_cfg)
    assert [c[0] for c in cfg] == [True, True, True, False]  # Pallas at scales 0-2

    def jax_loss(p, d):
        h0 = jblock.apply({"params": p}, b, method=FlaxBlocks.initial_state)
        new, disp = jblock.apply({"params": p}, d, h0)
        loss = sum(jnp.sum(disp[k] * r[k]) for k in r)
        for s, hs in enumerate(new):  # planar carries are (B, H, C, wp)
            hs = hs.transpose(0, 1, 3, 2)[:, :, :w >> s] if cfg[s][0] else hs
            loss = loss + jnp.sum(hs * q[s])
        return loss

    jgp, jgd = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(
        params, {k: jnp.asarray(v) for k, v in dec.items()})

    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa
    dt = {k: nchw(v).requires_grad_() for k, v in dec.items()}
    new, disp = block(dt, block.initial_state(b))
    loss = sum((disp[k] * nchw(r[k])).sum() for k in r)
    loss = loss + sum((hs * nchw(q[s])).sum() for s, hs in enumerate(new))
    loss.backward()

    got = convert_gru_blocks({k: _np(p.grad) for k, p in block.named_parameters()})
    _close_rel(_leaves(got), _leaves(jgp), 1e-4, "params")
    _close_rel({k: _np(v.grad).transpose(0, 2, 3, 1) for k, v in dt.items()},
               {k: np.asarray(v) for k, v in jgd.items()}, 1e-4, "d ")


# -------------------------------------------------------- the whole step


def _opts(**kw):
    return Options(height=H, width=W, batch_size=B, len_sequence=T, gru_version="v10",
                   compute_dtype="float32", **kw)


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


def _batch():
    rng = np.random.RandomState(5)
    batch = {f"color/{i}": rng.rand(B, T, H, W, 3).astype(np.float32) for i in (0, -1, 1)}
    batch["K"] = np.stack([KITTI_K] * B).astype(np.float32)
    batch["jitter"] = np.array([[1.1, 0.9, 1.15, 0.05], [0.85, 1.1, 0.9, -0.07]][:B], np.float32)
    return batch


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: put in place of
    the JAX step modules' ``jnp``, it turns their float32 casts of the
    geometry, warp and loss into float64 ones."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _nchw_inputs(inputs):
    """JAX preprocessed inputs (NHWC images) -> the port's (NCHW) tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.asarray(v).transpose(0, 3, 1, 2) if k.startswith("color") else np.asarray(v)))
        for k, v in inputs.items()}


def test_preprocess_gru_batch_matches_jax():
    """B-major flattening of (B, T) frames, K and jitter repeated over T."""
    batch = _batch()
    want, jb, jt = jax_preprocess_gru_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                            _opts(), is_train=True)
    got, pb, pt = steps_gru.preprocess_gru_batch(to_device(batch, "cpu"), _opts())
    assert (pb, pt) == (jb, jt) == (B, T)
    want = _nchw_inputs(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-6, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def step():
    """One step on both sides in float64: (port models after the
    forward/backward, port losses, JAX losses, JAX grads, JAX new
    batch_stats, the starting params and stats)."""
    import ssde_tpu.ops.warp
    import ssde_tpu.train.steps
    import ssde_tpu.train.steps_gru

    models = steps_gru.build_gru_models(_opts(), "cpu", torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    for p in models.h0_parameters():
        sample_(p, g, lambda t: t.normal_(0, 0.1, generator=g))
    for m in models.modules():
        m.double()
    models.gru.kernel_scales = (False,) * 4  # the plain convs: conv3x3 takes no float64
    params, stats = _tree(models)
    batch = {k: v.astype(np.float64) for k, v in _batch().items()}

    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "BatchNorm",
               functools.partial(flax.linen.BatchNorm, use_fast_variance=False))
    for mod in (ssde_tpu.train.steps, ssde_tpu.train.steps_gru, ssde_tpu.ops.warp):
        mp.setattr(mod, "jnp", _Float64Numpy())
    try:
        with jax.enable_x64(True):
            jm = jax_build_gru_models(_opts())
            inputs, jb, jt = jax_preprocess_gru_batch(
                {k: jnp.asarray(v) for k, v in batch.items()}, _opts(), is_train=True)
            fn = jax.jit(jax.value_and_grad(
                lambda p: jax_gru_loss_fn(jm, p, stats, inputs, jb, jt, None, True),
                has_aux=True))
            (_, (jstats, jlosses, _)), jgrads = fn(params)
            jstats, jlosses, jgrads = jax.tree.map(np.asarray, (jstats, jlosses, jgrads))
            inputs = _nchw_inputs(inputs)
    finally:
        mp.undo()
    assert inputs["color_aug/0/0"].dtype == torch.float64
    models.train()
    _, losses, _ = steps_gru.gru_loss_fn(models, inputs, B, T)
    losses["loss"].backward()
    return models, {k: v.detach() for k, v in losses.items()}, jlosses, jgrads, jstats, \
        params, stats


def test_step_losses_match_jax(step):
    _, losses, jlosses, *_ = step
    assert set(losses) == set(jlosses) == {"loss"} | {f"loss/{s}" for s in range(4)}
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-9, err_msg=k)


@pytest.mark.parametrize("group", GROUPS)
def test_step_gradients_match_jax(step, group):
    models, _, _, jgrads, *_ = step
    _close_rel(_leaves(_tree(models, grads=True)[0][group]), _leaves(jgrads[group]), 1e-6,
               group)
    if group == "depth":  # the heads pre_disp never runs have no gradient
        assert all(p.grad is None for p in models.depth.dispconv_parameters())


def test_step_batch_stats_match_jax(step):
    models, *_, jstats, _, _ = step
    _close_rel(_leaves(_tree(models)[1]), _leaves(jstats), 1e-6, "batch_stats")


def test_step_adam_matches_optax(step):
    """The port's gradients of the recurrent block (h0 included) through both
    optimizers at the GRU trainer's constant rate (``gru_lr_decay`` off);
    tests/test_torch_mono_step.py holds the other modules' Adam."""
    models, *_, params, stats = step
    with jax.enable_x64(True):
        jstate = JaxTrainState.create(params["gru"], {}, create_optimizer(1e-4, 0, 4))
        want = _leaves(jax.jit(lambda st, g: st.apply_gradients(g))(
            jstate, _tree(models, grads=True)[0]["gru"]).params)
    port = copy.deepcopy(models.gru)
    for p, src in zip(port.parameters(), models.gru.parameters()):
        p.grad = src.grad.clone()
    TrainState(port.parameters(), 1e-4, 0, 4).apply_gradients()
    got = _leaves(convert_gru_blocks({k: _np(v) for k, v in port.state_dict().items()}))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert w.dtype == np.float64, k
        np.testing.assert_allclose(got[k], w, atol=1e-16, rtol=1e-12, err_msg=k)


# ------------------------------------------------------ the freeze, entry point


def test_h0_freeze_is_exact_and_leaves_the_rest_alone():
    """From the freeze on, h0 stays bit-identical while the other parameters
    and their Adam moments follow exactly the run without a freeze."""
    models = steps_gru.build_gru_models(_opts(), "cpu", torch.Generator().manual_seed(1))
    frozen, free = copy.deepcopy(models), copy.deepcopy(models)
    states = [TrainState(m.parameters(), 1e-4, 0, 4) for m in (frozen, free)]
    g = torch.Generator().manual_seed(2)
    grads = [[torch.randn(p.shape, generator=g) for p in models.parameters()] for _ in range(3)]
    for step_i, gs in enumerate(grads):
        if step_i == 1:
            states[0].freeze(frozen.h0_parameters())
            h0 = [p.detach().clone() for p in frozen.h0_parameters()]
        for m, st in zip((frozen, free), states):
            for p, gr in zip(m.parameters(), gs):
                p.grad = gr.clone()
            st.apply_gradients()
    assert all(torch.equal(a, b) for a, b in zip(frozen.h0_parameters(), h0))
    assert not any(torch.equal(a, b) for a, b in zip(free.h0_parameters(), h0))
    h0_ids = {id(p) for p in frozen.h0_parameters()}
    for (pa, pb) in zip(frozen.parameters(), free.parameters()):
        if id(pa) in h0_ids:
            continue
        assert torch.equal(pa, pb)
        sa, sb = states[0].optimizer.state[pa], states[1].optimizer.state[pb]
        assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq", "step"))


def _argv(*extra):
    return ["--gru_version", "v10", "--synthetic_data", "--height", str(H), "--width", str(W),
            "--batch_size", "1", "--len_sequence", "2", "--num_epochs", "1",
            "--save_frequency", "2", "--num_workers", "1", "--log_frequency", "2",
            "--compute_dtype", "float32", "--no_cuda", *extra]


def test_entry_point_trains_an_epoch_on_the_cpu(capsys):
    """scripts/train_gru on the CPU: one synthetic epoch (4 steps), finite
    losses and val() lines, every parameter the step trains moved, and no
    kernel launch."""
    counters = (conv3x3, conv3x3_dx, conv3x3_dw, warp_family_fwd, warp_family_bwd,
                photometric_fwd, photometric_bwd)
    before = [fn.launches for fn in counters]
    tr = train_gru.build_trainer(train_gru.MonodepthOptions().parse(_argv()))
    assert tr.device == torch.device("cpu") and tr.opt.frame_ids == [0, -1, 1]
    start = [p.detach().clone() for p in tr.models.parameters()]
    tr.train()
    out = capsys.readouterr().out
    assert tr.step == 4 and tr.state.step == 4
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2 and all(np.isfinite(float(ln.split("loss:")[1].split("|")[0]))
                                   for ln in lines)
    vals = [ln for ln in out.splitlines() if ln.startswith("val ")]
    assert len(vals) == 2 and all(np.isfinite(float(v.split()[2])) for v in vals)
    assert not any(torch.equal(a, b) for a, b in zip(start, tr.models.parameters()))
    assert [fn.launches for fn in counters] == before


def test_trainer_freezes_h0_from_h_s_epoch():
    tr = train_gru.build_trainer(train_gru.MonodepthOptions().parse(_argv("--h_s_epoch", "0")))
    h0 = [p.detach().clone() for p in tr.models.h0_parameters()]
    enc = [p.detach().clone() for p in tr.models.encoder.parameters()]
    tr.train()
    assert all(torch.equal(a, b) for a, b in zip(tr.models.h0_parameters(), h0))
    assert not any(torch.equal(a, b) for a, b in zip(tr.models.encoder.parameters(), enc))


def test_gru_trainer_overrides_and_refusals(capsys, kitti_tree, monkeypatch):  # noqa: F811
    opt = train_gru.MonodepthOptions().parse(_argv("--fuse", "0", "--frame_ids", "0", "1"))
    tr = train_gru.build_trainer(opt)
    assert "overridden" in capsys.readouterr().out
    assert tr.opt.fuse == 1 and tr.opt.frame_ids == [0, -1, 1]
    assert tr.state.lr == 1e-4 and tr.state.scheduler_step_size == 0  # constant rate
    with pytest.raises(ValueError, match="use_stereo"):
        train_gru.build_trainer(train_gru.MonodepthOptions().parse(_argv("--use_stereo")))
    # every version builds a trainer, with a Head where the version has one
    for version, head in (("v8", False), ("v7", True), ("v5", False)):
        tr = train_gru.build_trainer(
            train_gru.MonodepthOptions().parse(_argv("--gru_version", version)))
        assert tr.models.gru.version == version and (tr.models.head is not None) == head
    # without --synthetic_data the trainer reads --data_path's scenes
    monkeypatch.setenv("SSDE_SPLITS_DIR", kitti_tree["splits"])
    tr = train_gru.build_trainer(train_gru.MonodepthOptions().parse(
        [a for a in _argv() if a != "--synthetic_data"] + ["--data_path", kitti_tree["data"]]))
    assert isinstance(tr.train_dataset, KITTISeqDataset) and len(tr.train_loader) == 3


def test_trainers_need_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    """No silent fallback: without a card, a trainer that was not asked for
    the CPU raises; the builders default to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv() if a != "--no_cuda"]
    with pytest.raises(RuntimeError, match="no_cuda"):
        train_gru.build_trainer(train_gru.MonodepthOptions().parse(argv))
    with pytest.raises(RuntimeError, match="no_cuda"):
        trainer.Trainer(Options(model="monodepth2", synthetic_data=True, height=32, width=64,
                                batch_size=2, num_workers=1))
    assert train_gru.build_trainer(train_gru.MonodepthOptions().parse(argv),
                                   "cpu").device.type == "cpu"
    for build in (steps_gru.build_gru_models, steps.build_mono_models):
        assert inspect.signature(build).parameters["device"].default == "cuda"
