"""The mono train step of the port against the JAX package's, end to end.

One step in float32 with ``rng=None`` (no automask noise), on the same
converted weights and the same host batch, jitter on: the port's
``preprocess_train`` + ``mono_loss_fn`` + backward against JAX
``preprocess_batch`` + ``mono_loss_fn`` + ``jax.grad``.

The shape is 64x128, B=2. At 32x64 the encoder's last feature map is one
pixel high, and the JAX package's border-corrected reflect conv
(``ssde_tpu/models/common.py`` ``conv3x3_reflect_same``) gets the gradient
of such an input wrong (its own finite differences disagree with its
``jax.grad``; ``ROADMAP.md`` Queue 3), so the comparison would measure that.
The frames are per-pixel noise from a numpy seed: on the synthetic data's
flat 8x8 blocks a warped frame can equal its source bit for bit, the
identity and reprojection errors then tie exactly, and which of them the
minimum's gradient reaches depends on rounding. flax runs its two-pass
batch variance (see tests/test_torch_pose.py).

Bounds: the loss and each ``loss/{s}`` 1e-5 relative; the new
``batch_stats`` 1e-6; every gradient 3e-3 relative to its tensor's max.
That is float32's own error in this step, not a port difference: the
port's float32 gradients differ from its own float64 run of the same step
by up to 1.2e-3 (encoder), 4.1e-4 (depth decoder), 2.2e-4 (pose encoder)
and 1.3e-4 (pose decoder), and from JAX's by the same amounts; the
encoder's gradient passes BatchNorm's backward, which cancels most of what
reaches it. Adam is held on its own: both optimizers take the same
gradients and must leave the same parameters to two float32 ulps.
"""

import copy
import functools
import json
import os

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ssde_tpu.checkpoint import (convert_depth_decoder, convert_pose_decoder,
                                 convert_resnet_encoder)
from ssde_tpu.config import Options
from ssde_tpu.data.transforms import preprocess_batch as jax_preprocess
from ssde_tpu.train.state import TrainState as JaxTrainState
from ssde_tpu.train.state import create_optimizer
from ssde_tpu.train.steps import build_mono_models as jax_build_mono_models
from ssde_tpu.train.steps import mono_loss_fn as jax_mono_loss_fn
from ssde_tpu_torch.data.pipeline import to_device
from ssde_tpu_torch.data.synthetic import make_synthetic_batch
from ssde_tpu_torch.ops.photometric import photometric_bwd, photometric_fwd
from ssde_tpu_torch.ops.warp_banded import warp_family_bwd, warp_family_fwd
from ssde_tpu_torch.scripts import train_dpt
from ssde_tpu_torch.train.state import TrainState, lr_at
from ssde_tpu_torch.train.steps import (build_mono_models, mono_loss_fn,
                                        preprocess_train)

H, W, B = 64, 128, 2
GROUPS = ("encoder", "depth", "pose_encoder", "pose")


def _opts(**kw):
    return Options(height=H, width=W, batch_size=B, compute_dtype="float32", **kw)


def _np(t):
    return t.detach().numpy().copy()


def _tree(models, grads=False):
    """(params, batch_stats) of the port's modules as flax trees."""
    get = (lambda m: {k: _np(p.grad) for k, p in m.named_parameters()}) if grads else \
        (lambda m: {k: _np(v) for k, v in m.state_dict().items()})
    enc_p, enc_s, _ = convert_resnet_encoder(get(models.encoder))
    pe_p, pe_s, _ = convert_resnet_encoder(get(models.pose_encoder))
    params = {"encoder": enc_p, "depth": convert_depth_decoder(get(models.depth)),
              "pose_encoder": pe_p, "pose": convert_pose_decoder(get(models.pose))}
    return params, {"encoder": enc_s, "pose_encoder": pe_s}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


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


@pytest.fixture(scope="module")
def step():
    """One step on both sides: (port models after the forward/backward,
    port losses, JAX loss, JAX losses, JAX grads, JAX new batch_stats,
    the starting params and stats)."""
    models = build_mono_models(_opts(), "cpu", torch.Generator().manual_seed(0))
    params, stats = _tree(models)
    batch = make_synthetic_batch(B, H, W, seed=0)
    rng = np.random.RandomState(5)
    for i in (0, -1, 1):
        batch[f"color/{i}"] = rng.rand(B, H, W, 3).astype(np.float32)
    batch["jitter"] = np.array([[1.1, 0.9, 1.15, 0.05], [0.85, 1.1, 0.9, -0.07]], np.float32)

    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "BatchNorm",
               functools.partial(flax.linen.BatchNorm, use_fast_variance=False))
    try:
        jm = jax_build_mono_models(_opts())
        inputs = jax_preprocess({k: jnp.asarray(v) for k, v in batch.items()}, H, W, 4,
                                [0, -1, 1], is_train=True, pyramid_frames=[0],
                                aug_num_scales=1)
        fn = jax.jit(jax.value_and_grad(
            lambda p: jax_mono_loss_fn(jm, p, stats, inputs, None, True), has_aux=True))
        (jloss, (jstats, jlosses, _)), jgrads = fn(params)
    finally:
        mp.undo()

    models.train()
    loss, losses, _ = mono_loss_fn(models, preprocess_train(to_device(batch, "cpu"),
                                                            models.opts), None)
    loss.backward()
    return models, losses, jloss, jlosses, jgrads, jstats, params, stats


def test_losses_match_jax(step):
    _, losses, jloss, jlosses, *_ = step
    assert set(losses) == set(jlosses) == {"loss"} | {f"loss/{s}" for s in range(4)}
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    assert float(losses["loss"]) == pytest.approx(float(jloss), rel=1e-5)


@pytest.mark.parametrize("group", GROUPS)
def test_gradients_match_jax(step, group):
    models, _, _, _, jgrads, *_ = step
    got = _leaves(_tree(models, grads=True)[0][group])
    want = _leaves(jgrads[group])
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(got[k], w, atol=3e-3 * np.abs(w).max(), rtol=0,
                                   err_msg=f"{group}{k}")


def test_batch_stats_match_jax(step):
    models, _, _, _, _, jstats, _, _ = step
    got, want = _leaves(_tree(models)[1]), _leaves(jstats)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=1e-6, err_msg=k)


def test_adam_step_matches_optax(step):
    """The same gradients (the port's) through both optimizers, at a global
    step past the first StepLR boundary so the schedule is checked too."""
    models, *_, params, stats = step
    steps_per_epoch, start = 2, 31  # boundary 15 * 2 = 30: the rate is 1e-5
    tx = create_optimizer(1e-4, 15, steps_per_epoch)
    jstate = JaxTrainState.create(params, stats, tx)
    sched = lambda x: isinstance(x, optax.ScaleByScheduleState)  # noqa: E731
    jstate = jstate.replace(opt_state=jax.tree.map(
        lambda x: x._replace(count=jnp.asarray(start, jnp.int32)) if sched(x) else x,
        jstate.opt_state, is_leaf=sched))
    apply = jax.jit(lambda st, g: st.apply_gradients(g))
    want = _leaves(apply(jstate, _tree(models, grads=True)[0]).params)

    port = copy.deepcopy(models)
    for p, src in zip(port.parameters(), models.parameters()):
        p.grad = src.grad.clone()
    state = TrainState(port.parameters(), 1e-4, 15, steps_per_epoch)
    state.step = start
    assert state.lr == pytest.approx(1e-5)
    state.apply_gradients()
    assert state.step == start + 1
    got = _leaves(_tree(port)[0])
    assert got.keys() == want.keys()
    moved = 0.0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-10, rtol=2.5e-7, err_msg=k)
        moved = max(moved, float(np.abs(w - _leaves(params)[k]).max()))
    assert moved == pytest.approx(1e-5, rel=1e-2)  # Adam's first step: lr * sign(g)


def test_lr_schedule_is_keyed_on_the_global_step():
    assert [lr_at(s, 1e-4, 15, 4) for s in (0, 59, 60, 119, 120)] == pytest.approx(
        [1e-4, 1e-4, 1e-5, 1e-5, 1e-6])
    assert lr_at(10**6, 1e-4, 0, 4) == 1e-4


def test_trainer_epoch_through_the_entry_point(tmp_path, capsys):
    """The entry point trains one synthetic epoch (8 steps at B=2, 32x64,
    bfloat16 autocast on the CPU): finite losses, changed parameters, the
    val() loss line, and no kernel launch on the CPU."""
    before = (warp_family_fwd.launches, warp_family_bwd.launches, photometric_fwd.launches,
              photometric_bwd.launches)
    argv = ["--model", "monodepth2", "--synthetic_data", "--height", "32", "--width", "64",
            "--batch_size", "2", "--num_epochs", "1", "--save_frequency", "2",
            "--log_frequency", "4", "--num_workers", "2", "--log_dir", str(tmp_path)]
    opts = train_dpt.MonodepthOptions().parse(argv)
    trainer = train_dpt.build_trainer(opts, "cpu")
    start = {k: v.clone() for k, v in trainer.models.encoder.state_dict().items()}
    trainer.train()
    out = capsys.readouterr().out
    assert trainer.step == 8 and trainer.state.step == 8
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2  # batches 0 and 4
    for ln in lines:
        assert np.isfinite(float(ln.split("loss:")[1].split("|")[0]))
    vals = [ln for ln in out.splitlines() if ln.startswith("val ")]
    assert len(vals) == 2 and all(np.isfinite(float(v.split()[2])) for v in vals)
    after = trainer.models.encoder.state_dict()
    assert any(not torch.equal(start[k], after[k]) for k in start if k.endswith("weight"))
    assert trainer.models.encoder.encoder.bn1.num_batches_tracked.item() == 8
    assert (warp_family_fwd.launches, warp_family_bwd.launches, photometric_fwd.launches,
            photometric_bwd.launches) == before


def test_train_writes_weights_0(tmp_path):
    """At the default --save_frequency 1, train() ends its epoch with
    save_model(): weights_0/ holds the four modules, each the trainer's
    state, and adam.pth, beside models/opt.json."""
    opts = train_dpt.MonodepthOptions().parse(
        ["--model", "monodepth2", "--synthetic_data", "--height", "32", "--width", "64",
         "--batch_size", "2", "--num_epochs", "1", "--log_frequency", "8",
         "--num_workers", "1", "--log_dir", str(tmp_path)])
    trainer = train_dpt.build_trainer(opts, "cpu")
    trainer.train()
    folder = tmp_path / "mdp" / "models" / "weights_0"
    assert sorted(os.listdir(folder)) == ["adam.pth", "depth.pth", "encoder.pth", "pose.pth",
                                          "pose_encoder.pth"]
    assert (tmp_path / "mdp" / "models" / "opt.json").is_file()
    for name in ("encoder", "depth", "pose_encoder", "pose"):
        sd = torch.load(folder / f"{name}.pth", weights_only=True)
        for k, v in getattr(trainer.models, name).state_dict().items():
            assert torch.equal(sd[k], v), (name, k)
    adam = torch.load(folder / "adam.pth", weights_only=True)
    assert {int(s["step"]) for s in adam["state"].values()} == {8}


@pytest.mark.parametrize("model", ["rn_encoder_with_attention", "rn_fusion", "dpt_gru"])
def test_other_models_are_not_ported(model, tmp_path):
    """train_dpt's other models, all ported since: each builds its trainer,
    none raises NotImplementedError."""
    opts = Options(model=model, synthetic_data=True, height=32, width=64, batch_size=2,
                   log_dir=str(tmp_path))
    want = {"rn_encoder_with_attention": "AttentionTrainer", "rn_fusion": "FusionV3Trainer",
            "dpt_gru": "DPTTrainer"}[model]
    assert type(train_dpt.build_trainer(opts, "cpu")).__name__ == want


REFUSED = [("pose_model_type", "posecnn"), ("pose_model_type", "shared"),
           ("pose_model_input", "all"), ("predictive_mask", True), ("v1_multiscale", True)]


@pytest.mark.parametrize("trainer", ["dpt", "fusion", "gru"])
@pytest.mark.parametrize("flag,value", REFUSED)
def test_unported_options_raise(trainer, flag, value):
    """The options that a trainer's JAX step cannot run raise, naming the
    option and the trainer; the mono and attention trainers take all of
    them (tests/test_torch_mono_options.py)."""
    from ssde_tpu_torch.train.trainer import DPTTrainer, FusionV3Trainer
    from ssde_tpu_torch.train.trainer_gru import GRUTrainer

    cls = {"dpt": DPTTrainer, "fusion": FusionV3Trainer, "gru": GRUTrainer}[trainer]
    opts = _opts(**{flag: value}, disable_automasking=flag == "predictive_mask")
    with pytest.raises(NotImplementedError, match=f"--{flag}.*the {trainer} trainer"):
        cls.check_supported(opts)
    build_mono_models(opts, "cpu")


@pytest.mark.parametrize("trainer", ["dpt", "fusion", "gru"])
def test_trainers_take_the_loss_options(trainer):
    """--no_ssim and --avg_reprojection reach every trainer's loss, the
    shared compute_losses; --use_stereo the DPT and fusion trainers'."""
    from ssde_tpu_torch.train.trainer import DPTTrainer, FusionV3Trainer
    from ssde_tpu_torch.train.trainer_gru import GRUTrainer

    cls = {"dpt": DPTTrainer, "fusion": FusionV3Trainer, "gru": GRUTrainer}[trainer]
    cls.check_supported(_opts(no_ssim=True, avg_reprojection=True))
    stereo = _opts(use_stereo=True)
    if trainer == "gru":
        with pytest.raises(NotImplementedError, match="--use_stereo: the gru trainer"):
            cls.check_supported(stereo)
    else:
        cls.check_supported(stereo)


def _synthetic_argv(tmp_path, *extra):
    return ["--model", "monodepth2", "--synthetic_data", "--height", "32", "--width", "64",
            "--batch_size", "2", "--num_epochs", "1", "--save_frequency", "2",
            "--log_frequency", "8", "--num_workers", "1", "--log_dir", str(tmp_path), *extra]


def test_profile_steps_writes_a_trace_of_its_window(tmp_path, capsys):
    """--profile_steps 2 traces steps 5 and 6 (the JAX trainer's window,
    5 .. 5+N) with torch.profiler into <log_dir>/<model_name>/profile/."""
    trainer = train_dpt.build_trainer(
        train_dpt.MonodepthOptions().parse(_synthetic_argv(tmp_path, "--profile_steps", "2")),
        "cpu")
    trainer.train()
    assert trainer.step == 8
    folder = tmp_path / "mdp" / "profile"
    assert os.listdir(folder) == ["steps_5-7.pt.trace.json"]
    with open(folder / "steps_5-7.pt.trace.json") as f:
        trace = json.load(f)
    # the window holds the two steps' operations, the backward's among them
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names) and any("Backward" in n for n in names)
    assert "profile of steps 5-7 written" in capsys.readouterr().out


def test_profile_window_left_open_is_closed_when_training_ends(tmp_path):
    """A window past the last step (5 .. 5+100 in 8 steps) is written when
    train() returns; the JAX trainer leaves its trace open."""
    trainer = train_dpt.build_trainer(
        train_dpt.MonodepthOptions().parse(_synthetic_argv(tmp_path, "--profile_steps", "100")),
        "cpu")
    trainer.train()
    assert os.listdir(tmp_path / "mdp" / "profile") == ["steps_5-105.pt.trace.json"]


@pytest.mark.parametrize("n", [2, 8])
def test_more_than_one_device_trains(tmp_path, n, capfd):
    """--no_cuda --num_devices 2 trains the epoch through train_dpt.main()
    over 2 gloo ranks; 8 with --batch_size 2 clamps to 2 by the JAX rule.
    The mesh is printed, each rank names itself, and rank 0 alone logs and
    writes weights_0/ (--save_frequency 1)."""
    argv = _synthetic_argv(tmp_path, "--no_cuda", "--num_devices", str(n), "--save_frequency",
                           "1")
    assert train_dpt.main(argv) is None  # the trainers live in the ranks
    out = capfd.readouterr().out
    assert "Training is using mesh: data=2 [cpu, cpu] over gloo" in out
    assert "Device: cpu, rank 0 of 2" in out and "Device: cpu, rank 1 of 2" in out
    assert out.count("Training model named") == 1 and out.count("saved model to") == 1
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(steps) == 1 and np.isfinite(float(steps[0].split("loss:")[1].split("|")[0]))
    assert sorted(os.listdir(tmp_path / "mdp" / "models")) == ["opt.json", "weights_0"]
    sd = torch.load(tmp_path / "mdp" / "models" / "weights_0" / "encoder.pth", weights_only=True)
    fresh = build_mono_models(Options(height=32, width=64, batch_size=2), "cpu",
                              torch.Generator().manual_seed(0)).encoder.state_dict()
    assert any(not torch.equal(sd[k], v) for k, v in fresh.items() if k.endswith("weight"))
    adam = torch.load(tmp_path / "mdp" / "models" / "weights_0" / "adam.pth", weights_only=True)
    assert {int(s["step"]) for s in adam["state"].values()} == {8}


def test_one_device_trains(tmp_path):
    """--num_devices 1 is one card (here the CPU): the epoch runs and no
    profile is written without --profile_steps."""
    trainer = train_dpt.build_trainer(train_dpt.MonodepthOptions().parse(
        _synthetic_argv(tmp_path, "--num_devices", "1")), "cpu")
    trainer.train()
    assert trainer.step == 8 and trainer.state.step == 8
    assert not (tmp_path / "mdp" / "profile").exists()
