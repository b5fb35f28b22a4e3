"""Resuming the port's trainers from the JAX package's native ``.ckpt``
folders, and the disparity served from them, against the JAX package.

The trees are ``tests/test_torch_ckpt_folder.py``'s (``jax.eval_shape`` of
the JAX trainer's init, filled with seeded float32 values), saved with the
JAX ``save_checkpoint`` and, for the trainers, an ``adam.ckpt`` of the JAX
``create_optimizer`` state with seeded moments at a count of COUNT:

- every trainer resumes from it: its modules, the moments of every
  parameter it trains (through the parameter's converter), Adam's step and
  the trainer's at the count, and the next update's rate the JAX
  schedule's; a layout that does not fit (a module missing, the raveled
  ``FusedAdamState``) warns and keeps fresh moments;
- ``test_simple`` takes its feed size from ``encoder.ckpt``;
- mono disparity (``make_mono_infer_fn`` against ``mono_infer``) and GRU v10
  streamed disparity (the JAX script's ``build_evaluator`` against the
  port's, both on the folder) agree at 1e-4, 64x96, float32;
- the port's ``save_checkpoint`` of ``flax_state`` reads back through the
  JAX ``load_checkpoint`` to equal trees.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssde_tpu.checkpoint as jax_ckpt
from ssde_tpu.config import Options as JaxOptions
from ssde_tpu.train import state as jax_state
from ssde_tpu.train import steps as jax_steps
from ssde_tpu.train import steps_gru as jax_steps_gru
from ssde_tpu_torch import checkpoint, logging_utils
from ssde_tpu_torch.config import Options
from ssde_tpu_torch.data.synthetic import scene_frames
from ssde_tpu_torch.scripts import evaluate_depth_gru_fusion, test_simple, train_dpt, train_gru
from ssde_tpu_torch.train import steps
from ssde_tpu_torch.train.state import TrainState
from ssde_tpu_torch.train.trainer import FusionTrainer
from test_torch_ckpt_folder import (FAMILIES, H, W, _assert_holds, _fill, _native,
                                    _port_bundle, _port_options, _want)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNT = 37  # Adam's count in the adam.ckpt files: past a few schedule boundaries


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_no_tensorboard():
    """One torch thread, as in tests/test_torch_mono_step.py (which says why),
    and the trainers' TensorBoard writers a no-op: importing tensorboard
    imports TensorFlow here, some 12 s, and nothing here reads the logs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logging_utils, "_summary_writer_cls", lambda: None)
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _remove_written_folders(tmp_path):
    """Each test's folders (the DPT's .ckpt alone is ~0.5 GB) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _adam_state(params, lr, step_size, steps_per_epoch, seed):
    """The JAX trainers' optimizer state (``create_optimizer``) for
    ``params``, its moments filled from ``seed`` (nu >= 0) and its counts at
    COUNT."""
    tx = jax_state.create_optimizer(lr, step_size, steps_per_epoch)
    head, (adam, sched), tail = jax.eval_shape(tx.init, params)
    mu, nu = _fill(adam.mu, seed), jax.tree.map(np.abs, _fill(adam.nu, seed + 1))
    count = jnp.asarray(COUNT, jnp.int32)
    return (head, (adam._replace(count=count, mu=mu, nu=nu), sched._replace(count=count)),
            tail)


def _trainer(label, folder, log):
    kind, _ = FAMILIES[label]
    opts = _port_options(label, synthetic_data=True, load_weights_folder=folder,
                         scheduler_step_size=1, log_dir=log)
    if kind == "gru":
        return train_gru.build_trainer(opts, "cpu")
    if kind == "pyramid":
        return FusionTrainer(opts, "cpu")
    opts.model = {"mono": "monodepth2", "attention": "rn_encoder_with_attention",
                  "v3": "rn_fusion", "dpt": "dpt"}[kind]
    return train_dpt.build_trainer(opts, "cpu")


@pytest.mark.parametrize("label", ["mono", "attention", "gru_v4", "fusion_pyramid",
                                   "fusion_v3"])
def test_trainer_resumes_with_adam_ckpt(label, tmp_path, capsys):
    _, params, stats = _native(label)
    folder = str(tmp_path / "weights")
    opt_state = _adam_state(params, 1e-4, 1, 8, seed=100)
    jax_ckpt.save_checkpoint(folder, params, stats, opt_state, height=H, width=W)
    trainer = _trainer(label, folder, str(tmp_path / "log"))
    out = capsys.readouterr().out
    assert f"Adam moments loaded from {folder}" in out and f"at step {COUNT}" in out
    models, optimizer = trainer.models, trainer.state.optimizer
    for name in params:
        module = getattr(models, name)
        _assert_holds(module, _want(name, module, params[name], stats.get(name, {})))
    adam = opt_state[1][0]
    trained = {id(p) for p in models.parameters()}
    checked = 0
    for name, module in checkpoint._bundle_modules(models):
        mu = _want(name, module, adam.mu[name], stats.get(name, {}))
        nu = _want(name, module, adam.nu[name], stats.get(name, {}))
        for key, p in module.named_parameters():
            if id(p) not in trained:
                continue
            s = optimizer.state[p]
            assert torch.equal(s["exp_avg"], mu[key]) and torch.equal(s["exp_avg_sq"], nu[key])
            assert float(s["step"]) == COUNT
            checked += 1
    assert checked == len(trained) == sum(len(g["params"]) for g in optimizer.param_groups)
    assert trainer.state.step == COUNT
    schedule = jax_state.make_lr_schedule(trainer.opt.learning_rate,
                                          trainer._scheduler_step_size(),
                                          trainer.state.steps_per_epoch)
    np.testing.assert_allclose(trainer.state.lr, float(schedule(COUNT)), rtol=1e-6)


def test_adam_ckpt_that_does_not_fit_keeps_fresh_moments(tmp_path, capsys):
    _, params, stats = _native("mono")
    opt_state = _adam_state(params, 1e-4, 1, 8, seed=100)
    head, (adam, sched), tail = opt_state
    no_pose = {k: v for k, v in adam.mu.items() if k != "pose"}
    fused = {"0": {}, "1": {"count": np.asarray(COUNT, np.int32),
                            "mu": np.zeros(10, np.float32), "nu": np.zeros(10, np.float32)}}
    for i, state in enumerate(((head, (adam._replace(mu=no_pose, nu=no_pose), sched), tail),
                               fused)):
        folder = str(tmp_path / f"weights{i}")
        jax_ckpt.save_checkpoint(folder, params, stats, state, height=H, width=W)
        with pytest.warns(UserWarning, match="adam.ckpt does not match the optimizer"):
            trainer = _trainer("mono", folder, str(tmp_path / "log"))
        assert "Adam moments not loaded" in capsys.readouterr().out
        assert trainer.state.step == 0 and not trainer.state.optimizer.state
        _assert_holds(trainer.models.pose, _want("pose", trainer.models.pose, params["pose"], {}))


def test_mono_disparity_from_a_native_folder(tmp_path):
    jm, params, stats = _native("mono")
    jax_ckpt.save_checkpoint(str(tmp_path), params, stats, height=H, width=W)
    models = _port_bundle("mono")
    checkpoint.load_eval_folder(str(tmp_path), models, ("encoder", "depth"))
    x = np.random.RandomState(3).rand(2, H, W, 3).astype(np.float32)
    want = np.asarray(jax_steps.make_mono_infer_fn(jm)(params, stats, jnp.asarray(x)))
    got = steps.mono_infer(models, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0, atol=1e-4)


def test_test_simple_takes_the_feed_size_from_encoder_ckpt(tmp_path):
    from PIL import Image

    _, params, stats = _native("mono")
    folder = tmp_path / "weights"
    jax_ckpt.save_checkpoint(str(folder), params, stats, height=H, width=W)
    images = tmp_path / "images"
    images.mkdir()
    rs = np.random.RandomState(4)
    Image.fromarray((rs.rand(75, 250, 3) * 255).astype(np.uint8)).save(images / "0.jpg")
    test_simple.main(["--image_path", str(images), "--model_path", str(folder), "--no_cuda",
                      "--no_colormap"])
    disp = np.load(images / "0_disp.npy")
    assert disp.shape == (1, H, W, 1) and np.isfinite(disp).all()  # not 192x640


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gru_v10_streams_from_a_native_folder(tmp_path, monkeypatch):
    """The JAX script's evaluator and the port's on one ``.ckpt`` folder.
    The JAX script runs ``init_gru_params`` eagerly (minutes here) and then
    replaces each module's entry whole with the folder's, so it gets a
    placeholder (None) for each; one left in place would fail loudly."""
    _, params, stats = _native("gru_v10")
    jax_ckpt.save_checkpoint(str(tmp_path), params, stats, height=H, width=W)
    monkeypatch.setattr(jax_steps_gru, "init_gru_params", lambda models, rng, batch: (
        {n: None for n in params}, {n: None for n in stats}))
    jopts = JaxOptions(height=H, width=W, gru_version="v10", load_weights_folder=str(tmp_path))
    frames = scene_frames(H, W, 3)
    want = _jax_script("evaluate_depth_gru_fusion").build_evaluator(jopts).predict_scene(
        [jnp.asarray(f) for f in frames])
    opts = Options(height=H, width=W, gru_version="v10", load_weights_folder=str(tmp_path))
    got = evaluate_depth_gru_fusion.build_evaluator(opts, "cpu", seed=1).predict_scene(frames)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=1e-4)


def test_port_writes_what_the_jax_package_reads(tmp_path):
    """``flax_state`` of a trained-looking bundle through the port's
    ``save_checkpoint``; the JAX ``load_checkpoint`` (with the JAX init's
    trees as templates, whose structure it enforces) reads equal trees."""
    _, params, stats = _native("mono")
    models = _port_bundle("mono")
    state = TrainState(models.parameters())
    for p in models.parameters():
        p.grad = torch.full_like(p, 0.5)
    state.apply_gradients()
    mine = checkpoint.flax_state(models, state.optimizer, state.step)
    checkpoint.save_checkpoint(str(tmp_path), *mine, height=H, width=W, use_stereo=True)
    template = jax.eval_shape(jax_state.create_optimizer(1e-4, 15, 8).init, params)
    got_p, got_s, got_opt, meta = jax_ckpt.load_checkpoint(str(tmp_path), params, stats,
                                                           opt_state=template)
    assert meta == {"height": H, "width": W, "use_stereo": True}
    want_opt = (mine[2]["0"], (mine[2]["1"]["0"], mine[2]["1"]["1"]), mine[2]["2"])
    for got, want in ((got_p, mine[0]), (got_s, mine[1]), (got_opt, want_opt)):
        got_l, got_def = jax.tree_util.tree_flatten(got)
        want_l, _ = jax.tree_util.tree_flatten(want)
        assert len(got_l) == len(want_l) > 0
        for a, b in zip(got_l, want_l):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(got_opt[1][0].count) == 1 and np.asarray(got_opt[1][0].mu["depth"][
        "dispconv_0"]["conv"]["bias"]).any()
    # and the port reads its own folder back to the same modules
    again = _port_bundle("mono")
    checkpoint.load_eval_folder(str(tmp_path), again, list(params))
    for a, b in zip(models.modules(), again.modules()):
        for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert k.endswith("num_batches_tracked") or torch.equal(x, y), k
