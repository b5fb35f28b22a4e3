"""The fusion trainers of the port on the CPU, at 32x64, B=2 (the port
alone; tests/test_torch_fusion_step.py holds the loss and its gradients to
the JAX package).

* Each trainer through its entry point's ``build_trainer``
  (``train_fusion``: the pyramid; ``train_fusion_v3`` with and without
  ``--disable_attention``) or its class (``FusionScaleLoopTrainer``, which
  no script reaches): the forced ``frame_ids``, the frames the data carry,
  and one step on synthetic data with finite losses after which every
  module has moved and every parameter with a gradient has moved. The
  seeded weights give negative disparities for v3 and the scale loop (no
  variant ends in a sigmoid); the loss stays finite at these seeds, which
  the test asserts.
* ``train_fusion_v3.main()`` for an epoch: ``weights_0/`` holds
  ``fusion.pth``; a trainer resumed from it with no ``--models_to_load``
  restores every module, ``fusion`` included, and Adam bit for bit, while
  ``--models_to_load encoder depth`` leaves the fusion module at its seeded
  init.
* ``FusionV3Trainer`` reads the split's ``train_files_seq.txt`` where it
  exists, else ``train_files.txt`` (a split list under ``SSDE_SPLITS_DIR``
  in a temporary directory, on the miniature raw tree of
  tests/test_kitti_tree.py); ``FusionTrainer`` reads ``train_files.txt``.
* ``train_dpt --model rn_fusion`` builds ``FusionV3Trainer``, and the
  other models their trainers (``AttentionTrainer``, ``DPTTrainer``).
* The pyramid trains no ``dispconv_*`` head; v3 trains them.
* Both scripts raise without a card unless ``--no_cuda``.
"""

import os

import numpy as np
import pytest
import torch

from ssde_tpu_torch.config import MonodepthOptions, Options
from ssde_tpu_torch.scripts import train_dpt, train_fusion, train_fusion_v3
from ssde_tpu_torch.train import steps_fusion
from ssde_tpu_torch.train.trainer import (AttentionTrainer, DPTTrainer, FusionScaleLoopTrainer,
                                          FusionTrainer, FusionV3Trainer, device_batch)
from test_kitti_tree import SCENE, kitti_tree  # noqa: F401

H, W, B = 32, 64, 2
# (trainer class, how to build it from argv, the fusion variant, extra arguments)
RUNS = {"pyramid": (FusionTrainer, train_fusion.build_trainer, "pyramid", []),
        "v3": (FusionV3Trainer, train_fusion_v3.build_trainer, "v3", []),
        "v3_no_attention": (FusionV3Trainer, train_fusion_v3.build_trainer, "v3",
                            ["--disable_attention"]),
        "scale_loop": (FusionScaleLoopTrainer, FusionScaleLoopTrainer, "scale_loop", [])}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The small-size runs here take one torch thread (see
    tests/test_torch_mono_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(log_dir, *extra):
    return ["--synthetic_data", "--height", str(H), "--width", str(W), "--batch_size", str(B),
            "--num_epochs", "1", "--num_workers", "1", "--mono_pretrained", "0",
            "--compute_dtype", "float32", "--no_cuda", "--log_dir", str(log_dir), *extra]


def _build(run, log_dir, *extra):
    _, build, _, run_extra = RUNS[run]
    return build(MonodepthOptions().parse(_argv(log_dir, *run_extra, *extra)))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_each_trainer_takes_a_step(run, tmp_path):
    cls, _, variant, extra = RUNS[run]
    trainer = _build(run, tmp_path)
    assert type(trainer) is cls and trainer.models.variant == variant
    assert trainer.opt.frame_ids == [0, -2, -1, 1]
    assert trainer._frame_idxs() == [0, -1, -2, 1]
    host = next(iter(trainer.train_loader))
    assert {f"color/{i}" for i in (0, -1, -2, 1)} <= host.keys()
    units = {type(m).__name__ for m in trainer.models.fusion.modules()}
    assert ("ResidualAttentionUnit" in units) == ("--disable_attention" not in extra)
    models = trainer.models
    before = [[p.detach().clone() for p in m.parameters()] for m in models.modules()]
    losses = trainer.step_fn(models, trainer.state, device_batch(host, "cpu"),
                             torch.Generator().manual_seed(0))
    assert set(losses) == {"loss"} | {f"loss/{s}" for s in range(4)}
    assert all(np.isfinite(float(v)) for v in losses.values())
    trained = {id(p) for p in models.parameters()}
    for m, old in zip(models.modules(), before):
        moved = [not torch.equal(a, p) for a, p in zip(old, m.parameters())]
        assert any(moved), type(m).__name__
        for (name, p), mv in zip(m.named_parameters(), moved):
            # Adam moves a parameter by about the learning rate wherever its
            # gradient is well above Adam's eps, and not at all where none
            # reached it (an attention conv's key bias has a true gradient
            # of 0 and a rounding-sized one: either may happen)
            g = p.grad.abs().max().item() if id(p) in trained and p.grad is not None else 0.0
            assert mv if g > 1e-6 else (g > 0 or not mv), (type(m).__name__, name, g)
    assert trainer.state.step == 1


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The v3 trainer after one epoch through ``train_fusion_v3.main()``,
    and its weights_0 folder."""
    log_dir = tmp_path_factory.mktemp("fusion_log")
    trainer = train_fusion_v3.main(_argv(log_dir, "--model_name", "fusion"))
    return trainer, log_dir / "fusion" / "models" / "weights_0"


def _module_state(trainer, name):
    return {k: v.detach().clone() for k, v in getattr(trainer.models, name).state_dict().items()}


def _assert_identical(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_weights_0_holds_fusion_pth(trained):
    trainer, folder = trained
    assert trainer.step == len(trainer.train_loader) > 0
    assert sorted(os.listdir(folder)) == ["adam.pth", "depth.pth", "encoder.pth", "fusion.pth",
                                          "pose.pth", "pose_encoder.pth"]
    _assert_identical(torch.load(folder / "fusion.pth", weights_only=True),
                      _module_state(trainer, "fusion"))


def test_resume_restores_fusion_pth(trained, tmp_path):
    trainer, folder = trained
    assert "fusion" not in Options().models_to_load  # the default does not name it
    reloaded = _build("v3", tmp_path, "--load_weights_folder", str(folder))
    for name in ("encoder", "depth", "fusion", "pose_encoder", "pose"):
        _assert_identical(_module_state(reloaded, name), _module_state(trainer, name))
    assert reloaded.state.step == trainer.state.step > 0
    for a, b in zip(trainer.state.optimizer.state.values(),
                    reloaded.state.optimizer.state.values()):
        _assert_identical(a, b)


def test_an_explicit_models_to_load_leaves_fusion_alone(trained, tmp_path):
    trainer, folder = trained
    fresh = _build("v3", tmp_path)
    part = _build("v3", tmp_path, "--load_weights_folder", str(folder),
                  "--models_to_load", "encoder", "depth")
    _assert_identical(_module_state(part, "fusion"), _module_state(fresh, "fusion"))
    assert not torch.equal(_module_state(fresh, "fusion")["fusion_block_1.conv3x3.conv.weight"],
                           _module_state(trainer, "fusion")["fusion_block_1.conv3x3.conv.weight"])
    for name in ("encoder", "depth"):
        _assert_identical(_module_state(part, name), _module_state(trainer, name))
    _assert_identical(_module_state(part, "pose"), _module_state(fresh, "pose"))


@pytest.mark.parametrize("cls,seq", [(FusionV3Trainer, True), (FusionV3Trainer, False),
                                     (FusionTrainer, True)])
def test_train_files(kitti_tree, tmp_path, monkeypatch, cls, seq):  # noqa: F811
    split = tmp_path / "splits" / "eigen_zhou"
    split.mkdir(parents=True)
    plain = [f"{SCENE} {i} l" for i in range(2, 6)]
    (split / "train_files.txt").write_text("\n".join(plain) + "\n")
    (split / "val_files.txt").write_text(f"{SCENE} 3 l\n")
    if seq:
        (split / "train_files_seq.txt").write_text(f"{SCENE} 3 l\n{SCENE} 4 r\n")
    monkeypatch.setenv("SSDE_SPLITS_DIR", str(tmp_path / "splits"))
    opts = MonodepthOptions().parse(
        ["--data_path", kitti_tree["data"], "--height", str(H), "--width", str(W),
         "--no_cuda", "--log_dir", str(tmp_path / "log"), "--mono_pretrained", "0"])
    trainer = cls(opts)
    want = [f"{SCENE} 3 l", f"{SCENE} 4 r"] if seq and cls is FusionV3Trainer else plain
    assert trainer.train_dataset.filenames == want
    assert trainer.val_dataset.filenames == [f"{SCENE} 3 l"]


@pytest.mark.parametrize("model", ["rn_fusion", "rn_encoder_with_attention", "dpt_gru"])
def test_train_dpt_models(model, tmp_path):
    opts = MonodepthOptions().parse(_argv(tmp_path, "--model", model))
    want = {"rn_fusion": FusionV3Trainer, "rn_encoder_with_attention": AttentionTrainer,
            "dpt_gru": DPTTrainer}[model]
    assert type(train_dpt.build_trainer(opts)) is want


@pytest.mark.parametrize("variant", ["pyramid", "v3"])
def test_the_pyramid_trains_no_dispconv_head(variant):
    models = steps_fusion.build_fusion_models(Options(height=H, width=W), variant, "cpu")
    trained = {id(p) for p in models.parameters()}
    heads = {id(p) for p in models.depth.dispconv_parameters()}
    assert len(heads) == 8  # a conv's weight and bias at each of 4 scales
    assert all((h in trained) == (variant == "v3") for h in heads)
    assert all(id(p) in trained for m in models.modules() for p in m.parameters()
               if id(p) not in heads)


@pytest.mark.parametrize("script", [train_fusion, train_fusion_v3])
def test_the_scripts_need_a_card_unless_no_cuda(script, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a != "--no_cuda"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        script.main(argv)
    assert script.build_trainer(MonodepthOptions().parse(argv + ["--no_cuda"])).device.type == \
        "cpu"
