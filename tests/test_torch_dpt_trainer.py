"""``train_dpt`` with no ``--model`` (the DPT-hybrid, ``dpt_gru``) and with
``--model rn_encoder_with_attention``, on the CPU.

* ``train_dpt.main()`` on synthetic data at 64x128, B=2, bf16 autocast
  (the default): an epoch of 8 steps and its two ``val()``; finite losses;
  every module moved; the DPT trainer's frames [0, -1, 1] at scale 0.
* ``weights_0/``: ``dpt.pth`` beside the pose modules, or an ``encoder.pth``
  that holds ``atten1`` .. ``atten4``; each file the trainer's state.
* A trainer built on ``weights_0/`` with the default ``--models_to_load``
  (which does not name ``dpt``) is bit-identical to the saved one, Adam's
  moments and step count included; ``--models_to_load pose_encoder pose``
  leaves the depth network at its seeded init.
* ``--mono_pretrained`` from a Monodepth2 folder (``models/mono_640x192``
  under a temporary working directory): the DPT trainer loads the pose
  modules and keeps its DPT; the attention trainer loads the ResNet part of
  ``encoder.pth``, the decoder and the pose modules, and keeps its
  attention convs at their init.

A DPT folder is 1.5 GB (the model's 118 M parameters and Adam's two
moments), so each run's log directory is removed when its tests end.
"""

import ctypes
import gc
import os
import shutil

import numpy as np
import pytest
import torch

from ssde_tpu_torch import checkpoint
from ssde_tpu_torch.config import MonodepthOptions, Options
from ssde_tpu_torch.scripts import train_dpt
from ssde_tpu_torch.train.steps import build_mono_models
from ssde_tpu_torch.train.trainer import AttentionTrainer, DPTTrainer, TrainerBase

H, W, B = 64, 128, 2
# label: (extra arguments, trainer class, the depth network's modules)
RUNS = {"dpt": ([], DPTTrainer, ("dpt",)),
        "attention": (["--model", "rn_encoder_with_attention"], AttentionTrainer,
                      ("encoder", "depth"))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_mono_step.py (which says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _return_memory():
    """After the module (and so after ``trained``'s last teardown), hand the
    freed heap back to the system: a parallel run keeps this worker's
    process for the files that follow, and this file's trainers take up to
    5.5 GB."""
    yield
    gc.collect()
    ctypes.CDLL(None).malloc_trim(0)


def _argv(log_dir, label, *extra):
    return ["--synthetic_data", "--height", str(H), "--width", str(W), "--batch_size", str(B),
            "--num_epochs", "1", "--num_workers", "1", "--log_frequency", "4", "--no_cuda",
            "--log_dir", str(log_dir), *RUNS[label][0], *extra]


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _assert_identical(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("label", sorted(RUNS))
def test_mono_pretrained(label, tmp_path, monkeypatch, capsys):
    """A Monodepth2 folder at models/mono_640x192 (seed-1 mono modules).

    Defined before ``trained`` so that it runs before that fixture's first
    instance: the fixture holds a trained DPT trainer (118 M parameters with
    Adam's moments) and its 1.5 GB weights_0 until the module ends, and
    these trainers and writes would otherwise come on top of both."""
    mono = build_mono_models(Options(height=H, width=W), "cpu", torch.Generator().manual_seed(1))
    checkpoint.save_folder(str(tmp_path / "models" / "mono_640x192"), mono, height=H, width=W)
    monkeypatch.chdir(tmp_path)
    fresh = train_dpt.build_trainer(MonodepthOptions().parse(
        _argv(tmp_path / "log", label, "--mono_pretrained", "0")))
    warm = train_dpt.build_trainer(MonodepthOptions().parse(_argv(tmp_path / "log", label)))
    out = capsys.readouterr().out
    assert warm.opt.mono_pretrained == 1
    for name in ("pose_encoder", "pose"):
        _assert_identical(_state(getattr(warm.models, name)), _state(getattr(mono, name)))
    if label == "dpt":
        assert "---> Load monodepth2 weights: ['pose_encoder', 'pose']" in out
        _assert_identical(_state(warm.models.dpt), _state(fresh.models.dpt))
        return
    assert "atten1..4 left at their init" in out
    _assert_identical(_state(warm.models.depth), _state(mono.depth))
    got, init = _state(warm.models.encoder), _state(fresh.models.encoder)
    resnet = _state(mono.encoder)
    for k, v in got.items():
        assert torch.equal(v, init[k] if k.startswith("atten") else resnet[k]), k
    assert sum(k.startswith("atten") for k in got) == 4 * 5  # 3 convs and 2 tables each


@pytest.fixture(scope="module", params=sorted(RUNS))
def trained(request, tmp_path_factory):
    """(label, trainer, weights_0, losses of each step, val() results, the
    modules' state before training) of ``train_dpt.main()``."""
    label = request.param
    log = tmp_path_factory.mktemp(f"log_{label}")
    cls = RUNS[label][1]
    record = {"history": [], "vals": [], "start": None}
    run_epoch, val, train = TrainerBase.run_epoch, TrainerBase.val, TrainerBase.train

    def observed_train(trainer):
        record["start"] = {n: _state(getattr(trainer.models, n)) for n in _names(trainer)}
        return train(trainer)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TrainerBase, "train", observed_train)
        mp.setattr(TrainerBase, "run_epoch",
                   lambda t: record["history"].extend(run_epoch(t)) or record["history"])
        mp.setattr(TrainerBase, "val", lambda t: record["vals"].append(val(t)) or
                   record["vals"][-1])
        trainer = train_dpt.main(_argv(log, label, "--mono_pretrained", "0"))
    assert type(trainer) is cls
    yield label, trainer, log / "mdp" / "models" / "weights_0", record
    del trainer
    gc.collect()
    shutil.rmtree(log, ignore_errors=True)


def _names(trainer):
    return [n for n in checkpoint.MODULE_NAMES if getattr(trainer.models, n, None) is not None]


def test_an_epoch_and_its_val(trained):
    label, trainer, _, record = trained
    assert trainer.step == 8 and trainer.state.step == 8
    losses = [{k: float(v) for k, v in h.items()} for h in record["history"]]
    assert len(losses) == 8 and all(np.isfinite(v) for h in losses for v in h.values())
    assert len(record["vals"]) == 2  # at steps 0 and 4
    assert all(np.isfinite(v) for d in record["vals"] for v in d.values())
    if label == "dpt":
        assert trainer.opt.frame_ids == [0, -1, 1] and trainer.opt.scales == [0]
        assert set(losses[0]) == {"loss", "loss/0"} and set(record["vals"][0]) == {"loss",
                                                                                  "loss/0"}
    else:
        assert set(losses[0]) == {"loss"} | {f"loss/{s}" for s in range(4)}
    for name in _names(trainer):  # every module moved
        after = _state(getattr(trainer.models, name))
        assert any(not torch.equal(v, after[k]) for k, v in record["start"][name].items()), name


def test_weights_0(trained):
    label, trainer, folder, _ = trained
    modules = RUNS[label][2]
    assert sorted(os.listdir(folder)) == sorted(
        ["adam.pth", "pose.pth", "pose_encoder.pth"] + [f"{m}.pth" for m in modules])
    for name in modules + ("pose_encoder", "pose"):
        sd, _ = checkpoint.read_module(str(folder / f"{name}.pth"))
        _assert_identical(sd, _state(getattr(trainer.models, name)))
    if label == "attention":
        keys = torch.load(folder / "encoder.pth", weights_only=True)
        assert {k.split(".")[0] for k in keys} == {"encoder", "atten1", "atten2", "atten3",
                                                   "atten4", "height", "width", "use_stereo"}


def test_resume_restores_every_module(trained, tmp_path):
    """The default --models_to_load does not name dpt; the resumed DPT
    trainer loads dpt.pth all the same."""
    label, trainer, folder, _ = trained
    assert "dpt" not in Options().models_to_load
    reloaded = train_dpt.build_trainer(MonodepthOptions().parse(
        _argv(tmp_path, label, "--load_weights_folder", str(folder))))
    for name in _names(trainer):
        _assert_identical(_state(getattr(reloaded.models, name)),
                          _state(getattr(trainer.models, name)))
    assert reloaded.state.step == trainer.state.step == 8
    for a, b in zip(trainer.state.optimizer.state.values(),
                    reloaded.state.optimizer.state.values()):
        _assert_identical(a, b)


def test_models_to_load_pose_only_leaves_the_depth_network(trained, tmp_path):
    """The depth network stays at its seeded init: the state the trained
    run started from (no second fresh trainer of 118 M parameters)."""
    label, trainer, folder, record = trained
    part = train_dpt.build_trainer(MonodepthOptions().parse(
        _argv(tmp_path, label, "--load_weights_folder", str(folder),
              "--models_to_load", "pose_encoder", "pose", "--mono_pretrained", "0")))
    for name in RUNS[label][2]:
        _assert_identical(_state(getattr(part.models, name)), record["start"][name])
    for name in ("pose_encoder", "pose"):
        _assert_identical(_state(getattr(part.models, name)),
                          _state(getattr(trainer.models, name)))
