"""The trainers on a KITTI tree: ``weights_<epoch>/`` written and read back.

Both entry points train on the miniature tree of ``tests/test_kitti_tree.py``
(its ``kitti_tree`` writer, imported) at 64x128 in float32 on the CPU and
write ``weights_0/`` in the reference's per-module ``.pth`` layout. The JAX
package reads that folder (``load_monodepth2_checkpoint``, which converts
``gru.pth`` with ``convert_gru_blocks``) and gives the port's disparity at
1e-4. A trainer built on the folder resumes bit for bit: one further step
from the saved trainer and from the reloaded one leaves identical
parameters, statistics and Adam moments. ``--models_to_load`` loads only
what it names, a file that does not match raises, an ``adam.pth`` that
does not match leaves fresh moments and a warning, and
``--matmul_precision`` sets the TF32 switches.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssde_tpu.checkpoint import load_monodepth2_checkpoint
from ssde_tpu.config import Options as JaxOptions
from ssde_tpu.eval.gru_runners import GRUStreamEvaluator as JaxEvaluator
from ssde_tpu.train.steps import build_mono_models as jax_build_mono_models
from ssde_tpu.train.steps import make_mono_infer_fn
from ssde_tpu.train.steps_gru import build_gru_models as jax_build_gru_models
from ssde_tpu_torch import checkpoint
from ssde_tpu_torch.eval.gru_runners import GRUStreamEvaluator
from ssde_tpu_torch.scripts import train_dpt, train_gru
from ssde_tpu_torch.train.trainer import DEPTH_METRICS, device_batch
from test_kitti_tree import kitti_tree  # noqa: F401

H, W = 64, 128
MONO_FILES = {"encoder.pth", "depth.pth", "pose_encoder.pth", "pose.pth", "adam.pth"}
_SCRIPTS = {"mono": (train_dpt, ["--model", "monodepth2", "--batch_size", "2"]),
            "gru": (train_gru, ["--gru_version", "v10", "--batch_size", "1",
                                "--len_sequence", "2"])}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The small-size runs here take one torch thread (see
    tests/test_torch_mono_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(kind, tree, log_dir, *extra):
    return [*_SCRIPTS[kind][1], "--data_path", tree["data"], "--height", str(H),
            "--width", str(W), "--num_epochs", "1", "--log_frequency", "1",
            "--num_workers", "1", "--compute_dtype", "float32", "--mono_pretrained", "0",
            "--no_cuda", "--log_dir", str(log_dir), *extra]


def _build(kind, tree, log_dir, *extra):
    module = _SCRIPTS[kind][0]
    return module.build_trainer(module.MonodepthOptions().parse(_argv(kind, tree, log_dir,
                                                                      *extra)))


def _state(trainer):
    """Every parameter and buffer of every module, and the Adam moments."""
    out = {f"{i}.{k}": v.detach().clone() for i, m in enumerate(trainer.models.modules())
           for k, v in m.state_dict().items()}
    for i, s in enumerate(trainer.state.optimizer.state.values()):
        for k, v in s.items():
            out[f"adam.{i}.{k}"] = v.detach().clone()
    return out


def _assert_identical(a, b, keys=None):
    assert a.keys() == b.keys()
    for k in keys or a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module", params=sorted(_SCRIPTS))
def trained(request, kitti_tree, tmp_path_factory):  # noqa: F811
    """(kind, tree, the trainer after one epoch on the tree through its
    entry point's main(), its stdout, its weights_0 folder)."""
    kind = request.param
    log_dir = tmp_path_factory.mktemp(f"log_{kind}")
    mp = pytest.MonkeyPatch()
    mp.setenv("SSDE_SPLITS_DIR", kitti_tree["splits"])
    capture = []
    mp.setattr("builtins.print", lambda *a, **k: capture.append(" ".join(map(str, a))))
    try:
        trainer = _SCRIPTS[kind][0].main(_argv(kind, kitti_tree, log_dir))
    finally:
        mp.undo()
    yield kind, kitti_tree, trainer, capture, os.path.join(log_dir, "mdp", "models", "weights_0")


def test_trainers_train_on_the_tree_and_write_weights_0(trained):
    kind, _, trainer, out, folder = trained
    assert trainer.step == len(trainer.train_loader) > 0
    assert trainer.state.step == trainer.step
    files = set(os.listdir(folder))
    assert files == MONO_FILES | ({"gru.pth"} if kind == "gru" else set())
    assert os.path.isfile(os.path.join(os.path.dirname(folder), "opt.json"))
    vals = [ln for ln in out if ln.startswith("val ")]
    assert len(vals) == trainer.step
    for ln in vals:
        words = ln.split()
        scalars = dict(zip(words[1::2], map(float, words[2::2])))
        assert set(DEPTH_METRICS) <= scalars.keys() and "loss" in scalars
        assert all(np.isfinite(v) for v in scalars.values())
    enc = torch.load(os.path.join(folder, "encoder.pth"), weights_only=True)
    assert (enc["height"], enc["width"], enc["use_stereo"]) == (H, W, False)
    _assert_identical(
        {k: v for k, v in enc.items() if isinstance(v, torch.Tensor)},
        {k: v.detach() for k, v in trainer.models.encoder.state_dict().items()})


def test_val_returns_the_depth_metrics(trained):
    _, _, trainer, _, _ = trained
    scalars = trainer.val()
    assert set(DEPTH_METRICS) <= scalars.keys()
    assert all(np.isfinite(v) for v in scalars.values())


def test_the_jax_package_reads_what_the_port_writes(trained):
    kind, _, trainer, _, folder = trained
    params, stats, meta = load_monodepth2_checkpoint(folder)
    assert int(meta["height"]) == H and int(meta["width"]) == W
    m = trainer.models.train(False)
    rs = np.random.RandomState(2)
    image = rs.rand(2, H, W, 3).astype(np.float32)
    if kind == "mono":
        with torch.no_grad():
            got = m.depth(m.encoder(torch.from_numpy(image).permute(0, 3, 1, 2)))["disp/0"]
        jm = jax_build_mono_models(JaxOptions(height=H, width=W, compute_dtype="float32"))
        want = make_mono_infer_fn(jm)(params, stats, jnp.asarray(image))
        got, want = got[:, 0].numpy(), np.asarray(want)[..., 0]
    else:
        assert set(params) == {"encoder", "depth", "pose_encoder", "pose", "gru"}
        opts = JaxOptions(height=H, width=W, compute_dtype="float32", gru_version="v10")
        jev = JaxEvaluator(jax_build_gru_models(opts), params, {"encoder": stats["encoder"]})
        frames = [image, image[::-1].copy()]
        got = GRUStreamEvaluator(m).predict_scene(frames)[-1]
        want = np.asarray(jev.predict_scene(frames)[-1])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


class _Copy:
    """The models and optimizer state of a trainer, copied together (so the
    optimizer keeps pointing at the copied parameters)."""

    def __init__(self, trainer):
        self.step_fn = trainer.step_fn
        self.models, self.state = copy.deepcopy((trainer.models, trainer.state))


def _one_step(trainer, host, seed=5):
    gen = torch.Generator("cpu").manual_seed(seed)
    return trainer.step_fn(trainer.models, trainer.state, device_batch(host, "cpu"), gen)


def test_resume_reproduces_the_next_step_bit_for_bit(trained, tmp_path, monkeypatch):
    kind, tree, trainer, _, folder = trained
    monkeypatch.setenv("SSDE_SPLITS_DIR", tree["splits"])
    saved = _Copy(trainer)
    reloaded = _build(kind, tree, tmp_path, "--load_weights_folder", folder)
    assert reloaded.state.step == saved.state.step > 0
    _assert_identical(_state(reloaded), _state(saved))
    host = next(iter(reloaded.train_loader))
    a, b = _one_step(saved, host), _one_step(reloaded, host)
    assert torch.equal(a["loss"], b["loss"])
    after = _state(saved)
    _assert_identical(_state(reloaded), after)
    assert not torch.equal(after["0.encoder.conv1.weight"], _state(trainer)["0.encoder.conv1.weight"])


def test_models_to_load_changes_only_those_modules(trained, tmp_path, monkeypatch):
    kind, tree, trainer, _, folder = trained
    monkeypatch.setenv("SSDE_SPLITS_DIR", tree["splits"])
    fresh = _build(kind, tree, tmp_path)
    part = _build(kind, tree, tmp_path, "--load_weights_folder", folder,
                  "--models_to_load", "encoder", "pose")
    for name in ("encoder", "depth", "pose_encoder", "pose", "gru"):
        module = getattr(part.models, name, None)
        if module is None:
            continue
        want = getattr(trainer.models if name in ("encoder", "pose") else fresh.models, name)
        _assert_identical({k: v.detach() for k, v in module.state_dict().items()},
                          {k: v.detach() for k, v in want.state_dict().items()})


def test_a_file_that_does_not_match_raises(trained, tmp_path, monkeypatch):
    kind, tree, trainer, _, folder = trained
    monkeypatch.setenv("SSDE_SPLITS_DIR", tree["splits"])
    for name, edit in (("depth", lambda sd: sd.update({"decoder.0.conv.conv.weight":
                                                       torch.zeros(1, 1, 3, 3)})),
                       ("pose", lambda sd: sd.update({"net.9.weight": torch.zeros(1)})),
                       ("encoder", lambda sd: sd.pop("encoder.conv1.weight"))):
        bad = tmp_path / name
        bad.mkdir()
        sd = torch.load(os.path.join(folder, f"{name}.pth"), weights_only=True)
        edit(sd)
        torch.save(sd, bad / f"{name}.pth")
        with pytest.raises((RuntimeError, KeyError)):
            _build(kind, tree, tmp_path, "--load_weights_folder", str(bad))


def test_an_adam_file_that_does_not_match_leaves_fresh_moments(trained, tmp_path, monkeypatch):
    kind, tree, trainer, _, folder = trained
    monkeypatch.setenv("SSDE_SPLITS_DIR", tree["splits"])
    sd = torch.load(os.path.join(folder, "adam.pth"), weights_only=True)
    first = sd["param_groups"][0]["params"][0]
    sd["state"][first]["exp_avg"] = torch.zeros(3)
    bad = tmp_path / "bad_adam"
    bad.mkdir()
    torch.save(sd, bad / "adam.pth")
    for name in ("encoder", "depth"):
        os.link(os.path.join(folder, f"{name}.pth"), bad / f"{name}.pth")
    with pytest.warns(UserWarning, match="freshly initialized"):
        t = _build(kind, tree, tmp_path, "--load_weights_folder", str(bad))
    assert t.state.step == 0 and not t.state.optimizer.state
    _assert_identical({k: v.detach() for k, v in t.models.encoder.state_dict().items()},
                      {k: v.detach() for k, v in trainer.models.encoder.state_dict().items()})


def test_a_missing_module_file_is_skipped(tmp_path):
    models = type("Bundle", (), {"encoder": torch.nn.Linear(2, 2), "depth": None})()
    assert checkpoint.load_folder(str(tmp_path), models) == ({}, [])


@pytest.mark.parametrize("value,tf32", [("default", True), ("float32", False),
                                        ("highest", False)])
def test_trainers_honour_matmul_precision(kitti_tree, tmp_path, monkeypatch, value, tf32):
    """Building a trainer sets both TF32 switches for float32 and highest and
    leaves them for default; they are process-wide, so the test restores
    them."""
    monkeypatch.setenv("SSDE_SPLITS_DIR", kitti_tree["splits"])
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for kind in sorted(_SCRIPTS):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            _build(kind, kitti_tree, tmp_path, "--matmul_precision", value)
            assert torch.backends.cudnn.allow_tf32 is tf32
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
