"""The port's copies of the JAX package's host-side evaluation code against
their originals, and the pieces of the port that the evaluation scripts
share.

``ssde_tpu_torch.eval.pose``, ``ssde_tpu_torch.metrics`` and
``ssde_tpu_torch.io`` are copies of ``ssde_tpu/eval/pose.py``,
``ssde_tpu/metrics.py`` and ``ssde_tpu/io.py`` (the port imports nothing of
``ssde_tpu``); on seeded numpy inputs each gives the original's result
exactly: the same numpy, PIL and matplotlib arithmetic. (The copy of
``ssde_tpu/eval/depth.py`` is held in ``tests/test_torch_config.py``.)
Then ``train.steps.mono_infer`` and ``checkpoint.load_eval_folder``.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from ssde_tpu import io as jax_io
from ssde_tpu import metrics as jax_metrics
from ssde_tpu.eval import pose as jax_pose
from ssde_tpu_torch import checkpoint, io, metrics
from ssde_tpu_torch.config import Options
from ssde_tpu_torch.eval import pose
from ssde_tpu_torch.models.resnet import randomize_bn_stats_
from ssde_tpu_torch.train.steps import build_mono_models, mono_infer


def _se3(rs, n):
    """n random rigid transforms (4, 4), float64."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rs.randn(3, 3))
        out[i, :3, :3] = q * np.sign(np.linalg.det(q))
        out[i, :3, 3] = rs.randn(3)
    return out


# ------------------------------------------------------------------- eval/pose


def test_dump_xyz_and_compute_ate_match():
    rs = np.random.RandomState(0)
    T = _se3(rs, 4)
    np.testing.assert_array_equal(pose.dump_xyz(T), jax_pose.dump_xyz(T))
    gt, pred = rs.randn(5, 3), rs.randn(5, 3)
    assert pose.compute_ate(gt, pred) == jax_pose.compute_ate(gt, pred)


@pytest.mark.parametrize("n,track_length", [(12, 5), (7, 3)])
def test_evaluate_pose_sequence_matches(n, track_length):
    rs = np.random.RandomState(n)
    pred = _se3(rs, n - 1).astype(np.float32)
    gt = _se3(rs, n)
    got = pose.evaluate_pose_sequence(pred, gt, track_length)
    assert got == jax_pose.evaluate_pose_sequence(pred, gt, track_length)
    assert all(np.isfinite(got))


# --------------------------------------------------------------------- metrics


def test_metric_aggregator_matches():
    rs = np.random.RandomState(1)
    ours, theirs = metrics.MetricAggregator(), jax_metrics.MetricAggregator()
    for i in range(4):
        target = np.where(rs.rand(30, 40) < 0.4, 0.0, rs.uniform(1, 80, (30, 40)))
        if i == 2:
            target[:] = 0  # no valid pixel: skipped
        output = rs.uniform(1, 80, (30, 40))
        ours.evaluate(output, target)
        theirs.evaluate(output, target)
    assert ours.count == theirs.count == 3
    assert ours.average() == theirs.average()
    ours.reset()
    assert ours.count == 0 and ours.average()["rmse"] == 0.0


def test_context_helpers_match():
    rs = np.random.RandomState(2)
    for n, k in ((5, 1), (6, 3)):
        np.testing.assert_array_equal(metrics.banded_mask(n, k), jax_metrics.banded_mask(n, k))
    l1, l2 = rs.randn(2, 6, 3, 4, 5), rs.randn(2, 6, 2, 4, 5)
    np.testing.assert_array_equal(metrics.context_vectors(l1, l2, 2),
                                  jax_metrics.context_vectors(l1, l2, 2))
    x = rs.randn(3, 4)
    prev1, prev2 = [rs.randn(3, 4) for _ in range(3)], [rs.randn(2, 4) for _ in range(3)]
    np.testing.assert_array_equal(metrics.context_vector(x, prev1, prev2, (2, 4)),
                                  jax_metrics.context_vector(x, prev1, prev2, (2, 4)))


# -------------------------------------------------------------------------- io


@pytest.mark.parametrize("shape", [(6, 9), (6, 9, 3)])
def test_pfm_round_trips_between_the_copies(tmp_path, shape):
    image = np.random.RandomState(3).randn(*shape).astype(np.float32)
    io.write_pfm(str(tmp_path / "a.pfm"), image, scale=2.0)
    jax_io.write_pfm(str(tmp_path / "b.pfm"), image, scale=2.0)
    assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
    data, scale = io.read_pfm(str(tmp_path / "b.pfm"))
    want, want_scale = jax_io.read_pfm(str(tmp_path / "a.pfm"))
    assert scale == want_scale == 2.0
    np.testing.assert_array_equal(data, want)
    np.testing.assert_array_equal(data, image)
    with pytest.raises(ValueError):
        io.write_pfm(str(tmp_path / "c.pfm"), image.astype(np.float64))


@pytest.mark.parametrize("bits", [1, 2])
def test_write_depth_png_matches(tmp_path, bits):
    depth = np.random.RandomState(4).uniform(1, 80, (7, 11))
    for mod, name in ((io, "a.png"), (jax_io, "b.png")):
        mod.write_depth_png(str(tmp_path / name), depth, bits=bits)
        mod.write_depth_png(str(tmp_path / f"flat_{name}"), np.full((3, 4), 5.0), bits=bits)
    for a, b in (("a.png", "b.png"), ("flat_a.png", "flat_b.png")):
        got, want = (np.asarray(Image.open(tmp_path / f)) for f in (a, b))
        assert got.dtype == want.dtype == (np.uint8 if bits == 1 else np.uint16)
        np.testing.assert_array_equal(got, want)


def test_colormap_and_palette_match():
    pytest.importorskip("matplotlib")
    disp = np.random.RandomState(5).rand(12, 20).astype(np.float32)
    got = io.colormap_disparity(disp)
    assert got.dtype == np.uint8 and got.shape == (12, 20, 3)
    np.testing.assert_array_equal(got, jax_io.colormap_disparity(disp))
    np.testing.assert_array_equal(io.colormap_disparity(disp, 50.0),
                                  jax_io.colormap_disparity(disp, 50.0))
    assert io._build_palette(256) == jax_io._build_palette(256)
    labels = np.random.RandomState(6).randint(0, 21, (5, 7))
    assert io.get_mask_pallete(labels).tobytes() == jax_io.get_mask_pallete(labels).tobytes()


# ---------------------------------------------------- mono_infer, the folder


@pytest.fixture(scope="module")
def models():
    gen = torch.Generator().manual_seed(1)
    m = build_mono_models(Options(height=64, width=128, compute_dtype="float32"), "cpu", gen)
    randomize_bn_stats_(m.encoder, gen)
    return m


def test_mono_infer_uses_the_running_statistics_and_leaves_them(models):
    models.train(True)
    before = {k: v.clone() for k, v in models.encoder.state_dict().items()}
    x = torch.from_numpy(np.random.RandomState(7).rand(2, 3, 64, 128).astype(np.float32))
    disp = mono_infer(models, x)
    assert disp.shape == (2, 1, 64, 128) and disp.dtype == torch.float32
    assert not disp.requires_grad
    assert models.encoder.training and models.depth.training  # modes restored
    for k, v in models.encoder.state_dict().items():
        assert torch.equal(v, before[k]), k
    models.train(False)
    with torch.no_grad():
        want = models.depth(models.encoder(x))["disp/0"]
    torch.testing.assert_close(disp, want, rtol=0, atol=0)
    assert not torch.equal(disp, mono_infer(models, x.flip(-1)))


def test_load_eval_folder_refuses_what_it_cannot_load(models, tmp_path):
    with pytest.raises(FileNotFoundError, match="zoo"):
        checkpoint.load_eval_folder(str(tmp_path / "missing"), models, ("encoder",))
    native = tmp_path / "native"
    native.mkdir()
    for name in ("encoder", "depth", "adam"):
        (native / f"{name}.ckpt").write_bytes(b"\x80")
    with pytest.raises(ValueError, match=r"encoder\.ckpt is not a JAX \.ckpt file"):
        checkpoint.load_eval_folder(str(native), models, ("encoder", "depth"))
    folder = tmp_path / "pth"
    checkpoint.save_folder(str(folder), models, height=64, width=128)
    os.remove(folder / "depth.pth")
    with pytest.raises(FileNotFoundError, match="depth.pth"):
        checkpoint.load_eval_folder(str(folder), models, ("encoder", "depth"))
    meta = checkpoint.load_eval_folder(str(folder), models, ("encoder", "pose"))
    assert meta == {"height": 64, "width": 128, "use_stereo": 0}
