"""The port's training logs against the JAX package's.

``ssde_tpu_torch.logging_utils`` (``Writers``, ``TimeLogger``,
``save_opts``) and ``ssde_tpu_torch.utils`` (``normalize_image``,
``sec_to_hm_str``) are the counterparts of ``ssde_tpu/logging_utils.py`` and
``ssde_tpu/utils.py``. Given the same values (NCHW tensors for the port,
NHWC arrays for JAX) both writers leave TensorBoard event files with the
same tags, steps, scalars and decoded image pixels; the console line is the
same character for character under one clock; ``opt.json`` is the same
file. Without the ``tensorboard`` package the writers do nothing. Then the
trainer: ``val()``'s failure rule, and one synthetic epoch of the mono
trainer at 64x128 whose ``train`` tags are the JAX step's loss keys without
``warp/band_violation`` (the port's warp is exact).
"""

import dataclasses
import io
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

import jax

from ssde_tpu import config as jax_config
from ssde_tpu import logging_utils as jax_logging
from ssde_tpu import utils as jax_utils
from ssde_tpu.data.transforms import preprocess_batch as jax_preprocess
from ssde_tpu.train import steps as jax_steps
from ssde_tpu_torch import logging_utils, utils
from ssde_tpu_torch.config import MonodepthOptions, Options
from ssde_tpu_torch.data.synthetic import make_synthetic_batch
from ssde_tpu_torch.scripts import train_dpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 64, 128, 2
HM_LINE = re.compile(r"step +\d+ \| examples/s: +[0-9.]+ \| loss: [0-9.]+ \| "
                     r"time elapsed: \d{2,}h\d\dm\d\ds \| time left: \d{2,}h\d\dm\d\ds")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The trainers here take one torch thread: beside the other workers of
    a parallel pytest run a thread pool in every process oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(folder):
    """{tag: [(step, value)]} of the scalars and {tag: [(step, pixels)]} of
    the images in the event files under ``folder``."""
    acc = EventAccumulator(str(folder), size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    tags = acc.Tags()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in tags["scalars"]}
    images = {t: [(e.step, np.asarray(Image.open(io.BytesIO(e.encoded_image_string))))
                  for e in acc.Images(t)] for t in tags["images"]}
    return scalars, images


def _panels(rs, n, scales=(0, 1, 2, 3)):
    """Seeded NHWC colour frames, disparities and automasks, as the JAX
    trainer's val() hands them to its writer."""
    inputs, outputs = {}, {}
    for s in scales:
        h, w = H // 2**s, W // 2**s
        for fid in (0, -1):
            inputs[f"color/{fid}/{s}"] = rs.rand(n, h, w, 3).astype(np.float32)
        outputs[f"disp/{s}"] = (rs.rand(n, h, w, 1) * 0.3 + 0.01).astype(np.float32)
        outputs[f"identity_selection/{s}"] = (rs.rand(n, h, w, 1) > 0.5).astype(np.float32)
    return inputs, outputs


def _nchw(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in tree.items()}


@pytest.mark.parametrize("n,frame_ids", [(5, [0]), (2, [0, -1])])
def test_writers_write_what_the_jax_writers_write(tmp_path, n, frame_ids):
    rs = np.random.RandomState(n)
    inputs, outputs = _panels(rs, n)
    train = {"loss": 0.125, "loss/0": rs.rand(), "loss/3": np.float32(rs.rand())}
    val = {"loss": rs.rand(), "de/abs_rel": rs.rand(), "da/a1": rs.rand()}
    for label, writers, (ins, outs) in (
            ("jax", jax_logging.Writers(str(tmp_path / "jax")), (inputs, outputs)),
            ("port", logging_utils.Writers(str(tmp_path / "port")),
             (_nchw(inputs), _nchw(outputs)))):
        assert set(writers.writers) == {"train", "val"}, label
        for step in (0, 7):
            writers.scalars("train", step, train)
            writers.scalars("val", step, val)
            writers.images("val", step, ins, outs, [0, 1, 2, 3], frame_ids)
        writers.close()
    for mode in ("train", "val"):
        want_s, want_i = _events(tmp_path / "jax" / mode)
        got_s, got_i = _events(tmp_path / "port" / mode)
        assert got_s == want_s and set(got_i) == set(want_i)
        for tag, events in want_i.items():
            assert [s for s, _ in got_i[tag]] == [s for s, _ in events], tag
            for (_, got), (_, want) in zip(got_i[tag], events):
                np.testing.assert_array_equal(got, want, err_msg=tag)
    _, images = _events(tmp_path / "port" / "val")
    want = {f"{kind}_{s}/{j}" for s in range(4) for j in range(min(n, 4))
            for kind in ["disp", "automask"] + [f"color_{f}" for f in frame_ids]}
    assert set(images) == want


_NO_TENSORBOARD = """
import importlib.abc, os, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "tensorboard" or name.startswith("torch.utils.tensorboard"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
from ssde_tpu_torch.config import Options
from ssde_tpu_torch.logging_utils import Writers
from ssde_tpu_torch.scripts.train_dpt import build_trainer

log = sys.argv[1]
w = Writers(log)
assert w.writers == {}
w.scalars("train", 0, {"loss": 1.0})
x = torch.zeros(2, 3, 8, 8)
w.images("val", 0, {"color/0/0": x}, {"disp/0": x[:, :1]}, [0], [0])
w.close()
trainer = build_trainer(Options(model="monodepth2", synthetic_data=True, height=32, width=64,
                                batch_size=2, compute_dtype="float32", num_workers=1,
                                mono_pretrained=0, log_dir=log), "cpu")
assert trainer.val() is not None
trainer.writers.close()
events = [f for _, _, files in os.walk(log) for f in files if "tfevents" in f]
assert not events, events
assert "tensorboard" not in sys.modules
print("no-op ok")
"""


def test_writers_are_a_no_op_without_tensorboard(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "SSDE_PLATFORM"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", _NO_TENSORBOARD, str(tmp_path)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "no-op ok" in res.stdout
    assert "TensorBoard is not installed: the writers are a no-op" in res.stdout


@pytest.mark.parametrize("step,duration,elapsed,total", [
    (0, 0.25, 3.2, 100), (5, 1.5, 10239.0, 1000), (1999, 1e-12, 86399.9, 2000),
    (40, 0.031, 61.0, 41)])
def test_time_logger_line_matches_jax(monkeypatch, capsys, step, duration, elapsed, total):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    loggers = [jax_logging.TimeLogger(total, 12), logging_utils.TimeLogger(total, 12)]
    monkeypatch.setattr(time, "time", lambda: 1000.0 + elapsed)
    rates = [lg.log(step, duration, 0.0123456) for lg in loggers]
    jax_line, port_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line and rates[0] == rates[1]
    assert HM_LINE.fullmatch(port_line)


@pytest.mark.parametrize("t", [0, 59.9, 60, 3599, 3600, 10239, 86399.7, 360000])
def test_sec_to_hm_str_matches_jax(t):
    assert utils.sec_to_hm(t) == jax_utils.sec_to_hm(t)
    assert utils.sec_to_hm_str(t) == jax_utils.sec_to_hm_str(t)


@pytest.mark.parametrize("shape,const", [((8, 16), False), ((3, 5, 7), False), ((4, 4), True)])
def test_normalize_image_matches_jax(shape, const):
    x = np.full(shape, 0.3, np.float32) if const else \
        np.random.RandomState(0).randn(*shape).astype(np.float32)
    got, want = utils.normalize_image(x), jax_utils.normalize_image(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_save_opts_matches_jax(tmp_path):
    argv = ["--model", "monodepth2", "--height", "64", "--width", "128", "--scales", "0", "1",
            "--frame_ids", "0", "-1", "1", "--learning_rate", "3e-4", "--use_stereo"]
    logging_utils.save_opts(str(tmp_path / "port"), MonodepthOptions().parse(argv))
    jax_logging.save_opts(str(tmp_path / "jax"), jax_config.MonodepthOptions().parse(argv))
    got = (tmp_path / "port" / "models" / "opt.json").read_bytes()
    assert got == (tmp_path / "jax" / "models" / "opt.json").read_bytes()


def _mono_trainer(tmp_path):
    return train_dpt.build_trainer(Options(
        model="monodepth2", synthetic_data=True, height=H, width=W, batch_size=B,
        compute_dtype="float32", num_workers=1, mono_pretrained=0,
        log_dir=str(tmp_path)), "cpu")


def test_val_survives_four_failures_and_raises_on_the_fifth(tmp_path, capsys):
    trainer = _mono_trainer(tmp_path)
    process_batch = trainer.process_batch
    calls = []

    def failing(batch, generator=None):
        calls.append(1)
        raise RuntimeError(f"broken batch {len(calls)}")

    trainer.process_batch = failing
    for i in range(4):
        assert trainer.val() is None
        assert f"val failed ({i + 1} consecutive): broken batch {i + 1}" in capsys.readouterr().out
    trainer.process_batch = process_batch  # a success resets the count
    scalars = trainer.val()
    assert scalars is not None and np.isfinite(scalars["loss"])
    trainer.process_batch = failing
    for _ in range(4):
        assert trainer.val() is None
    with pytest.raises(RuntimeError, match="broken batch 9"):
        trainer.val()
    assert len(calls) == 9
    trainer.writers.close()


def _jax_loss_keys():
    """The keys of the JAX mono step's losses at 64x128: its warp and loss
    (``mono_loss_fn``'s last two calls) traced, not run, on the synthetic
    batch with flat disparities and identity poses."""
    opts = jax_config.Options(height=H, width=W, batch_size=B, compute_dtype="float32")
    outputs = {f"disp/{s}": np.full((B, H >> s, W >> s, 1), 0.1, np.float32)
               for s in opts.scales}
    outputs.update({f"cam_T_cam/0/{f}": np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
                    for f in (-1, 1)})

    def losses(batch, outputs):
        inputs = jax_preprocess(batch, H, W, opts.num_scales, [0, -1, 1])
        outputs = jax_steps.generate_images_pred(inputs, dict(outputs), opts, (-1, 1))
        return jax_steps.compute_losses(inputs, outputs, opts, (-1, 1), jax.random.PRNGKey(0))

    return set(jax.eval_shape(losses, make_synthetic_batch(B, H, W, seed=0), outputs))


def test_mono_epoch_writes_the_jax_train_tags(tmp_path, capsys):
    log = tmp_path / "log"
    argv = ["--model", "monodepth2", "--synthetic_data", "--height", str(H), "--width", str(W),
            "--batch_size", str(B), "--num_epochs", "1", "--num_workers", "1",
            "--compute_dtype", "float32", "--log_frequency", "3", "--mono_pretrained", "0",
            "--save_frequency", "2", "--no_cuda", "--log_dir", str(log)]  # no weights_0
    trainer = train_dpt.main(argv)
    out = capsys.readouterr().out
    logged = [s for s in range(trainer.step) if s % 3 == 0]
    lines = [ln for ln in out.splitlines() if "examples/s" in ln]
    assert len(lines) == len(logged) and all(HM_LINE.fullmatch(ln) for ln in lines)
    assert f"TensorBoard event files under {log / 'mdp'}" in out

    scalars, images = _events(log / "mdp" / "train")
    want = _jax_loss_keys() - {"warp/band_violation"}
    assert set(scalars) == want and not images
    assert all([s for s, _ in v] == logged for v in scalars.values())
    val_scalars, val_images = _events(log / "mdp" / "val")
    assert set(val_scalars) == want
    assert set(val_images) == {f"{kind}_{s}/{j}" for s in range(4) for j in range(B)
                               for kind in ("color_0", "disp", "automask")}
    assert all([s for s, _ in v] == logged for v in val_images.values())

    # models/opt.json is what the JAX save_opts writes for the same options
    jax_opts = jax_config.Options(**dataclasses.asdict(trainer.opt))
    jax_logging.save_opts(str(tmp_path / "jax"), jax_opts)
    assert (log / "mdp" / "models" / "opt.json").read_bytes() == \
        (tmp_path / "jax" / "models" / "opt.json").read_bytes()
