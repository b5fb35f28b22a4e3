"""The port's slice end to end: GRU v10 streaming inference with ResNet18.

``ssde_tpu_torch``'s ``GRUStreamEvaluator`` (built through its script's
``build_evaluator``) against ``ssde_tpu.eval.gru_runners.GRUStreamEvaluator``
on the same weights and synthetic frames, for all three protocols, at
64x128 in float32 (bound 1e-4 on the disparity). A subprocess with the
imports of JAX, flax and the JAX package (``ssde_tpu``) blocked shows that
the port, its mono and GRU (v10 and v9) training slices included, needs
none of them: there, the mono trainer also trains on a written KITTI tree
and saves its weights.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ssde_tpu.checkpoint import (convert_depth_decoder, convert_gru_blocks,
                                 convert_resnet_encoder)
from ssde_tpu.config import Options
from ssde_tpu.eval.gru_runners import GRUStreamEvaluator as JaxEvaluator
from ssde_tpu.train.steps_gru import build_gru_models as jax_build_gru_models
from ssde_tpu_torch.data.synthetic import scene_frames
from ssde_tpu_torch.models.common import sample_
from ssde_tpu_torch.models.resnet import randomize_bn_stats_
from ssde_tpu_torch.ops.conv3x3 import conv3x3
from ssde_tpu_torch.scripts.evaluate_depth_gru_fusion import (build_evaluator,
                                                              predict_bucketed,
                                                              predict_scenes)

H, W, B = 64, 128, 2
TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _opts():
    opt = Options()
    opt.gru_version, opt.height, opt.width = "v10", H, W
    opt.compute_dtype = "float32"
    return opt


@pytest.fixture(scope="module")
def evaluators():
    """(port evaluator, JAX evaluator) on the same seeded weights."""
    ev = build_evaluator(_opts(), "cpu", seed=0)
    m = ev.models
    g = torch.Generator().manual_seed(1)
    randomize_bn_stats_(m.encoder, g)
    for s in range(4):  # a non-zero learned initial state
        sample_(m.gru.unit(s).h0_layer1, g, lambda t: t.normal_(0, 0.5, generator=g))
    sd = lambda mod: {k: v.detach().numpy() for k, v in mod.state_dict().items()}
    enc_p, enc_s, _ = convert_resnet_encoder(sd(m.encoder))
    params = {"encoder": enc_p, "depth": convert_depth_decoder(sd(m.depth)),
              "gru": convert_gru_blocks(sd(m.gru))}
    jev = JaxEvaluator(jax_build_gru_models(_opts()), params, {"encoder": enc_s})
    return ev, jev


@pytest.fixture(scope="module")
def frames():
    return scene_frames(H, W, 4, batch=B, seed=3)


def test_predict_single(evaluators, frames):
    ev, jev = evaluators
    got = ev.predict_single(frames[0])
    assert got.shape == (B, H, W) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jev.predict_single(frames[0]), atol=TOL, rtol=0)


def test_predict_with_warmup(evaluators, frames):
    ev, jev = evaluators
    got = ev.predict_with_warmup(frames[:2], frames[2])
    np.testing.assert_allclose(got, jev.predict_with_warmup(frames[:2], frames[2]),
                               atol=TOL, rtol=0)
    # the recurrence matters: warm-up changes the prediction
    assert np.abs(got - ev.predict_single(frames[2])).max() > 1e-3


def test_predict_scene(evaluators, frames):
    ev, jev = evaluators
    got, want = ev.predict_scene(frames[:3]), jev.predict_scene(frames[:3])
    assert len(got) == len(want) == 3
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=f"frame {t}")


def test_script_protocol_loops(evaluators, frames):
    """The bucketed single/warm-up loop and the scene loop of the script:
    items of different warm-up lengths, a padded last chunk, two scenes."""
    ev, jev = evaluators
    one = [f[:1] for f in frames]  # (1, H, W, 3) frames, as the KITTI reader gives
    items = [(0, one[:2], one[2]), (1, [], one[0]), (2, one[:2], one[3]),
             (3, one[:2], one[1]), (4, [], one[1])]
    got = predict_bucketed(ev, items, batch_size=2, min_depth=0.1, max_depth=100.0)
    for pos, prev, img in items:
        d = (ev.predict_with_warmup(prev, img) if prev else ev.predict_single(img))[0]
        np.testing.assert_allclose(got[pos], 0.01 + (10.0 - 0.01) * d, rtol=1e-6)
    scenes = predict_scenes(ev, [one[:2], one[1:4]], 0.1, 100.0)
    assert [len(s) for s in scenes] == [2, 3]
    want = jev.predict_scene([f.repeat(B, 0) for f in one[1:4]])
    np.testing.assert_allclose(scenes[1][2], 0.01 + (10.0 - 0.01) * want[2][0],
                               atol=TOL * 10, rtol=0)  # scaled disp spans 10x


def test_script_main_on_a_kitti_tree(tmp_path, monkeypatch):
    """The script's entry point on a miniature KITTI tree: its frame reader
    gives the JAX package's frames, and main() reports the eigen metrics of
    the bucketed warm-up predictions of the weights in --load_weights_folder
    (a reference-layout folder of the seed-0 models, which main() requires)."""
    from PIL import Image

    from ssde_tpu.data.kitti import pil_load_resized
    from ssde_tpu.eval.depth import evaluate_depth_predictions
    from ssde_tpu_torch.scripts import evaluate_depth_gru_fusion as script

    rng = np.random.RandomState(0)
    drive = "2011_09_26/2011_09_26_drive_0001_sync"
    img_dir = tmp_path / "kitti" / drive / "image_02" / "data"
    img_dir.mkdir(parents=True)
    for i in range(4):
        Image.fromarray((rng.rand(90, 300, 3) * 255).astype(np.uint8)).save(
            img_dir / f"{i:010d}.jpg")
    split = tmp_path / "splits" / "eigen"
    split.mkdir(parents=True)
    (split / "test_files.txt").write_text(f"{drive} 3 l\n{drive} 1 l\n")
    gt = rng.uniform(1.0, 80.0, (2, 90, 300)).astype(np.float32)
    np.savez(split / "gt_depths.npz", data=gt)
    monkeypatch.setenv("SSDE_SPLITS_DIR", str(tmp_path / "splits"))
    weights = tmp_path / "weights"
    weights.mkdir()
    seeded = build_evaluator(_opts(), "cpu").models
    for name in ("encoder", "depth", "gru"):
        torch.save(getattr(seeded, name).state_dict(), weights / f"{name}.pth")

    argv = ["--protocol", "warmup", "--warmup_frames", "2", "--eval_batch_size", "2",
            "--device", "cpu", "--gru_version", "v10", "--height", str(H),
            "--width", str(W), "--data_path", str(tmp_path / "kitti")]
    got = script.main(argv + ["--load_weights_folder", str(weights)])

    opt = _opts()
    opt.data_path = str(tmp_path / "kitti")
    frame = lambda i: script._load_frame(opt, drive, i)
    for i in range(4):
        want = pil_load_resized(str(img_dir / f"{i:010d}.jpg"), W, H, False)[None]
        assert np.array_equal(frame(i), want)
    assert frame(4) is None
    items = [(0, [frame(1), frame(2)], frame(3)), (1, [frame(0)], frame(1))]
    preds = predict_bucketed(build_evaluator(_opts(), "cpu"), items, 2, opt.min_depth,
                             opt.max_depth)
    want = evaluate_depth_predictions(np.stack(preds), list(gt), eval_split="eigen")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_cpu_path_never_launches_the_kernel(evaluators, frames):
    before = conv3x3.launches
    evaluators[0].predict_single(frames[0])
    assert conv3x3.launches == before


_NO_JAX = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "ssde_tpu")  # not ssde_tpu_torch

    class BlockJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, BlockJax())
    import ssde_tpu_torch
    for mod in pkgutil.walk_packages(ssde_tpu_torch.__path__, "ssde_tpu_torch."):
        importlib.import_module(mod.name)

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.synthetic import scene_frames
    from ssde_tpu_torch.scripts.evaluate_depth_gru_fusion import build_evaluator
    opt = Options()
    opt.gru_version, opt.height, opt.width = "v10", 64, 128
    disp = build_evaluator(opt, "cpu").predict_scene(scene_frames(64, 128, 2))
    assert disp[-1].shape == (1, 64, 128) and 0 < disp[-1].min() < disp[-1].max() < 1

    # the mono training slice: its entry point's trainer and one step
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.scripts.train_dpt import build_trainer
    from ssde_tpu_torch.train.steps import train_step
    opt = Options(model="monodepth2", synthetic_data=True, height=32, width=64,
                  batch_size=2, compute_dtype="float32", num_workers=1)
    trainer = build_trainer(opt, "cpu")
    batch = to_device(next(iter(trainer.train_loader)), "cpu")
    assert float(train_step(trainer.models, trainer.state, batch)["loss"]) > 0

    # that trainer as the JAX package's .ckpt folder (flax msgpack, adam.ckpt),
    # written and resumed from without flax
    import tempfile
    import torch
    from ssde_tpu_torch import checkpoint
    native = tempfile.mkdtemp()
    checkpoint.save_checkpoint(native, *checkpoint.flax_state(
        trainer.models, trainer.state.optimizer, trainer.state.step), height=32, width=64)
    opt.load_weights_folder = native
    resumed = build_trainer(opt, "cpu")
    assert resumed.state.step == trainer.state.step == 1
    for a, b in zip(trainer.models.parameters(), resumed.models.parameters()):
        assert torch.equal(a, b)
        sa, sb = trainer.state.optimizer.state[a], resumed.state.optimizer.state[b]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    del resumed
    import shutil
    shutil.rmtree(native)  # ~300 MB of weights and moments

    # the DPT trainer (train_dpt's default --model) and one step of it
    import ssde_tpu_torch.train.steps_dpt as steps_dpt
    opt = Options(synthetic_data=True, height=64, width=128, batch_size=2,
                  compute_dtype="float32", num_workers=1, mono_pretrained=0)
    trainer = build_trainer(opt, "cpu")
    assert type(trainer).__name__ == "DPTTrainer" and trainer.device.type == "cpu"
    batch = to_device(next(iter(trainer.train_loader)), "cpu")
    assert float(steps_dpt.train_step(trainer.models, trainer.state, batch)["loss"]) > 0
    del trainer

    # the GRU training slice: its entry point's trainer and one sequence step
    import ssde_tpu_torch.train.steps_gru as steps_gru
    import ssde_tpu_torch.train.trainer_gru  # noqa: F401
    from ssde_tpu_torch.scripts import train_gru
    opt = train_gru.MonodepthOptions().parse(
        ["--gru_version", "v10", "--synthetic_data", "--height", "64", "--width", "128",
         "--batch_size", "1", "--len_sequence", "2", "--compute_dtype", "float32",
         "--num_workers", "1", "--no_cuda"])
    trainer = train_gru.build_trainer(opt)
    batch = to_device(next(iter(trainer.train_loader)), "cpu")
    assert float(steps_gru.train_step(trainer.models, trainer.state, batch)["loss"]) > 0

    # GRU v9 (attention fusion): a tiny model through the same entry point,
    # one sequence step, and its streamed disparity
    opt = train_gru.MonodepthOptions().parse(
        ["--gru_version", "v9", "--synthetic_data", "--height", "64", "--width", "128",
         "--batch_size", "1", "--len_sequence", "2", "--compute_dtype", "float32",
         "--num_workers", "1", "--no_cuda"])
    trainer = train_gru.build_trainer(opt)
    assert type(trainer.models.gru.fusion(0).resConfUnit1).__name__ == "ResidualAttentionUnit"
    batch = to_device(next(iter(trainer.train_loader)), "cpu")
    assert float(steps_gru.train_step(trainer.models, trainer.state, batch)["loss"]) > 0
    opt = Options()
    opt.gru_version, opt.height, opt.width = "v9", 64, 128
    disp = build_evaluator(opt, "cpu").predict_scene(scene_frames(64, 128, 2))
    assert disp[-1].shape == (1, 64, 128) and 0 < disp[-1].min() < disp[-1].max() < 1

    # the mono trainer on a written KITTI tree: one epoch, then weights_0
    import os, tempfile
    import numpy as np
    from PIL import Image
    root = tempfile.mkdtemp()
    drive = "2011_09_26/2011_09_26_drive_0001_sync"
    for cam in ("image_02", "image_03"):
        os.makedirs(os.path.join(root, "kitti", drive, cam, "data"))
    os.makedirs(os.path.join(root, "kitti", drive, "velodyne_points", "data"))
    rs = np.random.RandomState(0)
    for i in range(6):
        for cam in ("image_02", "image_03"):
            Image.fromarray((rs.rand(48, 160, 3) * 255).astype(np.uint8)).save(
                os.path.join(root, "kitti", drive, cam, "data", f"{i:010d}.jpg"))
        pts = rs.rand(256, 4).astype(np.float32) * [20, 10, 2, 1] + [5, -5, -1, 0]
        pts.astype(np.float32).tofile(
            os.path.join(root, "kitti", drive, "velodyne_points", "data", f"{i:010d}.bin"))
    with open(os.path.join(root, "kitti", "2011_09_26", "calib_cam_to_cam.txt"), "w") as f:
        f.write("S_rect_02: 1242 375\\nR_rect_00: 1 0 0 0 1 0 0 0 1\\n"
                "P_rect_02: 721.5 0 609.6 44.9 0 721.5 172.9 0.2 0 0 1 0.003\\n")
    with open(os.path.join(root, "kitti", "2011_09_26", "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\\nT: 0 -0.08 -0.27\\n")
    os.makedirs(os.path.join(root, "splits", "eigen_zhou"))
    for which, ids in (("train", (1, 2, 3, 4)), ("val", (2, 3))):
        with open(os.path.join(root, "splits", "eigen_zhou", f"{which}_files.txt"), "w") as f:
            f.write("".join(f"{drive} {i} l\\n" for i in ids))
    os.environ["SSDE_SPLITS_DIR"] = os.path.join(root, "splits")
    from ssde_tpu_torch.scripts import train_dpt
    trainer = train_dpt.main(
        ["--model", "monodepth2", "--data_path", os.path.join(root, "kitti"), "--height", "32",
         "--width", "64", "--batch_size", "2", "--num_epochs", "1", "--num_workers", "1",
         "--compute_dtype", "float32", "--log_frequency", "1", "--mono_pretrained", "0",
         "--no_cuda", "--log_dir", os.path.join(root, "log")])
    assert trainer.step == 2 and "depth_gt" in trainer.train_dataset[0]
    saved = sorted(os.listdir(os.path.join(root, "log", "mdp", "models", "weights_0")))
    assert saved == ["adam.pth", "depth.pth", "encoder.pth", "pose.pth", "pose_encoder.pth"]
    import shutil
    shutil.rmtree(root)  # the tree and its ~300 MB of weights
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("no-jax ok")
""")


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "SSDE_PLATFORM"}
    env["OMP_NUM_THREADS"] = "1"  # one torch thread, as in _one_torch_thread
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "no-jax ok" in res.stdout
