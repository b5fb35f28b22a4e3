"""The port's mono depth and pose evaluation entry points against the JAX
package's scripts, on the CPU.

``ssde_tpu_torch.scripts`` {evaluate_depth, test_simple, evaluate_pose,
export_gt_depth, export_gt_depth_seq} and the ``mdp`` protocol of
``evaluate_depth_gru_fusion`` run on the miniature raw + odometry tree of
``tests/test_kitti_tree.py`` (its ``kitti_tree`` writer, imported) at
64x128 in float32, with split lists under ``tmp_path`` through
``$SSDE_SPLITS_DIR``. The weights are a ``.pth`` folder that the port's
``save_folder`` writes from seeded models with non-trivial BatchNorm
statistics; the JAX scripts (``scripts/*.py``, loaded from their files)
read the same folder through ``load_monodepth2_checkpoint``. Each script
gets its own folder of links to those files, since the scripts write their
outputs into the weights folder. Everything is written under pytest's
temporary directories.

Tolerances: disparities and poses within 1e-4 of their largest (the
networks' float32 summation orders differ); the 7 metrics 1e-4 relative;
ATE mean and std 1e-5 relative; what involves no network (the exports, the
external-disparity path, the benchmark PNGs) equal.
"""

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ssde_tpu.config import MonodepthOptions as JaxMonodepthOptions
from ssde_tpu_torch import checkpoint
from ssde_tpu_torch.config import MonodepthOptions, Options
from ssde_tpu_torch.models.resnet import randomize_bn_stats_
from ssde_tpu_torch.scripts import (
    evaluate_depth,
    evaluate_depth_gru_fusion,
    evaluate_pose,
    export_gt_depth,
    export_gt_depth_seq,
    test_simple,
)
from ssde_tpu_torch.train.steps import build_mono_models
from test_kitti_tree import N_FRAMES, SCENE, kitti_tree  # noqa: F401

H, W = 64, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
# 20 test lines: both cameras of every frame and 4 repeats, so the loader's
# batches of 16 end with a short one
EIGEN_LINES = ([f"{SCENE} {i} {s}" for s in "lr" for i in range(N_FRAMES)]
               + [f"{SCENE} {i} l" for i in (5, 1, 6, 2)])
# the exports' list: both cameras, a repeat, out of order
EXPORT_LINES = [f"{SCENE} 6 l", f"{SCENE} 1 r", f"{SCENE} 3 l", f"{SCENE} 1 l"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _links(src, dst):
    """A folder ``dst`` of links to the weight files in ``src``."""
    os.makedirs(dst)
    for f in os.listdir(src):
        os.symlink(os.path.join(src, f), os.path.join(dst, f))
    return str(dst)


def _write_list(splits, split, name, lines):
    os.makedirs(os.path.join(splits, split), exist_ok=True)
    with open(os.path.join(splits, split, name), "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.fixture(autouse=True, scope="module")
def _jax_init_placeholders():
    """``init_mono_params`` of the JAX package, as the JAX scripts call it,
    gives a placeholder (None) for each module's parameters and statistics.
    The scripts run it eagerly, op by op (about 650 XLA compiles, some 50 s
    on the CPU), and then replace each module's entry whole with the loaded
    folder's, so its values never reach their outputs; a placeholder left in
    place would fail loudly."""
    from ssde_tpu.train import steps as jax_steps

    def placeholders(models, rng, inputs):
        names = [n for n in ("encoder", "depth", "pose_encoder", "pose")
                 if getattr(models, n) is not None]
        assert models.predictive_mask is None
        return ({n: None for n in names},
                {n: None for n in ("encoder", "pose_encoder") if n in names})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "init_mono_params", placeholders)
        yield


@pytest.fixture(scope="module")
def setup(kitti_tree, tmp_path_factory):  # noqa: F811
    """The tree; split lists under ``root``/splits: the eigen list, its
    ground truth from the port's export, and an odometry list of the
    tree's N_FRAMES - 1 frame pairs (as KITTI's 1590 lines for sequence
    09's 1591 poses: a line per pair); the weights."""
    root = tmp_path_factory.mktemp("eval")
    splits = str(root / "splits")
    _write_list(splits, "eigen", "test_files.txt", EIGEN_LINES)
    _write_list(splits, "odom", "test_files_09.txt",
                [f"09 {i} l" for i in range(N_FRAMES - 1)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSDE_SPLITS_DIR", splits)
        export_gt_depth.main(["--data_path", kitti_tree["data"], "--split", "eigen"])
    gen = torch.Generator().manual_seed(0)
    models = build_mono_models(Options(height=H, width=W), "cpu", gen)
    randomize_bn_stats_(models.encoder, gen)
    randomize_bn_stats_(models.pose_encoder, gen)
    weights = root / "weights"
    checkpoint.save_folder(str(weights), models, height=H, width=W)
    return {"data": kitti_tree["data"], "splits": splits, "root": root,
            "weights": str(weights)}


@pytest.fixture
def splits_env(setup, monkeypatch):
    monkeypatch.setenv("SSDE_SPLITS_DIR", setup["splits"])
    return setup


def _depth_argv(setup, folder, *extra):
    return ["--eval_mono", "--data_path", setup["data"], "--height", str(H), "--width",
            str(W), "--num_workers", "2", "--load_weights_folder", folder,
            "--save_pred_disps", *extra]


@pytest.fixture(scope="module")
def exports(setup):
    """{(side, file): its arrays}: both exports on each side over
    EXPORT_LINES, each side under split lists of its own."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for side in ("jax", "port"):
            splits = str(setup["root"] / f"splits_{side}")
            _write_list(splits, "eigen", "test_files.txt", EXPORT_LINES)
            mp.setenv("SSDE_SPLITS_DIR", splits)
            if side == "jax":
                _jax_script("export_gt_depth").export_gt_depths_kitti(setup["data"], "eigen")
                _jax_script("export_gt_depth_seq").export_gt_depths_seq(setup["data"], "eigen")
            else:
                export_gt_depth.main(["--data_path", setup["data"], "--split", "eigen"])
                export_gt_depth_seq.main(["--data_path", setup["data"]])
            for name in ("gt_depths", "gt_depths_seq"):
                out[side, name] = dict(np.load(os.path.join(splits, "eigen", f"{name}.npz"),
                                               allow_pickle=True))
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "post_process"])
def depth_runs(request, setup):
    """(post_process, {side: (metrics, saved disparities)}); both sides
    score against the port's gt_depths.npz (the JAX script's evaluation
    fails on its own export when every map has one shape,
    ssde_tpu_torch/scripts/export_gt_depth.py)."""
    pp, out = request.param, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSDE_SPLITS_DIR", setup["splits"])
        for side in ("jax", "port"):
            folder = _links(setup["weights"], setup["root"] / f"{side}_depth{int(pp)}")
            argv = _depth_argv(setup, folder, *(["--post_process"] if pp else []))
            if side == "jax":
                m = _jax_script("evaluate_depth").evaluate(JaxMonodepthOptions().parse(argv))
            else:
                m = evaluate_depth.main(argv + ["--no_cuda"])
            out[side] = m, np.load(os.path.join(folder, "disps_eigen_split.npy"))
    return pp, out


def _image_folder(setup, name):
    images = setup["root"] / name
    images.mkdir()
    for i in (0, 3, 6):
        shutil.copy(os.path.join(setup["data"], SCENE, "image_02", "data", f"{i:010d}.jpg"),
                    images / f"frame{i}.jpg")
    return images


@pytest.fixture(scope="module")
def simple_runs(setup):
    """{side: the image folder after test_simple}."""
    out = {}
    jax_simple = _jax_script("test_simple")
    with pytest.MonkeyPatch.context() as mp:
        for side in ("port", "jax"):
            images = _image_folder(setup, f"{side}_images")
            argv = ["--image_path", str(images), "--model_path",
                    _links(setup["weights"], setup["root"] / f"{side}_simple")]
            if side == "jax":
                mp.setattr(sys, "argv", ["test_simple.py", *argv])
                jax_simple.test_simple(jax_simple.parse_args())
            else:
                test_simple.main(argv + ["--no_cuda"])
            out[side] = images
    return out


@pytest.fixture(scope="module")
def pose_runs(setup):
    """{side: ((mean ATE, std), poses.npy)}."""
    out = {}
    jax_eval = _jax_script("evaluate_pose").evaluate
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSDE_SPLITS_DIR", setup["splits"])
        for side in ("port", "jax"):
            folder = _links(setup["weights"], setup["root"] / f"{side}_pose")
            argv = ["--eval_split", "odom_9", "--data_path", setup["data"], "--height",
                    str(H), "--width", str(W), "--num_workers", "2",
                    "--load_weights_folder", folder]
            if side == "jax":
                ate = jax_eval(JaxMonodepthOptions().parse(argv))
            else:
                ate = evaluate_pose.main(argv + ["--no_cuda"])
            out[side] = ate, np.load(os.path.join(folder, "poses.npy"))
    return out


def _assert_close_to_largest(got, want, tol=1e-4):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    assert err <= tol, err


# ------------------------------------------------------------------ exports


def test_export_gt_depth_matches(exports):
    got, want = exports["port", "gt_depths"]["data"], exports["jax", "gt_depths"]["data"]
    # the port's is a 1-D array of float32 maps, the JAX script's (one shape
    # here) an (N, 375, 1242) array of Python floats: equal map by map
    assert got.shape == (len(EXPORT_LINES),) and got.dtype == object
    assert want.shape == (len(EXPORT_LINES), 375, 1242)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w.astype(np.float32))
    assert sum(int((g > 0).sum()) for g in got) > 100


def test_export_gt_depth_seq_matches(exports):
    got, want = exports["port", "gt_depths_seq"], exports["jax", "gt_depths_seq"]
    np.testing.assert_array_equal(got["index"], want["index"])
    assert list(got["index"]) == [f"{SCENE} {i}" for i in (1, 1, 3, 6)]
    assert got["data"].shape == (len(EXPORT_LINES),)
    for g, w in zip(got["data"], want["data"]):
        np.testing.assert_array_equal(g, w.astype(np.float32))


# ----------------------------------------------------------- evaluate_depth


def test_evaluate_depth_matches(depth_runs):
    _, runs = depth_runs
    (m, disps), (jm, jdisps) = runs["port"], runs["jax"]
    assert disps.shape == (len(EIGEN_LINES), H, W) and disps.dtype == np.float32
    _assert_close_to_largest(disps, jdisps)
    for k in METRICS + ("med_scale", "med_scale_std"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
        assert np.isfinite(m[k])


def test_the_short_last_batch_keeps_order_and_count(depth_runs):
    # lines 16..19 repeat frames 5, 1, 6, 2 of the left camera (lines 5, 1, 6, 2)
    disps = depth_runs[1]["port"][1]
    for line, frame in zip(range(16, 20), (5, 1, 6, 2)):
        np.testing.assert_allclose(disps[line], disps[frame], rtol=0, atol=1e-6)


@pytest.mark.parametrize("split", ["eigen", "benchmark"])
def test_ext_disp_to_eval_matches(splits_env, tmp_path, split):
    jax_eval = _jax_script("evaluate_depth").evaluate
    rs = np.random.RandomState(3)
    ext = tmp_path / "ext.npy"
    n = len(EIGEN_LINES) if split == "eigen" else 3  # no ground truth for "benchmark"
    np.save(ext, rs.uniform(0.02, 0.5, (n, 24, 80)).astype(np.float32))
    out = {}
    for side in ("port", "jax"):
        folder = tmp_path / side
        folder.mkdir()
        argv = ["--ext_disp_to_eval", str(ext), "--eval_split", split,
                "--load_weights_folder", str(folder)]
        parse = JaxMonodepthOptions().parse if side == "jax" else MonodepthOptions().parse
        out[side] = ((jax_eval if side == "jax" else evaluate_depth.evaluate)(parse(argv)),
                     folder)
    if split == "eigen":
        assert out["port"][0] == out["jax"][0] and set(METRICS) <= out["port"][0].keys()
        return
    assert out["port"][0] is out["jax"][0] is None
    names = sorted(os.listdir(out["port"][1] / "benchmark_predictions"))
    assert names == sorted(os.listdir(out["jax"][1] / "benchmark_predictions"))
    assert names == [f"{i:010d}.png" for i in range(n)]
    for n in names:
        got = np.asarray(Image.open(out["port"][1] / "benchmark_predictions" / n))
        want = np.asarray(Image.open(out["jax"][1] / "benchmark_predictions" / n))
        assert got.dtype == want.dtype and got.shape == (352, 1216)
        np.testing.assert_array_equal(got, want)


def test_eigen_to_benchmark_remap_matches(splits_env, tmp_path):
    jax_eval = _jax_script("evaluate_depth").evaluate
    ext = tmp_path / "ext.npy"
    np.save(ext, np.random.RandomState(4).rand(697, 2, 3).astype(np.float32))
    saved = {}
    for side in ("port", "jax"):
        folder = tmp_path / side
        folder.mkdir()
        argv = ["--ext_disp_to_eval", str(ext), "--eval_eigen_to_benchmark", "--no_eval",
                "--save_pred_disps", "--load_weights_folder", str(folder)]
        parse = JaxMonodepthOptions().parse if side == "jax" else MonodepthOptions().parse
        assert (jax_eval if side == "jax" else evaluate_depth.evaluate)(parse(argv)) is None
        saved[side] = np.load(folder / "disps_eigen_split.npy")
    assert saved["port"].shape == (652, 2, 3)
    np.testing.assert_array_equal(saved["port"], saved["jax"])


def test_mdp_protocol_is_the_evaluate_depth_protocol(splits_env, depth_runs, tmp_path):
    folder = _links(splits_env["weights"], tmp_path / "mdp")
    argv = _depth_argv(splits_env, folder)
    pp, runs = depth_runs
    if pp:
        argv.append("--post_process")
    m = evaluate_depth_gru_fusion.main(["--protocol", "mdp", "--device", "cpu"] + argv)
    assert m == runs["port"][0]
    np.testing.assert_array_equal(np.load(os.path.join(folder, "disps_eigen_split.npy")),
                                  runs["port"][1])


# -------------------------------------------------------------- test_simple


def test_test_simple_matches(simple_runs):
    port, jax = simple_runs["port"], simple_runs["jax"]
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax))
    for i in (0, 3, 6):
        assert {f"frame{i}_disp.npy", f"frame{i}_disp.jpeg"} <= set(names)
        got, want = np.load(port / f"frame{i}_disp.npy"), np.load(jax / f"frame{i}_disp.npy")
        assert got.shape == (1, H, W, 1)
        _assert_close_to_largest(got, want)
        with Image.open(port / f"frame{i}_disp.jpeg") as img:
            assert img.size == (160, 48) and img.mode == "RGB"


# ------------------------------------------------------------ evaluate_pose


def test_evaluate_pose_matches(pose_runs):
    (ate, poses), (jate, jposes) = pose_runs["port"], pose_runs["jax"]
    assert poses.shape == (N_FRAMES - 1, 4, 4)
    _assert_close_to_largest(poses, jposes)
    np.testing.assert_allclose(ate, jate, rtol=1e-5)
    assert all(np.isfinite(ate))


# ---------------------------------------------------- refusals, the device


def test_entry_points_need_the_card_unless_asked_for_the_cpu(splits_env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    folder = _links(splits_env["weights"], tmp_path / "w")
    with pytest.raises(RuntimeError, match="no_cuda"):
        evaluate_depth.main(_depth_argv(splits_env, folder))
    with pytest.raises(RuntimeError, match="no_cuda"):
        test_simple.main(["--image_path", str(tmp_path), "--model_path", folder])
    with pytest.raises(RuntimeError, match="no_cuda"):
        evaluate_pose.main(["--eval_split", "odom_9", "--data_path", splits_env["data"],
                            "--load_weights_folder", folder])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_depth_gru_fusion.main(["--protocol", "mdp"] + _depth_argv(splits_env, folder))
