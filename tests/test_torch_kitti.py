"""The port's KITTI data path against the JAX package's, on a written tree.

``ssde_tpu_torch.data`` copies ``splits``, ``kitti_utils``, ``kitti`` and
``sequence`` (the JAX package's ``ssde_tpu.data`` imports JAX), and
``ssde_tpu_torch.native`` builds ``native/velodyne.cpp`` itself. On the
miniature raw + odometry tree of ``tests/test_kitti_tree.py`` (its
``kitti_tree`` writer, imported), every item of every dataset equals the
JAX dataset's at the same seed, epoch and index, exactly: the same numpy
and PIL arithmetic. Velodyne depth maps are equal where both sides take
the same projection (native against native, numpy against numpy) and
within 1e-4 where they do not (``tests/test_native.py``). The trainers'
``_build_data`` give the JAX trainers' first batches, and the depth
metrics of ``val()`` the JAX trainers' numbers at 1e-12 relative.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import ssde_tpu.native
from ssde_tpu.config import Options as JaxOptions
from ssde_tpu.data import kitti as jax_kitti
from ssde_tpu.data import kitti_utils as jax_kitti_utils
from ssde_tpu.data import sequence as jax_sequence
from ssde_tpu.data import splits as jax_splits
from ssde_tpu.train.trainer import Trainer as JaxTrainer
from ssde_tpu.train.trainer_gru import GRUTrainer as JaxGRUTrainer
from ssde_tpu_torch import native
from ssde_tpu_torch.config import Options
from ssde_tpu_torch.data import kitti, kitti_utils, sequence, splits
from ssde_tpu_torch.train.trainer import GARG_CROP, Trainer, depth_metrics
from ssde_tpu_torch.train.trainer_gru import GRUTrainer
from test_kitti_tree import DATE, N_FRAMES, SCENE, kitti_tree  # noqa: F401

H, W = 32, 64


def _assert_items_equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_items_equal(x, y)
        return
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, (int, np.integer)):
        assert a == b
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        return
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------------ splits


@pytest.mark.parametrize("split,which,name", [
    ("eigen_zhou", "train", "train_files.txt"),
    ("eigen_zhou", "train_sequences", "train_sequences.txt"),
    ("eigen_zhou", "val_sequences", "val_sequences.txt"),
    ("odom", "test_files_09", "test_files_09.txt"),
    ("eigen_zhou", "missing", "missing_files.txt"),
])
def test_split_file_resolves_both_conventions(kitti_tree, monkeypatch, split, which, name):
    d = kitti_tree["splits"]
    got = splits.split_file(split, which, splits_dir=d)
    assert got == jax_splits.split_file(split, which, splits_dir=d)
    assert os.path.basename(got) == name
    monkeypatch.setenv("SSDE_SPLITS_DIR", d)
    assert splits.split_file(split, which) == jax_splits.split_file(split, which) == got
    monkeypatch.delenv("SSDE_SPLITS_DIR")
    assert splits.DEFAULT_SPLITS_DIR == jax_splits.DEFAULT_SPLITS_DIR
    assert splits.split_file(split, which) == jax_splits.split_file(split, which)


def test_readlines_and_parse_line(kitti_tree):
    path = splits.split_file("eigen_zhou", "train", splits_dir=kitti_tree["splits"])
    lines = splits.readlines(path)
    assert lines == jax_splits.readlines(path) and len(lines) == 4
    for line in lines + ["09 3 r", "2011_09_26/x"]:
        assert splits.parse_line(line) == jax_splits.parse_line(line)


# ------------------------------------------------------- calib and velodyne


def test_read_calib_file(kitti_tree):
    for name in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt"):
        path = os.path.join(kitti_tree["data"], DATE, name)
        got, want = kitti_utils.read_calib_file(path), jax_kitti_utils.read_calib_file(path)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def velodyne(kitti_tree):
    """(calib dir, a dense scan with points behind the car): 5000 points,
    many of them landing on a pixel another point hits too."""
    rs = np.random.RandomState(7)
    pts = np.zeros((5000, 4), np.float32)
    pts[:, 0] = rs.rand(5000) * 60 + 0.5
    pts[:, 1] = rs.randn(5000) * 8
    pts[:, 2] = rs.randn(5000) * 2
    pts[:500, 0] *= -1
    pts[:, 3] = rs.rand(5000)  # reflectance, replaced by 1 when loaded
    path = os.path.join(kitti_tree["data"], "dense_scan.bin")
    pts.tofile(path)
    return os.path.join(kitti_tree["data"], DATE), path


@pytest.mark.parametrize("cam,vel_depth", [(2, False), (3, False), (2, True)])
def test_generate_depth_map(velodyne, monkeypatch, cam, vel_depth):
    calib, scan = velodyne
    native_map = kitti_utils.generate_depth_map(calib, scan, cam, vel_depth)
    # the JAX package takes its native projection when its library loads
    assert ssde_tpu.native.get_lib() is not None
    np.testing.assert_array_equal(
        native_map, jax_kitti_utils.generate_depth_map(calib, scan, cam, vel_depth))
    # both sides on their numpy projection
    monkeypatch.setattr(kitti_utils, "project_velodyne_native", kitti_utils.project_velodyne_numpy)
    numpy_map = kitti_utils.generate_depth_map(calib, scan, cam, vel_depth)
    monkeypatch.setattr(ssde_tpu.native, "project_velodyne_native", lambda *a, **k: None)
    np.testing.assert_array_equal(
        numpy_map, jax_kitti_utils.generate_depth_map(calib, scan, cam, vel_depth))
    np.testing.assert_allclose(native_map, numpy_map, atol=1e-4, rtol=0)
    assert native_map.shape == (375, 1242) and (native_map > 0).sum() > 100


def test_native_library_is_built_into_the_build_directory():
    lib = native.get_lib()
    assert native.LIBRARY.exists() and native.LIBRARY.parent.name == "ssde_tpu_torch"
    assert native.LIBRARY.parent.parent.name == "build"
    assert lib is native.get_lib()


def test_a_failed_native_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "libssde_native.so")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()


def test_read_odom_poses(kitti_tree):
    path = os.path.join(kitti_tree["data"], "poses", "09.txt")
    got = kitti_utils.read_odom_poses(path)
    np.testing.assert_array_equal(got, jax_kitti_utils.read_odom_poses(path))
    assert got.shape == (N_FRAMES, 4, 4) and got[3, 0, 3] == pytest.approx(1.5)


# ---------------------------------------------------------------- datasets

RAW_LINES = [f"{SCENE} {i} l" for i in (2, 3, 4, 5)] + [
    f"{SCENE} 0 l",                    # frame -1 missing: falls back to frame 0
    f"{SCENE} {N_FRAMES - 1} r",       # frame +1 missing, right camera
]


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_raw_dataset_items_equal(kitti_tree, tmp_path, is_train, stereo, cached):
    ids = [0, -1, 1] + (["s"] if stereo else [])
    kw = dict(is_train=is_train, seed=3)
    got = kitti.KITTIRAWDataset(kitti_tree["data"], RAW_LINES, H, W, ids, **kw,
                                decoded_cache=str(tmp_path / "port") if cached else None)
    want = jax_kitti.KITTIRAWDataset(kitti_tree["data"], RAW_LINES, H, W, ids, **kw,
                                     decoded_cache=str(tmp_path / "jax") if cached else None)
    assert got.load_depth and want.load_depth
    flips = set()
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(RAW_LINES)):
            a, b = got[i], want[i]
            _assert_items_equal(a, b)
            assert a["color/0"].dtype == (np.uint8 if cached else np.float32)
            assert a["depth_gt"].shape == (375, 1242)
            flips.add(bool(np.array_equal(a["color/0"], got.get_color(
                SCENE, int(RAW_LINES[i].split()[1]), RAW_LINES[i][-1], True))))
    assert flips == ({False, True} if is_train else {False})
    if cached:  # the second visit reads the cache
        assert len(os.listdir(tmp_path / "port")) == len(os.listdir(tmp_path / "jax")) > 0
        _assert_items_equal(got[0], want[0])


@pytest.mark.parametrize("is_train", [False, True])
def test_odom_dataset_items_equal(kitti_tree, is_train):
    lines = [f"09 {i} l" for i in range(N_FRAMES)]
    got = kitti.KITTIOdomDataset(kitti_tree["data"], lines, H, W, [0, -1, 1], is_train=is_train)
    want = jax_kitti.KITTIOdomDataset(kitti_tree["data"], lines, H, W, [0, -1, 1],
                                      is_train=is_train)
    assert not got.load_depth
    for i in range(len(lines)):
        _assert_items_equal(got[i], want[i])


def test_depth_dataset_reads_a_16_bit_png(kitti_tree):
    folder = os.path.join(kitti_tree["data"], SCENE, "proj_depth", "groundtruth", "image_02")
    os.makedirs(folder, exist_ok=True)
    rs = np.random.RandomState(4)
    gt = (rs.rand(120, 400) * 80 * 256).astype(np.uint16)
    gt[rs.rand(120, 400) < 0.7] = 0
    Image.fromarray(gt).save(os.path.join(folder, "0000000003.png"))
    lines = [f"{SCENE} 3 l"]
    for is_train in (False, True):
        got = kitti.KITTIDepthDataset(kitti_tree["data"], lines, H, W, [0, -1, 1],
                                      is_train=is_train)
        want = jax_kitti.KITTIDepthDataset(kitti_tree["data"], lines, H, W, [0, -1, 1],
                                           is_train=is_train)
        for epoch in range(3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            a = got[0]
            _assert_items_equal(a, want[0])
            assert a["depth_gt"].shape == (375, 1242) and a["depth_gt"].max() > 1


def test_resize_nn_and_loaders_equal(kitti_tree):
    rs = np.random.RandomState(0)
    img = rs.rand(50, 70).astype(np.float32)
    for shape in ((50, 70), (375, 1242), (20, 33)):
        np.testing.assert_array_equal(kitti._resize_nn(img, shape),
                                      jax_kitti._resize_nn(img, shape))
    path = os.path.join(kitti_tree["data"], SCENE, "image_02", "data", "0000000001.jpg")
    for flip in (False, True):
        np.testing.assert_array_equal(kitti.pil_load_resized(path, W, H, flip),
                                      jax_kitti.pil_load_resized(path, W, H, flip))
        np.testing.assert_array_equal(kitti.load_resized_uint8(path, W, H, flip),
                                      jax_kitti.load_resized_uint8(path, W, H, flip))


# --------------------------------------------------------------- sequences


@pytest.mark.parametrize("n,k,n_tuples,seed", [(2, 2, 10, 0), (3, 2, 1, 5), (1, 0, 60, 2)])
def test_generate_frame_tuples(kitti_tree, n, k, n_tuples, seed):
    n_frames = sequence.count_scene_frames([SCENE], kitti_tree["data"])
    assert n_frames == jax_sequence.count_scene_frames([SCENE], kitti_tree["data"])
    assert n_frames[SCENE] == N_FRAMES
    got = sequence.generate_frame_tuples(n_frames, [SCENE, SCENE], n, k, n_tuples, seed)
    assert got and got == jax_sequence.generate_frame_tuples(
        n_frames, [SCENE, SCENE], n, k, n_tuples, seed)


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_seq_dataset_items_equal(kitti_tree, tmp_path, is_train, cached):
    n_frames = {SCENE: N_FRAMES}
    tuples = sequence.generate_frame_tuples(n_frames, [SCENE], 2, 2, 10)
    kw = dict(is_train=is_train, seed=1)
    got = sequence.KITTISeqDataset(kitti_tree["data"], tuples, H, W, 2, **kw,
                                   decoded_cache=str(tmp_path / "p") if cached else None)
    want = jax_sequence.KITTISeqDataset(kitti_tree["data"], tuples, H, W, 2, **kw,
                                        decoded_cache=str(tmp_path / "j") if cached else None)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(tuples)):
            a = got[i]
            _assert_items_equal(a, want[i])
            assert a["color/0"].shape == (2, H, W, 3) and a["depth_gt"].shape == (2, 375, 1242)


def test_pair_and_scene_datasets_equal(kitti_tree):
    config = {"height": H, "width": W, "data_path": kitti_tree["data"]}
    lines = [f"{SCENE} 2 l", f"{SCENE} 5 l", f"{SCENE} 4 l"]
    got = sequence.KITTIImagePairDataset(config, lines, is_train=True)
    want = jax_sequence.KITTIImagePairDataset(config, lines, is_train=True)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(lines)):
            _assert_items_equal(got[i], want[i])
    for test_frames in (None, [1, 4]):
        got = sequence.KITTISceneDataset(config, SCENE, test_frames)
        want = jax_sequence.KITTISceneDataset(config, SCENE, test_frames)
        assert len(got) == len(want) == N_FRAMES
        for i in range(N_FRAMES):
            _assert_items_equal(got[i], want[i])


# ----------------------------------------------------------- trainer data


def _bare(cls, opt):
    """A trainer with only its options: the data layer alone, no models."""
    t = object.__new__(cls)
    t.opt = opt
    return t


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_mono_trainer_build_data_gives_the_jax_batch(kitti_tree, monkeypatch, tmp_path,
                                                     stereo, cached):
    monkeypatch.setenv("SSDE_SPLITS_DIR", kitti_tree["splits"])
    kw = dict(synthetic_data=False, data_path=kitti_tree["data"], use_stereo=stereo,
              height=H, width=W, batch_size=2, num_workers=2, split="eigen_zhou")
    got = _bare(Trainer, Options(**kw, decoded_cache=str(tmp_path / "p") if cached else None))
    # the JAX package's decoded cache names its temporary file by process
    # only (ROADMAP Queue 3): two of its threads writing one frame collide,
    # the loader's producer thread dies and the loader waits forever. So
    # with a cache the reference decodes on one thread a loader, and its
    # validation loader (started while the training loader's producer still
    # prefetches) writes a cache of its own. Neither changes a batch.
    ref_kw = {**kw, "num_workers": 1} if cached else kw
    want = _bare(JaxTrainer,
                 JaxOptions(**ref_kw, decoded_cache=str(tmp_path / "j") if cached else None))
    got._build_data()
    want._build_data()
    if cached:
        want.val_dataset.decoded_cache = str(tmp_path / "j_val")
    assert got._frame_idxs() == want._frame_idxs()
    assert ("s" in got._frame_idxs()) == stereo
    for loader in ("train_loader", "val_loader"):
        a, b = next(iter(getattr(got, loader))), next(iter(getattr(want, loader)))
        _assert_items_equal(a, b)
        assert a["depth_gt"].shape == (2, 375, 1242)
        assert ("color/s" in a and "stereo_T" in a) == stereo


def test_gru_trainer_build_data_gives_the_jax_batch(kitti_tree, monkeypatch):
    monkeypatch.setenv("SSDE_SPLITS_DIR", kitti_tree["splits"])
    kw = dict(synthetic_data=False, data_path=kitti_tree["data"], height=H, width=W,
              batch_size=2, num_workers=2, len_sequence=2, split="eigen_zhou")
    got, want = _bare(GRUTrainer, Options(**kw)), _bare(JaxGRUTrainer, JaxOptions(**kw))
    got._build_data()
    want._build_data()
    assert got.train_dataset.sequences == want.train_dataset.sequences
    assert len(got.train_dataset) == 3
    for loader in ("train_loader", "val_loader"):
        a, b = next(iter(getattr(got, loader))), next(iter(getattr(want, loader)))
        _assert_items_equal(a, b)
        assert a["color/0"].shape == (2, 2, H, W, 3) and a["depth_gt"].shape == (2, 2, 375, 1242)


# ----------------------------------------------------------- depth metrics


def _depth_case(n, seed):
    rs = np.random.RandomState(seed)
    depth = rs.uniform(0.5, 90, (n, 48, 160)).astype(np.float32)
    gt = rs.uniform(1, 80, (n, 375, 1242)).astype(np.float32)
    gt[rs.rand(n, 375, 1242) < 0.9] = 0
    return depth, gt


def test_mono_depth_metrics_match_jax():
    depth, gt = _depth_case(3, 0)
    gt[1] = 0  # an image without ground truth is skipped
    got = object.__new__(Trainer).compute_depth_losses(
        {"depth_gt": gt}, {"depth/0/0": torch.from_numpy(depth)[:, None]})
    want = JaxTrainer.compute_depth_losses(
        object.__new__(JaxTrainer), {"depth_gt": gt}, {"depth/0/0": depth[..., None]})
    assert list(got) == list(want) == ["de/abs_rel", "de/sq_rel", "de/rms", "de/log_rms",
                                       "da/a1", "da/a2", "da/a3"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    assert depth_metrics(depth[:1], np.zeros((1, 375, 1242), np.float32)) == {}


def test_gru_depth_metrics_match_jax():
    """(B, T) ground truth against the B*T depths, B-major."""
    depth, gt = _depth_case(6, 1)
    gt = gt.reshape(2, 3, 375, 1242)
    got = object.__new__(GRUTrainer).compute_depth_losses(
        {"depth_gt": gt}, {"depth/0/0": torch.from_numpy(depth)[:, None]})
    want = object.__new__(JaxGRUTrainer).compute_depth_losses(
        {"depth_gt": gt}, {"depth/0/0": depth[..., None]})
    assert got.keys() == want.keys() and len(got) == 7
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    # the Garg crop: ground truth outside it counts for nothing
    outside = np.zeros((1, 375, 1242), np.float32)
    outside[0, :GARG_CROP[0]] = 10.0
    assert depth_metrics(depth[:1], outside) == {}


def test_decoded_cache_takes_concurrent_writers_of_one_frame(kitti_tree, tmp_path,
                                                              monkeypatch):
    """The loader's threads decode a frame that several items of a batch
    share at the same time; each writes its own temporary file before the
    atomic rename, so none finds its file renamed away by another. (A slow
    np.save holds every write open long enough for the threads to meet.)"""
    import time
    from concurrent.futures import ThreadPoolExecutor

    save = np.save

    def slow_save(f, arr):
        time.sleep(0.01)
        save(f, arr)

    monkeypatch.setattr(np, "save", slow_save)
    path = os.path.join(kitti_tree["data"], SCENE, "image_02", "data", "0000000002.jpg")
    want = jax_kitti.load_resized_uint8(path, W, H, False)
    for trial in range(4):
        cache = str(tmp_path / f"c{trial}")
        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(lambda _: kitti.load_resized_uint8(path, W, H, False, cache),
                                range(64)))
        assert all(np.array_equal(g, want) for g in got)
        assert len(os.listdir(cache)) == 1
