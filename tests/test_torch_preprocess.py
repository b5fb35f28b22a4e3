"""The port's data path against the JAX package's: the numpy copies
(``data/kitti``, ``data/synthetic``, ``data/pipeline``) held to their
originals bit for bit, and ``data/transforms.preprocess_batch`` with colour
jitter on against the JAX function (NCHW against NHWC). The jitter's HSV
round trip is float32 arithmetic in another order: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssde_tpu.data import kitti as jkitti
from ssde_tpu.data import pipeline as jpipeline
from ssde_tpu.data import synthetic as jsynthetic
from ssde_tpu.data.transforms import preprocess_batch as jax_preprocess
from ssde_tpu_torch.data import kitti, pipeline, synthetic
from ssde_tpu_torch.data.transforms import preprocess_batch

H, W, B = 32, 64, 3
FRAMES = [0, -1, 1]


def test_kitti_host_copies():
    assert np.array_equal(kitti.KITTI_K, jkitti.KITTI_K)
    assert np.array_equal(kitti.IDENTITY_JITTER, jkitti.IDENTITY_JITTER)
    for args in ((0, 0, 0), (3, 2, 17)):
        a, b = kitti.item_rng(*args), jkitti.item_rng(*args)
        assert np.array_equal(kitti.sample_jitter(a), jkitti.sample_jitter(b))
        assert a.random() == b.random()


@pytest.mark.parametrize("is_train", [True, False])
def test_synthetic_kitti_dataset_items(is_train):
    ds = synthetic.SyntheticKittiDataset(H, W, length=6, is_train=is_train,
                                         load_depth=True, seed=4)
    ref = jsynthetic.SyntheticKittiDataset(H, W, length=6, is_train=is_train,
                                           load_depth=True, seed=4)
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ds)):
            a, b = ds[i], ref[i]
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), (epoch, i, k)


def test_collate_batch_and_loader_order():
    a = synthetic.make_synthetic_batch(B, H, W, seed=1)
    b = jsynthetic.make_synthetic_batch(B, H, W, seed=1)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    u8 = [{"x": np.zeros((2, 2), np.uint8)}] * 2
    assert pipeline.collate(u8)["x"].dtype == np.uint8
    ds = synthetic.SyntheticKittiDataset(H, W, length=10)
    for use_processes in (False, True):  # threads, then the fork process pool
        kw = dict(shuffle=True, num_workers=2, seed=7, use_processes=use_processes)
        port, ref = pipeline.Loader(ds, 3, **kw), jpipeline.Loader(ds, 3, **kw)
        assert len(port) == len(ref) == 3
        for epoch in range(2):  # two epochs: the shuffle stream advances alike
            got, want = list(port), list(ref)
            assert len(got) == len(want) == 3, (use_processes, epoch)
            for x, y in zip(got, want):
                assert x.keys() == y.keys()
                assert all(x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in y), \
                    (use_processes, epoch)


def test_loader_surfaces_worker_errors():
    # the port's own rule: the JAX Loader's producer thread dies with the
    # exception and its consumer waits on the queue for ever
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError(f"item {i}")
            return {"x": np.full((2, 2), i, np.float32)}

    for use_processes in (False, True):  # a thread, then a forked process
        got = []
        with pytest.raises(KeyError, match="item 5"):
            for batch in pipeline.Loader(Broken(), 2, shuffle=False, num_workers=1,
                                         use_processes=use_processes):
                got.append(batch["x"][:, 0, 0].tolist())
        assert got == [[0, 1], [2, 3]], use_processes  # the batch of item 5 raised


@pytest.mark.parametrize("uint8", [False, True])
def test_preprocess_batch_with_jitter(uint8):
    batch = synthetic.make_synthetic_batch(B, H, W, seed=2)
    batch["jitter"] = np.array([[1.15, 0.85, 1.1, 0.07], [0.9, 1.2, 0.8, -0.09],
                                [1.0, 1.0, 1.0, 0.0]], np.float32)
    if uint8:
        for i in FRAMES:
            batch[f"color/{i}"] = (batch[f"color/{i}"] * 255).astype(np.uint8)
    kw = dict(pyramid_frames=[0], aug_num_scales=1)
    got = preprocess_batch(pipeline.to_device(batch, "cpu"), H, W, 4, FRAMES, True, **kw)
    want = jax_preprocess({k: jnp.asarray(v) for k, v in batch.items()}, H, W, 4, FRAMES,
                          True, **kw)
    assert got.keys() == want.keys()
    assert "color/0/3" in got and "color/-1/1" not in got and "color_aug/0/1" not in got
    for k, w in want.items():
        g = got[k].numpy()
        if g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-6, err_msg=k)


def test_preprocess_eval_builds_every_pyramid():
    batch = synthetic.make_synthetic_batch(2, H, W, seed=3)
    got = preprocess_batch(pipeline.to_device(batch, "cpu"), H, W, 4, FRAMES, False)
    for i in FRAMES:
        for s in range(4):
            assert got[f"color/{i}/{s}"].shape == (2, 3, H >> s, W >> s)
            assert torch.equal(got[f"color/{i}/{s}"], got[f"color_aug/{i}/{s}"])
