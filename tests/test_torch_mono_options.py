"""The Monodepth2 training options of the mono step, port against the JAX
package, on the CPU, in float64 on both sides.

One configuration a case: here MS (``--use_stereo``, frames 0 -1 1), S
(``--use_stereo --frame_ids 0``: no pose network), ``posecnn`` and
``shared``; in tests/test_torch_mono_options_loss.py ``--pose_model_input
all``, ``--predictive_mask --disable_automasking``, ``--v1_multiscale``
and ``--no_ssim --avg_reprojection`` (a file takes about two minutes on
one worker with a cold compile cache, most of it XLA's). Each runs the
same seeded numpy batch (per-pixel noise frames, ``stereo_T``, jitter on)
and the same weights through the JAX ``preprocess_batch`` and
``mono_loss_fn`` (``ssde_tpu/train/steps.py:579``) under ``jax.grad`` and
through the port's ``preprocess_train``, ``mono_loss_fn`` and backward, at
64x128, B=2, ``rng=None``, flax's two-pass batch variance, the JAX step's
float32 casts and its float32 grayscale weights read as float64
(tests/test_torch_fusion_step.py's recipe).

The weights: the JAX bundle's tree from ``jax.eval_shape`` of
``init_mono_params`` (no JAX init runs), filled with seeded float32 values
held as float64, carried into the port by ``encoder_from_flax``,
``depth_from_flax`` (also the mask decoder), ``pose_decoder_from_flax``
(also the shared decoder) and ``pose_cnn_from_flax``.

Bounds: the loss and each ``loss/{s}`` 1e-9 relative; every gradient, and
every BatchNorm running statistic after the step, 1e-6 of its tensor's
max. The automask argmin is pinned: the port runs first and records the
source each pixel's minimum takes at each scale, and the JAX step takes
the same (where two errors nearly tie, the two sides' rounding can pick
different ones, and the gradient follows the pick). The JAX step's own
argmin is returned beside it and may differ at no more than 1e-4 of the
pixels.

Also: ``PoseCNN`` against the flax module at 32x64 (float64, outputs 1e-9
of max); ``pose_cnn_from_flax`` of an ``eval_shape`` tree loading strictly;
the synthetic stereo item; a ``save_folder``/``load_folder`` round trip of
a PoseCNN bundle and of a predictive-mask bundle, bit-identical;
``train_dpt.main()`` with ``--use_stereo`` on the miniature KITTI tree of
tests/test_kitti_tree.py (both cameras), 2 steps under ``tmp_path``; and
the DPT step warping from "s" under ``--use_stereo``.
"""

import ctypes
import functools
import gc
import os

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.config import Options as JaxOptions
from ssde_tpu.data import synthetic as jsynthetic
from ssde_tpu.data.transforms import preprocess_batch as jax_preprocess
from ssde_tpu.models.pose import PoseCNN as FlaxPoseCNN
from ssde_tpu.train.steps import build_mono_models as jax_build_mono_models
from ssde_tpu.train.steps import init_mono_params
from ssde_tpu.train.steps import mono_loss_fn as jax_mono_loss_fn
from ssde_tpu_torch import checkpoint
from ssde_tpu_torch.config import Options
from ssde_tpu_torch.data import synthetic
from ssde_tpu_torch.data.kitti import KITTI_K
from ssde_tpu_torch.models import PoseCNN
from ssde_tpu_torch.scripts import train_dpt
from ssde_tpu_torch.train import steps
from test_kitti_tree import kitti_tree  # noqa: F401
from test_torch_attention_encoder import _Float64Numpy, _jax_plain_paths  # noqa: F401

H, W, B = 64, 128, 2
# label: the options of one configuration
CONFIGS = {
    "ms": dict(use_stereo=True),
    "s": dict(use_stereo=True, frame_ids=[0]),
    "posecnn": dict(pose_model_type="posecnn"),
    "shared": dict(pose_model_type="shared"),
    "pose_input_all": dict(pose_model_input="all"),
    "predictive_mask": dict(predictive_mask=True, disable_automasking=True),
    "v1_multiscale": dict(v1_multiscale=True),
    "no_ssim_avg": dict(no_ssim=True, avg_reprojection=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_mono_step.py (which says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy().copy()


def _fill(shapes, seed):
    """An eval_shape tree filled with seeded float32 values held as float64:
    kernels N(0, 1/fan_in), BatchNorm scales 1 + N(0, 0.1^2), variances in
    [0.5, 1.5), everything else N(0, 0.05^2)."""
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name, shape = jax.tree_util.keystr(path), s.shape
        if name.endswith("['var']"):
            v = rs.uniform(0.5, 1.5, shape)
        elif name.endswith("['scale']"):
            v = 1 + 0.1 * rs.randn(*shape)
        elif name.endswith("['kernel']"):
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.05 * rs.randn(*shape)
        return v.astype(np.float32).astype(np.float64)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_trees(models, params, stats):
    """(module name, port module, the JAX tree's state_dict for it) of every
    module of the port's bundle."""
    out = []
    for name in ("encoder", "depth", "pose_encoder", "pose", "predictive_mask"):
        module = getattr(models, name)
        if module is None:
            continue
        if name in ("encoder", "pose_encoder"):
            sd = checkpoint.encoder_from_flax(params[name], stats[name])
        elif name in ("depth", "predictive_mask"):
            sd = checkpoint.depth_from_flax(params[name], models.opts.scales)
        elif isinstance(module, PoseCNN):
            sd = checkpoint.pose_cnn_from_flax(params[name])
        else:
            sd = checkpoint.pose_decoder_from_flax(params[name])
        out.append((name, module, sd))
    return out


def _batch(label, rng):
    ids = steps.frame_ids(Options(**CONFIGS[label]))
    batch = {f"color/{i}": rng.rand(B, H, W, 3) for i in ids}
    batch["K"] = np.stack([KITTI_K] * B).astype(np.float64)
    batch["jitter"] = np.array([[1.1, 0.9, 1.15, 0.05], [0.85, 1.1, 0.9, -0.07]])
    if "s" in ids:  # KITTI's baseline, left and right camera
        batch["stereo_T"] = np.stack([np.eye(4)] * B)
        batch["stereo_T"][:, 0, 3] = [-0.1, 0.1]
    return ids, batch


class _PinnedNumpy(_Float64Numpy):
    """``jax.numpy`` as :class:`_Float64Numpy`, with the minimum over the
    last axis that the automask takes (``jnp.min`` and ``jnp.argmin`` over
    [identity, reprojection], ``ssde_tpu/train/steps.py:528-551`` and
    ``ops/losses.py:128-129``) at the index of ``pinned``, one array a call
    in call order; ``natural`` gets the argmin of the JAX step's own
    numbers, traced, for the loss function to return."""

    def __init__(self, pinned):
        self.pinned, self.natural, self.idx = iter(pinned), [], None

    def min(self, x, axis=None, keepdims=False):
        if axis != -1 or not keepdims:
            return jnp.min(x, axis=axis, keepdims=keepdims)
        self.idx = jnp.asarray(next(self.pinned))
        self.natural.append(jnp.argmin(x, axis=-1, keepdims=True))
        return jnp.take_along_axis(x, self.idx, axis=-1)

    def argmin(self, x, axis=None, keepdims=False):
        return self.idx


def _recording(record):
    """``steps.min_reprojection`` that records its argmin over [identity,
    reprojection] (B, H, W, 1) wherever there is more than one map."""
    plain = steps.min_reprojection

    def select(reproj, ident, generator=None):
        combined = reproj if ident is None else torch.cat([ident, reproj], 1)
        if combined.shape[1] > 1:
            record.append(_np(torch.argmin(combined, 1, keepdim=True)).transpose(0, 2, 3, 1))
        return plain(reproj, ident, generator)
    return select


_RUNS = {}


def _run(label, monkeypatch):
    """One step of ``label`` on both sides, cached as numpy: both sides'
    losses, gradients and BatchNorm running statistics in the port's
    layout (``losses``, ``grads``, ``stats``; the JAX ones ``j*``), the
    modules the port built, the pixels where the JAX step's own automask
    argmin differs from the port's and of how many (``flips``, ``pixels``),
    and the JAX gradients of modules the port does not build (``unused``).
    The port runs first and records its automask argmin; the JAX step takes
    it (:class:`_PinnedNumpy`)."""
    if label in _RUNS:
        return _RUNS[label]
    import ssde_tpu.data.transforms
    import ssde_tpu.ops.image
    import ssde_tpu.ops.losses
    import ssde_tpu.ops.warp
    import ssde_tpu.train.steps

    opts = Options(height=H, width=W, batch_size=B, compute_dtype="float32", **CONFIGS[label])
    jopts = JaxOptions(height=H, width=W, batch_size=B, compute_dtype="float32",
                       **CONFIGS[label])
    rng = np.random.RandomState(5)
    ids, batch = _batch(label, rng)
    v1 = bool(opts.v1_multiscale)

    monkeypatch.setattr(flax.linen, "BatchNorm",
                        functools.partial(flax.linen.BatchNorm, use_fast_variance=False))
    # the jitter's grayscale weights, a float32 constant made at import
    monkeypatch.setattr(ssde_tpu.data.transforms, "_GRAY_W", np.array([0.2989, 0.5870, 0.1140]))
    with jax.enable_x64(True):
        jm = jax_build_mono_models(jopts)
        inputs = jax_preprocess({k: jnp.asarray(v) for k, v in batch.items()}, H, W, 4, ids,
                                is_train=True, pyramid_frames=None if v1 else [0],
                                aug_num_scales=None if v1 else 1)
        shapes = jax.eval_shape(lambda: init_mono_params(jm, jax.random.PRNGKey(0), inputs))
    params, stats = _fill(shapes, 13)

    models = steps.build_mono_models(opts, "cpu", torch.Generator().manual_seed(0))
    for _, module, sd in _port_trees(models, params, stats):
        module.load_state_dict(sd, strict=True)
        module.double()
    tinputs = steps.preprocess_train({k: torch.from_numpy(v) for k, v in batch.items()}, opts)
    models.train()
    picked = []
    monkeypatch.setattr(steps, "min_reprojection", _recording(picked))
    _, losses, outputs = steps.mono_loss_fn(models, tinputs)
    losses["loss"].backward()

    pinned = _PinnedNumpy(picked)
    for mod in (ssde_tpu.train.steps, ssde_tpu.ops.losses):
        monkeypatch.setattr(mod, "jnp", pinned)
    for mod in (ssde_tpu.ops.warp, ssde_tpu.ops.image):
        monkeypatch.setattr(mod, "jnp", _Float64Numpy())

    def loss_fn(p):
        pinned.natural.clear()
        loss, (new_stats, jlosses, _) = jax_mono_loss_fn(jm, p, stats, inputs, None, True)
        return loss, (new_stats, jlosses, list(pinned.natural))

    with jax.enable_x64(True):
        fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (_, (jstats, jlosses, natural)), jgrads = fn(jax.tree.map(jnp.asarray, params))
        jlosses, jgrads, jstats, natural = jax.tree.map(np.asarray,
                                                        (jlosses, jgrads, jstats, natural))
    # the JAX gradients and statistics in the port's layout, float64 kept
    monkeypatch.setattr(checkpoint, "_t", lambda a: torch.from_numpy(np.array(a, np.float64)))
    trees = {name: (module, sd) for name, module, sd in _port_trees(models, jgrads, stats)}
    jtrees = {name: sd for name, _, sd in _port_trees(models, params, jstats)
              if name in ("encoder", "pose_encoder")}
    monkeypatch.undo()
    assert len(natural) == len(picked) and next(pinned.pinned, None) is None
    running = lambda sd: {k: _np(v) for k, v in sd.items() if "running" in k}  # noqa: E731
    _RUNS[label] = {
        "losses": {k: float(v.detach()) for k, v in losses.items()},
        "jlosses": {k: float(v) for k, v in jlosses.items()},
        "grads": {n: {k: _np(p.grad) for k, p in m.named_parameters()}
                  for n, (m, _) in trees.items()},
        "jgrads": {n: {k: _np(v) for k, v in sd.items()} for n, (_, sd) in trees.items()},
        "stats": {n: running(trees[n][0].state_dict()) for n in jtrees},
        "jstats": {n: running(sd) for n, sd in jtrees.items()},
        "flips": sum(int((a != b).sum()) for a, b in zip(natural, picked)),
        "pixels": sum(a.size for a in picked),
        "unused": {k: jgrads[k] for k in set(jgrads) - set(trees)},
    }
    return _RUNS[label]


def check_loss(label, monkeypatch):
    run = _run(label, monkeypatch)
    losses, jlosses = run["losses"], run["jlosses"]
    assert set(losses) == set(jlosses) == {"loss"} | {f"loss/{s}" for s in range(4)}
    for k in jlosses:
        assert np.isfinite(jlosses[k]), k
        np.testing.assert_allclose(losses[k], jlosses[k], rtol=1e-9, err_msg=k)
    # the JAX step's own automask argmin differs from the port's at near-ties only
    assert run["pixels"] and run["flips"] <= 1e-4 * run["pixels"], (run["flips"], run["pixels"])


def check_gradients(label, monkeypatch):
    run = _run(label, monkeypatch)
    for name, got in run["grads"].items():
        want = run["jgrads"][name]
        assert got.keys() <= want.keys() and got, name
        for k, g in got.items():
            w = want[k]
            assert np.abs(w).max() > 0, f"{name}.{k}"
            np.testing.assert_allclose(g, w, atol=1e-6 * np.abs(w).max(), rtol=0,
                                       err_msg=f"{name}.{k}")
    # the JAX bundle builds pose networks for stereo alone and never runs them
    assert sorted(run["unused"]) == (["pose", "pose_encoder"] if label == "s" else [])
    for tree in run["unused"].values():
        assert all(not np.any(v) for v in jax.tree_util.tree_leaves(tree))


def check_batch_stats(label, monkeypatch):
    run = _run(label, monkeypatch)
    assert set(run["jstats"]) == {"encoder"} | ({"pose_encoder"} & set(run["grads"]))
    for name, want in run["jstats"].items():
        got = run["stats"][name]
        assert got.keys() == want.keys(), name
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=1e-6 * np.abs(w).max(), rtol=0,
                                       err_msg=f"{name}.{k}")


# the configurations held here; the others in tests/test_torch_mono_options_loss.py
HELD = ("ms", "s", "posecnn", "shared")


@pytest.fixture(autouse=True, scope="module")
def _release_runs():
    """Drop the cached runs of this file's configurations and JAX's
    compiled steps when it ends, and return the memory: a parallel run
    keeps each worker's process for the files that follow."""
    yield
    for label in HELD:
        _RUNS.pop(label, None)
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL(None).malloc_trim(0)  # hand the freed heap back to the system


@pytest.mark.parametrize("label", HELD)
def test_loss_matches_jax(label, monkeypatch):
    check_loss(label, monkeypatch)


@pytest.mark.parametrize("label", HELD)
def test_gradients_match_jax(label, monkeypatch):
    check_gradients(label, monkeypatch)


@pytest.mark.parametrize("label", HELD)
def test_batch_stats_match_jax(label, monkeypatch):
    check_batch_stats(label, monkeypatch)


def test_bundles_follow_the_options():
    """Which modules each configuration builds, its warp sources and, for
    the mask, its channels (``ssde_tpu/train/steps.py:51-98``)."""
    want = {"ms": ("ResnetEncoder", "PoseDecoder", None, [-1, 1, "s"]),
            "s": (None, None, None, ["s"]),
            "posecnn": (None, "PoseCNN", None, [-1, 1]),
            "shared": (None, "PoseDecoder", None, [-1, 1]),
            "pose_input_all": ("ResnetEncoder", "PoseDecoder", None, [-1, 1]),
            "predictive_mask": ("ResnetEncoder", "PoseDecoder", 2, [-1, 1])}
    for label, (pe, pose, mask, sources) in want.items():
        m = steps.build_mono_models(Options(height=H, width=W, **CONFIGS[label]), "cpu")
        name = lambda x: None if x is None else type(x).__name__  # noqa: E731
        assert (name(m.pose_encoder), name(m.pose)) == (pe, pose), label
        assert (None if m.predictive_mask is None else
                m.predictive_mask.decoder[-1].conv.out_channels) == mask, label
        assert list(m.source_ids) == sources, label
    all3 = steps.build_mono_models(Options(height=H, width=W, pose_model_input="all"), "cpu")
    assert all3.pose_encoder.encoder.conv1.in_channels == 9
    shared = steps.build_mono_models(Options(height=H, width=W, pose_model_type="shared"), "cpu")
    assert shared.pose.net[1].in_channels == 2 * 256 and shared.pose.num_frames == 1
    with pytest.raises(ValueError, match="disable_automasking"):
        steps.build_mono_models(Options(predictive_mask=True), "cpu")


def test_pose_cnn_matches_flax():
    """PoseCNN of 2 and 3 frames at 32x64, float64, from a filled eval_shape
    tree through pose_cnn_from_flax (strict): the outputs within 1e-9 of
    their max."""
    rs = np.random.RandomState(3)
    for n in (2, 3):
        x = rs.rand(B, 32, 64, 3 * n)
        fmod = FlaxPoseCNN(num_input_frames=n)
        with jax.enable_x64(True):
            shapes = jax.eval_shape(lambda: fmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
            params = _fill(shapes, 7 + n)["params"]
            want = fmod.apply({"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x))
        port = PoseCNN(n)
        port.load_state_dict(checkpoint.pose_cnn_from_flax(params), strict=True)
        port.double()
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape == (B, n - 1, 1, 3)
            np.testing.assert_allclose(_np(g), w, atol=1e-9 * np.abs(w).max(), rtol=0)
        assert sorted(port.state_dict()) == sorted(
            [f"net.{i}.{k}" for i in range(7) for k in ("weight", "bias")]
            + ["pose_conv.weight", "pose_conv.bias"])
    with pytest.raises(KeyError, match="unexpected"):
        checkpoint.pose_cnn_from_flax({"dense": {}})


def test_synthetic_stereo_items():
    """With "s" among the frames the port's synthetic items carry
    stereo_T and a stereo frame one pixel on from frame 0; the temporal
    frames, K and jitter are the JAX generator's."""
    ids = [0, -1, 1, "s"]
    ds = synthetic.SyntheticKittiDataset(H, W, length=3, frame_idxs=ids, seed=2)
    ref = jsynthetic.SyntheticKittiDataset(H, W, length=3, frame_idxs=ids, seed=2)
    for i in range(3):
        a, b = ds[i], ref[i]
        assert set(a) - set(b) == {"stereo_T"}
        for k in b:
            assert np.array_equal(a[k], b[k]) == (k != "color/s"), (i, k)
        np.testing.assert_array_equal(a["stereo_T"], synthetic.LEFT_STEREO_T)
        assert a["stereo_T"][0, 3] == -0.1
    assert "stereo_T" not in synthetic.SyntheticKittiDataset(H, W, length=1)[0]


@pytest.mark.parametrize("label,kw", [
    ("posecnn", dict(pose_model_type="posecnn")),
    ("predictive_mask", dict(predictive_mask=True, disable_automasking=True)),
])
def test_save_load_round_trip(label, kw, tmp_path):
    """save_folder of a seeded bundle, load_folder into a bundle of another
    seed: every tensor bit-identical, pose.pth a PoseCNN's and
    predictive_mask.pth beside the rest."""
    opts = Options(height=H, width=W, **kw)
    a = steps.build_mono_models(opts, "cpu", torch.Generator().manual_seed(0))
    b = steps.build_mono_models(opts, "cpu", torch.Generator().manual_seed(1))
    checkpoint.save_folder(str(tmp_path), a, height=H, width=W)
    files = sorted(os.listdir(tmp_path))
    _, loaded = checkpoint.load_folder(str(tmp_path), b)
    assert files == sorted(f"{n}.pth" for n in loaded)
    want = {"posecnn": ["encoder", "depth", "pose"],
            "predictive_mask": ["encoder", "depth", "pose_encoder", "pose", "predictive_mask"]}
    assert loaded == want[label]
    for name in loaded:
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
    if label == "posecnn":
        assert "pose_conv.weight" in torch.load(tmp_path / "pose.pth", weights_only=True)


def test_train_dpt_main_stereo_on_a_kitti_tree(kitti_tree, tmp_path, monkeypatch):  # noqa: F811
    """train_dpt.main() --model monodepth2 --use_stereo on the miniature
    KITTI tree (image_02 and image_03): the data carry color/s and
    stereo_T, 2 steps with finite losses, weights_0 with the four modules
    and use_stereo in encoder.pth."""
    monkeypatch.setenv("SSDE_SPLITS_DIR", kitti_tree["splits"])
    trainer = train_dpt.main(
        ["--model", "monodepth2", "--use_stereo", "--data_path", kitti_tree["data"],
         "--height", "32", "--width", "64", "--batch_size", "2", "--num_epochs", "1",
         "--num_workers", "1", "--compute_dtype", "float32", "--log_frequency", "1",
         "--mono_pretrained", "0", "--no_cuda", "--log_dir", str(tmp_path)])
    assert trainer.step == 2 and trainer.state.step == 2
    assert list(trainer.models.source_ids) == [-1, 1, "s"]
    item = trainer.train_dataset[0]  # its baseline's sign flips with the image
    assert "color/s" in item and abs(item["stereo_T"][0, 3]) == pytest.approx(0.1)
    folder = tmp_path / "mdp" / "models" / "weights_0"
    assert sorted(os.listdir(folder)) == ["adam.pth", "depth.pth", "encoder.pth", "pose.pth",
                                          "pose_encoder.pth"]
    assert int(torch.load(folder / "encoder.pth", weights_only=True)["use_stereo"]) == 1
    history = trainer.val()
    assert np.isfinite(history["loss"])


def test_dpt_step_warps_from_the_stereo_source():
    """Under --use_stereo the DPT step warps from "s" too
    (ssde_tpu/train/steps_dpt.py:35-40): three sources at scale 0, so the
    photometric error takes G = 6B pairs; the loss is finite."""
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.train import steps_dpt

    opts = Options(height=H, width=W, batch_size=B, compute_dtype="float32", use_stereo=True,
                   frame_ids=[0, -1, 1], scales=[0])
    models = steps_dpt.build_dpt_models(opts, "cpu", torch.Generator().manual_seed(0))
    assert tuple(models.source_ids) == (-1, 1, "s")
    assert tuple(steps_dpt.build_dpt_models(Options(height=H, width=W), "cpu").source_ids) == (
        -1, 1)
    batch = synthetic.make_synthetic_batch(B, H, W, steps.frame_ids(opts), seed=3)
    models.train()
    with torch.no_grad():
        loss, _, outputs = steps_dpt.dpt_loss_fn(
            models, steps.preprocess_train(to_device(batch, "cpu"), opts))
    assert np.isfinite(float(loss)) and outputs["color_planar/s"].shape == (B, 3, H, W)
