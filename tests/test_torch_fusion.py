"""The 3-frame attention-fusion models of the port in serving against the
JAX package, on the CPU.

* Each block against its JAX module at 32x64 (B=2, float32):
  ``FeatureFusionBlock`` (the scale-loop block), ``FeatureFusionBlock_v2``
  (the initial block, a block above scale 1 and the scale-1 block; its
  ``upscale_1``/``upscale_2`` convs precede a PixelShuffle, so a wrong
  channel order would change the output), ``FeatureFusionBlock_v3`` with
  attention on and off, with and without ``init_scale``, and the chains
  ``Fusion`` and ``Fusion_v3`` on per-frame dicts of decoder outputs.
  Every output within 1e-4 of its largest value. The JAX attention runs its
  plain streaming path (tests/test_torch_gru_family.py says why); the
  port's attention units take their kernel path, whose CPU version is the
  plain attend3 (held to the kernel on the card by tests/test_torch_cuda.py
  and ``chip_smoke.py`` phase 22).
* Where the parameters come from: the port's seeded init, saved as
  ``fusion.pth`` and read by the JAX package's ``convert_fusion_v2``, the
  path of a reference checkpoint into the JAX package; the JAX modules run
  jitted. The JAX init of the attention chains costs 13-24 s each on a
  CPU with a cold compile cache (pyramid, v3; eager or jitted), which
  would take this file past its time budget, so the JAX init reaches the
  port through ``fusion_from_flax`` for the two cheap chains, the
  scale-loop block (attention units with shared embeddings, the depth
  head) and ``Fusion_v3`` with conv units (``conv_1``, the conv units,
  the ``upscale`` convs): loaded strictly and run against the JAX module.
* The layout of ``fusion.pth``: the port's ``state_dict``, through
  ``convert_fusion_v2``, gives the key tree and shapes of the flax init
  (``jax.eval_shape``) for every variant, and ``fusion_from_flax`` gives
  the state dict back.
* ``scripts/evaluate_depth_fusion`` of the port against the JAX script
  (``scripts/evaluate_depth_fusion.py``, loaded from its file) for
  ``pyramid``, ``v3``, ``v3 --disable_attention`` and ``scale_loop``, on
  the miniature raw tree of ``tests/test_kitti_tree.py`` at 64x128, with a
  split list and ``gt_depths.npz`` (the port's export) under a temporary
  directory. The weights are a ``.pth`` folder that the port's
  ``save_folder`` writes from seeded models with random BatchNorm
  statistics. The JAX script reads only ``.ckpt`` folders and skips a
  missing file silently (``ssde_tpu/checkpoint.py:68-71``), so it gets
  the same weights as a ``.ckpt`` folder made by the JAX package's
  ``load_monodepth2_checkpoint`` and ``save_checkpoint``. The scaled
  disparities within 1e-4 of their largest, the 7 metrics 1e-4 relative,
  NaN where the JAX script gives NaN (the pyramid's and the scale loop's
  disparities are not sigmoids, so a depth can be negative).
* The script needs the card unless ``--no_cuda``; a folder without
  ``fusion.pth`` raises.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax

from ssde_tpu.checkpoint import (_load_torch_state_dict, convert_fusion_v2,
                                 load_monodepth2_checkpoint, save_checkpoint)
from ssde_tpu.models import fusion as jax_fusion
from ssde_tpu_torch import checkpoint
from ssde_tpu_torch.config import Options
from ssde_tpu_torch.models import fusion
from ssde_tpu_torch.models.common import init_weights_
from ssde_tpu_torch.models.resnet import randomize_bn_stats_
from ssde_tpu_torch.scripts import evaluate_depth_fusion, export_gt_depth
from ssde_tpu_torch.train.steps_fusion import build_fusion_models
from test_kitti_tree import N_FRAMES, SCENE, kitti_tree  # noqa: F401

BH, BW, B = 32, 64, 2  # the blocks' size
H, W = 64, 128  # the scripts'
DEC_CH = (16, 32, 64, 128)  # the decoder's pre-disp channels at scales 0-3
METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every frame of the left camera, one batch of the loader's 8; the first two
# have no previous frames, which fall back to the centre frame
TEST_LINES = [f"{SCENE} {i} l" for i in range(N_FRAMES)]
# (variant, extra arguments) of the script runs
RUNS = {"pyramid": ("pyramid", []), "v3": ("v3", []),
        "v3_no_attention": ("v3", ["--disable_attention"]), "scale_loop": ("scale_loop", [])}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_gru_step.py (which says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_plain_paths(monkeypatch):
    """The JAX modules on their plain CPU paths."""
    for env in ("SSDE_CONV_INTERPRET", "SSDE_ATTN_KERNEL"):
        monkeypatch.delenv(env, raising=False)


def _nchw(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _assert_close_to_largest(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _leaves(tree):
    return {jax.tree_util.keystr(p): tuple(np.shape(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _to_jax(module, tmp_path, block=False):
    """``module``'s state_dict as fusion.pth, read by the JAX converter. A
    ``block`` of ``Fusion``/``Fusion_v3`` goes in as ``fusion_block_1``,
    whose tree is returned: the converter reads the entries outside the
    residual units and the depth head only under that prefix."""
    sd = module.state_dict()
    if block:
        sd = {f"fusion_block_1.{k}": v for k, v in sd.items()}
    path = tmp_path / "fusion.pth"
    torch.save(sd, path)
    tree = convert_fusion_v2(_load_torch_state_dict(str(path)))
    return tree["fusion_block_1"] if block else tree


def _seeded(module, seed):
    init_weights_(module, torch.Generator().manual_seed(seed))
    return module.eval()


def _frames(rs, sigmoid):
    """Three per-frame dicts of decoder outputs at BHxBW: sigmoid
    disparities (1 channel) or pre-disp features (DEC_CH)."""
    def one():
        return {f"disp/{s}": (rs.rand(B, BH >> s, BW >> s, 1) if sigmoid else
                              rs.randn(B, BH >> s, BW >> s, DEC_CH[s])).astype(np.float32)
                for s in range(4)}
    return one(), one(), one()


def _chain_args(chain, seed=0):
    """The NHWC inputs of a chain: three per-frame dicts, or the scale-loop
    block's (dt, upt, dt_1, dt_2) at scale 0."""
    rs = np.random.RandomState(seed)
    frames = _frames(rs, chain != "pyramid")
    if chain == "scale_loop":
        return tuple(frames[j]["disp/0"] for j in (0, 0, 1, 2))
    return frames


# the chains: (JAX module, port module)
CHAINS = {"pyramid": (lambda: jax_fusion.Fusion(), lambda: fusion.Fusion()),
          "v3": (lambda: jax_fusion.Fusion_v3(attention=True),
                 lambda: fusion.Fusion_v3(attention=True)),
          "v3_conv": (lambda: jax_fusion.Fusion_v3(attention=False),
                      lambda: fusion.Fusion_v3(attention=False)),
          "scale_loop": (lambda: jax_fusion.FeatureFusionBlock(2),
                         lambda: fusion.FeatureFusionBlock(2))}


def _block(case):
    """(JAX block, port block, NHWC inputs) of a block case, at the scale
    where its chain runs it."""
    rs = np.random.RandomState(1)
    x = lambda s, c: rs.randn(B, BH >> s, BW >> s, c).astype(np.float32)  # noqa: E731
    if case == "scale_loop":
        return (jax_fusion.FeatureFusionBlock(2), fusion.FeatureFusionBlock(2),
                [x(0, 1) for _ in range(4)])
    if case.startswith("v2_"):
        n = {"v2_init": 1, "v2_scale4": 2, "v2_scale1": 4}[case]
        feat, scale, init = fusion.FUSION_SPECS[n - 1]
        s, c = 4 - n, DEC_CH[4 - n]
        return (jax_fusion.FeatureFusionBlock_v2(feat, scale, init_scale=init),
                fusion.FeatureFusionBlock_v2(feat, scale, init),
                [x(s, c), None if init else x(s, c), x(s, c), x(s, c)])
    attention, init = "conv" not in case, case.endswith("init")
    return (jax_fusion.FeatureFusionBlock_v3(2, attention=attention, init_scale=init),
            fusion.FeatureFusionBlock_v3(2, attention, init_scale=init),
            [x(1, 1), None if init else x(1, 1), x(1, 1), x(1, 1)])


@pytest.mark.parametrize("case", ["scale_loop", "v2_init", "v2_scale4", "v2_scale1",
                                  "v3_attention", "v3_attention_init", "v3_conv",
                                  "v3_conv_init"])
def test_block_matches_jax(case, tmp_path):
    jax_block, block, ins = _block(case)
    block = _seeded(block, 10)
    params = _to_jax(block, tmp_path, block=case != "scale_loop")
    want = jax.jit(jax_block.apply)({"params": params}, *ins)
    with torch.no_grad():
        got = block(*(_nchw(a) for a in ins))
    assert len(got) == len(want) == 2
    if case == "v2_scale1":
        assert got[1] is None and want[1] is None
    for g, w in zip(got, want):
        if w is not None:
            _assert_close_to_largest(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2))
    if case.startswith("v2_"):  # every depth of the pyramid is at full resolution
        assert got[0].shape == (B, 1, BH, BW)


@pytest.mark.parametrize("chain", ["pyramid", "v3", "v3_conv"])
def test_chain_matches_jax(chain, tmp_path):
    make_jax, make_port = CHAINS[chain]
    module = _seeded(make_port(), 11)
    frames = _chain_args(chain)
    want = jax.jit(make_jax().apply)({"params": _to_jax(module, tmp_path)}, *frames)
    with torch.no_grad():
        got = module(*({k: _nchw(v) for k, v in f.items()} for f in frames))
    assert sorted(got) == sorted(want) == [f"disp/{s}" for s in range(4)]
    for k in want:
        _assert_close_to_largest(got[k].numpy(), np.asarray(want[k]).transpose(0, 3, 1, 2))
        full = chain == "pyramid" or k == "disp/0"
        assert got[k].shape[2:] == ((BH, BW) if full else (BH >> int(k[-1]), BW >> int(k[-1])))


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_fusion_pth_is_the_reference_layout(chain, tmp_path):
    """The port's state_dict as fusion.pth, read by the JAX converter, has
    the flax init's keys and shapes; fusion_from_flax gives it back."""
    make_jax, make_port = CHAINS[chain]
    module = make_port()
    tree = _to_jax(module, tmp_path)
    shapes = jax.eval_shape(make_jax().init, jax.random.PRNGKey(0), *_chain_args(chain))
    assert _leaves(tree) == _leaves(shapes["params"])
    back, sd = checkpoint.fusion_from_flax(tree), module.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("chain", ["scale_loop", "v3_conv"])
def test_the_jax_init_loads_into_the_port(chain):
    """fusion_from_flax of the JAX init (the shared relative embeddings'
    (3,) leaves, conv units, conv_1, the upscale conv) loads strictly, and
    the port then computes what the JAX module computes."""
    make_jax, make_port = CHAINS[chain]
    args = _chain_args(chain, seed=2)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(make_jax().init)(jax.random.PRNGKey(3), *args))
    module = make_port()
    module.load_state_dict(checkpoint.fusion_from_flax(params["params"]))
    want = jax.jit(make_jax().apply)(params, *args)
    nchw = [({k: _nchw(v) for k, v in a.items()} if isinstance(a, dict) else _nchw(a))
            for a in args]
    with torch.no_grad():
        got = module(*nchw)
    if isinstance(want, dict):
        got, want = [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]
    for g, w in zip(got, want):
        _assert_close_to_largest(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2))


# ------------------------------------------------------------- the script


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_script_evaluate_depth_fusion",
        os.path.join(REPO, "scripts", "evaluate_depth_fusion.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _jax_init_placeholders():
    """``init_fusion_params``, as the JAX script calls it, gives a
    placeholder (None) for each module. The script runs it eagerly, op by
    op, and then replaces each module's entry whole with the loaded
    folder's (flax's ``from_bytes`` of a None template returns the stored
    tree), so its values never reach the outputs; a placeholder left in
    place would fail loudly."""
    from ssde_tpu.train import steps_fusion as jax_steps_fusion

    def placeholders(models, rng, inputs):
        return ({n: None for n in ("encoder", "depth", "fusion", "pose_encoder", "pose")},
                {n: None for n in ("encoder", "pose_encoder")})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps_fusion, "init_fusion_params", placeholders)
        yield


@pytest.fixture(scope="module")
def setup(kitti_tree, tmp_path_factory):  # noqa: F811
    """The tree, the split list and its gt_depths.npz, and per variant a
    .pth folder (the port's) and the same weights as a .ckpt folder (the
    JAX script's)."""
    root = tmp_path_factory.mktemp("fusion_eval")
    splits = root / "splits"
    (splits / "eigen").mkdir(parents=True)
    (splits / "eigen" / "test_files.txt").write_text("\n".join(TEST_LINES) + "\n")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSDE_SPLITS_DIR", str(splits))
        export_gt_depth.main(["--data_path", kitti_tree["data"], "--split", "eigen"])
    weights = {}
    for seed, name in enumerate(("pyramid", "v3", "scale_loop")):
        opts = Options(height=H, width=W)
        gen = torch.Generator().manual_seed(seed)
        models = build_fusion_models(opts, name, "cpu", gen)
        randomize_bn_stats_(models.encoder, gen)
        pth, ckpt = str(root / f"{name}_pth"), str(root / f"{name}_ckpt")
        checkpoint.save_folder(pth, models, height=H, width=W)
        params, stats, _ = load_monodepth2_checkpoint(pth)
        save_checkpoint(ckpt, params, stats, height=H, width=W)
        weights[name] = pth, ckpt
    # v3's conv units: the same encoder and decoder, a fusion.pth of its own
    models = build_fusion_models(Options(height=H, width=W, disable_attention=True), "v3",
                                 "cpu", torch.Generator().manual_seed(3))
    pth, ckpt = str(root / "v3_no_attention_pth"), str(root / "v3_no_attention_ckpt")
    os.makedirs(pth)
    for f in ("encoder.pth", "depth.pth"):
        os.symlink(os.path.join(weights["v3"][0], f), os.path.join(pth, f))
    torch.save(models.fusion.state_dict(), os.path.join(pth, "fusion.pth"))
    params, stats, _ = load_monodepth2_checkpoint(pth)
    save_checkpoint(ckpt, params, stats, height=H, width=W)
    weights["v3_no_attention"] = pth, ckpt
    return {"data": kitti_tree["data"], "splits": str(splits), "weights": weights}


def _argv(setup, folder, extra):
    return ["--data_path", setup["data"], "--height", str(H), "--width", str(W),
            "--num_workers", "2", "--load_weights_folder", folder, *extra]


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request, setup):
    """(run, {side: (metrics, scaled disparities)})."""
    variant, extra = RUNS[request.param]
    pth, ckpt = setup["weights"][request.param]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSDE_SPLITS_DIR", setup["splits"])
        for side, module in (("port", evaluate_depth_fusion), ("jax", _jax_script())):
            seen = []
            original = module.evaluate_depth_predictions

            def record(pred_disps, *args, **kw):
                seen.append(np.array(pred_disps))
                return original(pred_disps, *args, **kw)

            mp.setattr(module, "evaluate_depth_predictions", record)
            argv = ["--fusion_variant", variant,
                    *_argv(setup, pth if side == "port" else ckpt, extra)]
            if side == "port":
                metrics = module.main(argv + ["--no_cuda"])
            else:
                mp.setattr(sys, "argv", ["evaluate_depth_fusion.py", *argv])
                metrics = module.main()
            out[side] = metrics, seen[0]
    return request.param, out


def test_evaluate_depth_fusion_matches_the_jax_script(runs, capsys):
    run, out = runs
    (metrics, disps), (jax_metrics, jax_disps) = out["port"], out["jax"]
    assert disps.shape == (len(TEST_LINES), H, W) and disps.dtype == np.float32
    assert np.isfinite(disps).all()
    _assert_close_to_largest(disps, jax_disps)
    for k in METRICS:
        assert np.isnan(metrics[k]) == np.isnan(jax_metrics[k]), (run, k)
        if not np.isnan(jax_metrics[k]):
            np.testing.assert_allclose(metrics[k], jax_metrics[k], rtol=1e-4, err_msg=k)


def test_the_script_needs_the_card_unless_no_cuda(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SSDE_SPLITS_DIR", setup["splits"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        evaluate_depth_fusion.main(_argv(setup, setup["weights"]["v3"][0], []))


def test_a_folder_without_fusion_pth_raises(setup, tmp_path, monkeypatch):
    monkeypatch.setenv("SSDE_SPLITS_DIR", setup["splits"])
    for f in ("encoder.pth", "depth.pth"):
        os.symlink(os.path.join(setup["weights"]["v3"][0], f), tmp_path / f)
    with pytest.raises(FileNotFoundError, match="fusion.pth"):
        evaluate_depth_fusion.main(_argv(setup, str(tmp_path), ["--no_cuda"]))
