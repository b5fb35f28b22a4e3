"""The port's copies of host-side JAX-package code against their originals.

``ssde_tpu_torch.config`` (``Options``, ``MonodepthOptions``) and
``ssde_tpu_torch.eval.depth`` (the eigen protocol and the flip post-process
that the evaluation scripts use) are copies, so that the port imports nothing of ``ssde_tpu``. The
fields, defaults, flags and choices must stay the original's, and the
metrics must give the original's numbers (1e-12 relative: the same numpy
arithmetic).
"""

import dataclasses

import numpy as np
import pytest

from ssde_tpu import config as jax_config
from ssde_tpu.eval import depth as jax_depth
from ssde_tpu_torch import config
from ssde_tpu_torch.eval import depth


def _defaults(cls):
    return {f.name: (f.type, f.default if f.default is not dataclasses.MISSING
                     else f.default_factory()) for f in dataclasses.fields(cls)}


def test_options_fields_and_defaults_match():
    assert _defaults(config.Options) == _defaults(jax_config.Options)
    assert config._CHOICES == jax_config._CHOICES
    assert config.Options().num_scales == jax_config.Options().num_scales == 4


@pytest.mark.parametrize("argv", [
    [],
    ["--no_cuda"],
    ["--gru_version", "v10", "--synthetic_data", "--batch_size", "8", "--len_sequence", "3"],
    ["--scales", "0", "1", "--frame_ids", "0", "-1", "1", "--split", "odom"],
    ["--models_to_load", "encoder", "depth", "--load_weights_folder", "w", "--png"],
    ["--num_layers", "50", "--compute_dtype", "float32", "--learning_rate", "3e-4",
     "--h_s_epoch", "0", "--gru_lr_decay", "--warp_backend", "gather"],
])
def test_parse_matches(argv):
    assert dataclasses.asdict(config.MonodepthOptions().parse(argv)) == \
        dataclasses.asdict(jax_config.MonodepthOptions().parse(argv))


@pytest.mark.parametrize("argv", [["--split", "bogus"], ["--num_layers", "19"],
                                  ["--compute_dtype", "float16"], ["--no_such_flag"]])
def test_parse_refuses_what_the_original_refuses(argv):
    for mod in (config, jax_config):
        with pytest.raises(SystemExit):
            mod.MonodepthOptions().parse(argv)


def test_options_save_and_load_round_trip(tmp_path):
    opt = config.MonodepthOptions().parse(["--no_cuda", "--scales", "0", "2"])
    opt.save(str(tmp_path / "opt.json"))
    assert jax_config.Options.load(str(tmp_path / "opt.json")) == \
        jax_config.Options(**dataclasses.asdict(opt))
    assert config.Options.load(str(tmp_path / "opt.json")) == opt


def test_depth_metrics_match():
    rng = np.random.RandomState(0)
    gt, pred = rng.uniform(1, 80, 500), rng.uniform(1, 80, 500)
    np.testing.assert_allclose(depth.compute_errors(gt, pred),
                               jax_depth.compute_errors(gt, pred), rtol=1e-12)
    disp = rng.uniform(0.01, 1, (48, 160))
    np.testing.assert_allclose(depth.disp_to_eval_depth(disp, (90, 300)),
                               jax_depth.disp_to_eval_depth(disp, (90, 300)), rtol=1e-12)


@pytest.mark.parametrize("kw", [{}, {"eval_split": "eigen_benchmark"}, {"eval_split": "odom_9"},
                                {"disable_median_scaling": True, "pred_depth_scale_factor": 5.4}])
def test_evaluate_depth_predictions_matches(kw):
    rng = np.random.RandomState(1)
    disps = rng.uniform(0.01, 0.5, (3, 48, 160)).astype(np.float32)
    gts = [np.where(rng.rand(90, 300) < 0.3, 0.0, rng.uniform(1, 85, (90, 300)))
           .astype(np.float32) for _ in range(3)]
    got = depth.evaluate_depth_predictions(disps, gts, **kw)
    want = jax_depth.evaluate_depth_predictions(disps, gts, **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("shape", [(3, 48, 160), (1, 7, 5)])
def test_batch_post_process_disparity_matches(shape):
    rng = np.random.RandomState(2)
    left, right = rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)
    got = depth.batch_post_process_disparity(left, right[:, :, ::-1])
    np.testing.assert_array_equal(
        got, jax_depth.batch_post_process_disparity(left, right[:, :, ::-1]))
    assert got.shape == shape
    assert depth.STEREO_SCALE_FACTOR == jax_depth.STEREO_SCALE_FACTOR == 5.4
