"""The Monodepth2 options that reach the loss, port against the JAX
package, on the CPU, in float64 on both sides: ``--pose_model_input all``,
``--predictive_mask --disable_automasking``, ``--v1_multiscale`` and
``--no_ssim --avg_reprojection``, by tests/test_torch_mono_options.py's
recipe and bounds (the loss 1e-9 relative, every gradient and BatchNorm
running statistic 1e-6 of its tensor's max, the automask argmin pinned).
"""

import ctypes
import gc

import jax
import pytest

from test_torch_attention_encoder import _jax_plain_paths  # noqa: F401
from test_torch_mono_options import (_RUNS, _one_torch_thread,  # noqa: F401
                                     check_batch_stats, check_gradients, check_loss)

HELD = ("pose_input_all", "predictive_mask", "v1_multiscale", "no_ssim_avg")


@pytest.fixture(autouse=True, scope="module")
def _release_runs():
    """Drop the cached runs of this file's configurations and JAX's
    compiled steps when it ends, and return the memory (as in
    tests/test_torch_mono_options.py)."""
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
