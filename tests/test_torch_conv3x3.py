"""The port's conv3x3 twin against the Pallas kernel it replaces.

``ssde_tpu_torch.ops.conv3x3.conv3x3_reference`` (F.pad + F.conv2d + act,
the CPU path of the CUDA kernel's wrapper) is held against
``ssde_tpu/ops/pallas/conv3x3.py`` run in interpret mode on the same numpy
inputs, for both pad modes, every act and bias present or absent. The CUDA
kernel itself is held against the twin on the card by chip_smoke.py.
Tolerance 1e-5: both sides are f32 sums of at most 9*Cin products.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssde_tpu.ops.pallas.conv3x3 import conv3x3 as pallas_reflect
from ssde_tpu.ops.pallas.conv3x3 import conv3x3_zero_chain
from ssde_tpu_torch.ops import build
from ssde_tpu_torch.ops.conv3x3 import ACTS, conv3x3, conv3x3_reference

B, CIN, COUT, H = 2, 5, 7, 6
TOL = 1e-5


def _inputs(width, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, CIN, H, width).astype(np.float32)
    w = (rng.randn(COUT, CIN, 3, 3) / np.sqrt(9 * CIN)).astype(np.float32)
    b = rng.randn(COUT).astype(np.float32)
    return x, w, b


def _planar(x):  # NCHW -> the Pallas kernel's (B, H, C, W)
    return jnp.asarray(x.transpose(0, 2, 1, 3))


def _hwio(w):
    return jnp.asarray(w.transpose(2, 3, 1, 0))


def _port(x, w, b, pad, act):
    bt = None if b is None else torch.from_numpy(b)
    return conv3x3(torch.from_numpy(x), torch.from_numpy(w), bt, pad, act).numpy()


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("pad", ["zero", "reflect"])
def test_twin_matches_pallas_kernel(pad, act, bias):
    launches = conv3x3.launches
    if pad == "zero":
        # physical width 128 (the kernel's lane multiple); logical widths 128
        # and 100 (chain padding: columns past wl are zero fill and the
        # kernel treats column wl-1 as the right edge)
        x, w, b = _inputs(128)
        for wl in (128, 100):
            xz = x.copy()
            xz[..., wl:] = 0.0
            got = conv3x3_zero_chain(_planar(xz), _hwio(w),
                                     jnp.asarray(b) if bias else None, act,
                                     wl=wl, interpret=True)
            got = np.asarray(got).transpose(0, 2, 1, 3)[..., :wl]
            want = _port(np.ascontiguousarray(xz[..., :wl]), w,
                         b if bias else None, pad, act)
            np.testing.assert_allclose(want, got, atol=TOL, rtol=0,
                                       err_msg=f"wl={wl}")
    else:
        x, w, b = _inputs(40)  # any width: the wrapper pads lanes to 128
        bj = jnp.asarray(b if bias else np.zeros_like(b))
        got = np.asarray(pallas_reflect(_planar(x), _hwio(w), bj, act,
                                        interpret=True)).transpose(0, 2, 1, 3)
        want = _port(x, w, b if bias else None, pad, act)
        np.testing.assert_allclose(want, got, atol=TOL, rtol=0)
    assert conv3x3.launches == launches  # CPU tensors never launch the kernel


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, b = (torch.from_numpy(a) for a in _inputs(8))
    with pytest.raises(ValueError):
        conv3x3(x, w, b, "circular", "none")
    with pytest.raises(ValueError):
        conv3x3(x, w, b, "zero", "gelu")
    with pytest.raises(TypeError):
        conv3x3(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        conv3x3(x.transpose(2, 3), w, b)  # not contiguous
    with pytest.raises(ValueError):
        conv3x3(x, w[:, :2].contiguous(), b)  # Cin mismatch
    with pytest.raises(ValueError):
        conv3x3(x[:, :, :1].contiguous(), w, b, "reflect")  # reflect needs H >= 2
    # a device with no kernel raises instead of running the twin
    with pytest.raises(ValueError):
        conv3x3(x.to("meta"), w.to("meta"), b.to("meta"))
    assert torch.equal(conv3x3(x, w, b, "reflect", "tanh"),
                       conv3x3_reference(x, w, b, "reflect", "tanh"))


def test_build_without_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
