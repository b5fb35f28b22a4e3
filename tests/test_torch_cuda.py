"""The hand-written CUDA conv3x3 kernel against its plain twin, on the card.

These tests need a CUDA card (sm_90a) and nvcc, and skip elsewhere. They
import no JAX and run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest imports JAX.) chip_smoke.py
checks the kernel at the slice's 640x192 shapes, which its 32x16 output
tile divides evenly; the shapes here are the ragged ones: widths and
heights the tile does not divide, channel counts off the 8-channel input
stage and the 16-channel output chunk, and reflect padding at its 2-pixel
minimum. Bounds as in chip_smoke.py: float32 1e-4 relative to max|ref|,
bfloat16 1e-2 against the float32 twin on the same bf16-rounded inputs.
"""

import itertools

import pytest
import torch

from ssde_tpu_torch.ops.conv3x3 import ACTS, conv3x3, conv3x3_reference

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the twin in full float32
    yield torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.allow_tf32 = tf32


def _inputs(dev, B, cin, cout, h, w, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, cin, h, w, device=dev, generator=g)
    wt = torch.randn(cout, cin, 3, 3, device=dev, generator=g) / (3 * cin ** 0.5)
    b = torch.randn(cout, device=dev, generator=g) * 0.1
    return x, wt, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", ["zero", "reflect"])
@pytest.mark.parametrize("B,cin,cout,h,w", [
    (1, 3, 1, 2, 2),        # reflect minimum, one output channel
    (2, 5, 17, 7, 37),      # nothing divides: Cin % 8, Cout % 16, H % 16, W % 32
    (1, 32, 96, 16, 128),   # scale-0 x-conv widths at test resolution
    (2, 64, 192, 9, 64),    # scale-1 x-conv widths, ragged rows
    (3, 8, 16, 33, 31),
])
def test_kernel_matches_twin(dev, B, cin, cout, h, w, pad, dtype):
    x, wt, b = _inputs(dev, B, cin, cout, h, w)
    with torch.inference_mode():
        for act, has_b in itertools.product(ACTS, (True, False)):
            xi, wi, bi = x.to(dtype), wt.to(dtype), b.to(dtype) if has_b else None
            got = conv3x3(xi, wi, bi, pad, act)
            want = conv3x3_reference(xi.float(), wi.float(),
                                     None if bi is None else bi.float(), pad, act)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == want.shape
            rel = ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-12)).item()
            assert rel <= TOL[dtype], (act, has_b, rel)


def test_launches_on_the_current_stream(dev):
    x, wt, b = _inputs(dev, 2, 8, 16, 20, 40)
    want = conv3x3_reference(x, wt, b, "zero", "elu")
    before = conv3x3.launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode(), torch.cuda.stream(side):
        got = conv3x3(x, wt, b, "zero", "elu")
    side.synchronize()
    assert conv3x3.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_cuda_inputs_raise_instead_of_falling_back(dev):
    x, wt, b = _inputs(dev, 1, 8, 16, 8, 8)
    before = conv3x3.launches
    with pytest.raises(RuntimeError, match="no backward"):
        conv3x3(x, wt.requires_grad_(), b)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3(x.transpose(2, 3), wt.detach(), b)
    with pytest.raises(ValueError, match="one device"):
        conv3x3(x, wt.detach().cpu(), b)
    with pytest.raises(TypeError):
        conv3x3(x.half(), wt.detach().half(), b.half())
    assert conv3x3.launches == before
