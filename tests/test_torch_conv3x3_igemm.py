"""The bf16 tensor-core conv's operand layout, on the CPU.

The bf16 forward kernel (``csrc/conv3x3_tc.cu``) is an implicit GEMM: the
weights packed by ``pack_weights`` (N_pad, 9, Cin_pad; tap-major, ci-minor,
zero-filled to the kernel's channel multiples) against the tap stack of the
input, which the kernel never writes out. ``conv3x3_igemm_reference`` is
that arithmetic in plain torch (the packed weights against ``F.unfold`` of
the padded input, in the kernel's K order). It is held here against
``conv3x3_reference`` (the plain version the main path's tests use) and
against the Pallas kernel it replaces, ``ssde_tpu/ops/pallas/conv3x3.py``
``conv3x3`` (reflect) and ``conv3x3_zero_chain`` (zero) in interpret mode,
through the planar layout, on the same numpy inputs: both pads, every act,
Cin in {3, 5, 32} and Cout in {1, 17, 96}. Tolerance 1e-5 absolute on O(1)
outputs: every side sums at most 9 * 32 float32 products.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against ``conv3x3_reference`` there.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssde_tpu.ops.pallas.conv3x3 import conv3x3 as pallas_reflect
from ssde_tpu.ops.pallas.conv3x3 import conv3x3_zero_chain
from ssde_tpu_torch.ops.conv3x3 import (ACTS, PADS, conv3x3, conv3x3_igemm_reference,
                                        conv3x3_reference, dw_tile_m, fwd_tiles, pack_weights)

B, H = 2, 6
TOL = 1e-5
CINS, COUTS = (3, 5, 32), (1, 17, 96)


def _inputs(cin, cout, width, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, cin, H, width).astype(np.float32)
    w = (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    return x, w, b


def _igemm(x, w, b, pad, act):
    cout, cin = w.shape[:2]
    wp = pack_weights(torch.from_numpy(w), *fwd_tiles(cin, cout))
    bt = None if b is None else torch.from_numpy(b)
    return conv3x3_igemm_reference(torch.from_numpy(x), wp, cout, bt, pad, act).numpy()


@pytest.mark.parametrize("cin,cout", [(3, 1), (5, 17), (32, 96)])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("pad", PADS)
def test_implicit_gemm_matches_pallas_kernel(pad, act, cin, cout):
    planar = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    hwio = lambda a: jnp.asarray(a.transpose(2, 3, 1, 0))  # noqa: E731
    if pad == "zero":
        # the chain variant at physical width 128 and logical width 100:
        # columns past wl are zero fill and column wl-1 is the right edge
        x, w, b = _inputs(cin, cout, 128)
        x[..., 100:] = 0.0
        got = conv3x3_zero_chain(planar(x), hwio(w), jnp.asarray(b), act, wl=100,
                                 interpret=True)
        got = np.asarray(got).transpose(0, 2, 1, 3)[..., :100]
        x = np.ascontiguousarray(x[..., :100])
    else:
        x, w, b = _inputs(cin, cout, 40)
        got = np.asarray(pallas_reflect(planar(x), hwio(w), jnp.asarray(b), act,
                                        interpret=True)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_igemm(x, w, b, pad, act), got, atol=TOL, rtol=0)


@pytest.mark.parametrize("cin,cout", list(itertools.product(CINS, COUTS)))
def test_implicit_gemm_matches_plain_conv(cin, cout):
    x, w, b = _inputs(cin, cout, 37, seed=cin * cout)
    for pad, act, bias in itertools.product(PADS, ACTS, (True, False)):
        bb = b if bias else None
        want = conv3x3_reference(*(None if a is None else torch.from_numpy(a)
                                   for a in (x, w, bb)), pad, act).numpy()
        np.testing.assert_allclose(_igemm(x, w, bb, pad, act), want, atol=TOL, rtol=0,
                                   err_msg=f"{pad} {act} bias={bias}")


@pytest.mark.parametrize("cin,cout", [(3, 1), (5, 17), (32, 96), (64, 192), (1, 32)])
def test_packed_weights_layout(cin, cout):
    """K = tap * Cin_pad + ci with tap = 3 ky + kx; zeros past Cout and Cin;
    N_pad and Cin_pad are multiples of the kernel's BN and CC."""
    w = torch.randn(cout, cin, 3, 3)
    cc, bn = fwd_tiles(cin, cout)
    wp = pack_weights(w, cc, bn)
    n_pad, taps, cin_pad = wp.shape
    assert taps == 9 and n_pad % bn == 0 and cin_pad % cc == 0
    assert n_pad - bn < cout <= n_pad and cin_pad - cc < cin <= cin_pad
    for co, ci, ky, kx in itertools.product(range(cout), range(cin), range(3), range(3)):
        assert wp[co, 3 * ky + kx, ci] == w[co, ci, ky, kx]
    assert not wp[cout:].any() and not wp[:, :, cin:].any()
    assert wp.dtype == w.dtype


def test_tile_choices():
    # (CC, BN) of the forward: K steps of 16, n8 fragments; 96 = 3 x 32
    assert [fwd_tiles(cin, cout) for cin, cout in
            ((32, 1), (1, 32), (32, 96), (64, 192), (64, 128), (5, 17), (192, 64))] == [
        (32, 8), (16, 32), (32, 32), (32, 64), (32, 64), (16, 32), (32, 64)]
    # output channels per block of the bf16 weight gradient; 1 = the head path
    assert [dw_tile_m(c) for c in (1, 17, 32, 64, 96, 128, 192)] == [1, 32, 32, 64, 32, 64, 64]


def test_wrapper_rejects_a_grid_the_bf16_kernel_cannot_launch():
    """gridDim.z = B x output-channel blocks must stay within 65535: B =
    65536 images of one channel is one block each (BN = 8), so it raises
    on the CPU already, before any card would refuse it."""
    x = torch.zeros(65536, 1, 1, 2, dtype=torch.bfloat16)
    w = torch.zeros(1, 1, 3, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="grid"):
        conv3x3(x, w)
    conv3x3(x[:65535].contiguous(), w)  # the largest batch the grid takes
