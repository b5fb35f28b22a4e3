"""The gradient of the port's conv3x3 against the Pallas VJPs it replaces.

On the CPU ``conv3x3`` is ``conv3x3_reference`` under ordinary autograd,
which is the plain version of both backward kernels (the forward kernel as
dx, and the weight-gradient kernel #2). It is held against ``jax.vjp`` of
``conv3x3_zero`` (zero pad) and ``conv3x3`` (reflect pad) from
``ssde_tpu/ops/pallas/conv3x3.py`` in interpret mode, which run
``_conv_rows`` as dx and ``_dw_call`` as dW: dx, dw and db, all five acts,
bias on and off, a ragged width (40, padded to 128 lanes on the JAX side)
and a 2-pixel-high map (where the reflect folds of rows 1 and H-2 land on
rows 1 and 0). Tolerance 1e-5 of each gradient's max: both sides sum at
most B*H*W = 480 float32 products.

The backward's host-side assembly (``conv3x3_backward``: act' from the
output, the 180-degree rotation, db, the reflect folds and their corners)
is held against autograd of the plain forward in float64, with the plain
versions in the kernels' place, at 1e-10 of max.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.ops.pallas.conv3x3 import conv3x3 as pallas_reflect
from ssde_tpu.ops.pallas.conv3x3 import conv3x3_zero as pallas_zero
from ssde_tpu_torch.ops.conv3x3 import (ACTS, conv3x3, conv3x3_backward, conv3x3_dw,
                                        conv3x3_dw_reference, conv3x3_dx, conv3x3_reference,
                                        dw_partitions, rot_w)

B, CIN, COUT, W = 2, 5, 7, 40
TOL = 1e-5


def _inputs(h, w, cin=CIN, cout=COUT, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, cin, h, w).astype(dtype)
    wt = (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(dtype)
    b = rng.randn(cout).astype(dtype)
    g = rng.randn(B, cout, h, w).astype(dtype)
    return x, wt, b, g


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0, err_msg=what)


@pytest.mark.parametrize("pad,height,act,bias", [
    *(("zero", 6, act, True) for act in ACTS), ("zero", 6, "relu", False),
    *(("reflect", 6, act, True) for act in ACTS), ("reflect", 6, "none", False),
    ("reflect", 2, "sigmoid", True), ("reflect", 2, "none", False)])
def test_gradients_match_pallas_vjp(pad, height, act, bias):
    x, w, b, g = _inputs(height, W)
    planar = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    fn = pallas_zero if pad == "zero" else pallas_reflect
    bj = jnp.asarray(b if bias else np.zeros_like(b))

    def jax_fn(xx, ww, bb):
        return fn(xx, ww, bb if (bias or pad == "reflect") else None, act, interpret=True)

    jdx, jdw, jdb = jax.jit(lambda *a: jax.vjp(jax_fn, *a[:3])[1](a[3]))(
        planar(x), jnp.asarray(w.transpose(2, 3, 1, 0)), bj, planar(g))

    xt, wt = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True) if bias else None
    launches = (conv3x3.launches, conv3x3_dx.launches, conv3x3_dw.launches)
    conv3x3(xt, wt, bt, pad, act).backward(torch.from_numpy(g))
    assert (conv3x3.launches, conv3x3_dx.launches, conv3x3_dw.launches) == launches

    _close(xt.grad, np.asarray(jdx).transpose(0, 2, 1, 3), TOL, "dx")
    _close(wt.grad, np.asarray(jdw).transpose(3, 2, 0, 1), TOL, "dw")
    if bias:
        _close(bt.grad, jdb, TOL, "db")


def _plain_dx(gp, w):
    return conv3x3_reference(gp, rot_w(w))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("pad,shape", [
    ("zero", (6, 11, CIN, COUT)), ("reflect", (6, 11, CIN, COUT)),
    ("reflect", (2, 9, CIN, COUT)), ("reflect", (5, 2, CIN, COUT)),
    ("reflect", (7, 10, 4, 1)), ("zero", (7, 10, 1, 4))])
def test_backward_assembly_matches_autograd(pad, shape, act):
    """The head's case is here: Cout = 1, so its dx is a conv from 1 channel."""
    h, w_, cin, cout = shape
    x, w, b, g = (torch.from_numpy(a) for a in _inputs(h, w_, cin, cout, 1, np.float64))
    xt, wt, bt = (t.clone().requires_grad_() for t in (x, w, b))
    out = conv3x3_reference(xt, wt, bt, pad, act)
    out.backward(g)
    dx, dw, db = conv3x3_backward(x, w, out.detach(), g, pad, act, dx_fn=_plain_dx,
                                  dw_fn=conv3x3_dw_reference)
    for got, want, name in ((dx, xt.grad, "dx"), (dw, wt.grad, "dw"), (db, bt.grad, "db")):
        assert got.dtype == torch.float64, name
        _close(got, want, 1e-10, name)
    none = conv3x3_backward(x, w, out.detach(), g, pad, act, dx_fn=_plain_dx,
                            dw_fn=conv3x3_dw_reference, needs=(False, False, False))
    assert none == (None, None, None)


def test_backward_assembly_keeps_the_input_dtype():
    """bf16 operands: gp, dx and dw come back in the operands' dtype, dw
    accumulated in float32 by the plain version."""
    x, w, b, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(4, 6))
    out = conv3x3_reference(x, w, b, "reflect", "sigmoid")
    dx, dw, db = conv3x3_backward(x, w, out, g, "reflect", "sigmoid")
    assert dx.dtype == dw.dtype == db.dtype == torch.bfloat16
    assert conv3x3_dw(x, g).dtype == torch.float32
    assert dx.shape == x.shape and dw.shape == w.shape and db.shape == b.shape


def test_dw_partitions():
    # bf16 (the tensor-core kernels): GRU v10 scale 0 at B=8 (640x192), the
    # cell's x conv 32 -> 96 has 3 x 1 channel blocks of 32 x 32, 3 blocks per
    # SM on 132 SMs
    assert dw_partitions(8, 192, 640, 32, 96, 132) == 132
    assert dw_partitions(1, 4, 64, 16, 16, 132) == 1  # never more than the 4x64 tiles
    assert dw_partitions(1, 8, 64, 16, 16, 132) == 2
    # the scale-1 head (its CUDA-core path): 2 blocks of 32 input channels, 4
    # blocks per SM
    assert dw_partitions(8, 96, 320, 64, 1, 132) == 264
    # 64 -> 192: 3 x 2 blocks of 64 x 32 channels, 2 blocks per SM
    assert dw_partitions(8, 96, 320, 64, 192, 132) == 44
    # float32 (the 3xTF32 kernel): 3 x 1 blocks of 32 x 32 channels, 4x64
    # tiles, 2 blocks per SM; the heads 3 per SM
    f32 = torch.float32
    assert dw_partitions(8, 192, 640, 32, 96, 132, f32) == 88
    assert dw_partitions(1, 8, 32, 16, 16, 132, f32) == 2
    assert dw_partitions(8, 96, 320, 64, 1, 132, f32) == 198
