"""The port's fused photometric error (``ops/photometric``, the port of
Pallas kernels #5 and #6, here on its CPU twins) against the JAX package.

``photometric_error_planar`` runs in interpret mode at (G=4, C=3, 16, 128)
with G = 2B, as tests/test_photometric_pallas.py runs it. The forward is
held at 2e-5 (float32, SSIM sums in another order). The backward's
coefficient maps reach 1/C2 ~ 1e3 and cancel, so its bound is relative to
max |d pred|: 1e-4. Flat textures, where float32 itself is coarser, are
held to a float64 run instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.ops.losses import reprojection_loss as jax_reprojection_loss
from ssde_tpu.ops.pallas.photometric import photometric_error_planar
from ssde_tpu_torch.ops.losses import reprojection_loss
from ssde_tpu_torch.ops.photometric import (photometric_bwd, photometric_bwd_reference,
                                            photometric_error, photometric_fwd,
                                            photometric_reference)

G, B, C, H, W = 4, 2, 3, 16, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The small-size runs here take one torch thread. Beside the other
    workers of a parallel pytest run, a thread pool in every process
    oversubscribes the cores, and their many small ops then wait minutes in
    its barriers instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    pred = rng.rand(G, C, H, W).astype(np.float32)
    targ = rng.rand(B, C, H, W).astype(np.float32)
    cot = rng.randn(G, H, W).astype(np.float32)
    return pred, targ, cot


def test_flat_texture_against_float64():
    """Flat 4x4 blocks, the synthetic data's texture: in a flat window the
    variances are E[x^2] - E[x]^2 of equal values, float32 rounding of
    ~1e-8 against C2 = 9e-4. Over four seeds the Pallas kernel in
    interpret mode is 4-5e-5 from float64 in the forward and 1.0-2.1e-4 of
    max |d pred| in the backward, this twin 6-7e-5 and 1.0-6.1e-4; the port
    is held to float64 at 1e-4 and 1e-3."""
    rng = np.random.RandomState(2)
    blocks = np.kron(rng.rand(G + B, C, H // 4, W // 4), np.ones((4, 4)))
    pred, targ = blocks[:G].astype(np.float32), blocks[G:].astype(np.float32)
    cot = rng.randn(G, H, W).astype(np.float32)
    p64, t64, c64 = (torch.from_numpy(a).double() for a in (pred, targ, cot))
    got = photometric_fwd(torch.from_numpy(pred), torch.from_numpy(targ))
    torch.testing.assert_close(got.double(), photometric_reference(p64, t64),
                               atol=1e-4, rtol=0)
    want = photometric_bwd_reference(p64, t64, c64)
    got = photometric_bwd(torch.from_numpy(pred), torch.from_numpy(targ),
                          torch.from_numpy(cot))
    torch.testing.assert_close(got.double(), want,
                               atol=1e-3 * want.abs().max().item(), rtol=0)


def test_forward_matches_pallas_interpret(data):
    pred, targ, _ = data
    want = np.asarray(photometric_error_planar(jnp.asarray(pred), jnp.asarray(targ), True))
    got = photometric_fwd(torch.from_numpy(pred), torch.from_numpy(targ))
    assert got.shape == (G, H, W)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_vjp_matches_pallas_interpret(data):
    pred, targ, cot = data
    jt = jnp.asarray(targ)
    want = jax.grad(lambda p: jnp.sum(photometric_error_planar(p, jt, True) * cot))(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    (photometric_error(tp, torch.from_numpy(targ)) * torch.from_numpy(cot)).sum().backward()
    w = np.asarray(want)
    np.testing.assert_allclose(tp.grad.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)


def test_against_reprojection_loss(data):
    """The fused map equals the losses module's per-pair reprojection_loss
    against targ[g % B], in the port and in JAX."""
    pred, targ, _ = data
    got = photometric_fwd(torch.from_numpy(pred), torch.from_numpy(targ))
    for g in range(G):
        port = reprojection_loss(torch.from_numpy(pred[g:g + 1]),
                                 torch.from_numpy(targ[g % B:g % B + 1]))
        np.testing.assert_allclose(got[g].numpy(), port[0, 0].numpy(), atol=2e-5, rtol=0)
        jx = jax_reprojection_loss(jnp.asarray(pred[g:g + 1].transpose(0, 2, 3, 1)),
                                   jnp.asarray(targ[g % B:g % B + 1].transpose(0, 2, 3, 1)))
        np.testing.assert_allclose(got[g].numpy(), np.asarray(jx)[0, ..., 0], atol=2e-5, rtol=0)


def test_backward_matches_jax_grad_of_plain_reprojection_loss(data):
    """The port's backward against ``jax.grad`` of the JAX package's plain
    ``reprojection_loss`` on each pair (independent of either fused form),
    float32, 1e-4 of max |d pred|."""
    pred, targ, cot = data
    want = np.stack([np.asarray(jax.grad(lambda p, g=g: jnp.sum(
        jax_reprojection_loss(p, jnp.asarray(targ[g % B:g % B + 1].transpose(0, 2, 3, 1)))
        [0, ..., 0] * cot[g]))(jnp.asarray(pred[g:g + 1].transpose(0, 2, 3, 1))))[0]
        .transpose(2, 0, 1) for g in range(G)])
    got = photometric_bwd(torch.from_numpy(pred), torch.from_numpy(targ),
                          torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_target_gets_no_gradient(data):
    pred, targ, _ = data
    tt = torch.from_numpy(targ).requires_grad_()
    tp = torch.from_numpy(pred).requires_grad_()
    photometric_error(tp, tt).sum().backward()
    assert tt.grad is None and tp.grad is not None


@pytest.mark.parametrize("shape", [(3, 1, 2, 2), (2, 3, 3, 5), (2, 3, 9, 13)])
def test_small_and_ragged_shapes(shape):
    """Reflect at its 2-pixel minimum and ragged tiles, float64: the forward
    against the ops/losses form per pair (1e-12), the backward against
    central differences (torch.autograd.gradcheck, its default 1e-5)."""
    g_, c, h, w = shape
    rng = np.random.RandomState(1)
    pred = torch.from_numpy(rng.rand(g_, c, h, w))
    targ = torch.from_numpy(rng.rand(1, c, h, w))
    got = photometric_fwd(pred, targ)
    for g in range(g_):
        torch.testing.assert_close(got[g], reprojection_loss(pred[g:g + 1], targ)[0, 0],
                                   atol=1e-12, rtol=0)
    assert torch.autograd.gradcheck(lambda p: photometric_error(p, targ),
                                    (pred.clone().requires_grad_(),))


def test_refusals():
    pred, targ = torch.zeros(6, 3, 8, 8), torch.zeros(4, 3, 8, 8)
    with pytest.raises(ValueError, match="multiple"):
        photometric_fwd(pred, targ)
    with pytest.raises(TypeError):
        photometric_fwd(pred[:4].half(), targ.half())
    with pytest.raises(TypeError):
        photometric_fwd(pred[:4].double(), targ)
    with pytest.raises(ValueError, match="contiguous"):
        photometric_fwd(pred[:4].transpose(2, 3), targ)
    with pytest.raises(ValueError, match="gradient"):
        photometric_bwd(pred[:4], targ, torch.zeros(4, 8, 9))
    before = (photometric_fwd.launches, photometric_bwd.launches)
    photometric_fwd(pred[:4], targ)
    photometric_bwd(pred[:4], targ, torch.zeros(4, 8, 8))
    assert (photometric_fwd.launches, photometric_bwd.launches) == before
