"""The port's plain ops against the JAX package's: geometry
(``ops/geometry``), ``resize_bilinear`` and ``reflect_pad_2d``
(``ops/image``) and the losses (``ops/losses``), float32 on the same numpy
inputs. Layouts differ (NCHW here, NHWC in JAX); the tests transpose.
Tolerances: 1e-6 on exact-arithmetic ops (resize, pad), 1e-5 on the
geometry and the losses (float32 sums and 4x4 products in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.ops import geometry as jg
from ssde_tpu.ops import image as ji
from ssde_tpu.ops import losses as jl
from ssde_tpu_torch.ops import geometry, image, losses


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(rng, invert):
    aa = (rng.randn(3, 1, 3) * 0.1).astype(np.float32)
    t = (rng.randn(3, 1, 3) * 0.5).astype(np.float32)
    _close(geometry.rot_from_axisangle(torch.from_numpy(aa)),
           jg.rot_from_axisangle(jnp.asarray(aa)), 1e-6)
    _close(geometry.get_translation_matrix(torch.from_numpy(t)),
           jg.get_translation_matrix(jnp.asarray(t)), 0)
    _close(geometry.transformation_from_parameters(torch.from_numpy(aa[:, 0]),
                                                   torch.from_numpy(t[:, 0]), invert),
           jg.transformation_from_parameters(jnp.asarray(aa[:, 0]), jnp.asarray(t[:, 0]),
                                             invert), 1e-6)


def _cameras(rng, B, H, W):
    K = np.tile(np.array([[0.58 * W, 0, 0.5 * W, 0], [0, 1.92 * H, 0.5 * H, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (B, 1, 1))
    inv_K = np.linalg.inv(K).astype(np.float32)
    aa = (rng.randn(B, 3) * 0.02).astype(np.float32)
    tr = (rng.randn(B, 3) * 0.1).astype(np.float32)
    T = np.asarray(jg.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr)))
    depth = rng.uniform(1.0, 50.0, (B, H, W, 1)).astype(np.float32)
    return K, inv_K, T, depth


def test_backproject_project_and_reproject(rng):
    B, H, W = 2, 12, 20
    K, inv_K, T, depth = _cameras(rng, B, H, W)
    pts = geometry.backproject_depth(_nchw(depth), torch.from_numpy(inv_K))
    jpts = jg.backproject_depth(jnp.asarray(depth), jnp.asarray(inv_K))
    _close(pts, jpts, 1e-5 * float(np.abs(jpts).max()))
    pix = geometry.project_3d(pts, torch.from_numpy(K), torch.from_numpy(T), H, W)
    _close(pix, jg.project_3d(jpts, jnp.asarray(K), jnp.asarray(T), H, W), 1e-5)
    fused = geometry.reproject_coords(_nchw(depth), torch.from_numpy(inv_K),
                                      torch.from_numpy(K), torch.from_numpy(T))
    assert fused.shape == (B, H, W, 2)
    _close(fused, jg.reproject_coords(jnp.asarray(depth), jnp.asarray(inv_K),
                                      jnp.asarray(K), jnp.asarray(T)), 1e-5)
    _close(fused, pix, 1e-5)


def test_disp_to_depth(rng):
    disp = rng.rand(2, 1, 4, 6).astype(np.float32)
    for got, want in zip(geometry.disp_to_depth(torch.from_numpy(disp), 0.1, 100.0),
                         jg.disp_to_depth(jnp.asarray(disp), 0.1, 100.0)):
        _close(got, want, 1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("hw,out", [((6, 10), (24, 40)), ((24, 40), (6, 10)),
                                    ((5, 7), (12, 9)), ((1, 4), (3, 8))])
def test_resize_bilinear(rng, hw, out, align_corners):
    x = rng.rand(2, *hw, 3).astype(np.float32)
    got = image.resize_bilinear(_nchw(x), out, align_corners)
    want = ji.resize_bilinear(jnp.asarray(x), out, align_corners)
    assert got.shape == (2, 3) + out
    _close(_nhwc(got), want, 1e-6)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("hw,out", [((6, 10), (24, 40)), ((24, 24), (4, 6)), ((1, 4), (3, 8))])
def test_resize_bilinear_gradient(rng, hw, out, align_corners):
    """The backward (an index_add of the index_select gathers) against
    jax.grad of the JAX resize, float64 (its float32 casts read as float64),
    within 1e-12 of the largest; rows no output reads get exactly 0."""
    x = rng.rand(2, *hw, 3)
    r = rng.randn(2, *out, 3)
    xt = _nchw(x).requires_grad_()
    (image.resize_bilinear(xt, out, align_corners) * _nchw(r)).sum().backward()

    class F64:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(ji, "jnp", F64())
        want = np.asarray(jax.grad(lambda a: jnp.sum(ji.resize_bilinear(a, out, align_corners)
                                                     * r))(jnp.asarray(x)))
    got = _nhwc(xt.grad)
    assert xt.grad.dtype == torch.float64
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)
    assert np.all(got[want == 0] == 0)


@pytest.mark.parametrize("hw", [(5, 7), (1, 4), (3, 1), (1, 1)])
def test_reflect_pad_2d(rng, hw):
    """Size-1 dimensions repeat their value, as jnp.pad(mode="reflect")."""
    x = rng.rand(2, *hw, 3).astype(np.float32)
    _close(_nhwc(image.reflect_pad_2d(_nchw(x))), ji.reflect_pad_2d(jnp.asarray(x)), 0)


def test_ssim_reprojection_and_smoothness(rng):
    x, y = rng.rand(2, 10, 14, 3).astype(np.float32), rng.rand(2, 10, 14, 3).astype(np.float32)
    _close(_nhwc(losses.ssim(_nchw(x), _nchw(y))), jl.ssim(jnp.asarray(x), jnp.asarray(y)), 1e-5)
    for no_ssim in (False, True):
        _close(_nhwc(losses.reprojection_loss(_nchw(x), _nchw(y), no_ssim)),
               jl.reprojection_loss(jnp.asarray(x), jnp.asarray(y), no_ssim), 1e-5)
    disp = rng.rand(2, 10, 14, 1).astype(np.float32)
    _close(losses.smooth_loss(_nchw(disp), _nchw(x)),
           jl.smooth_loss(jnp.asarray(disp), jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("disable_automasking", [False, True])
def test_photometric_loss(rng, disable_automasking):
    """Min-reprojection and automask without noise, and the automask
    preferring an identity map that is exactly the target."""
    B, H, W = 2, 8, 12
    target = rng.rand(B, H, W, 3).astype(np.float32)
    preds = [rng.rand(B, H, W, 3).astype(np.float32) for _ in range(2)]
    idents = [target.copy(), rng.rand(B, H, W, 3).astype(np.float32)]
    got = losses.photometric_loss([_nchw(p) for p in preds], [_nchw(i) for i in idents],
                                  _nchw(target), None,
                                  disable_automasking=disable_automasking)
    want = jl.photometric_loss([jnp.asarray(p) for p in preds],
                               [jnp.asarray(i) for i in idents], jnp.asarray(target), None,
                               disable_automasking=disable_automasking)
    for g, w in zip(got, want):
        _close(_nhwc(g), w, 1e-5)
    if not disable_automasking:
        assert float(got[1].sum()) == 0.0  # the identity map of the target wins everywhere


def test_automask_noise_comes_from_the_generator(rng):
    reproj = torch.from_numpy(rng.rand(2, 2, 4, 4).astype(np.float32))
    ident = reproj.clone()  # exact ties: the noise decides
    a = losses.min_reprojection(reproj, ident, torch.Generator().manual_seed(0))
    b = losses.min_reprojection(reproj, ident, torch.Generator().manual_seed(0))
    c = losses.min_reprojection(reproj, ident, None)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    assert float(c[1].sum()) == 0.0  # argmin takes the first of equal values
    assert 0 < float(a[1].sum()) < a[1].numel()
