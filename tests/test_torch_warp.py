"""The port's warp against the JAX package's: the plain exact warp
(``ops/warp.grid_sample``), the family warp of the train step
(``ops/warp_banded``, the port of Pallas kernel #7, forward and grid
gradient, here on their CPU twins) and the dispatch of every
``Options.warp_backend`` name to it.

Images are NCHW in the port and NHWC in JAX; the tests transpose. Grid
coordinates are kept off the integers (and off the clamp edges) where a
gradient is compared, because the derivative of floor/clip is undefined
there. Tolerances: 1e-6 on the float32 forward, 1e-5 relative on the
grid gradient; 1e-2 against the banded Pallas warp, whose taps and
residuals are bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.config import Options
from ssde_tpu.ops.pallas.warp_banded import grid_sample_banded_planar
from ssde_tpu.ops.warp import grid_sample as jax_grid_sample
from ssde_tpu_torch.ops.warp import (grad_masks, grid_sample, warp_family_bwd_reference,
                                     warp_family_reference)
from ssde_tpu_torch.ops.warp_banded import grid_sample_family, warp_family_bwd, warp_family_fwd
from ssde_tpu_torch.train.steps import WARP_BACKENDS, generate_images_pred


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _grids(rng, S, B, H, W, spread=0.03, off_integer=True):
    """Near-identity reprojection-like grids (S, B, H, W, 2); with
    ``off_integer`` every unnormalised coordinate is at least 0.05 px from
    an integer and inside (0, size-1)."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    fx = xs[None, None] + rng.randn(S, B, H, W) * spread * W
    fy = ys[None, None] + rng.randn(S, B, H, W) * spread * H
    if off_integer:
        fx = np.clip(np.floor(fx) + rng.uniform(0.05, 0.95, fx.shape), 0.05, W - 1.05)
        fy = np.clip(np.floor(fy) + rng.uniform(0.05, 0.95, fy.shape), 0.05, H - 1.05)
    # (f * 2 + 1) / size - 1 inverts ((g + 1) * size - 1) / 2
    gx, gy = (2 * fx + 1) / W - 1, (2 * fy + 1) / H - 1
    return np.stack([gx, gy], -1).astype(np.float32)


def test_grid_sample_matches_jax_forward_and_grid_gradient():
    rng = np.random.RandomState(0)
    B, H, W = 2, 24, 40
    img = rng.rand(B, H, W, 3).astype(np.float32)
    grid = _grids(rng, 1, B, H, W)[0]
    cot = rng.randn(B, H, W, 3).astype(np.float32)
    want = jax_grid_sample(jnp.asarray(img), jnp.asarray(grid))
    g_want = jax.grad(lambda g: jnp.sum(jax_grid_sample(jnp.asarray(img), g)
                                        * cot))(jnp.asarray(grid))
    tg = torch.from_numpy(grid).requires_grad_()
    got = grid_sample(_nchw(img), tg)
    (got * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-6, rtol=0)
    g = np.asarray(g_want)
    np.testing.assert_allclose(tg.grad.numpy(), g, atol=1e-5 * np.abs(g).max(), rtol=0)


def test_grid_sample_border_and_out_of_range():
    """Coordinates on and beyond the border: clamped, anchor W-2 with
    wx = 1 at the right edge, exact against JAX and F.grid_sample."""
    rng = np.random.RandomState(1)
    B, H, W = 1, 9, 13
    img = rng.rand(B, H, W, 2).astype(np.float32)
    grid = rng.uniform(-1.6, 1.6, (B, 7, 11, 2)).astype(np.float32)
    grid[0, 0, :4] = [[1.0, 1.0], [-1.0, -1.0], [1 - 1 / W, 0.0], [-1 + 1 / W, 1 - 1 / H]]
    want = np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    got = grid_sample(_nchw(img), torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-6, rtol=0)
    tg = torch.nn.functional.grid_sample(_nchw(img), torch.from_numpy(grid),
                                         mode="bilinear", padding_mode="border",
                                         align_corners=False)
    np.testing.assert_allclose(got.numpy(), tg.numpy(), atol=1e-6, rtol=0)


def test_family_warp_matches_banded_pallas_planar():
    """grid_sample_family (S grids, one launch) against
    grid_sample_banded_planar in interpret mode: outputs, and the grid
    gradient through both custom VJPs (the TPU keeps taps and residuals in
    bf16, hence 1e-2)."""
    rng = np.random.RandomState(2)
    S, B, H, W = 2, 2, 32, 128
    img = rng.rand(B, H, W, 3).astype(np.float32)
    grids = _grids(rng, S, B, H, W, spread=0.005)
    cot = rng.randn(S * B, 3, H, W).astype(np.float32)
    ji, jg = jnp.asarray(img), jnp.asarray(grids)
    want = grid_sample_banded_planar(ji, jg, False, 8, True)
    g_want = jax.grad(lambda g: jnp.sum(grid_sample_banded_planar(ji, g, False, 8, True)
                                        * cot))(jg)
    tg = torch.from_numpy(grids).requires_grad_()
    got = grid_sample_family(_nchw(img), tg)
    (got * torch.from_numpy(cot)).sum().backward()
    assert got.shape == (S * B, 3, H, W)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-2, rtol=0)
    g = np.asarray(g_want)
    np.testing.assert_allclose(tg.grad.numpy(), g, atol=1e-2 * np.abs(g).max(), rtol=0)


def test_family_warp_is_the_exact_warp_per_scale():
    """Each g = s*B + b block of the family warp is grid_sample of grid s,
    and rdx/rdy are the derivatives of the output in the fractions."""
    rng = np.random.RandomState(3)
    S, B, H, W = 3, 2, 12, 20
    img = torch.from_numpy(rng.rand(B, 3, H, W).astype(np.float32))
    grids = torch.from_numpy(_grids(rng, S, B, H, W, spread=0.2))
    out, rdx, rdy = warp_family_reference(img, grids)
    assert torch.equal(warp_family_fwd(img, grids), out)
    for s in range(S):
        torch.testing.assert_close(out[s * B:(s + 1) * B], grid_sample(img, grids[s]),
                                   atol=1e-6, rtol=0)
    # finite differences in the grid: d out / d gx = rdx * W/2 inside
    eps = 1e-3
    for axis, rd, scale in ((0, rdx, W / 2), (1, rdy, H / 2)):
        step = torch.zeros_like(grids)
        step[..., axis] = eps
        plus, _, _ = warp_family_reference(img, grids + step)
        minus, _, _ = warp_family_reference(img, grids - step)
        fd = (plus - minus) / (2 * eps)
        torch.testing.assert_close(fd, rd * scale, atol=2e-2, rtol=0)


def test_family_warp_backward_matches_jax_grid_sample():
    """The plain backward of the family warp against jax.grad of the exact
    JAX grid_sample over the S scales (each scale's grid gets the gradient
    of its own term), with coordinates inside the image and out of range;
    none on a clamp edge, where the derivative of clip is undefined."""
    rng = np.random.RandomState(6)
    S, B, H, W = 3, 2, 12, 20
    img = rng.rand(B, H, W, 3).astype(np.float32)
    grids = _grids(rng, S, B, H, W, spread=0.2)
    far = rng.rand(S, B, H, W) < 0.25  # a quarter of the pixels anywhere in [-1.6, 1.6]^2
    grids[far] = rng.uniform(-1.6, 1.6, (far.sum(), 2)).astype(np.float32)
    cot = rng.randn(S * B, 3, H, W).astype(np.float32)
    ji = jnp.asarray(img)
    cot_nhwc = jnp.asarray(cot.reshape(S, B, 3, H, W).transpose(0, 1, 3, 4, 2))

    def loss(g):
        return sum(jnp.sum(jax_grid_sample(ji, g[s]) * cot_nhwc[s]) for s in range(S))

    want = np.asarray(jax.grad(loss)(jnp.asarray(grids)))
    got = warp_family_bwd_reference(_nchw(img), torch.from_numpy(grids),
                                    torch.from_numpy(cot)).numpy()
    assert got.shape == (S, B, H, W, 2)
    assert (want[far] == 0).any() and (want[~far] != 0).all()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_family_warp_backward_is_the_residual_assembly(dtype):
    """The plain backward is the assembly the residuals fed before the
    backward became a kernel: masks, the channel sums of dout times rdx and
    rdy, the stack; bit for bit, also through grid_sample_family."""
    rng = np.random.RandomState(7)
    S, B, H, W = 2, 3, 9, 14
    img = torch.from_numpy(rng.rand(B, 3, H, W)).to(dtype)
    grids = torch.from_numpy(rng.uniform(-1.3, 1.3, (S, B, H, W, 2))).to(dtype)
    dout = torch.from_numpy(rng.randn(S * B, 3, H, W)).to(dtype)
    _, rdx, rdy = warp_family_reference(img, grids)
    in_x, in_y = grad_masks(grids, H, W)
    dwx = (dout * rdx).sum(1).reshape(S, B, H, W)
    dwy = (dout * rdy).sum(1).reshape(S, B, H, W)
    want = torch.stack([dwx * in_x, dwy * in_y], -1)
    assert torch.equal(warp_family_bwd_reference(img, grids, dout), want)
    assert torch.equal(warp_family_bwd(img, grids, dout), want)
    tg = grids.clone().requires_grad_()
    (grid_sample_family(img, tg) * dout).sum().backward()
    assert torch.equal(tg.grad, want)


def test_family_warp_saves_no_residual():
    """The autograd Function keeps the image and the grids for its backward,
    nothing of the size of the output."""
    rng = np.random.RandomState(8)
    img = torch.from_numpy(rng.rand(2, 3, 8, 10).astype(np.float32))
    grids = torch.from_numpy(_grids(rng, 3, 2, 8, 10)).requires_grad_()
    out = grid_sample_family(img, grids)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == img.data_ptr() and torch.equal(saved[0], img)
    assert saved[1].data_ptr() == grids.data_ptr() and torch.equal(saved[1], grids)
    assert not saved[0].requires_grad


def test_bench_warp_measures_only_on_a_card(monkeypatch):
    """scripts/bench_warp times the card: without one its measuring process
    raises, and nothing falls back to the CPU."""
    from ssde_tpu_torch.scripts import bench_warp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card is available"):
        bench_warp.main(["--measure"])


def test_family_warp_has_no_image_gradient():
    rng = np.random.RandomState(4)
    img = torch.from_numpy(rng.rand(1, 3, 8, 8).astype(np.float32)).requires_grad_()
    grids = torch.from_numpy(_grids(rng, 1, 1, 8, 8)).requires_grad_()
    grid_sample_family(img, grids).sum().backward()
    assert img.grad is None and grids.grad is not None


def test_family_warp_refusals():
    img = torch.zeros(2, 3, 8, 8)
    grids = torch.zeros(1, 2, 8, 8, 2)
    with pytest.raises(TypeError):
        warp_family_fwd(img.half(), grids.half())
    with pytest.raises(TypeError):
        warp_family_fwd(img.double(), grids)
    with pytest.raises(ValueError, match="batch"):
        warp_family_fwd(img, torch.zeros(1, 3, 8, 8, 2))
    with pytest.raises(ValueError, match="contiguous"):
        warp_family_fwd(img.transpose(2, 3), grids)
    with pytest.raises(ValueError, match="unsupported"):
        warp_family_fwd(torch.zeros(2, 3, 1, 8), grids)
    dout = torch.zeros(2, 3, 8, 8)
    with pytest.raises(TypeError):
        warp_family_bwd(img, grids, dout.double())
    with pytest.raises(ValueError, match="must be"):
        warp_family_bwd(img, grids, torch.zeros(2, 3, 8, 7))
    with pytest.raises(ValueError, match="must be"):
        warp_family_bwd(img, torch.zeros(2, 2, 8, 8, 2), dout)  # S*B = 4 planes
    with pytest.raises(ValueError, match="contiguous"):
        warp_family_bwd(img, grids, dout.transpose(2, 3))
    with pytest.raises(ValueError, match="batch"):
        warp_family_bwd(img, torch.zeros(1, 3, 8, 8, 2), dout)
    with pytest.raises(TypeError):
        warp_family_bwd(img.half(), grids.half(), dout.half())


def test_cpu_warp_never_counts_a_launch():
    before = (warp_family_fwd.launches, warp_family_bwd.launches)
    warp_family_fwd(torch.zeros(1, 3, 4, 4), torch.zeros(2, 1, 4, 4, 2))
    warp_family_bwd(torch.zeros(1, 3, 4, 4), torch.zeros(2, 1, 4, 4, 2),
                    torch.zeros(2, 3, 4, 4))
    assert (warp_family_fwd.launches, warp_family_bwd.launches) == before


@pytest.mark.parametrize("backend", WARP_BACKENDS)
def test_every_warp_backend_runs_the_family_warp(backend, monkeypatch):
    """Rows #8-#10 of the kernel table (and the XLA mxu/gather warps) have
    no Hopper kernel of their own: every backend name warps through the
    port of #7 and gives the same output, in one call per source."""
    rng = np.random.RandomState(5)
    B, H, W = 2, 16, 32
    opts = Options(height=H, width=W, compute_dtype="float32", warp_backend=backend)
    inputs = {"K/0": torch.eye(4).repeat(B, 1, 1) * 20, "inv_K/0": torch.eye(4).repeat(B, 1, 1) / 20}
    inputs["K/0"][:, 3, 3] = inputs["inv_K/0"][:, 3, 3] = 1.0
    outputs = {}
    for f in (-1, 1):
        inputs[f"color/{f}/0"] = torch.from_numpy(rng.rand(B, 3, H, W).astype(np.float32))
        T = torch.eye(4).repeat(B, 1, 1)
        T[:, 0, 3] = 0.05 * f
        outputs[f"cam_T_cam/0/{f}"] = T
    for s in opts.scales:
        outputs[f"disp/{s}"] = torch.from_numpy(
            rng.uniform(0.2, 0.8, (B, 1, H >> s, W >> s)).astype(np.float32))
    calls = []
    import ssde_tpu_torch.train.steps as steps

    real = steps.grid_sample_family
    monkeypatch.setattr(steps, "grid_sample_family",
                        lambda img, g: calls.append(tuple(g.shape)) or real(img, g))
    out = generate_images_pred(inputs, dict(outputs), opts, [-1, 1])
    monkeypatch.undo()
    assert calls == [(4, B, H, W, 2)] * 2
    ref_opts = Options(height=H, width=W, compute_dtype="float32")
    ref = generate_images_pred(inputs, dict(outputs), ref_opts, [-1, 1])
    for f in (-1, 1):
        assert torch.equal(out[f"color_planar/{f}"], ref[f"color_planar/{f}"])
        for s in opts.scales:
            torch.testing.assert_close(
                out[f"color/{f}/{s}"],
                grid_sample(inputs[f"color/{f}/0"], out[f"sample/{f}/{s}"]),
                atol=1e-6, rtol=0)


def test_unknown_warp_backend_is_refused():
    opts = Options(height=16, width=32, warp_backend="bogus")
    with pytest.raises(ValueError, match="warp_backend"):
        generate_images_pred({}, {}, opts, [-1, 1])
