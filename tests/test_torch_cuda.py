"""The hand-written CUDA kernels against their plain twins, on the card:
conv3x3 (#1) forward and as dx, its weight gradient (#2), the family warp
(#7) forward and grid gradient, the photometric error forward and backward (#5, #6) and the windowed
attention forward and backward (#3, #4).

These tests need a CUDA card (sm_90a) and nvcc, and skip elsewhere. They
import no JAX and run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest imports JAX.) chip_smoke.py
checks the kernels at the slice's 640x192 shapes; the shapes here are the
ragged ones and the edges of each body's tiling: widths and heights that
the 4x64 tile of both bodies does not divide, channel counts off their
input stages (float32 8 or 16, bf16 16 or 32), output blocks (8, 32 or 64)
and MMA multiples, reflect padding at its 2-pixel minimum, 1- and 2-pixel
maps, the Cout = 1 heads and the 1-channel convs of their dx (K = 9), and
the recurrent family's small-channel convs (Cin and Cout 1 to 6) and
2-channel attention, and the 3-frame fusion blocks' attention (C = 2, 4,
32 and 256, channel-shared embeddings, their gradients through #4),
modules and train step.
Bounds as in chip_smoke.py: float32 1e-4 relative to max|ref| and, against
float64, 4x the plain float32 conv's own error; bfloat16 1e-2 against the
float32 twin on the same bf16-rounded inputs.
"""

import itertools

import pytest
import torch

from ssde_tpu_torch.models.attention import AttentionConv
from ssde_tpu_torch.ops.attention_win import (BWD_BAND, BWD_STRIP, FWD_BAND, FWD_STRIP, attend3,
                                              attend3_bwd, attend3_fwd, attend3_reference)
from ssde_tpu_torch.ops.conv3x3 import (ACTS, act_grad, conv3x3, conv3x3_dw,
                                        conv3x3_dw_reference, conv3x3_dx, conv3x3_reference,
                                        packed_weights)
from ssde_tpu_torch.ops import photometric as photo
from ssde_tpu_torch.ops.photometric import (photometric_bwd, photometric_bwd_reference,
                                            photometric_fwd, photometric_reference)
from ssde_tpu_torch.ops.warp import warp_family_bwd_reference, warp_family_reference
from ssde_tpu_torch.ops.warp_banded import grid_sample_family, warp_family_bwd, warp_family_fwd

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
    (2, 32, 1, 12, 136),    # the scale-0 head, W % 64 != 0
    (1, 64, 1, 9, 80),      # the scale-1 head
    (2, 1, 32, 6, 72),      # the scale-0 head's dx: a conv from 1 channel (K = 9)
    (1, 1, 64, 5, 40),      # the scale-1 head's dx
    (1, 32, 192, 5, 64),    # N = 192 from 32 channels: 3 blocks of 64
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
    # an input that requires grad goes through the kernels, it does not raise
    conv3x3(x, wt.requires_grad_(), b).sum().backward()
    assert conv3x3.launches == before + 1 and wt.grad is not None
    before += 1
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3(x.transpose(2, 3), wt.detach(), b)
    with pytest.raises(ValueError, match="one device"):
        conv3x3(x, wt.detach().cpu(), b)
    with pytest.raises(TypeError):
        conv3x3(x.half(), wt.detach().half(), b.half())
    assert conv3x3.launches == before


# ------------------------------------- the float32 body (3xTF32) at its edges
# Against float64 the kernel's worst error over a shape's acts and biases is
# held to F64_RATIO x the plain float32 conv's (cuDNN, TF32 off): float32 in
# build_evaluator's sense. The smallest maps carry enough outputs and
# channels for their largest error to be more than one rounding's luck.
F64_RATIO = 4.0


_F32_EDGES = [
    (3, 40, 9, 1, 1),       # a 1-pixel map (zero pad only: reflect needs 2): the centre tap
    (2, 7, 8, 2, 2),        # 2-pixel map: the reflect minimum; Cout 8 = one n8 block
    (1, 9, 9, 3, 65),       # Cin one past CC = 8, Cout one past 8, W one past 64
    (2, 17, 96, 5, 63),     # Cin one past CC = 16, H one past 4, W one short of 64
    (1, 32, 192, 7, 130),   # N = 192: 6 blocks of 32
    (1, 64, 1, 6, 70),      # the head
    (3, 1, 3, 4, 64),       # a 1-channel conv to 3: K = 9 taps x 8 staged channels
]


@pytest.mark.parametrize("B,cin,cout,h,w,pad", [
    c + (p,) for c in _F32_EDGES for p in ("zero", "reflect") if p == "zero" or min(c[3:]) >= 2])
def test_float32_body_at_its_edges(dev, B, cin, cout, h, w, pad):
    x, wt, b = _inputs(dev, B, cin, cout, h, w, seed=cin + cout)
    e_got, e_want = 0.0, 0.0  # worst against float64
    with torch.inference_mode():
        for act, has_b in itertools.product(ACTS, (True, False)):
            bi = b if has_b else None
            got = conv3x3(x, wt, bi, pad, act)
            want = conv3x3_reference(x, wt, bi, pad, act)
            ref64 = conv3x3_reference(x.double(), wt.double(), None if bi is None else
                                      bi.double(), pad, act)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert _rel(got, want) <= TOL[torch.float32], (act, has_b)
            e_got = max(e_got, (got.double() - ref64).abs().max().item())
            e_want = max(e_want, (want.double() - ref64).abs().max().item())
    assert e_got <= F64_RATIO * e_want, (e_got, e_want)


def test_float32_weights_are_packed_once_per_version(dev):
    """Serving calls the forward with fixed weights: the second call packs
    nothing and launches the conv kernel alone; an in-place update of the
    weights packs them again."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1, 32, 96, 320, device=dev)
    conv = torch.nn.Conv2d(32, 64, 3, device=dev)
    with torch.inference_mode():
        first = conv3x3(x, conv.weight, conv.bias)
        packs = packed_weights.packs
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            second = conv3x3(x, conv.weight, conv.bias)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert packed_weights.packs == packs and torch.equal(first, second)
        assert len(kernels) == 1 and "conv3x3_fwd_tf32" in kernels[0], kernels
        with torch.no_grad():
            conv.weight.mul_(2.0)
        third = conv3x3(x, conv.weight, conv.bias)
    assert packed_weights.packs == packs + 1
    assert _rel(third, conv3x3_reference(x, conv.weight.detach(), conv.bias.detach())) <= 1e-4


def test_float32_kernels_refuse_instead_of_falling_back(dev):
    """What the float32 kernels cannot take raises on the card: no plain
    version runs in their place."""
    x, wt, b = _inputs(dev, 1, 8, 16, 8, 8)
    before = (conv3x3.launches, conv3x3_dw.launches)
    with pytest.raises(ValueError, match="grid"):
        conv3x3(torch.zeros(1, 1, 4 * 65535 + 1, 1, device=dev), wt[:, :1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_dw(x.transpose(2, 3), torch.randn(1, 16, 8, 8, device=dev))
    with pytest.raises(TypeError):
        conv3x3_dw(x, torch.randn(1, 16, 8, 8, device=dev).double())
    with pytest.raises(ValueError, match="reflect"):
        conv3x3_dw(x[:, :, :1].contiguous(), torch.randn(1, 16, 1, 8, device=dev), "reflect")
    assert (conv3x3.launches, conv3x3_dw.launches) == before


# --------------------------------------------- the backward: dx (#1) and dW (#2)
# Bounds as in chip_smoke.py phase 10: float32 1e-4 of each gradient's max
# (dW sums B*H*W products in blocked partial sums) against autograd of the
# plain forward. bfloat16 1e-2 against autograd of the plain conv in
# float32 on the same bf16-rounded operands: x, w, b and the gradient gp =
# g * act'(out) that the kernels receive, which the backward rounds to
# bf16 with act' taken from the bf16 output (near 1, sigmoid's 1 - out
# keeps only a few bits; the JAX backward rounds the same way).


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad,act", [("zero", "none"), ("zero", "relu"), ("reflect", "sigmoid"),
                                     ("reflect", "elu"), ("zero", "tanh")])
@pytest.mark.parametrize("B,cin,cout,h,w", [
    (1, 3, 1, 2, 2),        # reflect minimum; dx of a 1-channel output
    (2, 5, 17, 7, 37),      # nothing divides the tiles or the channel blocks
    (2, 32, 1, 16, 40),     # the sigmoid head: dx from 1 channel to 32
    (1, 64, 1, 9, 72),      # the scale-1 head: dx from 1 channel to 64
    (1, 64, 128, 9, 64),
    (1, 32, 96, 6, 128),    # 96 = 3 blocks of 32 in dW and the forward
    (1, 192, 64, 5, 64),    # a conv from 192 channels: dx to 192, 6 input chunks
])
def test_backward_kernels_match_autograd(dev, B, cin, cout, h, w, pad, act, dtype):
    x, wt, b = _inputs(dev, B, cin, cout, h, w, seed=3)
    g = torch.randn(B, cout, h, w, device=dev)
    xi, wi, bi = (t.to(dtype).requires_grad_() for t in (x, wt, b))
    before = (conv3x3.launches, conv3x3_dx.launches, conv3x3_dw.launches)
    conv3x3(xi, wi, bi, pad, act).backward(g.to(dtype))
    torch.cuda.synchronize()
    assert (conv3x3.launches, conv3x3_dx.launches, conv3x3_dw.launches) == tuple(
        n + 1 for n in before)
    xr, wr, br = (t.detach().float().requires_grad_() for t in (xi, wi, bi))
    if dtype == torch.float32:
        conv3x3_reference(xr, wr, br, pad, act).backward(g)
    else:
        with torch.no_grad():
            out = conv3x3(xi.detach(), wi.detach(), bi.detach(), pad, act).float()
            ag = act_grad(act, out)
            gp = (g.to(dtype).float() * (1.0 if ag is None else ag)).to(dtype).float()
        conv3x3_reference(xr, wr, br, pad).backward(gp)
    for got, want in ((xi.grad, xr.grad), (wi.grad, wr.grad), (bi.grad, br.grad)):
        assert got.dtype == dtype and got.shape == want.shape
        rel = ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-12)).item()
        assert rel <= TOL[dtype], (act, rel)


# The model axis (parallel.model_sharded_params at m = 2): a rank of v10's
# GRU step runs #1 (forward and dx) and #2 on its slice of each kernel conv's
# output channels at scales 0 and 1: the cells' x conv (its gates' and
# candidate's slices, 32 -> 48 and 64 -> 96), h conv (32 -> 32, 64 -> 64) and
# reset*h conv (32 -> 16, 64 -> 32), and the conv units (32 -> 16, 64 -> 32).
# Each against its plain version at the bounds above, and the slice's
# forward against the same channels of the whole conv.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,act", [(32, 48, "none"), (32, 32, "none"), (32, 16, "none"),
                                          (32, 16, "relu"), (64, 96, "none"), (64, 64, "none"),
                                          (64, 32, "none"), (64, 32, "relu")])
def test_kernels_on_a_model_axis_slice(dev, cin, cout, act, dtype):
    B, h, w = 2, 12, 80
    x, wt, b = _inputs(dev, B, cin, 2 * cout, h, w, seed=7)
    rows = slice(cout, 2 * cout)  # rank 1's rows of the whole weight
    xi = x.to(dtype).requires_grad_()
    wi, bi = (t[rows].contiguous().to(dtype).requires_grad_() for t in (wt, b))
    g = torch.randn(B, cout, h, w, device=dev)
    out = conv3x3(xi, wi, bi, "zero", act)
    out.backward(g.to(dtype))
    with torch.no_grad():
        whole = conv3x3(xi.detach(), wt.to(dtype), b.to(dtype), "zero", act)[:, rows]
    torch.cuda.synchronize()
    xr, wr, br = (t.detach().float().requires_grad_() for t in (xi, wi, bi))
    want = conv3x3_reference(xr, wr, br, "zero", act)
    ag = act_grad(act, out.detach().float())
    gp = (g.to(dtype).float() * (1.0 if ag is None else ag)).to(dtype).float()
    conv3x3_reference(xr, wr, br, "zero").backward(gp)
    for got, ref in ((out, want), (whole, want), (xi.grad, xr.grad), (wi.grad, wr.grad),
                     (bi.grad, br.grad)):
        assert got.dtype == dtype and got.shape == ref.shape
        rel = ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-12)).item()
        assert rel <= TOL[dtype], rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_gradient_is_deterministic(dev, dtype):
    x, _, _ = _inputs(dev, 8, 32, 96, 96, 320, seed=4)
    x, g = x.to(dtype), torch.randn(8, 96, 96, 320, device=dev).to(dtype)
    first = conv3x3_dw(x, g, "zero")
    assert torch.equal(first, conv3x3_dw(x, g, "zero"))
    assert first.dtype == torch.float32 and first.shape == (96, 32, 3, 3)


@pytest.mark.parametrize("cout", [1, 17])
def test_bf16_weight_gradient_reads_an_unaligned_g(dev, cout):
    """g with a storage offset of one element is not 16-byte aligned: the
    bf16 kernels stage it without cp.async and agree with the aligned copy."""
    x, _, _ = _inputs(dev, 2, 32, cout, 9, 64, seed=5)
    flat = torch.randn(2 * cout * 9 * 64 + 1, device=dev).to(torch.bfloat16)
    g = flat[1:].view(2, cout, 9, 64)
    assert g.data_ptr() % 16 != 0
    got = conv3x3_dw(x.to(torch.bfloat16), g, "reflect")
    assert torch.equal(got, conv3x3_dw(x.to(torch.bfloat16), g.clone(), "reflect"))
    want = conv3x3_dw_reference(x.to(torch.bfloat16).float(), g.float(), "reflect")
    assert _rel(got, want) <= 1e-5


# ------------------------------------------------ family warp and photometric
# Bounds as in chip_smoke.py: the warp's coordinates are rounded as the
# twin rounds them, its interpolation may fuse multiply-adds: 1e-5 absolute
# on images in [0, 1]; its grid gradient sums the channels in another
# order, 1e-5 of max. The photometric forward 1e-5 absolute; its backward
# cancels terms of size ~1/C2, so 1e-4 relative to max |d pred|.


def _warp_inputs(dev, S, B, H, W, spread, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.rand(B, 3, H, W, device=dev, generator=g)
    grids = (torch.rand(S, B, H, W, 2, device=dev, generator=g) * 2 - 1) * spread
    return img, grids.contiguous()


def _check_warp(img, grids, dout):
    """Both kernels against their plain versions on the same operands."""
    S, B, H, W, _ = grids.shape
    out = warp_family_fwd(img, grids)
    dgrid = warp_family_bwd(img, grids, dout)
    torch.cuda.synchronize()
    assert out.shape == (S * B, img.shape[1], H, W) and dgrid.shape == grids.shape
    torch.testing.assert_close(out, warp_family_reference(img, grids)[0], atol=1e-5, rtol=0)
    want = warp_family_bwd_reference(img, grids, dout)
    torch.testing.assert_close(dgrid, want, atol=1e-5 * want.abs().max().item(), rtol=0)
    return out, dgrid


@pytest.mark.parametrize("S,B,H,W,spread", [
    (1, 1, 2, 2, 1.0),       # the 2x2 minimum, every pixel a border case
    (3, 2, 7, 37, 1.3),      # ragged, a third of the coordinates out of range
    (4, 3, 33, 65, 0.9),
    (2, 1, 192, 640, 1.0),   # the slice's width
    (2, 2, 9, 13, 1.2),      # odd Wo and Ho*Wo: a pixel a thread
    (2, 3, 6, 5, 1.1),       # Wo one past 4 pixels a thread, Ho*Wo = 2 (mod 4)
    (2, 3, 8, 5, 1.1),       # Wo = 5, Ho*Wo = 0 (mod 4): a thread's 4 pixels span rows
    (1, 12, 96, 320, 1.0),   # --v1_multiscale's S = 1 at scales 1-3
    (1, 12, 48, 160, 1.0),
    (1, 12, 24, 80, 1.0),
])
def test_warp_family_matches_twin(dev, S, B, H, W, spread):
    img, grids = _warp_inputs(dev, S, B, H, W, spread)
    dout = torch.randn(S * B, 3, H, W, device=dev)
    _check_warp(img, grids, dout)
    # through the autograd Function: the forward kernel's output, the
    # backward kernel's gradient, one launch each
    before = (warp_family_fwd.launches, warp_family_bwd.launches)
    tg = grids.clone().requires_grad_()
    (grid_sample_family(img, tg) * dout).sum().backward()
    assert (warp_family_fwd.launches, warp_family_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = warp_family_bwd_reference(img, grids, dout)
    torch.testing.assert_close(tg.grad, want, atol=1e-5 * want.abs().max().item(), rtol=0)


def test_warp_family_on_the_border_and_pixel_centres(dev):
    """Coordinates exactly on the image's border, beyond it, and on pixel
    centres (integer unnormalised coordinates: the floor's ties), where the
    masks and anchors must be the plain version's to the bit."""
    S, B, H, W = 2, 2, 12, 20
    g = torch.Generator(device=dev).manual_seed(5)
    xs = torch.tensor([-1.5, -1.0, -1 + 1 / W, 1 - 1 / W, 1.0, 1.25], device=dev)
    ys = torch.tensor([-1.0, -1 + 1 / H, 1 - 1 / H, 1.0, 2.0], device=dev)
    centres_x = (2 * torch.arange(W, device=dev) + 1) / W - 1
    centres_y = (2 * torch.arange(H, device=dev) + 1) / H - 1
    pick = lambda v, n: v[torch.randint(len(v), (n,), device=dev, generator=g)]  # noqa: E731
    n = S * B * H * W
    gx = torch.where(torch.rand(n, device=dev, generator=g) < 0.5, pick(xs, n),
                     pick(centres_x, n))
    gy = torch.where(torch.rand(n, device=dev, generator=g) < 0.5, pick(ys, n),
                     pick(centres_y, n))
    grids = torch.stack([gx, gy], -1).reshape(S, B, H, W, 2).contiguous()
    img = torch.rand(B, 3, H, W, device=dev, generator=g)
    _check_warp(img, grids, torch.randn(S * B, 3, H, W, device=dev, generator=g))


def test_warp_family_takes_planes_off_a_vector_boundary(dev):
    """Every tensor one value into its buffer: the kernels take a pixel a
    thread with scalar accesses there, and give what the aligned call gives."""
    img, grids = _warp_inputs(dev, 3, 2, 16, 40, 1.2, seed=6)
    dout = torch.randn(6, 3, 16, 40, device=dev)
    shifted = [torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape) for t in
               (img, grids, dout)]
    for a, b in zip(shifted, (img, grids, dout)):
        a.copy_(b)
    out, dgrid = _check_warp(*shifted)
    torch.testing.assert_close(out, warp_family_fwd(img, grids), atol=1e-6, rtol=0)
    torch.testing.assert_close(dgrid, warp_family_bwd(img, grids, dout),
                               atol=1e-6 * dgrid.abs().max().item(), rtol=0)


def test_warp_family_backward_is_deterministic(dev):
    """Each pixel sums its channels in a fixed order and owns its output:
    a second backward is bit-identical."""
    img, grids = _warp_inputs(dev, 4, 3, 96, 320, 1.0, seed=7)
    dout = torch.randn(12, 3, 96, 320, device=dev)
    first = warp_family_bwd(img, grids, dout)
    assert torch.equal(first, warp_family_bwd(img, grids, dout))


@pytest.mark.parametrize("G,B,H,W", [(1, 1, 2, 2), (3, 1, 3, 5), (6, 2, 17, 33),
                                     (4, 4, 9, 100), (10, 2, 192, 640),
                                     # W = 1, 2, 3 (mod 4)
                                     (2, 1, 9, 61), (2, 1, 9, 62), (2, 1, 9, 63),
                                     # one off the kernels' bands and strips
                                     (4, 2, photo.FWD_BAND + 1, photo.FWD_STRIP - 1),
                                     (4, 2, photo.FWD_BAND - 1, photo.FWD_STRIP + 1),
                                     (4, 2, photo.BWD_BAND - 1, photo.BWD_STRIP + 1),
                                     (4, 2, 2 * photo.BWD_BAND + 1, 2 * photo.BWD_STRIP - 1),
                                     # G / B = 10, and the GRU step's G = 240
                                     (20, 2, 192, 640), (240, 24, 192, 640)])
def test_photometric_matches_twins(dev, G, B, H, W):
    g = torch.Generator(device=dev).manual_seed(1)
    pred = torch.rand(G, 3, H, W, device=dev, generator=g)
    targ = torch.rand(B, 3, H, W, device=dev, generator=g)
    gout = torch.randn(G, H, W, device=dev, generator=g)
    out = photometric_fwd(pred, targ)
    dpred = photometric_bwd(pred, targ, gout)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, photometric_reference(pred, targ), atol=1e-5, rtol=0)
    want = photometric_bwd_reference(pred, targ, gout)
    torch.testing.assert_close(dpred, want, atol=1e-4 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("C", [1, 4])
def test_photometric_takes_any_channel_count(dev, C):
    g = torch.Generator(device=dev).manual_seed(2)
    pred = torch.rand(6, C, 19, 70, device=dev, generator=g)
    targ = torch.rand(3, C, 19, 70, device=dev, generator=g)
    gout = torch.randn(6, 19, 70, device=dev, generator=g)
    torch.testing.assert_close(photometric_fwd(pred, targ), photometric_reference(pred, targ),
                               atol=1e-5, rtol=0)
    want = photometric_bwd_reference(pred, targ, gout)
    torch.testing.assert_close(photometric_bwd(pred, targ, gout), want,
                               atol=1e-4 * want.abs().max().item(), rtol=0)


def test_photometric_flat_texture_against_float64(dev):
    """Flat 4x4 blocks, and a band of rows where pred equals the target: the
    clip (n = d) and the sign (x = y) meet their ties there. Held to a
    float64 run at tests/test_torch_photometric.py's bounds (float32 itself
    is coarse in flat windows): forward 1e-4, backward 1e-3 of max."""
    g = torch.Generator(device=dev).manual_seed(3)
    blocks = torch.rand(6, 3, 16, 40, device=dev, generator=g, dtype=torch.float64)
    flat = blocks.repeat_interleave(4, 2).repeat_interleave(4, 3)
    pred, targ = flat[:4].float().contiguous(), flat[4:].float().contiguous()
    pred[:, :, 20:30] = targ.repeat(2, 1, 1, 1)[:, :, 20:30]
    gout = torch.randn(4, 64, 160, device=dev, generator=g)
    p64, t64, g64 = pred.double(), targ.double(), gout.double()
    torch.testing.assert_close(photometric_fwd(pred, targ).double(),
                               photometric_reference(p64, t64), atol=1e-4, rtol=0)
    want = photometric_bwd_reference(p64, t64, g64)
    torch.testing.assert_close(photometric_bwd(pred, targ, gout).double(), want,
                               atol=1e-3 * want.abs().max().item(), rtol=0)


def test_photometric_backward_is_deterministic_and_takes_planes_off_a_float2(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    pred = torch.rand(20, 3, 48, 160, device=dev, generator=g)
    targ = torch.rand(2, 3, 48, 160, device=dev, generator=g)
    gout = torch.randn(20, 48, 160, device=dev, generator=g)
    first = photometric_bwd(pred, targ, gout)
    assert torch.equal(first, photometric_bwd(pred, targ, gout))
    # even W, but each tensor starts one value into its buffer: the kernels
    # load single values there instead of float2 pairs
    shifted = [torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape) for t in
               (pred, targ, gout)]
    for a, b in zip(shifted, (pred, targ, gout)):
        a.copy_(b)
    torch.testing.assert_close(photometric_fwd(*shifted[:2]), photometric_fwd(pred, targ),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(photometric_bwd(*shifted), first,
                               atol=1e-6 * first.abs().max().item(), rtol=0)


def test_new_kernels_launch_on_the_current_stream(dev):
    img, grids = _warp_inputs(dev, 2, 2, 20, 40, 1.0)
    pred = torch.rand(4, 3, 20, 40, device=dev)
    gout = torch.randn(4, 20, 40, device=dev)
    dout = torch.randn(4, 3, 20, 40, device=dev)
    want = (warp_family_reference(img, grids)[0], photometric_reference(pred, img),
            photometric_bwd_reference(pred, img, gout),
            warp_family_bwd_reference(img, grids, dout))
    counters = (warp_family_fwd, photometric_fwd, photometric_bwd, warp_family_bwd)
    before = tuple(f.launches for f in counters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = (warp_family_fwd(img, grids), photometric_fwd(pred, img),
               photometric_bwd(pred, img, gout), warp_family_bwd(img, grids, dout))
    side.synchronize()
    assert tuple(f.launches for f in counters) == tuple(b + 1 for b in before)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=1e-4 * want[2].abs().max().item(), rtol=0)
    torch.testing.assert_close(got[3], want[3], atol=1e-5 * want[3].abs().max().item(), rtol=0)


def test_new_kernels_refuse_instead_of_falling_back(dev):
    img, grids = _warp_inputs(dev, 1, 2, 8, 8, 1.0)
    pred, targ = torch.rand(6, 3, 8, 8, device=dev), torch.rand(4, 3, 8, 8, device=dev)
    counters = (warp_family_fwd, photometric_fwd, photometric_bwd, warp_family_bwd)
    before = tuple(f.launches for f in counters)
    with pytest.raises(ValueError, match="multiple"):
        photometric_fwd(pred, targ)  # G = 6 is not a multiple of B = 4
    with pytest.raises(ValueError, match="contiguous"):
        photometric_fwd(pred[:4].transpose(2, 3), targ)
    with pytest.raises(TypeError):
        photometric_bwd(pred[:4].half(), targ.half(), torch.zeros(4, 8, 8, device=dev).half())
    with pytest.raises(ValueError, match="contiguous"):
        warp_family_fwd(img.transpose(2, 3), grids)
    with pytest.raises(TypeError):
        warp_family_fwd(img.bfloat16(), grids)
    with pytest.raises(ValueError, match="one device"):
        warp_family_fwd(img, grids.cpu())
    dout = torch.zeros(2, 3, 8, 8, device=dev)
    with pytest.raises(ValueError, match="one device"):
        warp_family_bwd(img, grids, dout.cpu())
    with pytest.raises(TypeError):
        warp_family_bwd(img, grids, dout.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        warp_family_bwd(img, grids, dout.transpose(2, 3))
    with pytest.raises(ValueError, match="must be"):
        warp_family_bwd(img, grids, dout[:1])
    assert tuple(f.launches for f in counters) == before


# ------------------------------------------------ windowed attention (#3, #4)
# Bounds as in chip_smoke.py phase 14: the float32 forward 1e-5 absolute on
# O(1) operands; float32 gradients 1e-4 of each gradient's max against
# autograd of the plain version in float64; bf16 1e-2 of max against the
# float32 plain version on the same bf16-rounded operands. The shapes are
# the ragged ones (chip_smoke.py holds the v9 shapes at 640x192): 1-pixel
# maps, widths and heights off the 16x32 forward and 8x32 backward tiles.


def _attn(dev, B, C, H, W, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, C, H, W, device=dev, generator=g)
    kp = torch.randn(B, C, H + 2, W + 2, device=dev, generator=g)
    vp = torch.randn(B, C, H + 2, W + 2, device=dev, generator=g)
    rel = torch.randn(9, C, device=dev, generator=g) * 0.5
    return q, kp, vp, rel, torch.randn(B, C, H, W, device=dev, generator=g)


def _attn_grads(q, kp, vp, rel, g):
    leaves = [t.detach().requires_grad_() for t in (q, kp, vp, rel)]
    return torch.autograd.grad(attend3_reference(*leaves), leaves, g)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,W", [
    (1, 1, 1, 1), (2, 3, 1, 7), (2, 5, 2, 33), (3, 17, 9, 45), (1, 40, 37, 31), (2, 32, 16, 64),
    # the edges of #4's partition: H + 2 one short of, at and past a band of
    # padded rows, H a band and 2 bands + 1; W + 2 one short of, at and one
    # past a strip of padded columns, and past 2; odd W (unpaired rows)
    (1, 2, BWD_BAND - 2, BWD_STRIP - 2), (2, 3, BWD_BAND - 1, BWD_STRIP - 3),
    (1, 2, BWD_BAND, BWD_STRIP - 1), (2, 2, BWD_BAND + 1, 2 * BWD_STRIP - 1),
    (1, 3, 2 * BWD_BAND + 1, 1), (1, 4, 1, 2 * BWD_STRIP),
    # the edges of #3's partition: H one short of, at and one past a band of
    # output rows and past 2; W one short of, at and one past a strip of
    # output columns and 2; odd W, H = 1 and W = 1
    (1, 2, FWD_BAND - 1, FWD_STRIP - 1), (2, 3, FWD_BAND, FWD_STRIP),
    (1, 2, FWD_BAND + 1, FWD_STRIP + 1), (2, 2, 2 * FWD_BAND + 1, 2 * FWD_STRIP - 1),
    (1, 3, FWD_BAND, 2 * FWD_STRIP), (1, 2, 2 * FWD_BAND, 2 * FWD_STRIP + 1),
    (2, 3, 1, FWD_STRIP + 1), (1, 4, FWD_BAND + 1, 1)])
def test_attend3_kernels_match_plain(dev, B, C, H, W, dtype):
    q, kp, vp, rel, g = _attn(dev, B, C, H, W)
    ops = [t.to(dtype) for t in (q, kp, vp)]
    before = (attend3_fwd.launches, attend3_bwd.launches)
    out = attend3_fwd(*ops, rel)
    grads = attend3_bwd(*ops, rel, g.to(dtype))
    torch.cuda.synchronize()
    assert (attend3_fwd.launches, attend3_bwd.launches) == tuple(n + 1 for n in before)
    assert out.dtype == dtype and [t.dtype for t in grads] == [dtype] * 3 + [torch.float32]
    if dtype == torch.float32:
        torch.testing.assert_close(out, attend3_reference(q, kp, vp, rel), atol=1e-5, rtol=0)
        want = _attn_grads(*(t.double() for t in (q, kp, vp, rel, g)))
        for a, b in zip(grads, want):
            assert a.shape == b.shape and _rel(a.double(), b) <= 1e-4
    else:
        f = [t.float() for t in ops]
        assert _rel(out.float(), attend3_reference(*f, rel)) <= 1e-2
        for a, b in zip(grads, _attn_grads(*f, rel, g.to(dtype).float())):
            assert _rel(a.float(), b) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attend3_backward_takes_maps_off_a_pair_boundary(dev, dtype):
    # even W, but each map starts one value into its buffer: #4 loads and
    # stores single values there instead of pairs
    B, C, H, W = 2, 3, 11, 2 * BWD_STRIP
    q, kp, vp, rel, g = _attn(dev, B, C, H, W, seed=3)
    shifted = [torch.empty(t.numel() + 1, dtype=dtype, device=dev)[1:].view(t.shape)
               for t in (q, kp, vp, g)]
    for s, t in zip(shifted, (q, kp, vp, g)):
        s.copy_(t)
    got = attend3_bwd(shifted[0], shifted[1], shifted[2], rel, shifted[3])
    want = attend3_bwd(*(t.to(dtype) for t in (q, kp, vp)), rel, g.to(dtype))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attend3_forward_takes_maps_off_a_pair_boundary(dev, dtype):
    # even W, but each map starts one value into its buffer: #3 loads single
    # values there instead of pairs
    B, C, H, W = 2, 3, FWD_BAND + 3, 2 * FWD_STRIP
    q, kp, vp, rel, _ = _attn(dev, B, C, H, W, seed=4)
    shifted = [torch.empty(t.numel() + 1, dtype=dtype, device=dev)[1:].view(t.shape)
               for t in (q, kp, vp)]
    for s, t in zip(shifted, (q, kp, vp)):
        s.copy_(t)
    assert torch.equal(attend3_fwd(*shifted, rel), attend3_fwd(q.to(dtype), kp.to(dtype),
                                                               vp.to(dtype), rel))


def test_attend3_backward_is_deterministic_and_autograd_reaches_it(dev):
    q, kp, vp, rel, g = _attn(dev, 4, 32, 48, 160, seed=2)
    first, second = attend3_bwd(q, kp, vp, rel, g), attend3_bwd(q, kp, vp, rel, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    leaves = [t.clone().requires_grad_() for t in (q, kp, vp, rel)]
    attend3(*leaves).backward(g)
    assert all(torch.equal(t.grad, a) for t, a in zip(leaves, first))


def test_attend3_launches_on_the_current_stream_and_refuses(dev):
    q, kp, vp, rel, _ = _attn(dev, 2, 8, 20, 40)
    want = attend3_reference(q, kp, vp, rel)
    before = attend3_fwd.launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = attend3(q, kp, vp, rel)
    side.synchronize()
    assert attend3_fwd.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="contiguous"):
        attend3(q.transpose(2, 3).contiguous().transpose(2, 3), kp, vp, rel)
    with pytest.raises(ValueError, match="one device"):
        attend3(q, kp, vp, rel.cpu())
    with pytest.raises(TypeError):
        attend3(q.double(), kp.double(), vp.double(), rel.double())  # no float64 kernel
    with pytest.raises(TypeError, match="rel"):
        attend3(q.bfloat16(), kp.bfloat16(), vp.bfloat16(), rel.bfloat16())
    assert attend3_fwd.launches == before + 1


@pytest.mark.parametrize("shared_rel,use_bias", [(False, True), (True, False)])
def test_attention_conv_kernel_path_matches_the_plain_path(dev, shared_rel, use_bias):
    """The module on the card through #3/#4 (ring padded with the bias)
    against its plain path (bias through the zero-padded input) on the CPU:
    the output and every gradient, 1e-4 of max."""
    torch.manual_seed(0)
    mod = AttentionConv(12, 16, 3, use_bias=use_bias, shared_rel=shared_rel)
    x = torch.randn(2, 12, 13, 37)
    cpu, card = mod, AttentionConv(12, 16, 3, use_bias=use_bias, shared_rel=shared_rel).to(dev)
    card.load_state_dict(mod.state_dict())
    r = torch.randn(2, 16, 13, 37)
    xs = [x.clone().requires_grad_(), x.to(dev).requires_grad_()]
    outs = [cpu(xs[0]), card(xs[1], kernel=True)]
    for o, rr in zip(outs, (r, r.to(dev))):
        (o * rr).sum().backward()
    assert _rel(outs[1].cpu(), outs[0].detach()) <= 1e-4
    assert _rel(xs[1].grad.cpu(), xs[0].grad) <= 1e-4
    scale = max(p.grad.abs().max() for p in cpu.parameters())  # the key bias's is 0
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        assert ((a.grad.cpu() - b.grad).abs().max() / scale).item() <= 1e-4, name


# the recurrent family's small-channel convs (v1's cells and heads at 1
# channel, v2's at 2): (Cin, Cout) of each conv, and of its dx, the same
# conv from Cout to Cin
GRU_FAMILY_CONVS = [(1, 3), (1, 2), (1, 1), (2, 6), (2, 4), (2, 2), (2, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", ["zero", "reflect"])
@pytest.mark.parametrize("cin,cout", GRU_FAMILY_CONVS + [(3, 1), (4, 2), (6, 2)])
@pytest.mark.parametrize("B,h,w", [(1, 24, 80), (2, 37, 45)])
def test_gru_family_convs_match_twin(dev, B, h, w, cin, cout, pad, dtype):
    """The forward at v1's and v2's channel counts (and their dx's), every
    act, bias on and off, against the plain version (the bounds above)."""
    x, wt, b = _inputs(dev, B, cin, cout, h, w, seed=5)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", GRU_FAMILY_CONVS)
@pytest.mark.parametrize("pad", ["zero", "reflect"])
def test_gru_family_backward_matches_autograd(dev, cin, cout, pad, dtype):
    """dx (the forward kernel from Cout to Cin channels), dW and db of the
    family's small-channel convs against autograd of the plain version."""
    B, h, w, act = 2, 37, 45, ("sigmoid" if cout == 1 else "relu")
    x, wt, b = _inputs(dev, B, cin, cout, h, w, seed=6)
    g = torch.randn(B, cout, h, w, device=dev)
    xi, wi, bi = (t.to(dtype).requires_grad_() for t in (x, wt, b))
    before = (conv3x3.launches, conv3x3_dx.launches, conv3x3_dw.launches)
    conv3x3(xi, wi, bi, pad, act).backward(g.to(dtype))
    torch.cuda.synchronize()
    assert (conv3x3.launches, conv3x3_dx.launches, conv3x3_dw.launches) == tuple(
        n + 1 for n in before)
    xr, wr, br = (t.detach().float().requires_grad_() for t in (xi, wi, bi))
    with torch.no_grad():
        out = conv3x3(xi.detach(), wi.detach(), bi.detach(), pad, act).float()
        gp = (g.to(dtype).float() * act_grad(act, out)).to(dtype).float()
    conv3x3_reference(xr, wr, br, pad).backward(gp)
    for got, want in ((xi.grad, xr.grad), (wi.grad, wr.grad), (bi.grad, br.grad)):
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel(got.float(), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W", [(1, 24, 80), (2, 48, 160), (1, 96, 320)])
def test_attend3_at_two_channels(dev, B, H, W, dtype):
    """#3/#4 at C = 2, v2's attention units, at its scales 3 to 1 (scale
    0's 192x640 is chip_smoke.py's), against the plain attend3."""
    q, kp, vp, rel, g = _attn(dev, B, 2, H, W, seed=7)
    ops = [t.to(dtype) for t in (q, kp, vp)]
    out, grads = attend3_fwd(*ops, rel), attend3_bwd(*ops, rel, g.to(dtype))
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(out, attend3_reference(q, kp, vp, rel), atol=1e-5, rtol=0)
        want = _attn_grads(*(t.double() for t in (q, kp, vp, rel, g)))
        assert all(_rel(a.double(), b) <= 1e-4 for a, b in zip(grads, want))
    else:
        f = [t.float() for t in ops]
        assert _rel(out.float(), attend3_reference(*f, rel)) <= 1e-2
        assert all(_rel(a.float(), b) <= 1e-2
                   for a, b in zip(grads, _attn_grads(*f, rel, g.to(dtype).float())))


def _shared_rel(dev, C, seed):
    """A channel-shared (9, C) relative-embedding table, as the fusion
    blocks' ``AttentionConv(shared_rel=True)`` builds it: rel_h by window
    row in the first C/2 channels, rel_w by window column in the rest."""
    torch.manual_seed(seed)
    return AttentionConv(C, C, 3, use_bias=True, shared_rel=True).rel_table().detach().to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,W", [(2, 4, 24, 80), (1, 4, 96, 320), (2, 256, 24, 80),
                                     (1, 2, 48, 160)])
def test_attend3_at_the_fusion_shapes(dev, B, C, H, W, dtype):
    """#3/#4 at the 3-frame fusion blocks' shapes with shared embeddings:
    C = 4 (Fusion_v3's third unit), C = 256 (the pyramid's first block) at
    24x80, C = 2 (its other units); against the plain attend3. chip_smoke.py
    phase 22 holds every fusion shape at 640x192."""
    q, kp, vp, _, g = _attn(dev, B, C, H, W, seed=8)
    rel = _shared_rel(dev, C, seed=8)
    ops = [t.to(dtype) for t in (q, kp, vp)]
    out, grads = attend3_fwd(*ops, rel), attend3_bwd(*ops, rel, g.to(dtype))
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(out, attend3_reference(q, kp, vp, rel), atol=1e-5, rtol=0)
        want = _attn_grads(*(t.double() for t in (q, kp, vp, rel, g)))
        assert all(_rel(a.double(), b) <= 1e-4 for a, b in zip(grads, want))
    else:
        f = [t.float() for t in ops]
        assert _rel(out.float(), attend3_reference(*f, rel)) <= 1e-2
        assert all(_rel(a.float(), b) <= 1e-2
                   for a, b in zip(grads, _attn_grads(*f, rel, g.to(dtype).float())))


@pytest.mark.parametrize("variant", ["pyramid", "v3", "scale_loop"])
def test_fusion_on_the_card_matches_the_cpu(dev, variant):
    """One seeded fusion module of each variant on per-frame decoder outputs
    at 32x64, B=2, float32: the card (attend3, 24 launches) against the
    CPU (the plain attend3), 1e-4 of the largest value."""
    from ssde_tpu_torch.models import FeatureFusionBlock, Fusion, Fusion_v3
    from ssde_tpu_torch.models.common import init_weights_

    make = {"pyramid": Fusion, "v3": Fusion_v3, "scale_loop": FeatureFusionBlock}[variant]
    cpu = make().eval()
    init_weights_(cpu, torch.Generator().manual_seed(9))
    card = make().to(dev).eval()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(9)
    ch = (16, 32, 64, 128) if variant == "pyramid" else (1, 1, 1, 1)
    frames = [{f"disp/{s}": torch.rand(2, ch[s], 32 >> s, 64 >> s, generator=g)
               for s in range(4)} for _ in range(3)]

    def run(module, device):
        fs = [{k: v.to(device) for k, v in f.items()} for f in frames]
        if variant != "scale_loop":
            return module(*fs)
        out, upt = {}, torch.zeros_like(fs[0]["disp/3"])
        for s in range(3, -1, -1):
            out[f"disp/{s}"], upt = module(fs[0][f"disp/{s}"], upt, fs[1][f"disp/{s}"],
                                           fs[2][f"disp/{s}"])
        return out

    with torch.no_grad():
        want = run(cpu, "cpu")
        before = attend3_fwd.launches
        got = run(card, dev)
        torch.cuda.synchronize()
    assert attend3_fwd.launches - before == 24
    for k in want:
        assert _rel(got[k].cpu(), want[k]) <= 1e-4, k


@pytest.mark.parametrize("C", [2, 4, 32])
def test_shared_embedding_gradients_through_the_kernel(dev, C):
    """An AttentionConv with channel-shared embeddings at a fusion width
    (the rel_h | rel_w split 1 | 1 at C = 2, 2 | 2 at C = 4) through #3/#4
    on the card against its plain path on the CPU: the output and every
    gradient, rel_h and rel_w (#4's drel summed through the expand)
    included, 1e-4 of max (the key bias, whose gradient is 0, against the
    largest)."""
    torch.manual_seed(C)
    cpu = AttentionConv(C, C, 3, use_bias=True, shared_rel=True)
    card = AttentionConv(C, C, 3, use_bias=True, shared_rel=True).to(dev)
    card.load_state_dict(cpu.state_dict())
    x, r = torch.randn(2, C, 24, 80), torch.randn(2, C, 24, 80)
    xs = [x.clone().requires_grad_(), x.to(dev).requires_grad_()]
    outs = [cpu(xs[0]), card(xs[1], kernel=True)]
    for o, rr in zip(outs, (r, r.to(dev))):
        (o * rr).sum().backward()
    assert _rel(outs[1].cpu(), outs[0].detach()) <= 1e-4
    assert _rel(xs[1].grad.cpu(), xs[0].grad) <= 1e-4
    scale = max(p.grad.abs().max() for p in cpu.parameters())
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        ref = scale if name == "key_conv.bias" else b.grad.abs().max()
        assert ((a.grad.cpu() - b.grad).abs().max() / ref).item() <= 1e-4, name


@pytest.mark.parametrize("variant,attention", [("pyramid", True), ("v3", True), ("v3", False),
                                               ("scale_loop", True)])
def test_fusion_train_step_on_the_card(dev, variant, attention):
    """One fusion train step at 64x128, B=2, float32 (TF32 off) on the card
    and on the CPU from the same weights and batch: #3 and #4 launched 24
    times each (none with conv units), the warp's forward and backward
    twice, the photometric forward and backward once; finite losses, the
    card's within 1e-4 of the CPU's."""
    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.train.state import TrainState
    from ssde_tpu_torch.train.steps_fusion import TRAIN_FRAMES, build_fusion_models, train_step

    opts = Options(height=64, width=128, batch_size=2, compute_dtype="float32",
                   disable_attention=not attention)
    batch = make_synthetic_batch(2, 64, 128, frame_idxs=TRAIN_FRAMES, seed=0)
    counters = (attend3_fwd, attend3_bwd, warp_family_fwd, warp_family_bwd, photometric_fwd,
                photometric_bwd)
    loss = {}
    for where in ("cpu", dev):
        models = build_fusion_models(opts, variant, where, torch.Generator().manual_seed(0))
        state = TrainState(models.parameters(), 1e-4, 15, 1)
        before = [f.launches for f in counters]
        losses = train_step(models, state, to_device(batch, where))
        loss[str(where)] = float(losses["loss"])
        assert all(torch.isfinite(v) for v in losses.values())
    torch.cuda.synchronize()
    n = 24 if attention else 0
    assert [f.launches - b for f, b in zip(counters, before)] == [n, n, 2, 2, 1, 1]
    assert abs(loss[str(dev)] - loss["cpu"]) <= 1e-4 * abs(loss["cpu"])


def test_a_folder_saved_on_the_card_loads_on_the_cpu(dev, tmp_path):
    """weights_<epoch>/ written from a mono trainer's models and Adam on the
    card loads into models and an optimizer on the CPU bit for bit."""
    from ssde_tpu_torch import checkpoint
    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.train.state import TrainState
    from ssde_tpu_torch.train.steps import build_mono_models, train_step

    opts = Options(height=64, width=128, batch_size=2)
    card = build_mono_models(opts, dev, torch.Generator().manual_seed(0))
    state = TrainState(card.parameters(), 1e-4, 15, 1)
    train_step(card, state, to_device(make_synthetic_batch(2, 64, 128, seed=0), dev))
    checkpoint.save_folder(str(tmp_path), card, state.optimizer, height=64, width=128)
    cpu = build_mono_models(opts, "cpu", torch.Generator().manual_seed(1))
    cpu_state = TrainState(cpu.parameters(), 1e-4, 15, 1)
    assert checkpoint.load_folder(str(tmp_path), cpu)[1] == [
        "encoder", "depth", "pose_encoder", "pose"]
    assert checkpoint.load_adam(str(tmp_path / "adam.pth"), cpu_state.optimizer)
    for a, b in zip(card.modules(), cpu.modules()):
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            assert vb.device.type == "cpu" and torch.equal(va.cpu(), vb), k
    for pa, pb in zip(card.parameters(), cpu.parameters()):
        sa, sb = state.optimizer.state[pa], cpu_state.optimizer.state[pb]
        assert all(torch.equal(sa[k].cpu(), sb[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
