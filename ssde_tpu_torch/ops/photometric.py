"""Fused photometric error, 0.85 * SSIM + 0.15 * L1 per pixel, forward and
backward as hand-written CUDA kernels (counterpart of
``ssde_tpu/ops/pallas/photometric.py`` ``photometric_error_planar``).

``pred`` (G, C, H, W) and ``targ`` (B, C, H, W), float32 (the CPU twins
also take float64, for reference runs); pair g reads
``targ[g % B]``. The result (G, H, W) is
0.85 * clip((1 - SSIM) / 2, 0, 1) + 0.15 * |p - t|, averaged over
channels, with 3x3 box means under reflect padding (C1 = 0.01^2,
C2 = 0.03^2). The gradient reaches ``pred`` only.

:func:`photometric_fwd` and :func:`photometric_bwd` launch
``ssde_tpu_torch/csrc/photometric.cu`` for CUDA tensors and raise on
anything the kernels do not take; only CPU tensors go to the plain
versions, :func:`photometric_reference` (the ``ops/losses`` formulation)
and :func:`photometric_bwd_reference` (autograd of the plain forward).

:func:`fwd_partition` and :func:`bwd_partition` model how the kernels
split the work (warps, bands, strips, lanes, the columns and rows each lane
loads, the fold-back multiplicities of the backward), so that the CPU tests
can check it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import torch

from .build import launch
from .losses import ssim

_SSIM_W, _L1_W = 0.85, 0.15

# the kernels' partition (csrc/photometric.cu's kFwdStrip, kFwdBand,
# kBwdCols, kBwdStrip, kBwdBand and kWarps). One warp per (pair g,
# band of output rows, strip of columns), WARPS warps a block in a 1-D grid
# whose fastest index is the pair among the G / B that share a target.
# Forward: the warp of strip s writes the FWD_STRIP output columns from
# FWD_STRIP * s, 2 a lane. Backward: it holds BWD_COLS columns from
# BWD_STRIP * s - 2, 2 a lane, and writes the BWD_STRIP of lanes 1..30. A
# lane of columns x, x + 1 loads columns x - 1 .. x + 2 of each row,
# reflected into the image; the warp walks its rows once per channel.
FWD_STRIP, FWD_BAND = 64, 4
BWD_COLS, BWD_STRIP, BWD_BAND = 64, 60, 16
WARPS, LANES = 4, 32


# Floating-point operations per value (pixel and channel) of the kernels'
# bodies, counted from csrc/photometric.cu per column of a lane (its halo
# products included); a fused multiply-add counts 2 (as the 67 TFLOP/s
# float32 peak counts it), a reciprocal, compare, min, max or abs 1:
#   both:     products x^2, y^2, xy of the 4 columns a lane takes, 12 / 2 =
#             6; horizontal 3-sums, the pair's shared, 5 x 3 / 2 = 7.5;
#             vertical, 10
#   forward:  SSIM's factors from the sums scaled by 81, 15; n / d by one
#             reciprocal, the clip and 0.85 s, 10; 0.15 |x - y|, 4: 52.5,
#             and 1 a pixel for the 1 / C
#   backward: window statistics 19 (means 2, products 3, variances and
#             covariance 6, u, v, w, z 8); coefficients 18 (n, d, 1 / d,
#             n / d 4, the live tests and g / d 3, g's scale 1, the cofactor
#             6, a, b, c 4); the horizontal adjoint 3 x 2 FMAs = 12; the
#             vertical 12; the sign's two compares and dx 9: 93.5
FWD_OPS, BWD_OPS = 52.5, 93.5


def work(kind: str, G: int, B: int, C: int, H: int, W: int) -> tuple[float, float]:
    """(floating-point operations, bytes) of one launch of the forward
    (``kind`` "fwd") or backward ("bwd") kernel: every input read once
    (the target once for its G / B pairs), every output written once,
    float32."""
    n_pred, n_targ, n_map = G * C * H * W, B * C * H * W, G * H * W
    if kind == "fwd":
        return FWD_OPS * n_pred + n_map, 4.0 * (n_pred + n_targ + n_map)
    return BWD_OPS * n_pred, 4.0 * (2 * n_pred + n_targ + n_map)


def reflect(i: int, n: int) -> int:
    """The kernels' reflect: -1 -> 1, n -> n - 2, further out clamped."""
    i = -i if i < 0 else i
    i = 2 * (n - 1) - i if i > n - 1 else i
    return min(max(i, 0), n - 1)


def fold(q: int, p: int, n: int) -> int:
    """Fold-back multiplicity of the reflect-pad 3x3 box sum's adjoint: how
    often row (or column) q of the box sum's output reads p, |q - p| <= 1."""
    if q < 0 or q >= n:
        return 0
    return 2 if (q == 0 and p == 1) or (q == n - 1 and p == n - 2) else 1


def lane_columns(x: int, W: int, vec: bool, lane: int = 1,
                 edge: bool = True) -> tuple[int, int, int, int]:
    """The columns (l, a0, a1, r) whose values lane ``lane`` of columns
    x, x + 1 takes: x - 1, the pair, x + 2, reflected. With ``vec`` (W even)
    it loads only the pair, one aligned float2 at a0 (x clamped into the
    image); its halo is the neighbour lanes' a1 and a0 (shuffles), its own
    other value where the image ends, and at the warp's edge lanes a load
    where ``edge`` (the forward), else the lane's own value (a shuffle from
    beyond the warp)."""
    if not vec:
        return reflect(x - 1, W), reflect(x, W), reflect(x + 1, W), reflect(x + 2, W)
    a0 = min(max(x, 0), W - 2)
    l = a0 - 1 if a0 > 0 and (edge or lane > 0) else a0 + 1
    r = a0 + 2 if a0 + 2 < W and (edge or lane < LANES - 1) else a0
    return l, a0, a0 + 1, r


@dataclasses.dataclass(frozen=True)
class Unit:
    """One warp's work. Lane ``l`` holds columns ``x[l]``, ``x[l] + 1``,
    loads ``cols[l]`` of every row and writes the columns ``own[l]`` says;
    ``rows`` are the input rows the warp loads, in order; ``out_rows`` the
    output rows it writes. Backward only: ``coef_rows`` are the rows whose
    coefficients it computes (row i from input rows i - 1, i, i + 1 as
    loaded), ``mcol[l]`` the lane's column fold-backs (x - 1 into x, x + 1
    into x, x into x + 1, x + 2 into x + 1), and ``mrow[i]`` the row
    fold-backs (r - 1 into r, r + 1 into r) of ``out_rows[i]``."""
    g: int
    b: int
    x: tuple[int, ...]
    cols: tuple[tuple[int, int, int, int], ...]
    own: tuple[tuple[bool, bool], ...]
    rows: tuple[int, ...]
    out_rows: tuple[int, ...]
    coef_rows: tuple[int, ...] = ()
    mcol: tuple[tuple[int, int, int, int], ...] = ()
    mrow: tuple[tuple[int, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class Partition:
    """The grid of one kernel: strips and bands of a plane, blocks of the
    1-D grid, and (``units()``) each warp's work in grid order."""
    G: int
    B: int
    H: int
    W: int
    backward: bool
    vec: bool

    @property
    def strips(self) -> int:
        return -(-self.W // (BWD_STRIP if self.backward else FWD_STRIP))

    @property
    def bands(self) -> int:
        return -(-self.H // (BWD_BAND if self.backward else FWD_BAND))

    @property
    def blocks(self) -> int:
        return -(-self.G * self.strips * self.bands // WARPS)

    def units(self) -> Iterator[Unit]:
        """unit = ((b * bands + band) * strips + strip) * (G / B) + k reads
        pair g = k * B + b."""
        H, W, pairs = self.H, self.W, self.G // self.B
        for b in range(self.B):
            for band in range(self.bands):
                for strip in range(self.strips):
                    for k in range(pairs):
                        yield (self._bwd_unit if self.backward else self._fwd_unit)(
                            k * self.B + b, b, band, strip, H, W)

    def _fwd_unit(self, g, b, band, strip, H, W) -> Unit:
        xs = tuple(strip * FWD_STRIP + 2 * l for l in range(LANES))
        y0, y1 = band * FWD_BAND, min((band + 1) * FWD_BAND, H)
        return Unit(g, b, xs,
                    tuple(lane_columns(x, W, self.vec, l) for l, x in enumerate(xs)),
                    tuple((x < W, x + 1 < W) for x in xs),
                    tuple(reflect(y, H) for y in range(y0 - 1, y1 + 1)), tuple(range(y0, y1)))

    def _bwd_unit(self, g, b, band, strip, H, W) -> Unit:
        xs = tuple(strip * BWD_STRIP - 2 + 2 * l for l in range(LANES))
        p0, p1 = band * BWD_BAND, min((band + 1) * BWD_BAND, H)
        qa, qb = max(p0 - 1, 0), min(p1, H - 1)
        out_rows = tuple(range(p0, p1))
        return Unit(g, b, xs,
                    tuple(lane_columns(x, W, self.vec, l, False) for l, x in enumerate(xs)),
                    tuple((0 < l < LANES - 1 and x < W, 0 < l < LANES - 1 and x + 1 < W)
                          for l, x in enumerate(xs)),
                    tuple(reflect(y, H) for y in range(qa - 1, qb + 2)), out_rows,
                    tuple(range(qa, qb + 1)),
                    tuple((fold(x - 1, x, W), fold(x + 1, x, W), fold(x, x + 1, W),
                           fold(x + 2, x + 1, W)) for x in xs),
                    tuple((fold(r - 1, r, H), fold(r + 1, r, H)) for r in out_rows))


def fwd_partition(G: int, B: int, H: int, W: int, vec: bool | None = None) -> Partition:
    """The forward kernel's partition; ``vec`` (float2 pairs) defaults to
    W even, as the entry point picks it for aligned planes."""
    return Partition(G, B, H, W, False, W % 2 == 0 if vec is None else vec)


def bwd_partition(G: int, B: int, H: int, W: int, vec: bool | None = None) -> Partition:
    """The backward kernel's partition (see :func:`fwd_partition`)."""
    return Partition(G, B, H, W, True, W % 2 == 0 if vec is None else vec)


def _check_args(pred, targ, gout=None) -> None:
    tensors = (pred, targ) if gout is None else (pred, targ, gout)
    if any(t.device != pred.device for t in tensors):
        raise ValueError("photometric: pred, targ and the gradient must be on one device")
    ok = (torch.float32, torch.float64) if pred.device.type == "cpu" else (torch.float32,)
    if pred.dtype not in ok or any(t.dtype != pred.dtype for t in tensors):
        raise TypeError("photometric: float32 (float64 on the CPU twins), got "
                        f"{[t.dtype for t in tensors]}")
    if pred.dim() != 4 or targ.dim() != 4 or pred.shape[1:] != targ.shape[1:]:
        raise ValueError(f"photometric: pred (G, C, H, W) and targ (B, C, H, W) "
                         f"must agree, got {tuple(pred.shape)} and {tuple(targ.shape)}")
    G, C, H, W = pred.shape
    B = targ.shape[0]
    if B < 1 or G % B:
        raise ValueError(f"photometric: G={G} is not a multiple of B={B}")
    if min(H, W) < 2 or C < 1:
        raise ValueError(f"photometric: unsupported shape {tuple(pred.shape)}")
    if max(fwd_partition(G, B, H, W).blocks, bwd_partition(G, B, H, W).blocks) > 2**31 - 1:
        raise ValueError(f"photometric: {tuple(pred.shape)} needs a grid past 2^31 - 1 blocks")
    if gout is not None and gout.shape != (G, H, W):
        raise ValueError(f"photometric: gradient must be {(G, H, W)}, got {tuple(gout.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("photometric: inputs must be contiguous")


def _tiled_targ(pred, targ):
    return targ.repeat(pred.shape[0] // targ.shape[0], 1, 1, 1)


def photometric_reference(pred: torch.Tensor, targ: torch.Tensor) -> torch.Tensor:
    """Plain forward: ``ops.losses.reprojection_loss`` on the tiled target."""
    t = _tiled_targ(pred, targ)
    l1 = torch.mean(torch.abs(t - pred), 1)
    return _SSIM_W * torch.mean(ssim(pred, t), 1) + _L1_W * l1


def photometric_bwd_reference(pred: torch.Tensor, targ: torch.Tensor,
                              gout: torch.Tensor) -> torch.Tensor:
    """Plain backward: d pred (G, C, H, W) for the upstream ``gout``
    (G, H, W), autograd of :func:`photometric_reference` (the clip passes
    gradient on the closed interval and sign(0) = 0, as ``jax.grad`` of
    the plain formulation gives)."""
    with torch.enable_grad():
        p = pred.detach().requires_grad_()
        return torch.autograd.grad(photometric_reference(p, targ), p, gout)[0]


def photometric_fwd(pred: torch.Tensor, targ: torch.Tensor) -> torch.Tensor:
    """Per-pixel photometric error (G, H, W) of ``pred`` against
    ``targ[g % B]``."""
    _check_args(pred, targ)
    if pred.device.type == "cpu":
        return photometric_reference(pred, targ)
    if pred.device.type != "cuda":
        raise ValueError(f"photometric: no kernel for device {pred.device}")
    G, C, H, W = pred.shape
    out = torch.empty((G, H, W), dtype=pred.dtype, device=pred.device)
    launch("ssde_photometric_fwd", pred.device, pred.data_ptr(), targ.data_ptr(),
            out.data_ptr(), G, targ.shape[0], C, H, W)
    photometric_fwd.launches += 1
    return out


def photometric_bwd(pred: torch.Tensor, targ: torch.Tensor,
                    gout: torch.Tensor) -> torch.Tensor:
    """d pred (G, C, H, W) of the photometric error for upstream ``gout``."""
    _check_args(pred, targ, gout)
    if pred.device.type == "cpu":
        return photometric_bwd_reference(pred, targ, gout)
    if pred.device.type != "cuda":
        raise ValueError(f"photometric: no kernel for device {pred.device}")
    G, C, H, W = pred.shape
    dpred = torch.empty_like(pred)
    launch("ssde_photometric_bwd", pred.device, pred.data_ptr(), targ.data_ptr(),
            gout.data_ptr(), dpred.data_ptr(), G, targ.shape[0], C, H, W)
    photometric_bwd.launches += 1
    return dpred


photometric_fwd.launches = 0  # kernel launches; the CPU twins do not count
photometric_bwd.launches = 0


class _PhotometricError(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, targ):
        ctx.save_for_backward(pred, targ)
        return photometric_fwd(pred, targ)

    @staticmethod
    def backward(ctx, gout):
        pred, targ = ctx.saved_tensors
        return photometric_bwd(pred, targ, gout.contiguous()), None


def photometric_error(pred: torch.Tensor, targ: torch.Tensor) -> torch.Tensor:
    """Differentiable photometric error (G, H, W); gradient into ``pred``
    only (the target is raw data)."""
    return _PhotometricError.apply(pred, targ.detach())
