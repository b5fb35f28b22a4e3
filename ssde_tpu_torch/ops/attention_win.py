"""Fused 3x3 windowed per-channel attention, forward and backward: the
hand-written CUDA kernels and their plain PyTorch version.

Counterpart of ``ssde_tpu/ops/pallas/attention_win.py``: ``attend3`` and its
custom VJP ``_attend3_core`` (:274-377), whose forward ``_fwd_kernel`` and
backward ``_bwd_kernel`` become ``ssde_attend3_fwd`` and ``ssde_attend3_bwd``
in ``ssde_tpu_torch/csrc/attention_win.cu``. Per channel, over the 3x3
window of every pixel (tap i = kh*3 + kw):

    logit_i = q * (k_i + rel_i),   out = sum_i softmax_i(logit) * v_i

Layout is NCHW at true width: ``q`` (B, C, H, W); ``kp`` and ``vp`` (B, C,
H+2, W+2), padded by one pixel with the ring carrying the key and value
conv biases (zeros without bias), so that a ring's gradient reaches the
biases through the caller's pad; ``rel`` (9, C) float32. The TPU kernel's
planar (B, H, C, W) layout, 128-lane fill and logical width ``wl`` are
lane-layout workarounds with no counterpart here, and its saved softmax
weights (``want_s``) are not saved: the backward kernel recomputes them
(the source note of the .cu says why).

:func:`attend3` launches the kernels for CUDA tensors and raises on
anything they do not take; with an input that requires grad it goes
through an autograd Function whose backward is :func:`attend3_bwd`. Only
tensors on the CPU go to :func:`attend3_reference`, under ordinary
autograd: its autograd is the plain version of the backward kernel.
"""

from __future__ import annotations

import torch

from .build import launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forward kernel's partition (csrc/attention_win.cu's kFwdStrip,
# kFwdBand and kFwdWarps): one warp per (b, c) plane, strip of output
# columns and band of output rows, FWD_WARPS warps a block in a 1-D grid.
# The warp of strip s and band b writes the outputs at columns
# [FWD_STRIP * s, FWD_STRIP * (s + 1)), 2 a lane, of the output rows
# [FWD_BAND * b, FWD_BAND * (b + 1)); the lane of outputs x, x + 1 reads
# padded columns x .. x + 3 of the padded rows from FWD_BAND * b to 2 past
# the band.
FWD_STRIP, FWD_BAND, FWD_WARPS = 64, 16, 4
# the backward kernel's partition (csrc/attention_win.cu's kBwdWarpCols,
# kBwdStrip and kBwdBand): one warp per (b, c) plane, strip of padded
# columns and band of padded rows. The warp of strip s holds BWD_WARP_COLS
# padded columns from BWD_STRIP * s - 2, 2 a lane, and computes the outputs
# at the columns of all lanes but the last (their taps reach the next
# lane's columns); it owns the BWD_STRIP columns of its lanes but the first
# and the last (dk, dv there, and dq and drel of the outputs there) and
# the padded rows [BWD_BAND * b, BWD_BAND * (b + 1)) of band b, whose
# outputs it computes from 2 rows above the band on.
BWD_WARP_COLS, BWD_STRIP, BWD_BAND = 64, 60, 32


def _taps(t: torch.Tensor, H: int, W: int):
    """The 9 shifted (B, C, H, W) views of a padded (B, C, H+2, W+2) map,
    tap i = kh*3 + kw reading padded (h + kh, w + kw)."""
    return [t[:, :, kh:kh + H, kw:kw + W] for kh in range(3) for kw in range(3)]


def attend3_reference(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                      rel: torch.Tensor) -> torch.Tensor:
    """Plain version: the max-subtracted softmax over the 9 taps in float32
    (float64 stays float64), returned in ``q``'s dtype. The max is a
    constant of the softmax, so no gradient flows through it."""
    hi = torch.float64 if q.dtype == torch.float64 else torch.float32
    B, C, H, W = q.shape
    qf, r = q.to(hi), rel.to(hi)
    logits = [qf * (k + r[i].view(1, C, 1, 1))
              for i, k in enumerate(_taps(kp.to(hi), H, W))]
    m = torch.stack(logits).amax(0).detach()
    num = den = 0.0
    for logit, v in zip(logits, _taps(vp.to(hi), H, W)):
        e = torch.exp(logit - m)
        den = den + e
        num = num + e * v
    return (num / den).to(q.dtype)


def _check_args(q, kp, vp, rel, g=None) -> None:
    """What the kernels take; checked on the CPU too, so that the CPU tests
    catch a caller that would make the CUDA path raise (the CPU path also
    takes float64, for reference runs)."""
    tensors = (q, kp, vp, rel) if g is None else (q, kp, vp, rel, g)
    if any(t.device != q.device for t in tensors):
        raise ValueError("attend3: q, kp, vp, rel and the gradient must be on one device")
    ok = (*_DTYPES, torch.float64) if q.device.type == "cpu" else tuple(_DTYPES)
    maps = (q, kp, vp) if g is None else (q, kp, vp, g)
    if q.dtype not in ok or any(t.dtype != q.dtype for t in maps):
        raise TypeError("attend3: q, kp, vp and the gradient must all be float32 or all "
                        f"bfloat16, got {[t.dtype for t in maps]}")
    if rel.dtype != (torch.float64 if q.dtype == torch.float64 else torch.float32):
        raise TypeError(f"attend3: rel must be float32, got {rel.dtype}")
    if q.dim() != 4 or min(q.shape) < 1:
        raise ValueError(f"attend3: q must be (B, C, H, W), got {tuple(q.shape)}")
    B, C, H, W = q.shape
    if kp.shape != (B, C, H + 2, W + 2) or vp.shape != kp.shape:
        raise ValueError(f"attend3: kp and vp must be {(B, C, H + 2, W + 2)}, got "
                         f"{tuple(kp.shape)} and {tuple(vp.shape)}")
    if rel.shape != (9, C):
        raise ValueError(f"attend3: rel must be (9, {C}), got {tuple(rel.shape)}")
    if g is not None and g.shape != q.shape:
        raise ValueError(f"attend3: the gradient must be {tuple(q.shape)}, got {tuple(g.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attend3: inputs must be contiguous")
    if fwd_partition(B, C, H, W)[2] > 2**31 - 1 or bwd_partition(B, C, H, W)[2] > 2**31 - 1:
        raise ValueError(f"attend3: shape {tuple(q.shape)} exceeds the kernels' grid")


def _cuda_only(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def attend3_fwd(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                rel: torch.Tensor) -> torch.Tensor:
    """The forward kernel #3: (B, C, H, W) in ``q``'s dtype. CUDA only."""
    _check_args(q, kp, vp, rel)
    _cuda_only(q, "attend3_fwd")
    B, C, H, W = q.shape
    out = torch.empty_like(q)
    launch("ssde_attend3_fwd", q.device, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
           rel.data_ptr(), out.data_ptr(), B, C, H, W, _DTYPES[q.dtype])
    attend3_fwd.launches += 1
    return out


def fwd_partition(B: int, C: int, H: int, W: int) -> tuple[int, int, int]:
    """(strips, bands, blocks) of the forward kernel: the strips of
    FWD_STRIP output columns and the bands of FWD_BAND output rows of a
    plane, and its 1-D grid of FWD_WARPS warps a block. Its entry point
    computes the same and refuses more than 2^31 - 1 blocks."""
    strips, bands = -(-W // FWD_STRIP), -(-H // FWD_BAND)
    return strips, bands, -(-B * C * strips * bands // FWD_WARPS)


def bwd_partition(B: int, C: int, H: int, W: int) -> tuple[int, int, int]:
    """(strips, bands, n_partials) of the backward kernel: the strips of
    BWD_STRIP padded columns and the bands of BWD_BAND padded rows of a
    plane, and the rows of its drel scratch, one per warp. Its entry point
    checks the count."""
    strips, bands = -(-(W + 2) // BWD_STRIP), -(-(H + 2) // BWD_BAND)
    return strips, bands, B * C * strips * bands


def attend3_bwd(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, rel: torch.Tensor,
                g: torch.Tensor):
    """The backward kernel #4 for the output gradient ``g``: (dq, dkp, dvp)
    in the operands' dtype and drel (9, C) float32, the softmax recomputed
    and drel summed in a fixed order (deterministic). CUDA only."""
    _check_args(q, kp, vp, rel, g)
    _cuda_only(q, "attend3_bwd")
    B, C, H, W = q.shape
    dq, dkp, dvp = torch.empty_like(q), torch.empty_like(kp), torch.empty_like(vp)
    n = bwd_partition(B, C, H, W)[2]
    partial = torch.empty((n, 9), dtype=torch.float32, device=q.device)
    drel = torch.empty((9, C), dtype=torch.float32, device=q.device)
    launch("ssde_attend3_bwd", q.device, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
           rel.data_ptr(), g.data_ptr(), dq.data_ptr(), dkp.data_ptr(), dvp.data_ptr(),
           partial.data_ptr(), drel.data_ptr(), B, C, H, W, n, _DTYPES[q.dtype])
    attend3_bwd.launches += 1
    return dq, dkp, dvp, drel


# kernel launches; the CPU path does not count. The backward counts one per
# call of its two passes.
attend3_fwd.launches = 0
attend3_bwd.launches = 0


class _Attend3Fn(torch.autograd.Function):
    """The CUDA path with a gradient: kernel #3 forward, kernel #4 backward."""

    @staticmethod
    def forward(ctx, q, kp, vp, rel):
        ctx.save_for_backward(q, kp, vp, rel)
        return attend3_fwd(q, kp, vp, rel)

    @staticmethod
    def backward(ctx, g):
        return attend3_bwd(*ctx.saved_tensors, g.contiguous())


def attend3(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
            rel: torch.Tensor) -> torch.Tensor:
    """Fused 3x3 windowed per-channel attention on NCHW.

    q (B, C, H, W); kp, vp (B, C, H+2, W+2) with the +1 ring holding the
    key / value conv bias (zeros without bias); rel (9, C) float32, the
    relative embedding of window slot kh*3 + kw, added to the key taps.
    q, kp and vp are float32 or bfloat16 (float64 on the CPU), computed in
    float32 and returned in their dtype. Gradients reach all four operands.
    """
    _check_args(q, kp, vp, rel)
    if q.device.type == "cpu":
        return attend3_reference(q, kp, vp, rel)
    _cuda_only(q, "attend3")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, kp, vp, rel)):
        return _Attend3Fn.apply(q, kp, vp, rel)
    return attend3_fwd(q, kp, vp, rel)
