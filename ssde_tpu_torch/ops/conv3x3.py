"""Fused 3x3 SAME conv + bias + activation, forward and backward: the
hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``ssde_tpu/ops/pallas/conv3x3.py``: the Pallas
``_fwd_kernel`` behind ``conv3x3``, ``conv3x3_zero`` and
``conv3x3_zero_chain``, and the custom VJPs ``_c3z_bwd`` and ``_c3_bwd``,
which run that same kernel as dx and ``_dw_kernel`` as dW. Layout is NCHW
at true width; the TPU kernel's planar layout, 128-lane padding and logical
width ``wl`` are lane-layout workarounds with no counterpart here.

Each dtype has one body of each kernel, both implicit GEMMs on the tensor
cores: float32 runs the 3xTF32 kernels of ``ssde_tpu_torch/csrc/conv3x3_tf32.cu``
(each operand split into tf32 hi + lo, three products per float32 one),
bf16 those of ``csrc/conv3x3_tc.cu``. The forwards read the weights packed
by :func:`pack_weights` (float32: split into hi and lo planes), once per
weight tensor and version (:func:`packed_weights`). :func:`conv3x3`
launches them for CUDA tensors and
raises on anything they do not take; when an input requires grad it goes
through an autograd Function whose backward launches the same forward
kernel as dx (:func:`conv3x3_dx`) and the weight-gradient kernel
(:func:`conv3x3_dw`). Only tensors that lie on the CPU go to
:func:`conv3x3_reference`, under ordinary autograd: its autograd is the
plain version of both backward kernels. :func:`conv3x3_igemm_reference` is
the plain version of the bf16 forward's own arithmetic: the packed weights
against an im2col in the kernel's K order; :func:`conv3x3_tf32x3_reference`
that of the float32 forward: three such products of the split operands
(:func:`tf32_split`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .build import launch
from .image import reflect_pad_2d

PADS = ("zero", "reflect")
ACTS = ("none", "relu", "elu", "sigmoid", "tanh")  # codes 0..4 in the kernel
_DTYPES = (torch.float32, torch.bfloat16)
# weight-gradient blocks per SM to aim for when splitting the pixel sum, by
# (dtype, output channels per block) (dw_tile_m). bf16: 64-row blocks take
# 255 registers a thread, so 2 fit an SM, 32-row ones 168 (3 fit), the
# Cout = 1 path 80; of 2, 3 and 4 a sweep on an H100 found these fastest.
# float32: the 32-row block stages 96.6 KB of shared memory (2 fit an SM),
# the Cout = 1 path 69 KB (3 fit).
_DW_BLOCKS_PER_SM = {(torch.bfloat16, 64): 2, (torch.bfloat16, 32): 3, (torch.bfloat16, 1): 4,
                     (torch.float32, 32): 2, (torch.float32, 1): 3}
_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "none":
        return x
    if act == "relu":
        return F.relu(x)
    if act == "elu":
        return F.elu(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown act {act!r}; expected one of {ACTS}")


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None, pad: str = "zero",
                      act: str = "none") -> torch.Tensor:
    """Plain version: zero or reflect pad, F.conv2d, then the act."""
    if pad not in PADS:
        raise ValueError(f"unknown pad {pad!r}; expected one of {PADS}")
    xp = reflect_pad_2d(x) if pad == "reflect" else F.pad(x, (1, 1, 1, 1))
    return activation(F.conv2d(xp, w, b), act)


def _check_args(x, w, b, pad, act):
    """What the kernel takes; checked on the CPU too, so that the CPU tests
    catch a caller that would make the CUDA path raise."""
    if pad not in PADS:
        raise ValueError(f"unknown pad {pad!r}; expected one of {PADS}")
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {ACTS}")
    tensors = (x, w) if b is None else (x, w, b)
    if any(t.device != x.device for t in tensors):
        raise ValueError("conv3x3: x, w and b must be on one device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("conv3x3: x, w and b must all be float32 or all "
                        f"bfloat16, got {[t.dtype for t in tensors]}")
    if x.dim() != 4:
        raise ValueError(f"conv3x3: x must be (B, Cin, H, W), got {tuple(x.shape)}")
    B, Cin, H, W = x.shape
    if w.shape != (w.shape[0], Cin, 3, 3):
        raise ValueError(f"conv3x3: w must be (Cout, {Cin}, 3, 3), got {tuple(w.shape)}")
    if b is not None and b.shape != (w.shape[0],):
        raise ValueError(f"conv3x3: b must be ({w.shape[0]},), got {tuple(b.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3x3: x, w and b must be contiguous")
    if min(B, Cin, H, W) < 1 or (pad == "reflect" and min(H, W) < 2):
        raise ValueError(f"conv3x3: unsupported shape {tuple(x.shape)} for {pad} pad")
    # the forward, and the backward's dx (a conv from Cout to Cin channels):
    # a block per 4 pixel rows (gridDim.y) and per image and BN output
    # channels (gridDim.z)
    for cin, cout in ((Cin, w.shape[0]), (w.shape[0], Cin)):
        blocks, rows = -(-cout // fwd_tiles(cin, cout, x.dtype)[1]), -(-H // 4)
        if B * blocks > _GRID_YZ or rows > _GRID_YZ:
            raise ValueError("conv3x3: batch x output-channel blocks or row tiles "
                             "exceed the grid")


def fwd_tiles(cin: int, cout: int, dtype: torch.dtype = torch.bfloat16) -> tuple:
    """(CC, BN) of the forward kernel of ``dtype`` for a conv from ``cin``
    to ``cout`` channels: input channels staged per step and output channels
    per block (n8 MMA fragments). bf16 stages 16 or 32 channels (K steps 16
    deep) for 8, 32 or 64 output channels (96 takes 3 blocks of 32, not 2
    of 64 with a fourth empty). float32 stages 8 or 16 (K steps 8 deep;
    with its hi and lo weights, 32 would leave one block an SM) for 8 or 32
    (with 64 its split operands spill)."""
    if dtype == torch.float32:
        return (8 if cin <= 8 else 16), (8 if cout <= 8 else 32)
    cc = 16 if cin <= 16 else 32
    if cout <= 8:
        return cc, 8
    return cc, (32 if cout <= 32 or cout % 64 else 64)


def pack_weights(w: torch.Tensor, cc: int, bn: int) -> torch.Tensor:
    """The forward's B operand: (Cout, Cin, 3, 3) weights as (N_pad, 9,
    Cin_pad), tap-major and ci-minor (K = tap * Cin_pad + ci, tap = 3 ky +
    kx), zero-filled up to multiples of ``bn`` output and ``cc`` input
    channels, so that the kernel reads whole 16-byte rows and masks only
    its stores."""
    cout, cin = w.shape[:2]
    wp = w.new_zeros(-(-cout // bn) * bn, 9, -(-cin // cc) * cc)
    wp[:cout, :, :cin] = w.reshape(cout, cin, 9).transpose(1, 2)
    return wp


def tf32_split(x: torch.Tensor) -> tuple:
    """(hi, lo) of float32 ``x``: hi is x rounded to tf32 (10 mantissa bits)
    to nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds, and
    lo the same rounding of x - hi (exact in float32); hi + lo is x within
    2^-22 of |x|. Infinities and NaNs pass through as hi (their lo is NaN,
    as on the card); a finite x that rounds past the largest float gives an
    infinite hi."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)

    def rna(b):
        r = (b + 0x1000) & -0x2000  # add half of the 13 dropped bits' unit, drop them
        return torch.where((b & 0x7F800000) == 0x7F800000, b, r).view(torch.float32)

    hi = rna(bits)
    return hi, rna((x - hi).contiguous().view(torch.int32))


def packed_weights(w: torch.Tensor, cc: int, bn: int) -> torch.Tensor:
    """The forward kernel's packed B operand for ``w`` (:func:`pack_weights`;
    for float32 its :func:`tf32_split` planes, hi then lo, as (2, N_pad, 9,
    Cin_pad)), packed at most once per weight tensor and version: the result
    is kept on ``w`` and reused while ``w`` keeps its data, dtype and
    ``_version`` (an in-place update, ``load_state_dict`` included, bumps
    it). Inference tensors have no version counter and are packed every
    time. Each packing adds one to ``packed_weights.packs``."""
    key = None if w.is_inference() else (w._version, w.data_ptr(), w.dtype, cc, bn)
    kept = getattr(w, "_ssde_packed", None)
    if key is not None and kept is not None and kept[0] == key:
        return kept[1]
    wp = pack_weights(w, cc, bn)
    if w.dtype == torch.float32:
        wp = torch.stack(tf32_split(wp))
    packed_weights.packs += 1
    if key is not None:
        w._ssde_packed = (key, wp)
    return wp


packed_weights.packs = 0


def conv3x3_igemm_reference(x: torch.Tensor, wp: torch.Tensor, cout: int,
                            b: Optional[torch.Tensor] = None, pad: str = "zero",
                            act: str = "none") -> torch.Tensor:
    """Plain implicit GEMM: the packed weights ``wp`` (:func:`pack_weights`)
    against the im2col of ``x`` (F.unfold of the padded input), reordered
    to the kernel's K order (tap-major, ci-minor), then bias and act; the
    first ``cout`` of wp's rows are the output."""
    if pad not in PADS:
        raise ValueError(f"unknown pad {pad!r}; expected one of {PADS}")
    B, cin, H, W = x.shape
    n_pad, _, cin_pad = wp.shape
    xp = reflect_pad_2d(x) if pad == "reflect" else F.pad(x, (1, 1, 1, 1))
    cols = F.unfold(F.pad(xp, (0, 0, 0, 0, 0, cin_pad - cin)), 3)  # K = ci * 9 + tap
    cols = cols.view(B, cin_pad, 9, H * W).transpose(1, 2).reshape(B, 9 * cin_pad, H * W)
    out = (wp.reshape(n_pad, 9 * cin_pad) @ cols)[:, :cout].view(B, cout, H, W)
    if b is not None:
        out = out + b.view(1, cout, 1, 1)
    return activation(out, act)


def conv3x3_tf32x3_reference(x: torch.Tensor, w: torch.Tensor,
                             b: Optional[torch.Tensor] = None, pad: str = "zero",
                             act: str = "none") -> torch.Tensor:
    """Plain version of the float32 forward kernel's arithmetic: x and the
    packed weights split into tf32 hi + lo (:func:`tf32_split`), the three
    products lo * w_hi + hi * w_lo + hi * w_hi, each an implicit GEMM as in
    :func:`conv3x3_igemm_reference`, summed in that order in float32; then
    bias and act."""
    cout, cin = w.shape[:2]
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(pack_weights(w, *fwd_tiles(cin, cout,
                                                                            torch.float32)))
    out = sum(conv3x3_igemm_reference(a, wp, cout, pad=pad)
              for a, wp in ((xl, wh), (xh, wl), (xh, wh)))
    if b is not None:
        out = out + b.view(1, cout, 1, 1)
    return activation(out, act)


def _launch_fwd(x, w, b, pad, act):
    B, Cin, H, W = x.shape
    Cout = w.shape[0]
    out = torch.empty((B, Cout, H, W), dtype=x.dtype, device=x.device)
    cc, bn = fwd_tiles(Cin, Cout, x.dtype)
    wp = packed_weights(w, cc, bn)
    name = "ssde_conv3x3_fwd_bf16" if x.dtype == torch.bfloat16 else "ssde_conv3x3_fwd_tf32"
    launch(name, x.device, x.data_ptr(), wp.data_ptr(), None if b is None else b.data_ptr(),
           out.data_ptr(), B, Cin, H, W, Cout, wp.shape[-1], cc, bn, int(pad == "reflect"),
           ACTS.index(act))
    return out


def _cuda_only(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")


def rot_w(w: torch.Tensor) -> torch.Tensor:
    """Weights of the data-gradient conv (``_rot_w``, conv3x3.py:201-203):
    rotated 180 degrees, in and out swapped -> (Cin, Cout, 3, 3)."""
    return w.flip(2, 3).transpose(0, 1).contiguous()


def conv3x3_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of the zero-pad conv for the output gradient ``g`` (B, Cout, H, W)
    and its weights ``w`` (Cout, Cin, 3, 3): the zero-pad conv of ``g`` with
    :func:`rot_w` weights, in ``g``'s dtype. On CUDA it is the forward
    kernel; on the CPU its plain version."""
    wr = rot_w(w)
    _check_args(g, wr, None, "zero", "none")
    if g.device.type == "cpu":
        return conv3x3_reference(g, wr)
    _cuda_only(g, "conv3x3_dx")
    out = _launch_fwd(g, wr, None, "zero", "none")
    conv3x3_dx.launches += 1
    return out


def conv3x3_dw_reference(x: torch.Tensor, g: torch.Tensor, pad: str = "zero") -> torch.Tensor:
    """Plain weight gradient: autograd of :func:`conv3x3_reference` with
    respect to its weights, in float32 (float64 stays float64)."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    with torch.enable_grad():
        w = torch.zeros(g.shape[1], x.shape[1], 3, 3, dtype=dt, device=x.device,
                        requires_grad=True)
        out = conv3x3_reference(x.to(dt), w, None, pad)
        return torch.autograd.grad(out, w, g.to(dt))[0]


def dw_tile_m(cout: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Output channels per block of the weight gradient of ``dtype``: 1 for
    the Cout = 1 heads (their CUDA-core path), else m16 MMA fragments: bf16
    32 or 64 (96 takes 3 blocks of 32, not 2 of 64 with a fourth empty),
    float32 32 (its split fragments leave no registers for 64)."""
    if cout == 1:
        return 1
    if dtype == torch.float32:
        return 32
    return 64 if cout % 64 == 0 else 32


def dw_partitions(B: int, H: int, W: int, Cin: int, Cout: int, sms: int,
                  dtype: torch.dtype = torch.bfloat16) -> int:
    """P, the number of pixel partitions of the weight-gradient kernel of
    ``dtype``: enough blocks for ``_DW_BLOCKS_PER_SM`` per SM, at most one
    per pixel tile. A block takes :func:`dw_tile_m` x 32 channels and walks
    4x64 pixel tiles."""
    m = dw_tile_m(Cout, dtype)
    tiles, per_sm = B * -(-H // 4) * -(-W // 64), _DW_BLOCKS_PER_SM[(dtype, m)]
    chunks = -(-Cout // m) * -(-Cin // 32)
    return max(1, min(tiles, -(-per_sm * sms // chunks), _GRID_YZ))


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor, pad: str = "zero") -> torch.Tensor:
    """Weight gradient (Cout, Cin, 3, 3) float32 of the 3x3 SAME conv of
    ``x`` (B, Cin, H, W) under ``pad``, for the output gradient ``g``
    (B, Cout, H, W) of x's dtype. On CUDA kernel #2 of x's dtype (with its
    reduction pass), on the CPU its plain version."""
    if pad not in PADS:
        raise ValueError(f"unknown pad {pad!r}; expected one of {PADS}")
    if x.dim() != 4 or g.dim() != 4 or g.shape[0] != x.shape[0] or g.shape[2:] != x.shape[2:]:
        raise ValueError(f"conv3x3_dw: x {tuple(x.shape)} and g {tuple(g.shape)} disagree")
    if g.device != x.device or g.dtype != x.dtype:
        raise TypeError("conv3x3_dw: x and g must share device and dtype")
    if x.device.type == "cpu":
        return conv3x3_dw_reference(x, g, pad)
    _cuda_only(x, "conv3x3_dw")
    if x.dtype not in _DTYPES or not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("conv3x3_dw: x and g must be contiguous float32 or bfloat16")
    B, Cin, H, W = x.shape
    Cout = g.shape[1]
    if pad == "reflect" and min(H, W) < 2:
        raise ValueError(f"conv3x3_dw: unsupported shape {tuple(x.shape)} for reflect pad")
    P = dw_partitions(B, H, W, Cin, Cout,
                      torch.cuda.get_device_properties(x.device).multi_processor_count,
                      x.dtype)
    partial = torch.empty((P, Cout, Cin, 3, 3), dtype=torch.float32, device=x.device)
    dw = torch.empty((Cout, Cin, 3, 3), dtype=torch.float32, device=x.device)
    name = "ssde_conv3x3_dw_bf16" if x.dtype == torch.bfloat16 else "ssde_conv3x3_dw_tf32"
    launch(name, x.device, x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(), B,
           Cin, H, W, Cout, P, dw_tile_m(Cout, x.dtype), int(pad == "reflect"))
    conv3x3_dw.launches += 1
    return dw


def act_grad(act: str, out: torch.Tensor) -> Optional[torch.Tensor]:
    """act' from the float32 OUTPUT (``_act_grad``, conv3x3.py:334-348);
    None for "none" (multiply by 1)."""
    if act == "none":
        return None
    if act == "relu":
        return (out > 0).to(out.dtype)
    if act == "elu":
        return torch.where(out > 0, torch.ones_like(out), out + 1.0)
    if act == "sigmoid":
        return out * (1.0 - out)
    if act == "tanh":
        return 1.0 - out * out
    raise ValueError(f"unknown act {act!r}; expected one of {ACTS}")


def _strip(g_line: torch.Tensor, w_line: torch.Tensor) -> torch.Tensor:
    """1-D zero-padded adjoint along a border: s[:, ci, j] = sum over co, k
    of g_line[:, co, j - k + 1] * w_line[co, ci, k]. g_line (B, Cout, L),
    w_line (Cout, Cin, 3) -> (B, Cin, L)."""
    L = g_line.shape[2]
    s = 0.0
    for k in range(3):
        c = F.pad(torch.einsum("bol,oi->bil", g_line, w_line[:, :, k]), (1, 1))
        s = s + c[:, :, 2 - k:2 - k + L]
    return s


def reflect_folds_(dx: torch.Tensor, gp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Add, in place, what the reflect pad's border reads send back into x
    (``_c3_bwd``, conv3x3.py:356-437). With T the full correlation of ``gp``
    with the rotated weights on the (H+2)x(W+2) padded grid, padded row -1
    reads row 1 and row H reads H-2, so T's border rows and columns (strips
    of 1-D correlations) fold onto rows 1 and H-2 and columns 1 and W-2,
    and its four corners onto (1, 1), (1, W-2), (H-2, 1) and (H-2, W-2).
    ``dx`` (B, Cin, H, W), ``gp`` (B, Cout, H, W) and ``w`` (Cout, Cin, 3, 3)
    share one float dtype."""
    H, W = dx.shape[2:]
    dx[:, :, 1, :] += _strip(gp[:, :, 0, :], w[:, :, 0, :])
    dx[:, :, H - 2, :] += _strip(gp[:, :, H - 1, :], w[:, :, 2, :])
    dx[:, :, :, 1] += _strip(gp[:, :, :, 0], w[:, :, :, 0])
    dx[:, :, :, W - 2] += _strip(gp[:, :, :, W - 1], w[:, :, :, 2])
    for (gy, ky, ty), (gx, kx, tx) in ((r, c) for r in ((0, 0, 1), (H - 1, 2, H - 2))
                                       for c in ((0, 0, 1), (W - 1, 2, W - 2))):
        dx[:, :, ty, tx] += torch.einsum("bo,oi->bi", gp[:, :, gy, gx], w[:, :, ky, kx])
    return dx


def conv3x3_backward(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                     g: torch.Tensor, pad: str, act: str,
                     dx_fn: Callable = conv3x3_dx, dw_fn: Callable = conv3x3_dw,
                     needs=(True, True, True)):
    """(dx, dw, db) of ``conv3x3(x, w, b, pad, act)`` whose output was
    ``out``, for the output gradient ``g``; each is None where ``needs``
    says so. The host-side assembly of ``_c3z_bwd`` / ``_c3_bwd``
    (conv3x3.py:264-284, :356-437): gp = g * act'(out) in x's dtype,
    db = sum of gp in float32, dw = ``dw_fn(x, gp, pad)``, dx =
    ``dx_fn(gp, w)`` (the zero-pad adjoint) plus, for the reflect pad, the
    border folds in float32. ``dx_fn`` and ``dw_fn`` are the kernels'
    wrappers; a test passes their plain versions."""
    hi = torch.float64 if x.dtype == torch.float64 else torch.float32
    ag = act_grad(act, out.to(hi))
    gp = (g.to(hi) * ag if ag is not None else g.to(hi)).to(x.dtype).contiguous()
    db = gp.to(hi).sum((0, 2, 3)).to(w.dtype) if needs[2] else None
    dw = dw_fn(x, gp, pad).to(w.dtype) if needs[1] else None
    dx = None
    if needs[0]:
        dx = dx_fn(gp, w)
        if pad == "reflect":
            dx = reflect_folds_(dx.to(hi), gp.to(hi), w.to(hi)).to(x.dtype)
    return dx, dw, db


class _Conv3x3Fn(torch.autograd.Function):
    """The CUDA path with a gradient: the forward kernel, then a backward
    of the forward kernel as dx and kernel #2 as dW."""

    @staticmethod
    def forward(ctx, x, w, b, pad, act):
        out = _launch_fwd(x, w, b, pad, act)
        ctx.save_for_backward(x, w, out)
        ctx.pad, ctx.act = pad, act
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        dx, dw, db = conv3x3_backward(x, w, out, g.contiguous(), ctx.pad, ctx.act,
                                      needs=ctx.needs_input_grad[:3])
        return dx, dw, db, None, None


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
            pad: str = "zero", act: str = "none") -> torch.Tensor:
    """SAME 3x3 conv + optional bias + act on NCHW.

    x (B, Cin, H, W); w (Cout, Cin, 3, 3); b (Cout,) or None. ``pad`` is
    "zero" or "reflect" (column 0 reads column 1, column W-1 reads W-2; the
    same for rows). ``act`` is one of :data:`ACTS`. float32 or bfloat16,
    accumulated in f32, returned in the input dtype. Gradients reach x, w
    and b.
    """
    _check_args(x, w, b, pad, act)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, b, pad, act)
    _cuda_only(x, "conv3x3")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        out = _Conv3x3Fn.apply(x, w, b, pad, act)
    else:
        out = _launch_fwd(x, w, b, pad, act)
    conv3x3.launches += 1
    return out


# kernel launches; the CPU path does not count. dw counts one per call of
# its two passes.
conv3x3.launches = 0
conv3x3_dx.launches = 0
conv3x3_dw.launches = 0
