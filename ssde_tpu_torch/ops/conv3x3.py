"""Fused 3x3 SAME conv + bias + activation: the hand-written CUDA kernel and
its plain PyTorch twin.

Counterpart of ``ssde_tpu/ops/pallas/conv3x3.py`` (forward only: the Pallas
``_fwd_kernel`` behind ``conv3x3``, ``conv3x3_zero`` and
``conv3x3_zero_chain``). Layout is NCHW at true width; the TPU kernel's
planar layout, 128-lane padding and logical width ``wl`` are lane-layout
workarounds with no counterpart here.

:func:`conv3x3` launches ``ssde_tpu_torch/csrc/conv3x3.cu`` for CUDA tensors
and raises on anything that kernel does not take. Only tensors that lie on
the CPU go to :func:`conv3x3_reference`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

PADS = ("zero", "reflect")
ACTS = ("none", "relu", "elu", "sigmoid", "tanh")  # codes 0..4 in the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    """Plain version: F.pad (zero or reflect), F.conv2d, then the act."""
    if pad not in PADS:
        raise ValueError(f"unknown pad {pad!r}; expected one of {PADS}")
    mode = "reflect" if pad == "reflect" else "constant"
    return activation(F.conv2d(F.pad(x, (1, 1, 1, 1), mode=mode), w, b), act)


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
    cout_blocks = -(-w.shape[0] // 16) if w.shape[0] >= 16 else w.shape[0]
    if B * cout_blocks > 65535:
        raise ValueError("conv3x3: batch x output-channel blocks exceed the grid")


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
            pad: str = "zero", act: str = "none") -> torch.Tensor:
    """SAME 3x3 conv + optional bias + act on NCHW.

    x (B, Cin, H, W); w (Cout, Cin, 3, 3); b (Cout,) or None. ``pad`` is
    "zero" or "reflect" (column 0 reads column 1, column W-1 reads W-2; the
    same for rows). ``act`` is one of :data:`ACTS`. float32 or bfloat16,
    accumulated in f32, returned in the input dtype. Inference only.
    """
    _check_args(x, w, b, pad, act)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, b, pad, act)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"conv3x3: x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        raise RuntimeError("conv3x3: the CUDA kernel has no backward yet; "
                           "call it under torch.inference_mode()")
    from .build import load_library

    B, Cin, H, W = x.shape
    Cout = w.shape[0]
    out = torch.empty((B, Cout, H, W), dtype=x.dtype, device=x.device)
    err = load_library().lib.ssde_conv3x3_fwd(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), B, Cin, H, W, Cout, _DTYPES[x.dtype],
        int(pad == "reflect"), ACTS.index(act),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0  # kernel launches; the CPU twin does not count
