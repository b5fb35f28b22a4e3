"""What the bench scripts (``bench_infer``, ``bench_gru``, ``bench_loader``)
share: the device they time, the lines that name it, and their clock."""

from __future__ import annotations

import subprocess
import sys
import time

import torch


def bench_device(device=None) -> torch.device:
    """``device`` if given, else the card, by the entry points' rule
    (:func:`~ssde_tpu_torch.train.trainer.run_device`): a card that is asked
    for and absent is an error, and nothing falls back to the CPU."""
    from ..train.trainer import run_device

    return run_device(None, "cuda" if device is None else device)


def describe(device: torch.device) -> str:
    """Prints the versions and the device: on the card its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them
    (``chip_smoke.py`` phase 1 prints its card line with this). Returns the
    line to print beside each number: that output, or ``cpu``."""
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    if device.type != "cuda":
        print("device: cpu (no card: these times are the CPU's, no device metric)")
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    print(f"device: {torch.cuda.get_device_name(index)} (count {torch.cuda.device_count()})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(index)], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    if smi.returncode != 0 or not card:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card)
    return card


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def elapsed_ms(fn, n: int, device: torch.device) -> float:
    """Milliseconds of ``n`` chained calls of ``fn``: CUDA events around
    them on the card (the device's clock, its idle gaps included), the host
    clock after a synchronize elsewhere."""
    synchronize(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3
