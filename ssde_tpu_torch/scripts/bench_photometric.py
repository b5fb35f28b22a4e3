#!/usr/bin/env python
"""Times the photometric error kernels #5 (forward) and #6 (backward) on the
card, alone and in the train steps that run them.

Run from a checkout on a machine with a CUDA card:

    python -m ssde_tpu_torch.scripts.bench_photometric [--iters 20]
        [--csrc DIR] [--kernels-only]

Prints the card's name and power limit, the photometric kernels'
registers, shared memory and spills (ptxas -v, from the library's build),
and at G = 120, 240, 480 and 1200 pairs (640x192, C = 3, B = G / 10, as
the train steps issue them) each kernel's CUDA-event time, achieved GB/s
and bound: the larger of its bytes over 3.35 TB/s and its operations over
67 TFLOP/s (``ops/photometric.py`` counts them). Then the GRU v10 train
step at B=8, T=3 (time, and #5's and #6's share of its profiled device
time), at the Options defaults B=12, T=10 (two steps after one warm-up),
and the mono train step at B=12, all bf16.

``--csrc DIR`` builds the library from another tree's ``csrc`` (the same C
interface, e.g. a parent commit's, unpacked with ``git archive``) and runs
everything on its kernels, so that two bodies are compared within one call.
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12  # H100 SXM: HBM3 bytes/s, float32 CUDA-core FLOP/s
H, W, C = 192, 640, 3
PAIRS = 10  # G / B: (S + 1) * F pairs a target, S = 4 scales, F = 2 sources
GS = (120, 240, 480, 1200)
PROFILED_STEPS = 3


def _ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def use_sources(csrc: str) -> None:
    """Build and launch the kernels of another tree's ``csrc`` directory."""
    from ..ops import build

    root = Path(csrc).resolve()
    build.SOURCES = tuple(root / s.name for s in build.SOURCES)
    build.HEADERS = tuple(root / h.name for h in build.HEADERS)
    build.load_library.cache_clear()


def kernel_times(dev, card, iters) -> None:
    import torch

    from ..ops.photometric import photometric_bwd, photometric_fwd, work

    gen = torch.Generator(device=dev).manual_seed(0)
    for G in GS:
        B = G // PAIRS
        pred = torch.rand(G, C, H, W, device=dev, generator=gen)
        targ = torch.rand(B, C, H, W, device=dev, generator=gen)
        gout = torch.randn(G, H, W, device=dev, generator=gen)
        for name, fn in (("fwd", lambda: photometric_fwd(pred, targ)),
                         ("bwd", lambda: photometric_bwd(pred, targ, gout))):
            ms = _ms(fn, iters)
            flops, nbytes = work(name, G, B, C, H, W)
            t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
            print(f"  photometric_{name} G={G} B={B} C={C} {H}x{W}: {ms:.4f} ms, "
                  f"{nbytes / ms / 1e6:.0f} GB/s, bound {max(t_bytes, t_ops):.4f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'}; bytes {t_bytes:.4f}, "
                  f"operations {t_ops:.4f}) [{card}]")
        del pred, targ, gout
        torch.cuda.empty_cache()


def _gru_step(dev, B, T):
    import torch

    from ..config import Options
    from ..data.pipeline import collate, to_device
    from ..data.synthetic import SyntheticSeqDataset
    from ..train.state import TrainState
    from ..train.steps_gru import build_gru_models, train_step

    opts = Options(height=H, width=W, batch_size=B, len_sequence=T, gru_version="v10")
    models = build_gru_models(opts, dev, torch.Generator().manual_seed(0))
    state = TrainState(models.parameters(), opts.learning_rate, 0, 1000)
    ds = SyntheticSeqDataset(H, W, n=T, length=B, seed=0)
    batch = to_device(collate([ds[i] for i in range(B)]), dev)
    rng = torch.Generator(dev).manual_seed(0)
    return lambda: train_step(models, state, batch, rng)


def step_times(dev, card, iters) -> None:
    """The GRU v10 step at B=8, T=3 with #5's and #6's profile share, at
    B=12, T=10, and the mono step at B=12."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..config import Options
    from ..data.pipeline import to_device
    from ..data.synthetic import make_synthetic_batch
    from ..train.state import TrainState
    from ..train.steps import build_mono_models, train_step

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    step = _gru_step(dev, 8, 3)
    ms = _ms(step, iters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
    device = {"all": 0.0, "photometric_fwd": 0.0, "photometric_bwd": 0.0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            device["all"] += us
            for k in ("photometric_fwd", "photometric_bwd"):
                if k in e.name:
                    device[k] += us
    per = lambda us: us / 1e3 / PROFILED_STEPS  # noqa: E731 (ms a step)
    print(f"gru v10 train step B=8 T=3 {H}x{W} bf16: {ms:.3f} ms (CUDA events, mean of "
          f"{iters} after 3 warm-up); device time {per(device['all']):.3f} ms a step over "
          f"{PROFILED_STEPS} profiled steps [{card}]")
    for k in ("photometric_fwd", "photometric_bwd"):
        print(f"  {k}: {per(device[k]):.4f} ms a step, {device[k] / device['all']:.2%} of "
              f"device time")
    del step, prof
    gc.collect()
    torch.cuda.empty_cache()

    step = _gru_step(dev, 12, 10)  # the Options defaults, --gru_remat auto
    times = [_ms(step, 1, warmup=0) for _ in range(3)]
    print(f"gru v10 train step B=12 T=10 {H}x{W} bf16 (--gru_remat auto): {times[1]:.1f} and "
          f"{times[2]:.1f} ms after a {times[0]:.1f} ms warm-up [{card}]")
    del step
    gc.collect()
    torch.cuda.empty_cache()

    opts = Options(height=H, width=W, batch_size=12)
    models = build_mono_models(opts, dev, torch.Generator().manual_seed(0))
    state = TrainState(models.parameters(), opts.learning_rate, 15, 1000)
    batch = to_device(make_synthetic_batch(12, H, W, seed=0), dev)
    rng = torch.Generator(dev).manual_seed(0)
    ms = _ms(lambda: train_step(models, state, batch, rng), iters)
    print(f"mono train step B=12 {H}x{W} bf16: {ms:.3f} ms (CUDA events, mean of {iters} "
          f"after 3 warm-up) [{card}]")


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--csrc", help="build the kernels from this csrc directory")
    ap.add_argument("--kernels-only", action="store_true", help="skip the train steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_photometric: needs a CUDA card")
    if args.csrc:
        use_sources(args.csrc)
    from ..ops.build import load_library

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lib = load_library()
    print(f"{card}; kernels from {lib.path.name} (sources: "
          f"{Path(args.csrc).resolve() if args.csrc else 'this checkout'})")
    kernel = ""
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
        elif "photometric" in kernel and ("registers" in line or "spill" in line):
            print(f"  ptxas: {kernel}: {line.strip()}")
    kernel_times(dev, card, args.iters)
    if not args.kernels_only:
        step_times(dev, card, 10)


if __name__ == "__main__":
    main()
