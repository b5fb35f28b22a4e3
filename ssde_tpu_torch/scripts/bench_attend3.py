#!/usr/bin/env python
"""Times the windowed-attention kernels #3 (forward) and #4 (backward) at
the GRU v9 frame-step's attention shapes on the card.

Run from a checkout on a machine with a CUDA card:

    python -m ssde_tpu_torch.scripts.bench_attend3 [--iters 20]

Prints the card's name and power limit, the kernels' registers, shared
memory and spills (ptxas -v, from the library's build), and for each
attention shape of one v9 frame-step at 640x192 (B=8 bf16, the training
shape; B=8 and B=1 float32, the serving shapes) the CUDA-event time of each
kernel, its achieved bytes/s and its bytes bound at 3.35 TB/s, and at B=8
bf16 the time of the ring pad (``models/attention.pad_ring``) of one map;
then the frame-step's sums (16 calls), and a torch.profiler split of one
frame-step of #4 into its two passes (the main kernel and the drel
reduction). Last it times the v9 train step at B=8, T=3, bf16 (CUDA
events) and splits its profile: #3's and #4's share of the device time,
and ``aten::cat`` into the ring pads and everything else.
"""

from __future__ import annotations

import argparse
import subprocess

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
FEATS = (32, 64, 128, 256)  # the fusion blocks' channels at scales 0-3
H, W = 192, 640
STEP_B, STEP_T, PROFILED_STEPS = 8, 3, 3


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


def step_profile(dev, card, iters) -> None:
    """The v9 train step at B=8, T=3, bf16: its time, and its profile's
    device time split into #3, #4, the ring pads' cats and the other cats."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..config import Options
    from ..data.pipeline import collate, to_device
    from ..data.synthetic import SyntheticSeqDataset
    from ..models import attention
    from ..train.state import TrainState
    from ..train.steps_gru import build_gru_models, train_step

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    opts = Options(height=H, width=W, batch_size=STEP_B, len_sequence=STEP_T,
                   gru_version="v9")
    models = build_gru_models(opts, dev, torch.Generator().manual_seed(0))
    state = TrainState(models.parameters(), opts.learning_rate, 0, 1000)
    ds = SyntheticSeqDataset(H, W, n=STEP_T, length=STEP_B, seed=0)
    batch = to_device(collate([ds[i] for i in range(STEP_B)]), dev)
    rng = torch.Generator(dev).manual_seed(0)
    step = lambda: train_step(models, state, batch, rng)  # noqa: E731
    ms = _ms(step, iters, warmup=3)
    pad_ring = attention.pad_ring

    def labelled_pad_ring(x, b):  # marks the ring pads' cats in the profile
        with record_function("pad_ring"):
            return pad_ring(x, b)

    attention.pad_ring = labelled_pad_ring
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                step()
            torch.cuda.synchronize()
    finally:
        attention.pad_ring = pad_ring
    device = {"all": 0.0, "attend3_fwd": 0.0, "attend3_bwd": 0.0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            device["all"] += us
            for k in ("attend3_fwd", "attend3_bwd", "attend3_drel"):
                if k in e.name:
                    device["attend3_bwd" if k == "attend3_drel" else k] += us
    cats = {"ring pads": [0, 0.0], "other": [0, 0.0]}
    for e in prof.events():
        if e.name == "aten::cat":
            cats["other"][0] += 1
            cats["other"][1] += e.device_time_total
        elif e.name == "pad_ring":
            for c in e.cpu_children:
                if c.name == "aten::cat":
                    cats["ring pads"][0] += 1
                    cats["ring pads"][1] += c.device_time_total
    for i in range(2):  # "other" counted every cat so far
        cats["other"][i] -= cats["ring pads"][i]
    per = lambda us: us / 1e3 / PROFILED_STEPS  # noqa: E731 (ms a step)
    print(f"v9 train step B={STEP_B} T={STEP_T} {H}x{W} bf16: {ms:.3f} ms (CUDA events, mean "
          f"of {iters} after 3 warm-up); profile over {PROFILED_STEPS} steps: device time "
          f"{per(device['all']):.3f} ms a step [{card}]")
    for k in ("attend3_fwd", "attend3_bwd"):
        print(f"  {k}: {per(device[k]):.4f} ms a step, {device[k] / device['all']:.2%} of device "
              f"time")
    for k, (n, us) in cats.items():
        print(f"  aten::cat, {k}: {n // PROFILED_STEPS} calls, {per(us):.4f} ms a step, "
              f"{us / device['all']:.2%} of device time")
    del models, state, batch, prof
    torch.cuda.empty_cache()


def main(argv=None) -> None:
    import torch

    from ..models.attention import pad_ring
    from ..ops.attention_win import attend3_bwd, attend3_fwd
    from ..ops.build import load_library

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attend3: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    lib = load_library()
    kernel = ""
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
        elif "attend3" in kernel and ("registers" in line or "spill" in line):
            print(f"  ptxas: {kernel}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    calls = [(f, H >> s, W >> s) for s, f in enumerate(FEATS)]  # 4 calls of each a frame-step
    for B, dtype in ((8, torch.bfloat16), (8, torch.float32), (1, torch.float32)):
        elem = torch.finfo(dtype).bits // 8
        tot = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
        ops = {}
        for C, h, w in calls:
            q = torch.randn(B, C, h, w, device=dev, generator=gen).to(dtype)
            kp = torch.randn(B, C, h + 2, w + 2, device=dev, generator=gen).to(dtype)
            vp = torch.randn(B, C, h + 2, w + 2, device=dev, generator=gen).to(dtype)
            rel = torch.randn(9, C, device=dev, generator=gen) * 0.5
            g = torch.randn(B, C, h, w, device=dev, generator=gen).to(dtype)
            ops[(C, h, w)] = (q, kp, vp, rel, g)
            n_out, n_pad = B * C * h * w, B * C * (h + 2) * (w + 2)
            nbytes = {"fwd": elem * (2 * n_out + 2 * n_pad) + 36 * C,
                      "bwd": elem * (3 * n_out + 4 * n_pad) + 72 * C}
            t = {"fwd": _ms(lambda: attend3_fwd(q, kp, vp, rel), args.iters),
                 "bwd": _ms(lambda: attend3_bwd(q, kp, vp, rel, g), args.iters)}
            row = []
            for k in ("fwd", "bwd"):
                tot[k][0] += 4 * t[k]
                tot[k][1] += 4 * nbytes[k]
                row.append(f"{k} {t[k]:.4f} ms ({nbytes[k] / t[k] / 1e6:.0f} GB/s, bound "
                           f"{nbytes[k] / PEAK_BYTES * 1e3:.4f})")
            if dtype == torch.bfloat16:
                x, b = q, torch.randn(C, device=dev, generator=gen).to(dtype)
                pad_bytes = elem * (n_out + n_pad) + elem * C
                t_pad = _ms(lambda: pad_ring(x, b), args.iters)
                row.append(f"pad_ring of one map {t_pad:.4f} ms ({pad_bytes / t_pad / 1e6:.0f} "
                           f"GB/s, bound {pad_bytes / PEAK_BYTES * 1e3:.4f}; 2 a call)")
            print(f"  {dtype} B={B} C={C:3d} {h}x{w}: " + "; ".join(row))
        for k, (ms, nbytes) in tot.items():
            print(f"attend3 {k}: one v9 frame-step (16 calls) at B={B} {dtype}: {ms:.4f} ms, "
                  f"bound {nbytes / PEAK_BYTES * 1e3:.4f} ms ({nbytes / 1e9:.3f} GB) [{card}]")
        if dtype == torch.bfloat16:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for q, kp, vp, rel, g in ops.values():
                    for _ in range(4):
                        attend3_bwd(q, kp, vp, rel, g)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                if "attend3" in ev.key:
                    dev_us = getattr(ev, "device_time_total", None)
                    if dev_us is None:
                        dev_us = ev.cuda_time_total
                    print(f"  profile, one frame-step of #4: {ev.key[:60]}: {ev.count} "
                          f"launches, {dev_us / 1e3:.4f} ms")
        del ops
        torch.cuda.empty_cache()
    step_profile(dev, card, 10)


if __name__ == "__main__":
    main()
