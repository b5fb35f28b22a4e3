#!/usr/bin/env python
"""Times the family warp (#7) on the card: its forward, its grid gradient
and the pair of them, beside the library calls of the same functions, the
host's time a call, and the peak memory of the train steps that run it; on
this checkout's kernels or on other trees', in turn.

Run from a checkout on a machine with a CUDA card:

    python -m ssde_tpu_torch.scripts.bench_warp [--trees DIR [DIR ...]]

Each tree (a checkout's root, e.g. a parent commit unpacked with
``git archive``; by default this checkout) is measured in a process of its
own that imports ``ssde_tpu_torch`` from that tree and builds that tree's
kernels, so that two bodies compare within one call (``--trees PARENT . .
PARENT``). It calls only what every body of the warp has:
``ops.warp_banded.warp_family_fwd`` (which also returned the residuals rdx,
rdy while the backward was assembled from them in PyTorch),
``grid_sample_family`` with its autograd backward, the mono train step and
``scripts/bench_gru``; and ``warp_family_bwd`` where the tree has it.

Prints for each tree the card's name and power limit, then for each shape
(B=12 and 48 at S=4, 640x192; B=12 at S=1, 640x192 and at
--v1_multiscale's 320x96, 160x48, 80x24; near-identity grids) the
CUDA-event ms of the forward, the backward kernel, the pair through
grid_sample_family (forward and autograd backward), F.grid_sample border
over the S grids, aten's grid_sampler_2d_backward for the grid alone
(output_mask [False, True]) and that library pair; the host's microseconds
a call of the forward and of F.grid_sample over 300 unsynchronised calls
at B=12, S=4 and at 80x24; then the ms and peak memory of the mono train
step at B=48 and of GRU v5 at the Options defaults B=12, T=10 (bf16). The
last line is one JSON object of it all, by tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
H, W = 192, 640
CASES = (("b12_s4", 12, 4, H, W), ("b48_s4", 48, 4, H, W), ("b12_s1", 12, 1, H, W),
         ("v1_320x96", 12, 1, 96, 320), ("v1_160x48", 12, 1, 48, 160),
         ("v1_80x24", 12, 1, 24, 80))
HOST_CASES, HOST_CALLS = ("b12_s4", "v1_80x24"), 300
ITERS, WARMUP = 20, 3
KEYS = ("fwd_ms", "bwd_ms", "pair_ms", "library_fwd_ms", "library_bwd_ms", "library_pair_ms",
        "host_us", "library_host_us")


def _ms(fn, iters=ITERS):
    import torch

    for _ in range(WARMUP):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(fn, n=HOST_CALLS):
    """Host microseconds a call over ``n`` unsynchronised calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _grids(dev, gen, S, B, h, w):
    """Near-identity grids (S, B, h, w, 2), as reprojection gives: each
    pixel's centre moved by about 2 % of the image, some off its edges."""
    import torch

    ys = (2 * torch.arange(h, device=dev) + 1) / h - 1
    xs = (2 * torch.arange(w, device=dev) + 1) / w - 1
    base = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1)
    noise = torch.randn(S, B, h, w, 2, device=dev, generator=gen) * 0.04
    return (base + noise).contiguous()


def warp_shapes(dev, card):
    import torch

    from ssde_tpu_torch.ops import warp_banded

    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for label, B, S, h, w in CASES:
        img = torch.rand(B, 3, h, w, device=dev, generator=gen)
        grids = _grids(dev, gen, S, B, h, w)
        dout = torch.randn(S * B, 3, h, w, device=dev, generator=gen)
        img_s, grids_s = img.repeat(S, 1, 1, 1), grids.flatten(0, 1)
        g = grids.clone().requires_grad_()
        fwd = lambda: warp_banded.warp_family_fwd(img, grids)  # noqa: E731
        lib_fwd = lambda: F.grid_sample(img_s, grids_s, mode="bilinear",  # noqa: E731
                                        padding_mode="border", align_corners=False)
        lib_bwd = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
            dout, img_s, grids_s, 0, 1, False, [False, True])
        t = {}
        with torch.no_grad():
            t["fwd_ms"] = _ms(fwd)
            if hasattr(warp_banded, "warp_family_bwd"):
                t["bwd_ms"] = _ms(lambda: warp_banded.warp_family_bwd(img, grids, dout))
            t["library_fwd_ms"] = _ms(lib_fwd)
            t["library_bwd_ms"] = _ms(lib_bwd)
            t["library_pair_ms"] = _ms(lambda: (lib_fwd(), lib_bwd()))
            if label in HOST_CASES:
                t["host_us"], t["library_host_us"] = _host_us(fwd), _host_us(lib_fwd)
        t["pair_ms"] = _ms(lambda: torch.autograd.grad(
            warp_banded.grid_sample_family(img, g), g, dout))
        print(f"{label} (S={S} B={B} {w}x{h}): " + ", ".join(
            f"{k} {t[k]:.4f}" for k in KEYS if k in t) + f" [{card}]", flush=True)
        out[label] = t
        del img, grids, dout, img_s, grids_s, g
        torch.cuda.empty_cache()
    return out


def mono_step(dev, card, B=48, steps=3):
    """(ms, peak GiB) of the mono train step at ``B`` (the Options
    defaults: 640x192, bf16 autocast), after one step that makes Adam's
    moments."""
    import torch

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.train.state import TrainState
    from ssde_tpu_torch.train.steps import build_mono_models, train_step

    torch.backends.cudnn.allow_tf32 = True
    opts = Options(height=H, width=W, batch_size=B)
    models = build_mono_models(opts, dev, torch.Generator().manual_seed(0))
    state = TrainState(models.parameters(), opts.learning_rate, 15, 1000)
    batch = to_device(make_synthetic_batch(B, H, W, seed=0), dev)
    rng = torch.Generator(dev).manual_seed(0)
    train_step(models, state, batch, rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _ms(lambda: train_step(models, state, batch, rng), iters=steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"mono train step B={B} {W}x{H} bf16: {ms:.3f} ms, peak memory {peak:.3f} GiB "
          f"[{card}]", flush=True)
    del models, state, batch
    torch.cuda.empty_cache()
    return ms, peak


def measure() -> dict:
    """This process's tree: the card line, the warp's times and the steps."""
    import torch

    from ssde_tpu_torch.scripts import bench_gru
    from ssde_tpu_torch.scripts.bench_common import bench_device, describe

    dev = bench_device()
    card = describe(dev)
    res = {"card": card, "shapes": warp_shapes(dev, card)}
    res["mono_b48_ms"], res["mono_b48_peak_gib"] = mono_step(dev, card)
    torch.cuda.reset_peak_memory_stats()
    r = bench_gru.bench("v5", 12, 10, 2, H, W, dev, "auto", card)
    res["v5_b12_t10_ms"] = r["ms_per_step"]
    res["v5_b12_t10_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trees", nargs="+", default=[str(ROOT)],
                   help="checkout roots to measure in turn (default: this one)")
    p.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.measure:
        print("RESULT " + json.dumps(measure()), flush=True)
        return None
    results = []
    for tree in args.trees:
        root = Path(tree).resolve()
        print(f"== {tree} ({root})", flush=True)
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure"],
                              cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
                              capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        print("\n".join(ln for ln in lines if not ln.startswith("RESULT ")), flush=True)
        found = [ln[len("RESULT "):] for ln in lines if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not found:
            raise RuntimeError(f"bench_warp on {tree} failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        results.append({"tree": tree, **json.loads(found[0])})
    print("summary, ms (host: us a call):")
    for label, *_ in CASES:
        for r in results:
            t = r["shapes"][label]
            print(f"  {label:10s} {r['tree']}: " + ", ".join(
                f"{k} {t[k]:.4f}" for k in KEYS if k in t))
    for key in ("mono_b48_ms", "mono_b48_peak_gib", "v5_b12_t10_ms", "v5_b12_t10_peak_gib"):
        print(f"  {key}: " + ", ".join(f"{r['tree']} {r[key]:.3f}" for r in results))
    print(json.dumps({"trees": results}))
    return results


if __name__ == "__main__":
    main()
