#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``ssde_tpu_torch``).

Run from the repo root on a machine with one CUDA card (sm_90a):

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. setup   versions, card name and power limit, the CUDA kernel's build
  2. kernel  the hand-written conv3x3 kernel against its plain twin on the
             card, at every conv shape GRU v10 issues at 640x192 (B=1, 8),
             both pads, every act, bias on/off, float32 and bfloat16
  3. slice   GRU v10 / ResNet18 / 640x192 / float32 streaming depth through
             the port's own entry points (build_evaluator, the scene loop
             and the bucketed warm-up loop), seeded random weights; checks
             the outputs and that every kernel conv of the path launched
  4. cpu     the same weights and frames on the CPU (plain twins): card vs
             CPU disparity over 4 streamed frames
  5. times   kernel vs twin per conv shape, streaming latency at B=1,
             warm-up protocol throughput at B=8 (CUDA events / host clock)

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON. Imports no JAX.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
H, W = 192, 640
VERSION = "v10"
MIN_DEPTH, MAX_DEPTH = 0.1, 100.0
TOL_F32, TOL_BF16, TOL_CARD_VS_CPU = 1e-4, 1e-2, 1e-3
SCENE_FRAMES, WARMUP_FRAMES, EVAL_BATCH = 8, 10, 8  # script defaults (:55-63)
LATENCY_FRAMES, WARMUP_RUNS = 100, 5  # p90 of 100 samples has 10 beyond it


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def slice_convs(version: str, height: int, width: int):
    """The kernel convs of one frame-step: (name, Cin, Cout, h, w, pad, act,
    bias), from the block's own specs and per-scale predicate."""
    from ssde_tpu_torch.models.recurrent import GRU_HIDDEN_SPECS, kernel_scales

    spec, feats, convs = GRU_HIDDEN_SPECS[version], (32, 64, 128, 256), []
    for s, on in enumerate(kernel_scales(version)):
        if not on:
            continue
        h, w, cx, hid, f = height >> s, width >> s, spec["in_ch"][s], spec["hid"][s], feats[s]
        convs += [(f"s{s}.cell.x", cx, 3 * hid, h, w, "zero", "none", True),
                  (f"s{s}.cell.h", hid, 2 * hid, h, w, "zero", "none", False),
                  (f"s{s}.cell.reset_h", hid, hid, h, w, "zero", "none", False)]
        for r, c in itertools.product((1, 2), (1, 2)):
            convs.append((f"s{s}.rcu{r}.conv{c}", f, f, h, w, "zero",
                          "relu" if c == 1 else "none", True))
        convs.append((f"s{s}.head", f, 1, h, w, "reflect", "sigmoid", True))
    return convs


def cuda_ms(fn, iters=20, warmup=3):
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ssde_tpu.config import Options
        from ssde_tpu_torch.data.synthetic import scene_frames
        from ssde_tpu_torch.eval.gru_runners import GRUStreamEvaluator
        from ssde_tpu_torch.models.common import sample_
        from ssde_tpu_torch.models.resnet import randomize_bn_stats_
        from ssde_tpu_torch.ops.build import load_library
        from ssde_tpu_torch.ops.conv3x3 import ACTS, conv3x3, conv3x3_reference
        from ssde_tpu_torch.scripts.evaluate_depth_gru_fusion import (
            build_evaluator, predict_bucketed, predict_scenes)
        from ssde_tpu_torch.train.steps_gru import GRUModels
    except ImportError as e:
        fail(f"the port is not importable next to chip_smoke.py ({e})")

    # ------------------------------------------------------------ 1. setup
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    print(card)  # name, power.limit as nvidia-smi gives them
    t0 = time.perf_counter()
    lib = load_library()
    print(f"kernel library {lib.path.name}: nvcc {lib.build_seconds:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s"
          + ("" if lib.build_seconds else " (already built)"))
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convs and matmuls: every comparison is in full float32")

    # ----------------------------------------------- 2. kernel vs plain twin
    convs = slice_convs(VERSION, H, W)
    shapes = sorted({c[1:5] for c in convs}, key=lambda s: (-s[3], s[1]))
    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_abs_f32, n_cases = 0.0, 0
    worst_f64 = {"kernel": 0.0, "twin": 0.0}  # f32 cases against float64
    print(f"kernel vs twin: {len(shapes)} shapes x B(1,8) x pad x act x bias x dtype;"
          f" bounds rel f32 {TOL_F32}, bf16 {TOL_BF16} (vs f32 twin on bf16-rounded inputs)")
    with torch.inference_mode():
        for (cin, cout, h, w), B in itertools.product(shapes, (1, 8)):
            x = torch.randn(B, cin, h, w, device=dev, generator=g)
            wt = torch.randn(cout, cin, 3, 3, device=dev, generator=g) / (3 * cin ** 0.5)
            bt = torch.randn(cout, device=dev, generator=g) * 0.1
            for dt, pad, act, has_b in itertools.product(
                    (torch.float32, torch.bfloat16), ("zero", "reflect"), ACTS, (True, False)):
                xi, wi, bi = x.to(dt), wt.to(dt), bt.to(dt) if has_b else None
                out = conv3x3(xi, wi, bi, pad, act)
                ref = conv3x3_reference(xi.float(), wi.float(),
                                        None if bi is None else bi.float(), pad, act)
                torch.cuda.synchronize()
                if out.dtype != dt or out.shape != ref.shape:
                    fail(f"kernel output {out.dtype} {tuple(out.shape)}")
                err = (out.float() - ref).abs().max().item()
                rel = err / max(ref.abs().max().item(), 1e-12)
                n_cases += 1
                worst[dt] = max(worst[dt], rel)
                if dt == torch.float32:
                    worst_abs_f32 = max(worst_abs_f32, err)
                    ref64 = conv3x3_reference(x.double(), wt.double(),
                                              bt.double() if has_b else None, pad, act)
                    for name, o in (("kernel", out), ("twin", ref)):
                        worst_f64[name] = max(worst_f64[name],
                                              (o.double() - ref64).abs().max().item())
                tag = "f32 " if dt == torch.float32 else "bf16"
                print(f"  {cin:3d}->{cout:<3d} {h}x{w} B={B} {tag} {pad:7s} {act:7s} "
                      f"bias={int(has_b)} abs {err:.3e} rel {rel:.3e}")
                if rel > (TOL_F32 if dt == torch.float32 else TOL_BF16):
                    fail(f"kernel disagrees with twin: {cin}->{cout} {h}x{w} B={B} "
                         f"{dt} {pad} {act} bias={has_b}: rel {rel:.3e}")
    print(f"kernel vs twin: {n_cases} cases ok; worst rel f32 {worst[torch.float32]:.3e} "
          f"(abs {worst_abs_f32:.3e}), bf16 {worst[torch.bfloat16]:.3e}")
    print(f"float32 cases against float64: worst abs kernel {worst_f64['kernel']:.3e}, "
          f"twin {worst_f64['twin']:.3e}")

    # ------------------------------------------------------------ 3. slice
    opt = Options()
    opt.gru_version, opt.height, opt.width, opt.num_layers = VERSION, H, W, 18
    ev = build_evaluator(opt, dev, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    randomize_bn_stats_(ev.models.encoder, gen)
    for s in range(ev.models.gru.n_scales):
        sample_(ev.models.gru.unit(s).h0_layer1, gen,
                 lambda t: t.normal_(0.0, 0.1, generator=gen))
    scene = scene_frames(H, W, SCENE_FRAMES, batch=1, seed=SEED)
    seq = scene_frames(H, W, WARMUP_FRAMES + 1, batch=EVAL_BATCH, seed=SEED + 1)
    items = [(i, [f[i:i + 1] for f in seq[:WARMUP_FRAMES]], seq[-1][i:i + 1])
             for i in range(EVAL_BATCH)]
    steps = SCENE_FRAMES + WARMUP_FRAMES + 1
    per_step = len(convs)

    torch.cuda.synchronize()
    conv3x3.launches = 0
    scene_out = predict_scenes(ev, [scene], MIN_DEPTH, MAX_DEPTH)[0]
    warm_out = predict_bucketed(ev, items, EVAL_BATCH, MIN_DEPTH, MAX_DEPTH)
    torch.cuda.synchronize()
    launches = conv3x3.launches

    print(f"slice: GRU {VERSION}, ResNet18, {H}x{W}, float32; scene {SCENE_FRAMES} frames "
          f"at B=1 + warm-up {WARMUP_FRAMES}+1 frames at B={EVAL_BATCH} = {steps} frame-steps")
    print(f"slice: conv3x3.launches {launches} (expected {per_step} per frame-step x "
          f"{steps} = {per_step * steps})")
    if launches != per_step * steps:
        fail(f"conv3x3 launched {launches} times, expected {per_step * steps}")
    lo, hi = 1.0 / MAX_DEPTH, 1.0 / MIN_DEPTH
    for name, outs in (("scene", scene_out), ("warmup", warm_out)):
        for d in outs:
            if d.shape != (H, W) or not np.isfinite(d).all():
                fail(f"{name}: output {d.shape} not finite ({H}, {W})")
            if not (d.min() > lo and d.max() < hi):  # sigmoid disp strictly in (0, 1)
                fail(f"{name}: scaled disparity outside ({lo}, {hi})")
        depth = 1.0 / np.stack(outs)
        print(f"slice {name}: {len(outs)} x ({H}, {W}) scaled disp "
              f"[{min(d.min() for d in outs):.4f}, {max(d.max() for d in outs):.4f}], "
              f"depth [{depth.min():.3f}, {depth.max():.3f}] m")
    disp = ev.predict_scene(scene[:1])[0]
    if disp.shape != (1, H, W) or not (0 < disp.min() <= disp.max() < 1):
        fail(f"predict_scene disparity {disp.shape} not in (0, 1)")
    if np.abs(np.stack(scene_out[1:]) - scene_out[0]).max() == 0:
        fail("the streamed frames all gave one output")

    # ----------------------------------------------------- 4. card vs CPU
    cpu_models = GRUModels(*(copy.deepcopy(m).cpu() for m in
                             (ev.models.encoder, ev.models.depth, ev.models.gru)),
                           None, ev.models.opts)
    t0 = time.perf_counter()
    on_cpu = GRUStreamEvaluator(cpu_models).predict_scene(scene[:4])
    cpu_s = time.perf_counter() - t0
    on_card = ev.predict_scene(scene[:4])
    delta = max(np.abs(a - b).max() for a, b in zip(on_card, on_cpu))
    print(f"card vs CPU: max |d disp| {delta:.3e} over 4 streamed frames at B=1 "
          f"(bound {TOL_CARD_VS_CPU}; CPU took {cpu_s:.1f} s)")
    if not delta <= TOL_CARD_VS_CPU:
        fail(f"card and CPU disagree: {delta:.3e}")

    # ------------------------------------------------------------ 5. times
    print(f"times on {card} (CUDA events, 20 launches after 3 warm-up, order "
          "twin, kernel, kernel, twin; float32; inputs stay resident in L2 where they fit)")
    per_conv = {}
    with torch.inference_mode():
        for (cin, cout, h, w, pad, act, has_b), B in itertools.product(
                sorted({c[1:] for c in convs}, key=lambda c: (-c[3], c[1], c[0])), (1, 8)):
            x = torch.randn(B, cin, h, w, device=dev, generator=g)
            wt = torch.randn(cout, cin, 3, 3, device=dev, generator=g)
            bt = torch.randn(cout, device=dev, generator=g) if has_b else None
            k = lambda: conv3x3(x, wt, bt, pad, act)
            p = lambda: conv3x3_reference(x, wt, bt, pad, act)
            tp1, tk1, tk2, tp2 = cuda_ms(p), cuda_ms(k), cuda_ms(k), cuda_ms(p)
            tk, tp = (tk1 + tk2) / 2, (tp1 + tp2) / 2
            per_conv[(cin, cout, h, w, pad, act, has_b, B)] = (tk, tp)
            gflop = 2 * 9 * cin * cout * h * w * B / 1e9
            print(f"  {cin:3d}->{cout:<3d} {h}x{w} B={B} {pad:7s} {act:7s} "
                  f"bias={int(has_b)}: kernel "
                  f"{tk:.4f} ms ({gflop / tk:.2f} TFLOP/s), twin {tp:.4f} ms "
                  f"({gflop / tp:.2f} TFLOP/s) [{card}]")
    frame_k = sum(per_conv[c[1:] + (1,)][0] for c in convs)
    frame_p = sum(per_conv[c[1:] + (1,)][1] for c in convs)
    print(f"kernel convs of one frame-step at B=1 ({per_step} convs): kernel "
          f"{frame_k:.4f} ms, twin {frame_p:.4f} ms [{card}]")

    lat, carry = [], ev.initial_carry(1)
    for i in range(3 + LATENCY_FRAMES):  # 3 warm-up frames, then the samples
        t0 = time.perf_counter()
        carry, disp = ev.step(carry, ev.to_device(scene[i % len(scene)]))
        ev.to_host(disp)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.array(lat[3:])
    print(f"streaming latency at B=1: median {np.median(lat):.3f} ms, p90 "
          f"{np.percentile(lat, 90):.3f} ms per frame (n={lat.size}; frame upload, "
          f"step, disparity back on the host; host clock) [{card}]")
    runs = []
    for _ in range(1 + WARMUP_RUNS):  # the first run is warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_bucketed(ev, items, EVAL_BATCH, MIN_DEPTH, MAX_DEPTH)
        runs.append(time.perf_counter() - t0)
    runs = np.array(runs[1:])
    n_frames = EVAL_BATCH * (WARMUP_FRAMES + 1)
    print(f"warm-up protocol at B={EVAL_BATCH}: median {n_frames / np.median(runs):.2f} "
          f"frames/s, range [{n_frames / runs.max():.2f}, {n_frames / runs.min():.2f}] "
          f"(n={runs.size} runs of {n_frames} frames incl. warm-up; "
          f"{EVAL_BATCH / np.median(runs):.2f} test images/s) [{card}]")

    print(json.dumps({"kernels": [{
        "name": "conv3x3_fwd", "route": "cuda",
        "source": "ssde_tpu_torch/csrc/conv3x3.cu",
        "replaces": "ssde_tpu/ops/pallas/conv3x3.py:79",
        "launches": launches, "max_abs_err": worst_abs_f32,
        "ms": frame_k, "plain_ms": frame_p}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
