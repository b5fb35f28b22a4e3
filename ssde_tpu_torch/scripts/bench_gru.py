#!/usr/bin/env python
"""GRU sequence-training benchmark (counterpart of ``scripts/bench_gru.py``).

frame-samples/s of the port's GRU train step
(:func:`ssde_tpu_torch.train.steps_gru.train_step`) at B=8, T=3, 640x192,
bf16 for each version asked for (default v10 and v9), on one synthetic
batch already on the card: the step alone, without the loader. Prints the
versions, the card's name and power limit, then per version its peak
memory and one JSON line with the JAX script's keys.

    python -m ssde_tpu_torch.scripts.bench_gru

Env: BENCH_GRU_VERSIONS=v10,v9  BENCH_BATCH=8  BENCH_T=3  BENCH_STEPS=10
     BENCH_H=192  BENCH_W=640  BENCH_GRU_REMAT=auto

``BENCH_GRU_VERSIONS=v5 BENCH_BATCH=12 BENCH_T=10`` times v5 at the Options
defaults. The time is the CUDA events' around ``BENCH_STEPS`` chained steps
after 3 warm-up steps.
"""

from __future__ import annotations

import json
import os

import torch

from .bench_common import bench_device, describe, elapsed_ms

WARMUP = 3


def bench(version: str, B: int, T: int, n_steps: int, H: int, W: int, device,
          remat: str = "auto", card: str = "cpu"):
    """Times ``n_steps`` GRU train steps of ``version`` on ``device``; prints
    the peak memory (on the card) and the JSON line, and returns its dict."""
    from ..config import Options
    from ..data.pipeline import collate, to_device
    from ..data.synthetic import SyntheticSeqDataset
    from ..train.state import TrainState
    from ..train.steps_gru import build_gru_models, train_step

    device = torch.device(device)
    opts = Options(height=H, width=W, batch_size=B, len_sequence=T, num_layers=18,
                   compute_dtype="bfloat16", gru_version=version, scales=[0, 1, 2, 3],
                   gru_remat=remat)
    ds = SyntheticSeqDataset(H, W, n=T, length=B)
    batch = to_device(collate([ds[i] for i in range(B)]), device)
    models = build_gru_models(opts, device, torch.Generator().manual_seed(0))
    state = TrainState(models.parameters(), 1e-4, 0, 10)
    rng = torch.Generator(device).manual_seed(0)
    out = {}

    def step():
        out["losses"] = train_step(models, state, batch, rng)

    for _ in range(WARMUP):
        step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    ms = elapsed_ms(step, n_steps, device) / n_steps
    loss = float(out["losses"]["loss"])
    if device.type == "cuda":
        print(f"gru {version} B={B} T={T} {W}x{H} bf16 (--gru_remat {remat}): peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB over {n_steps} "
              f"steps; last loss {loss:.5f} [{card}]")
    else:
        print(f"gru {version} B={B} T={T} {W}x{H} bf16: last loss {loss:.5f}; peak memory "
              f"not measured [{card}]")
    result = {
        "metric": f"kitti_{W}x{H}_gru_{version}_train_frame_samples_per_sec",
        "value": round(B * T * 1e3 / ms, 2),
        "unit": "frame-samples/s",
        "batch": B, "seq_len": T,
        "ms_per_step": round(ms, 1),
    }
    print(json.dumps(result), flush=True)
    return result


def main(device=None):
    """The CLI: on the card unless ``device`` says otherwise. Returns the
    JSON lines' dicts, one per version."""
    device = bench_device(device)
    card = describe(device)
    versions = os.environ.get("BENCH_GRU_VERSIONS", "v10,v9").split(",")
    B = int(os.environ.get("BENCH_BATCH", "8"))
    T = int(os.environ.get("BENCH_T", "3"))
    n = int(os.environ.get("BENCH_STEPS", "10"))
    H = int(os.environ.get("BENCH_H", "192"))
    W = int(os.environ.get("BENCH_W", "640"))
    remat = os.environ.get("BENCH_GRU_REMAT", "auto")
    results = []
    for v in versions:
        results.append(bench(v.strip(), B, T, n, H, W, device, remat, card))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
