#!/usr/bin/env python
"""Host loader benchmark: JPEG decode throughput against the step's demand
(counterpart of ``scripts/bench_loader.py``).

Writes synthetic KITTI-sized JPEGs (1242x375) into a temporary directory,
then measures items/s (3 frames an item, the mono contract) through the
port's :class:`~ssde_tpu_torch.data.pipeline.Loader` with thread and with
process pools at several worker counts. Compare the best with the train
step's demand (samples/s x 3 frames a sample for the mono trainer).

    python -m ssde_tpu_torch.scripts.bench_loader [--n_images 192] [--workers 1,2,4,8]
    python -m ssde_tpu_torch.scripts.bench_loader --fed [--cache] [--fed_workers 2]

``--fed`` feeds the port's mono train step (ResNet18, bf16 autocast) from
the Loader for ``--fed_epochs`` epochs a row, in the JAX script's order:
``direct`` is the one-card trainer's path (each host batch to the card from
pinned memory, then the step), ``device_prefetch`` the data-parallel
trainer's handoff (``parallel.device_prefetch`` with its double buffer
forced on: batch N+1 sent before step N runs), ``plain_put_prefetch`` a
plain two-batch buffer of batches already sent, and ``direct2`` repeats
``direct``. ``--cache`` reads through the decode-once uint8 cache
(``data/kitti.load_resized_uint8``) and first reports its priming rate.
Prints the versions and the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from collections import deque

import numpy as np
import torch

from .bench_common import bench_device, describe, synchronize


class _JpegDataset:
    """Minimal dataset: decode + resize 3 frames per item (mono contract).

    ``cache_dir`` switches to the decode-once uint8 path
    (data/kitti.load_resized_uint8) — the fix for a host-bound feed.
    """

    def __init__(self, paths, width, height, cache_dir=None):
        self.paths = paths
        self.width = width
        self.height = height
        self.cache_dir = cache_dir

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        from ..data.kitti import load_resized_uint8, pil_load_resized

        out = {}
        for j, f in enumerate((0, -1, 1)):
            p = self.paths[(i + j) % len(self.paths)]
            if self.cache_dir is not None:
                out[f"color/{f}"] = load_resized_uint8(
                    p, self.width, self.height, False, self.cache_dir)
            else:
                out[f"color/{f}"] = pil_load_resized(p, self.width, self.height, False)
        out["K"] = np.eye(4, dtype=np.float32)
        return out


def write_jpegs(folder, n, src_width, src_height):
    """``n`` JPEGs of one seed-0 noise image, each rolled one pixel further
    (so that the files differ)."""
    from PIL import Image

    base = np.random.RandomState(0).randint(0, 255, (src_height, src_width, 3), np.uint8)
    paths = []
    for i in range(n):
        p = os.path.join(folder, f"{i:06d}.jpg")
        Image.fromarray(np.roll(base, i, axis=1)).save(p, quality=90)
        paths.append(p)
    return paths


def loader_tables(args, paths, card):
    """items/s and frames/s of one pass through the Loader per pool kind and
    worker count; prints the table and returns its rows (kind, workers,
    items/s, frames/s)."""
    from ..data.pipeline import Loader

    ds = _JpegDataset(paths, args.width, args.height)
    print(f"{len(paths)} JPEGs {args.src_width}x{args.src_height} -> "
          f"{args.width}x{args.height}, 3 frames/item, batch {args.batch_size} [{card}]")
    print(f"{'pool':>9} {'workers':>7} {'items/s':>9} {'frames/s':>9}")
    rows = []
    for use_proc in (False, True):
        for w in [int(x) for x in args.workers.split(",")]:
            loader = Loader(ds, args.batch_size, shuffle=False, drop_last=True,
                            num_workers=w, use_processes=use_proc)
            n = 0
            t0 = time.perf_counter()
            for batch in loader:
                n += batch["color/0"].shape[0]
            dt = time.perf_counter() - t0
            kind = "process" if use_proc else "thread"
            print(f"{kind:>9} {w:>7} {n / dt:>9.1f} {3 * n / dt:>9.1f}", flush=True)
            rows.append((kind, w, n / dt, 3 * n / dt))
    return rows


def bench_fed(args, paths, tmp, device, card):
    """The mono train step fed by the Loader (not by a batch on the card):
    the sustained loader + step pipeline that bounds KITTI training. Returns
    samples/s by row."""
    from ..config import Options
    from ..data.pipeline import Loader, collate, to_device
    from ..parallel import device_prefetch
    from ..train.state import TrainState
    from ..train.steps import build_mono_models, train_step
    from ..train.trainer import device_batch

    B = args.batch_size
    cache = os.path.join(tmp, "u8cache") if args.cache else None
    ds = _JpegDataset(paths, args.width, args.height, cache_dir=cache)
    if cache:  # prime the decode-once cache (the first epoch's cost, reported)
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        print(f"cache prime: {len(ds) / (time.perf_counter() - t0):.1f} items/s [{card}]")

    opts = Options(height=args.height, width=args.width, batch_size=B, num_layers=18,
                   compute_dtype="bfloat16", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3])
    models = build_mono_models(opts, device, torch.Generator().manual_seed(0))
    state = TrainState(models.parameters(), 1e-4, 15, 1000)
    loader = Loader(ds, B, shuffle=False, drop_last=True, num_workers=args.fed_workers)
    rng = torch.Generator(device).manual_seed(0)
    # warm: one step on the first batch
    losses = train_step(models, state, to_device(collate([ds[i] for i in range(B)]), device),
                        rng)
    float(losses["loss"])
    mode = "uint8-cache" if args.cache else "jpeg-decode"
    rates = {}

    def run(label, iterate):
        n, losses = 0, None
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.fed_epochs):
            for batch in iterate():
                losses = train_step(models, state, batch, rng)
                n += B
        float(losses["loss"])
        dt = time.perf_counter() - t0
        rates[label] = n / dt
        print(f"loader-fed step [{mode}, {args.fed_workers} workers, {label}]: "
              f"{n / dt:.1f} samples/s over {n} samples [{card}]", flush=True)

    def direct():
        for host in loader:
            yield device_batch(host, device)

    def plain_prefetch():
        buf = deque()
        for host in loader:
            buf.append(to_device(host, device))
            if len(buf) >= 2:
                yield buf.popleft()
        while buf:
            yield buf.popleft()

    run("direct", direct)
    run("device_prefetch", lambda: device_prefetch(loader, device, explicit=True))
    run("plain_put_prefetch", plain_prefetch)
    run("direct2", direct)
    return rates


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_images", type=int, default=192)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--src_width", type=int, default=1242)
    ap.add_argument("--src_height", type=int, default=375)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--workers", type=str, default="1,2,4,8")
    ap.add_argument("--fed", action="store_true",
                    help="feed the port's mono train step from the Loader")
    ap.add_argument("--cache", action="store_true",
                    help="use the decode-once uint8 cache in --fed mode")
    ap.add_argument("--fed_workers", type=int, default=2)
    ap.add_argument("--fed_epochs", type=int, default=3)
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """The CLI: on the card unless ``device`` says otherwise. Returns the
    table's rows, or with ``--fed`` the samples/s by row."""
    args = parse(argv)
    device = bench_device(device)
    card = describe(device)
    tmp = tempfile.mkdtemp(prefix="ssde_loader_bench_")
    try:
        paths = write_jpegs(tmp, args.n_images, args.src_width, args.src_height)
        if args.fed:
            return bench_fed(args, paths, tmp, device, card)
        return loader_tables(args, paths, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
