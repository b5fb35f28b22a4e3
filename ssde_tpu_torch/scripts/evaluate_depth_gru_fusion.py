#!/usr/bin/env python
"""Depth evaluation for the recurrent (GRU) model family on the GPU
(counterpart of ``scripts/evaluate_depth_gru_fusion.py``).

Protocols (selected with --protocol):
  single     fresh hidden state per test image
  warmup     run up to --warmup_frames previous frames of the same scene
             through the recurrence first
  scene      stream whole ordered scenes carrying state (uses
             gt_depths_seq.npz from scripts/export_gt_depth_seq.py)
  mdp        plain monodepth2 baseline: the evaluate_depth protocol on the
             folder's encoder.pth and depth.pth

Run: python -m ssde_tpu_torch.scripts.evaluate_depth_gru_fusion
       --gru_version v5 --load_weights_folder <folder> ...
(every ``--gru_version``, v1-v10, v6 and v2_wo_att; the folder holds
encoder.pth, depth.pth and gru.pth, and head.pth for v4, v6 and v7, or the
JAX package's .ckpt files of the same modules; a missing one raises).
The bucketed single/warm-up loop and the scene loop are functions
(:func:`predict_bucketed`, :func:`predict_scenes`) that other programs call.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import load_reference_folder
from ..config import MonodepthOptions, Options
from ..data.kitti import pil_load_resized
from ..data.splits import split_file
from ..eval.depth import evaluate_depth_predictions
from ..eval.gru_runners import GRUStreamEvaluator
from ..ops.geometry import disp_to_depth
from ..train.steps_gru import build_gru_models
from .evaluate_depth import evaluate as evaluate_mono
from .evaluate_depth import load_gt_depths, print_metrics

# (position in the test list, warm-up frames, test image), frames (1, H, W, 3)
Item = Tuple[int, List[np.ndarray], np.ndarray]


def build_evaluator(opt: Options, device="cuda", seed: int = 0) -> GRUStreamEvaluator:
    """float32 models (as the JAX script forces, :38-39), initialised from
    ``seed`` and then loaded from ``opt.load_weights_folder`` if it is set
    (:func:`main` requires it; callers that build an evaluator themselves
    may run the seeded weights). The folder, ``.pth`` or ``.ckpt``, must hold
    every module the version runs (``checkpoint.load_reference_folder``):
    a missing folder or file raises and names it.

    Like the JAX script's global matmul-precision switch, this turns TF32
    off for cuDNN convolutions and cuBLAS matmuls process-wide, so that
    float32 means full float32 on the card.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt.compute_dtype = "float32"
    models = build_gru_models(opt, device, torch.Generator().manual_seed(seed))
    if opt.load_weights_folder:
        load_reference_folder(os.path.expanduser(opt.load_weights_folder), models)
    return GRUStreamEvaluator(models)


def predict_bucketed(ev: GRUStreamEvaluator, items: Sequence[Item],
                     batch_size: int, min_depth: float,
                     max_depth: float) -> List[np.ndarray]:
    """Single / warm-up protocol: scaled disparity per item, in item order.

    Items are bucketed by warm-up length so every batched chunk runs the
    recurrence the same number of steps (identical per-item semantics to the
    reference's sequential loop, evaluate_depth_gru_fusion.py:140-199). The
    last partial chunk of a bucket is padded by repeating its last item
    (outputs discarded) so that every step sees one batch shape.
    """
    bs = max(1, batch_size)
    results = [None] * len(items)
    buckets = defaultdict(list)
    for it in items:
        buckets[len(it[1])].append(it)
    for L, bucket in sorted(buckets.items()):
        for c0 in range(0, len(bucket), bs):
            chunk = bucket[c0:c0 + bs]
            n = len(chunk)
            while len(chunk) < bs and len(bucket) >= bs:
                chunk = chunk + [chunk[-1]]
            image = np.concatenate([c[2] for c in chunk], axis=0)
            if L:
                prev = [np.concatenate([c[1][t] for c in chunk], axis=0)
                        for t in range(L)]
                disp = ev.predict_with_warmup(prev, image)
            else:
                disp = ev.predict_single(image)
            scaled, _ = disp_to_depth(disp, min_depth, max_depth)
            for i in range(n):
                results[chunk[i][0]] = scaled[i]
    return results


def predict_scenes(ev: GRUStreamEvaluator, scenes: Sequence[Sequence[np.ndarray]],
                   min_depth: float, max_depth: float) -> List[List[np.ndarray]]:
    """Scene protocol: per scene, the scaled disparity (H, W) of each frame."""
    out = []
    for frames in scenes:
        disps = ev.predict_scene(frames)
        out.append([disp_to_depth(d, min_depth, max_depth)[0][0] for d in disps])
    return out


def _load_frame(opt: Options, folder: str, idx: int):
    """(1, H, W, 3) float32 KITTI frame, or None when it does not exist."""
    ext = ".png" if opt.png else ".jpg"
    path = os.path.join(opt.data_path, folder, "image_02/data/{:010d}{}".format(idx, ext))
    if not os.path.exists(path):
        return None
    return pil_load_resized(path, opt.width, opt.height, False)[None]


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--protocol", type=str, default="warmup",
                        choices=["single", "warmup", "scene", "mdp"])
    parser.add_argument("--warmup_frames", type=int, default=10)
    parser.add_argument("--skip_frames", type=int, default=1,
                        help="stride when streaming scene frames "
                             "(reference skip_frames)")
    parser.add_argument("--eval_batch_size", type=int, default=8,
                        help="batch width for the single/warmup protocols")
    parser.add_argument("--device", type=str, default="cuda")
    args, remaining = parser.parse_known_args(argv)
    opt = MonodepthOptions().parse(remaining)
    if not opt.load_weights_folder:
        raise ValueError("--load_weights_folder is required: the folder of the trained "
                         "encoder, depth and gru (and head for v4, v6 and v7), .pth or "
                         ".ckpt, to evaluate")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    if args.protocol == "mdp":
        # the plain monodepth2 baseline is the evaluate_depth protocol (:76-82)
        return evaluate_mono(opt, args.device)

    split = split_file(opt.eval_split, "test")
    with open(split) as f:
        filenames = f.read().splitlines()
    gt_dir = os.path.dirname(split)
    ev = build_evaluator(opt, args.device)

    if args.protocol in ("single", "warmup"):
        gt_list = load_gt_depths(opt)
        items = []
        for pos, line in enumerate(filenames):
            folder, idx, _ = line.split()
            idx = int(idx)
            prev = []
            if args.protocol == "warmup":
                for j in range(idx - args.warmup_frames, idx):
                    f = _load_frame(opt, folder, j)
                    if f is not None:
                        prev.append(f)
            items.append((pos, prev, _load_frame(opt, folder, idx)))
        pred_disps = predict_bucketed(ev, items, args.eval_batch_size,
                                      opt.min_depth, opt.max_depth)
    else:
        seq = np.load(os.path.join(gt_dir, "gt_depths_seq.npz"), allow_pickle=True)
        gt_data, index = seq["data"], seq["index"]
        by_scene = defaultdict(list)
        for i, key in enumerate(index):
            folder, idx = str(key).rsplit(" ", 1)
            by_scene[folder].append((int(idx), i))
        scenes, gt_idx = [], []
        for folder in sorted(by_scene):
            entries = sorted(by_scene[folder])[:: args.skip_frames]
            loaded = [(gi, _load_frame(opt, folder, idx)) for idx, gi in entries]
            loaded = [(gi, f) for gi, f in loaded if f is not None]
            scenes.append([f for _, f in loaded])
            gt_idx += [gi for gi, _ in loaded]
        pred_disps = [d for s in predict_scenes(ev, scenes, opt.min_depth,
                                                opt.max_depth) for d in s]
        gt_list = [gt_data[gi] for gi in gt_idx]

    metrics = evaluate_depth_predictions(
        np.stack(pred_disps), gt_list,
        eval_split=opt.eval_split,
        disable_median_scaling=opt.disable_median_scaling,
        pred_depth_scale_factor=opt.pred_depth_scale_factor,
    )
    print_metrics(metrics)
    return metrics


if __name__ == "__main__":
    main()
