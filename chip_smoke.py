#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``ssde_tpu_torch``).

Run from the repo root on a machine with one CUDA card (sm_90a):

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. setup   versions, card name and power limit, the CUDA kernels' build
             (one nvcc per source, in parallel) and each kernel's ptxas
             registers, shared memory and spills
  2. kernel  the hand-written conv3x3 kernels against their plain twin on
             the card, at every conv shape GRU v10 issues at 640x192 (B=1,
             8) and ragged ones, both pads, every act, bias on/off, float32
             (the 3xTF32 tensor-core body; each case also held against
             float64 at 4x the plain float32 conv's own error) and bfloat16
  3. slice   GRU v10 / ResNet18 / 640x192 / float32 streaming depth through
             the port's own entry points (build_evaluator, the scene loop
             and the bucketed warm-up loop), seeded random weights; checks
             the outputs and that every kernel conv of the path launched
  4. cpu     the same weights and frames on the CPU (plain twins): card vs
             CPU disparity over 4 streamed frames
  5. times   kernel vs twin per conv shape, streaming latency at B=1,
             warm-up protocol throughput at B=8 (CUDA events / host clock)
  6. mono kernels  the family warp (#7: its forward and its grid-gradient
             kernel, the latter twice and bit-identical) and the photometric
             error forward and backward (#5, #6) against their plain
             versions at the mono slice's shapes (640x192, B=12 and 48, and
             B=16 of phase 26's bench_loader --fed; G=10B) and ragged ones;
             the photometric kernels also at the edges of their strips and
             bands, at W = 1, 2, 3 (mod 4) and at G = 240
  7. mono slice    the mono trainer built by the port's entry point at the
             Options defaults (ResNet18, B=12, bf16 autocast, synthetic
             data): one epoch of 8 steps and its val(); finite losses,
             changed parameters, the kernels' launch counts
  8. mono cpu      one step at 640x192, B=2, on the card and on the CPU
             with the same weights and batch (networks float64, the
             kernels' part float32, the automask argmin of a float64 CPU
             run): the losses, every gradient
  9. mono times    train step ms, samples/s and peak memory at B=12 and 48,
             each new kernel against its plain version, the device idle
             share; the warp's forward, backward and the pair of them also
             beside F.grid_sample and aten's grid_sampler_2d_backward (the
             grid alone), and the host's microseconds a call; the
             photometric kernels also at G = 240 and 1200 beside their bounds
 10. gru kernels   the conv3x3 backward (the forward kernel as dx, the
             weight-gradient kernel #2, db) against autograd of the plain
             version at every GRU v10 conv shape at B=8 (640x192), both pads,
             bias on/off, float32 (also at 4x the plain float32 backward's
             own error against float64) and bf16, and ragged and
             2-pixel-high maps; the dW of either dtype bit-identical twice
             at 32->96, 192x640, B=8
 11. gru slice     the GRU trainer built by the port's entry point
             (scripts/train_gru: v10, ResNet18, 640x192, B=8, T=3, bf16,
             synthetic data): one epoch of 4 steps and its val(); finite
             losses, changed parameters, launch counts per step; then an
             epoch with the learned initial states frozen
 12. gru cpu       (a) the v10 block unrolled over T=3 at B=1, float32, card
             (kernels) vs CPU (plain): outputs, hidden states, every
             gradient; (b) one whole GRU step at B=1, T=2 by phase 8's recipe
 13. gru times     train step ms, frame-samples/s, peak memory, idle share,
             the top device operations; per conv shape the forward, dx and
             dW kernels (float32 and bf16) beside cuDNN's forward,
             backward-data and backward-weight, their sums per frame-step,
             TFLOP/s and bounds (float32: 3xTF32 on the tensor cores, and
             the 67 TFLOP/s CUDA-core figure beside it)
 14. attn kernels  the windowed-attention forward (#3) and backward (#4)
             against the plain attend3 and its autograd at every GRU v9
             attention shape at 640x192 (B=1, 8; float32 against float64,
             bf16 against float32), ragged ones and the edges of #3's
             and #4's bands and strips; #4 bit-identical twice
 15. v9 serving    GRU v9 (attention fusion) streaming depth through
             build_evaluator, the scene loop (B=1) and the warm-up loop (B=8),
             float32, seeded weights: launches per frame-step (conv3x3 8,
             attend3 16); card vs CPU float32 vs CPU float64 disparity
 16. v9 train      scripts/train_gru --gru_version v9 at B=8, T=3, bf16: an
             epoch, its val() and a frozen-h0 epoch, launches per step; the
             v9 block card vs CPU over T=3 as phase 12 (a)
 17. v9 times      the v9 train step (ms, frame-samples/s, memory, idle
             share, top operations), v9 serving latency and throughput, and
             per attention shape kernels #3/#4 beside their plain versions
             and the bound (B=8 bf16, B=1 float32; #3 also at B=8 float32),
             and the ring pad of one map at B=8 bf16
 18. defaults      the GRU trainer's step at the Options defaults (B=12,
             T=10, 640x192, bf16) for v10 and v9 with the checkpointing
             that --gru_remat auto picks there, and v10 without it: ms per
             step (two after one warm-up) and peak memory
 19. kitti train   a KITTI raw tree written at KITTI's sizes (1242x375
             JPEGs of a moving texture, 120,000-point velodyne scans, calib
             files, eigen_zhou-style lists under $SSDE_SPLITS_DIR): the
             loader's items/s from the JPEGs and from a warm --decoded_cache;
             scripts/train_dpt.main (monodepth2, B=12, bf16) and
             scripts/train_gru.main (v10, B=8, T=3, bf16) for an epoch each on
             it: finite losses, changed parameters, the 7 depth metrics of
             val(), the kernels launched, weights_0/ with its .pth files and
             models/opt.json; a trainer built on weights_0 bit-identical to
             the saved one, Adam's step count included, and one further step
             from each within phase 8's tolerance; the KITTI mono step's ms
             and idle share beside phase 9's synthetic one, the GRU step's
             ms, and the seconds of save_model and load_model;
             --matmul_precision float32 turning both TF32 switches off and
             default leaving them
 20. mono eval     on phase 19's tree and its mono weights_0: an eigen-style
             test list (both cameras of the drive) and an odometry sequence
             09 at 1241x376 with poses/09.txt, written beside it;
             scripts/export_gt_depth, then through each script's main():
             evaluate_depth at 640x192 (float32, TF32 off) with and without
             --post_process, evaluate_depth_gru_fusion --protocol mdp (the
             same metrics), test_simple on a folder of frames and
             evaluate_pose on odom_9: finite metrics and ATE, frames/s and
             the device's idle share of the prediction loop, test_simple's
             median ms an image, evaluate_pose's pairs/s; mono_infer card vs
             CPU on 4 frames
 21. gru family    the rest of the recurrent family, v1, v2, v2_wo_att,
             v3, v4, v5 (the Options default), v6, v7 and v8 (ConvLSTM):
             kernels #1/#2 against their plain versions at the new
             small-channel convs (Cin and Cout 1 to 6, both pads, float32
             and bf16, forward and backward) and #3/#4 at C = 2; each
             version served (build_evaluator, the scene loop at B=1,
             float32, TF32 off, seeded weights): launches per frame-step,
             the median ms a frame, card vs CPU; scripts/train_gru's main()
             with no --gru_version (v5) at B=8, T=3, bf16 for an epoch:
             finite losses, moved parameters, launches; v5's step ms,
             frame-samples/s, memory and idle share (its step at the
             Options defaults, B=12, T=10, is phase 26's bench_gru); one train step
             of every other version at B=2, T=2, 640x192, bf16, and every
             block step card vs CPU against float64 with pinned relus (phase
             12's recipe); a summary line per version
 22. fusion serving  the 3-frame attention-fusion models: (a) #3 against
             its plain version at every attention shape of Fusion
             (pyramid), Fusion_v3 and the scale-loop block at 640x192
             (C = 2 and 4 at the four scales, C = 256/128/64/32 at scales
             3/2/1/0; shared embedding tables; float32 against float32 and
             float64 at B=1 and 8, bf16 against float32); (b) on phase 19's
             tree with phase 20's eigen-style list and gt_depths.npz,
             scripts/evaluate_depth_fusion's main() for pyramid, v3,
             v3 --disable_attention and scale_loop (ResNet18, float32, TF32
             off, seed-0 weights written by save_folder): finite
             disparities, the metrics printed, attend3 launches per batch
             24/24/0/24, card vs CPU on 4 items (phase 4's bound); (c) the
             prediction loop's frames/s and device idle share per variant,
             #3 per call at each fusion shape at B=8 float32 beside its
             plain version and bound, and the sums over one batch
 23. fusion train  (a) #4 against autograd of its plain version at the 12
             fusion attention shapes at B=1 and 12 (shared embedding
             tables; float32 against float64, bf16 against float32, dq,
             dkp, dvp and drel each), and its time per call at B=12 bf16
             beside the plain backward and the bound; (b) each fusion
             trainer through its entry point's main() at the Options
             defaults (ResNet18, 640x192, B=12, bf16, synthetic data, one
             epoch): train_fusion (pyramid), train_fusion_v3 with and
             without --disable_attention, train_dpt --model rn_fusion and
             FusionScaleLoopTrainer: finite losses, every module moved, the
             launches (attend3 24/24 a step, 0/0 without attention), then
             the step's ms, samples/s, peak memory and idle share; (c) one
             step of each variant at 64x128, B=2, card vs CPU and each
             against float64 (networks float64, the fusion module and the
             loss float32, relu masks and automask argmin pinned); (d)
             train_fusion_v3's main() on phase 19's tree with a
             train_files_seq.txt beside its lists: the seq list read, the
             7 depth metrics, weights_0 with fusion.pth, a trainer
             reloaded with no --models_to_load bit-identical, the loader's
             items/s (4 JPEGs an item)
 24. dpt train     train_dpt for the models it did not train before: (a) #7
             (forward and backward) at S = 1 and #5/#6 at the DPT step's
             G = 4B = 48 (B=12, 640x192) against their plain versions (phase
             6's tolerances), timed beside their bounds and, for the warp,
             phase 9's library calls; (b) train_dpt's
             main() with no --model, the DPT-hybrid (ViT-B/16 on a
             ResNet-50 stem, 118 M parameters, frames [0, -1, 1], scale 0),
             and (c) with --model rn_encoder_with_attention, each at the
             Options defaults (B=12, bf16, synthetic data, an epoch of 8
             steps and its val()): finite losses, every module moved, the
             launches (attend3 none: the 7x7 attention convs run the plain
             path), weights_0 with dpt.pth or encoder.pth; then the step's
             ms, samples/s, peak memory, idle share and top device
             operations; (d) one step of each at 64x128, B=2, card vs CPU
             and each against float64 (networks float64, the loss float32,
             the automask argmin of the float64 run); (e) a DPTTrainer
             reloaded from weights_0 with the default --models_to_load
             bit-identical, Adam's step count included, and the attention
             maps of a forward at 640x192 summing to 1, the mean map
             (B, 12, 40)
 25. options     the Monodepth2 training options of the mono step: (a)
             #7 on the stereo source's grids (S = 4, B=12, 640x192) and at
             S = 1 on the --v1_multiscale sources (320x96, 160x48, 80x24),
             and #5/#6 at the MS step's G = 180 and at --v1_multiscale's
             G = 48 at those sizes, against their plain versions (phase 6's
             tolerances), timed beside their bounds (the warp's forward,
             backward and pair beside phase 9's library calls, and its host
             time a call at 80x24); (b) train_dpt.main()
             --model monodepth2 with --use_stereo (MS, frames 0 -1 1) and
             --use_stereo --frame_ids 0 (S, no pose network) at the Options
             defaults (B=12, bf16, synthetic data, an epoch of 8 steps and
             its val()): finite losses, every module moved, the launches
             (warp 3 and 1 a step), weights_0; then the step's ms,
             samples/s, peak memory, idle share and top device operations;
             (c) one step at full width of posecnn, shared, --pose_model_input
             all, --predictive_mask --disable_automasking, --v1_multiscale
             and --no_ssim --avg_reprojection: the launches each states,
             finite losses, ms and peak memory; (d) one step of each of the
             eight at 64x128, B=2, card vs CPU and each against float64
             (networks float64, the loss float32, the automask argmin of the
             float64 run)
 26. bench       the bench entry points and the trainer's logs: (a)
             scripts/bench_infer's main() (B=32, ResNet18, 640x192, bf16):
             its JSON line and the finite disparity of that run; (b)
             scripts/bench_gru's
             main() for v10, v9 and v5 at B=8, T=3, bf16, 10 steps each after
             3 warm-up (their JSON lines, peak memory, the launches of
             #1-#7), and v5 at the Options defaults B=12, T=10 (3 steps,
             its launches with the checkpointed block's forward twice);
             (c) scripts/bench_loader's main(): the thread and process
             tables at 2 and 8 workers on 192 JPEGs of 1242x375, then
             --fed (the mono step at B=16 fed by the Loader, 96 JPEGs, one
             epoch a row) with and without --cache; (d) train_dpt.main()
             --model monodepth2 at the Options defaults (B=12, bf16,
             synthetic data) with --log_frequency 1 for an epoch: the
             examples/s lines in the JAX format (hours, minutes, seconds)
             and the TensorBoard files of train/ and val/ read back (tags,
             steps), or, where tensorboard does not import, none written
 27. native      the JAX package's .ckpt folders (run after phase 23, on
             phase 19's tree and weights_0 folders): (a) for the mono
             trainer (B=12) and GRU v10 (B=8, T=3), bf16, a trainer built
             on the .pth folder writes a .ckpt folder with adam.ckpt
             (checkpoint.flax_state through the copied JAX converters,
             save_checkpoint); a trainer built on it holds the same modules,
             Adam moments and step count bit for bit, and one further step
             from each agrees within phase 8's tolerance; save and load
             seconds and sizes of both formats; (b) evaluate_depth_gru_fusion's
             build_evaluator on the v10 .ckpt folder streams the .pth
             folder's disparity exactly (4 frames, B=1), and raises on a
             folder without gru.ckpt; (c) evaluate_depth's main() on the mono
             .ckpt folder gives phase 20's 7 metrics exactly
 28. dp          data parallelism (ssde_tpu_torch.parallel.launch, one process a
             mesh entry): (a) 3 float32 mono steps at B=12 over NCCL at world
             size 1 on cuda:0, deterministic algorithms on, bit-identical to
             the same steps in this process; (b) two gloo ranks sharing
             cuda:0 (NCCL refuses two ranks on one card): one mono step at
             B=12 and one GRU v10 step at B=8, T=3 against the one-process
             step (networks float64, the loss float32 on the kernels; losses
             1e-4 relative, gradients and BatchNorm statistics 1e-3 of each
             tensor's max), the ranks bit-identical, each rank's launches,
             step and gradient all-reduce ms and peak memory; (c) the mono
             step over NCCL on two cards where the machine has two
 29. mp          the model axis (parallel.make_mesh_2d, model_sharded_params:
             each rank computes its slice of every conv's output channels,
             then all-gathers it): (a) #1 (forward, dx) and #2 at the slice
             shapes of v10's kernel convs at scales 0-1 at m = 2 (B=2),
             float32 and bf16, against their plain versions, and each
             slice's forward against the same channels of the whole conv;
             (b) a (1, 2) mesh of two gloo ranks on cuda:0: one mono step at
             B=4 and one GRU v10 step at B=2, T=3 (640x192, phase 28 (b)'s
             precision and pins) against the one-process step after
             unshard_params (losses 1e-4 relative, gradients, BatchNorm
             statistics and parameters 1e-3 of each tensor's max), every
             rank the same; (c) a (2, 2) mesh of four gloo ranks on cuda:0:
             the mono step at B=4, held the same way; each rank's step ms,
             ms, calls and bytes of its gathers and model-group reductions,
             peak memory, the bytes of its parameters and Adam moments, its
             launches; (d) (b)'s mono step over NCCL on two cards where the
             machine has two

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON, each with its launches on the main path (for
attend3_fwd those of phases 15 and 16 together; phase 21's main path,
the family's serving and training, is added to every count and also
given alone as ``family_launches``; phase 22's, the fusion models'
evaluation, is added to attend3_fwd's and given alone as
``fusion_launches``, with #3's worst errors at the fusion shapes and its
times for one batch of each variant under ``fusion_*``; phase 23's, the
fusion trainers' runs, is added to attend3_fwd's, attend3_bwd's, the
warp's and the photometric kernels' counts and given alone as
``fusion_train_launches``, with #4's worst errors at the fusion shapes
and its times for one step of each variant at B=12 bf16 under
``fusion_*`` of attend3_bwd; phase 24's, train_dpt's DPT and
attention-encoder runs, is added to the warp's and the photometric
kernels' counts and given alone as ``dpt_train_launches``, with their
worst errors and times at the DPT step's shapes under ``dpt_*``; phase
25's, train_dpt's MS and S runs, is added to the same counts and given
alone as ``options_train_launches``, with their worst errors and times at
the new shapes under ``options_b12_*`` and the two steps' ms under
``options_*_step_ms``; phase 26's, the bench scripts' and the logged
trainer's runs, is added to the GRU step's and the mono step's kernels and
given alone as ``bench_launches``; phase 27's, the trainers resumed from
.ckpt folders and the GRU evaluator on one, is added to the same kernels
and given alone as ``native_launches``; phase 28's, every data-parallel
rank's steps, is added to the same kernels and given as ``dp_launches``,
and by run and rank as ``dp_launches_per_rank``; phase 29's, every
model-parallel rank's steps, the same way as ``mp_launches`` and
``mp_launches_per_rank``, with #1/#2's worst errors at the slice shapes
under ``mp_*``), its time, its plain
version's (conv3x3_fwd: float32 serving at B=1, and under bf16_b8_* and
f32_b8_* its bf16 and float32 bodies at a B=8 frame-step; conv3x3_dx and
conv3x3_dw: bf16, and float32 under f32_b8_*; attend3_fwd and attend3_bwd:
a B=8 bf16 frame-step, and #3's float32 serving frame-steps under f32_b8_*
and f32_b1_*; warp_family_fwd and warp_family_bwd: S=4 at B=12, and B=48
under b48_*, the forward and backward in turn under pair_* of
warp_family_bwd with the mono steps' peak memory, the host's microseconds
a call under *host_us), the least
time the card could take (``bound_ms``: the bytes the function must move
over 3.35 TB/s or its operations over the peak rate for its type, the
larger) and a PyTorch library call's time where one computes the same
function. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import os
import shutil
import sys
import tempfile
import time
import types

import numpy as np

SEED = 0
H, W = 192, 640
VERSION = "v10"
MIN_DEPTH, MAX_DEPTH = 0.1, 100.0
TOL_F32, TOL_BF16, TOL_CARD_VS_CPU = 1e-4, 1e-2, 1e-3
SCENE_FRAMES, WARMUP_FRAMES, EVAL_BATCH = 8, 10, 8  # script defaults (:55-63)
LATENCY_FRAMES, WARMUP_RUNS = 100, 5  # p90 of 100 samples has 10 beyond it
# mono slice: 640x192, frames [0, -1, 1], scales 0-3 (Options defaults)
MONO_B, BENCH_B, S_SCALES = 12, 48, 4
FED_B = 16  # bench_loader --fed: its --batch_size default (scripts/bench_loader.py)
# kernel vs plain version, float32 on the card:
#  warp: coordinates rounded as the twin rounds them, the lerp may fuse
#    multiply-adds -> 1e-5 absolute on images in [0, 1]; its grid gradient
#    (plain torch on either's residuals) 1e-5 of max
#  photometric forward: the same arithmetic, sums in another order -> 1e-5
#  photometric backward: terms of size ~1/C2 = 1.1e3 cancel -> 1e-4 of max
TOL_WARP, TOL_PHOTO, TOL_PHOTO_BWD = 1e-5, 1e-5, 1e-4
# card vs CPU, one step at 640x192, B=2: loss 1e-4 relative; gradients
# 1e-3 of each tensor's max, card vs CPU and each against a float64 run of
# the step on the CPU. The two sum in other orders (cuDNN, the kernels),
# and the gradient amplifies rounding in two places: the minimum over the
# identity and reprojection errors switches where two of them nearly tie
# (the synthetic data's flat blocks tie often), and the encoders in
# float32 are ill-conditioned (on an H100 and on the CPU alike, the
# all-float32 step's pose-encoder gradients are 6.8e-2 of a tensor's max
# from float64 on the synthetic batch; with only the networks in float64,
# 1.4e-4). So the held runs take their automask argmin from the float64
# run and run the networks in float64; the geometry, the warp and the
# photometric loss stay float32, the kernels on the card and their plain
# versions on the CPU. The all-float32 step is run as well and its error
# shown.
TOL_STEP_LOSS, TOL_STEP_GRAD = 1e-4, 1e-3
# the device's busy time over profiled steps, divided by the same number
# of unprofiled steps' CUDA-event time (the profiler slows the host)
IDLE_STEPS = 3
# GRU v10 sequence training: the JAX package's GRU benchmark configuration
# (scripts/bench_gru.py:34-37), full width
GRU_B, GRU_T = 8, 3
# phase 10, the conv3x3 backward (dx, dw, db) against autograd of the plain
# conv on the same operands and the same output gradient (chip_smoke's
# _conv_bwd says why): float32 1e-4 of each gradient's max against a
# float64 run (dW sums up to B*H*W = 983,040 products per weight in
# blocked float32 partial sums; dx is the forward kernel; cuDNN's own
# float32 backward-weight, TF32 off, was 1.5e-4 of max off at 32->96 on an
# H100, so it is shown, not used); bf16 1e-2 against a float32 run on the
# bf16-rounded operands: the kernels round dx to bf16 (2^-8) and dW to the
# weights' bf16.
TOL_BWD_F32, TOL_BWD_BF16 = 1e-4, 1e-2
# phase 14, kernels #3/#4 against the plain attend3 and its autograd on the
# same operands: the float32 forward 1e-5 absolute on O(1) inputs (the same
# float32 arithmetic, sums in another order, expf against torch.exp); the
# float32 gradients 1e-4 of each gradient's max against a float64 run (drel
# sums up to B*H*W = 983,040 products per entry at scale 0, B=8, in blocked
# float32 partial sums, as #2 does); bf16 1e-2 of max against a float32 run
# on the bf16-rounded operands (the kernels round their outputs to bf16).
TOL_ATTN_FWD, TOL_ATTN_GRAD, TOL_ATTN_BF16 = 1e-5, 1e-4, 1e-2
# float32 operations per output value of attend3, for bound_ms: the forward
# 9 logits (add, mul), their max, 9 (sub, exp, add, fma) and a divide; the
# backward that again plus 7 per tap (u, dlogit, dq, the dk and dv gathers)
ATTN_OPS_FWD, ATTN_OPS_BWD = 63, 126
# the card's published peaks (NVIDIA H100 SXM data sheet) for bound_ms: the
# float32 CUDA cores, the bf16 tensor cores, and float32-accurate work as
# 3xTF32 on the tensor cores (three TF32 products per float32 one at 495
# TFLOP/s), the least time of the float32 conv bodies
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float32_3xtf32": 495e12 / 3}
# every float32 conv case (phases 2 and 10) against float64: its worst error
# at most this times the plain float32 version's own worst error against
# float64 (cuDNN, TF32 off), so float32 means float32. A case of phase 2 is
# a shape at a batch size, its worst error the largest over its pads, acts,
# biases and outputs: one variant of a 2x2 map has 4 outputs of about 12
# products, whose largest error is a matter of a rounding or two (3->1 at
# 2x2, zero pad, no act or bias: 4.01x on an H100, where the 402 float32
# variants before it reached 2.94x). A case of phase 10 is one row, its
# worst error the largest of dx, dW and db.
F64_RATIO = 4.0


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAIL: {msg}")


FEATS = (32, 64, 128, 256)  # the fusion blocks' channels at scales 0-3


def slice_convs(version: str, height: int, width: int):
    """The kernel convs of one frame-step of the recurrent block: (name,
    Cin, Cout, h, w, pad, act, bias), from the block's own specs and
    per-scale predicate: the cell's convs (a GRU's three, an LSTM's two),
    v1/v3's sigmoid heads, and the fusion blocks' conv units (v2_wo_att,
    v10; v2, v8 and v9 have attention units in their place) and sigmoid
    head. The external Head of v4/v6/v7 is :func:`head_convs`."""
    from ssde_tpu_torch.models.recurrent import (GRU_HIDDEN_SPECS, block_version,
                                                 kernel_scales, scale_shift)

    v = block_version(version)
    spec, convs = GRU_HIDDEN_SPECS[v], []
    for s, on in enumerate(kernel_scales(v)):
        if not on:
            continue
        d = scale_shift(v, s)
        h, w, cx, hid = height >> d, width >> d, spec["in_ch"][s], spec["hid"][s]
        if spec["cell"] == "lstm":
            convs += [(f"s{s}.cell.x", cx, 4 * hid, h, w, "zero", "none", True),
                      (f"s{s}.cell.h", hid, 4 * hid, h, w, "zero", "none", False)]
        else:
            convs += [(f"s{s}.cell.x", cx, 3 * hid, h, w, "zero", "none", True),
                      (f"s{s}.cell.h", hid, 2 * hid, h, w, "zero", "none", False),
                      (f"s{s}.cell.reset_h", hid, hid, h, w, "zero", "none", False)]
        if v in ("v1", "v3"):
            convs.append((f"s{s}.head", hid, 1, h, w, "reflect", "sigmoid", True))
        elif v in ("v2", "v8", "v9", "v10"):
            f = 2 if v == "v2" else FEATS[s]
            if version in ("v2_wo_att", "v10"):
                units = 3 if v == "v2" else 2
                for r, c in itertools.product(range(1, units + 1), (1, 2)):
                    convs.append((f"s{s}.rcu{r}.conv{c}", f, f, h, w, "zero",
                                  "relu" if c == 1 else "none", True))
            convs.append((f"s{s}.head", f, 1, h, w, "reflect", "sigmoid", True))
    return convs


def head_convs(version: str, height: int, width: int, scales=(0, 1, 2, 3)):
    """The kernel convs of the external Head of v4/v6/v7 at ``scales`` (all
    four in training, scale 0 in serving), as :func:`slice_convs` lists
    them; none for the other versions."""
    from ssde_tpu_torch.models.recurrent import kernel_scales
    from ssde_tpu_torch.train.steps_gru import HEAD_VERSIONS

    if version not in HEAD_VERSIONS:
        return []
    on = kernel_scales(version)
    return [(f"head.s{s}", HEAD_VERSIONS[version][s], 1, height >> s, width >> s, "reflect",
             "sigmoid", True) for s in scales if on[s]]


def slice_attention(version: str, height: int, width: int):
    """The attend3 calls of one frame-step: (C, h, w) of each, at every
    scale 4 per GRUFusionBlock_v2 (2 units x 2 AttentionConvs) for v8 and
    v9, 6 per GRUFusionBlock (3 units) at C = 2 for v2; none for the
    versions without attention units."""
    from ssde_tpu_torch.models.recurrent import block_version

    v = block_version(version)
    if version in ("v2_wo_att", "v10") or v not in ("v2", "v8", "v9"):
        return []
    if v == "v2":
        return [(2, height >> s, width >> s) for s in range(4) for _ in range(6)]
    return [(f, height >> s, width >> s) for s, f in enumerate(FEATS) for _ in range(4)]


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


def bound(flops: float, nbytes: float, dtype: str):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the peak rate for ``dtype``."""
    t_ops, t_bytes = flops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_cost(cin, cout, h, w, B, elem, w_elem=None):
    """(FLOPs, bytes) of one 3x3 conv pass (forward, dx or dW) at B
    images of h x w: 2*9*Cin*Cout operations per pixel; each input read
    once and the output written once: the Cin- and Cout-channel activations
    at ``elem`` bytes a value, the weights (or dW) at ``w_elem`` (default
    ``elem``)."""
    w_elem = elem if w_elem is None else w_elem
    return (2 * 9 * cin * cout * h * w * B,
            elem * B * (cin + cout) * h * w + w_elem * 9 * cin * cout)


def main() -> None:
    import torch

    wall0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import ssde_tpu_torch.scripts.bench_gru  # noqa: F401
        import ssde_tpu_torch.scripts.bench_infer  # noqa: F401
        import ssde_tpu_torch.scripts.bench_loader  # noqa: F401
        import ssde_tpu_torch.scripts.evaluate_depth  # noqa: F401
        import ssde_tpu_torch.scripts.evaluate_depth_fusion  # noqa: F401
        import ssde_tpu_torch.scripts.evaluate_depth_gru_fusion  # noqa: F401
        import ssde_tpu_torch.scripts.evaluate_pose  # noqa: F401
        import ssde_tpu_torch.scripts.export_gt_depth  # noqa: F401
        import ssde_tpu_torch.scripts.test_simple  # noqa: F401
        import ssde_tpu_torch.scripts.train_dpt  # noqa: F401
        import ssde_tpu_torch.scripts.train_fusion  # noqa: F401
        import ssde_tpu_torch.scripts.train_fusion_v3  # noqa: F401
        import ssde_tpu_torch.scripts.train_gru  # noqa: F401
        from ssde_tpu_torch.ops.build import load_library
        from ssde_tpu_torch.scripts.bench_common import describe
    except ImportError as e:
        fail(f"the port is not importable next to chip_smoke.py ({e})")

    # ------------------------------------------------------------ 1. setup
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:  # versions, the card's name and count, then its name and power.limit
        card = describe(dev)  # as nvidia-smi gives them
    except RuntimeError as e:
        fail(str(e))
    t0 = time.perf_counter()
    lib = load_library()
    print(f"kernel library {lib.path.name}: nvcc {lib.build_seconds:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s"
          + ("" if lib.build_seconds else " (already built)"))
    kernel = ""
    for line in lib.log.splitlines():  # ptxas -v: each kernel's registers, smem, spills
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {kernel}: {line.strip()}")
    # ptxas reports static shared memory only; the tensor-core conv kernels
    # ask for theirs at launch (conv3x3_tc.cu launch_fwd, launch_dw_tc;
    # conv3x3_tf32.cu launch_fwd, launch_dw): the 6x66-pixel halo tile, plus
    # the forward's BN x (9 CC + pad) weights (float32: hi and lo) or dW's
    # g tile of 16 MT rows of 256 + pad pixels
    halo = lambda cc, pad, elem: 6 * 66 * (cc + pad) * elem  # noqa: E731
    print("  dynamic shared memory of conv3x3_tc.cu (bf16), bytes: " + ", ".join(
        [f"forward CC={cc} BN={bn} {halo(cc, 8, 2) + bn * (9 * cc + 8) * 2}"
         for cc in (16, 32) for bn in (8, 32, 64)]
        + [f"dW MT={mt} {halo(32, 8, 2) + 16 * mt * 264 * 2}" for mt in (2, 4)]))
    print("  dynamic shared memory of conv3x3_tf32.cu (float32), bytes: " + ", ".join(
        [f"forward CC={cc} BN={bn} {halo(cc, 4, 4) + 2 * bn * (9 * cc + 4) * 4}"
         for cc in (8, 16) for bn in (8, 32)]
        + [f"dW {halo(32, 8, 4) + 32 * 260 * 4}",
           f"dW heads {halo(32, 8, 4)} (+ 5632 static)"]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convs and matmuls: every comparison is in full float32")

    kernels = {"conv3x3_fwd": serving(dev, card)}
    errs = mono_kernels(dev, card)
    launch_counts = mono_slice(dev)
    mono_card_vs_cpu(dev)
    times = mono_times(dev, card)
    mono_step_ms = times.pop("train_step_ms")
    peak = times.pop("train_step_peak_gib")
    pair = times.pop("warp_family_pair")
    for name, src, rep in (("warp_family_fwd", "ssde_tpu_torch/csrc/warp_family.cu",
                            "ssde_tpu/ops/pallas/warp_banded.py:64"),
                           ("warp_family_bwd", "ssde_tpu_torch/csrc/warp_family.cu",
                            "ssde_tpu/ops/pallas/warp_banded.py:64 (its residuals), :463"),
                           ("photometric_fwd", "ssde_tpu_torch/csrc/photometric.cu",
                            "ssde_tpu/ops/pallas/photometric.py:97"),
                           ("photometric_bwd", "ssde_tpu_torch/csrc/photometric.cu",
                            "ssde_tpu/ops/pallas/photometric.py:110")):
        kernels[name] = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                         "launches": launch_counts[name], "max_abs_err": errs[name],
                         **times[name]}
    # the forward and backward in turn, and the mono steps' peak memory
    kernels["warp_family_bwd"].update({f"pair_{k}": v for k, v in pair.items()},
                                      **{f"mono_b{B}_step_peak_gib": v for B, v in peak.items()})
    errs = gru_kernels(dev)
    launch_counts = gru_slice(dev)
    gru_card_vs_cpu(dev)
    times = gru_times(dev, card)
    # the forward's entry carries float32 serving at B=1 (its ms, plain_ms,
    # ...) and, beside it, the bf16 and float32 bodies at a B=8 frame-step;
    # dx and dW carry bf16 training, and float32 beside it
    f32, bf16 = torch.float32, torch.bfloat16
    kernels["conv3x3_fwd"].update(
        bf16_source="ssde_tpu_torch/csrc/conv3x3_tc.cu",
        **{f"bf16_b8_{k}": v for k, v in times[(bf16, "conv3x3_fwd")].items()},
        **{f"f32_b8_{k}": v for k, v in times[(f32, "conv3x3_fwd")].items()})
    for name, rep in (("conv3x3_dx", "ssde_tpu/ops/pallas/conv3x3.py:79 (as dx at :279, :384)"),
                      ("conv3x3_dw", "ssde_tpu/ops/pallas/conv3x3.py:109")):
        kernels[name] = {"name": name, "route": "cuda",
                         "source": "ssde_tpu_torch/csrc/conv3x3_tc.cu", "replaces": rep,
                         "launches": launch_counts[name], "max_abs_err": errs[(name, bf16)],
                         **times[(bf16, name)],
                         "f32_source": "ssde_tpu_torch/csrc/conv3x3_tf32.cu",
                         "f32_max_abs_err": errs[(name, f32)],
                         **{f"f32_b8_{k}": v for k, v in times[(f32, name)].items()}}
    errs = attn_kernels(dev)
    serve_counts, v9_serving = serving_v9(dev, card)
    launch_counts = gru_slice(dev, "v9")
    gru_block_card_vs_cpu(dev, "v9")
    times = v9_times(dev, card, *v9_serving)
    for name, line in (("attend3_fwd", 117), ("attend3_bwd", 150)):
        kernels[name] = {"name": name, "route": "cuda",
                         "source": "ssde_tpu_torch/csrc/attention_win.cu",
                         "replaces": f"ssde_tpu/ops/pallas/attention_win.py:{line}",
                         "launches": launch_counts[name] + serve_counts.get(name, 0),
                         "max_abs_err": errs[name], **times[name]}
    default_size_steps(dev, card)
    root = tempfile.mkdtemp(prefix="ssde_kitti_")
    try:
        tree = kitti_train(dev, card, mono_step_ms, root)
        mono_metrics = mono_eval(dev, card, root, *tree[:3])
        counts, errs = gru_family(dev, card)
        fusion_count, fusion_errs, fusion_times = fusion_serving(dev, card, root, *tree[:2])
        train_count, bwd_errs, bwd_times = fusion_training(dev, card, root, *tree[:2])
        native_count = native_checkpoints(dev, card, root, tree[0], *tree[2:], mono_metrics)
    finally:
        os.environ.pop("SSDE_SPLITS_DIR", None)
        shutil.rmtree(root, ignore_errors=True)
    for name, n in counts.items():  # phase 21's main path adds to each count
        kernels[name]["launches"] += n
        kernels[name]["family_launches"] = n
    for (name, dt), err in errs.items():
        kernels[name][f"family_{'f32' if dt == f32 else 'bf16'}_max_abs_err"] = err
    # phase 22's main path (the fusion models' evaluation) adds to #3's count
    kernels["attend3_fwd"]["launches"] += fusion_count
    kernels["attend3_fwd"].update(
        fusion_launches=fusion_count, fusion_f32_max_abs_err=fusion_errs["f32"],
        fusion_bf16_max_rel_err=fusion_errs["bf16"],
        **{f"fusion_b8_f32_{label}_{k}": v
           for label, entry in fusion_times.items() for k, v in entry.items()})
    # phase 23's main path (the fusion trainers' runs) adds to the kernels of its step
    for name in ("attend3_fwd", "attend3_bwd", "warp_family_fwd", "warp_family_bwd",
                 "photometric_fwd", "photometric_bwd"):
        kernels[name]["launches"] += train_count[name]
        kernels[name]["fusion_train_launches"] = train_count[name]
    kernels["attend3_bwd"].update(
        fusion_f32_max_rel_err=bwd_errs["f32"],
        fusion_bf16_max_rel_err=max(v for k, v in bwd_errs.items() if k.startswith("bf16")),
        **{f"fusion_b12_bf16_{label}_{k}": v
           for label, entry in bwd_times.items() for k, v in entry.items()})
    # phase 27's main path (the trainers resumed from .ckpt folders, the GRU
    # evaluator on one) adds to the GRU step's and the mono step's kernels
    for name, n in native_count.items():
        kernels[name]["launches"] += n
        kernels[name]["native_launches"] = n
    # phase 24's main path (train_dpt's DPT and attention-encoder runs) adds to
    # the warp's and the photometric kernels' counts
    dpt_count, dpt_errs, dpt_times = dpt_training(dev, card)
    for name in ("warp_family_fwd", "warp_family_bwd", "photometric_fwd", "photometric_bwd"):
        kernels[name]["launches"] += dpt_count[name]
        kernels[name]["dpt_train_launches"] = dpt_count[name]
        kernels[name]["dpt_max_abs_err"] = dpt_errs[name]
        kernels[name].update({f"dpt_b12_{k}": v for k, v in dpt_times[name].items()})
    # phase 25's main path (train_dpt's MS and S runs) adds to the warp's and
    # the photometric kernels' counts
    opt_count, opt_errs, opt_times, opt_step_ms = options_training(dev, card)
    for name in ("warp_family_fwd", "warp_family_bwd", "photometric_fwd", "photometric_bwd"):
        kernels[name]["launches"] += opt_count[name]
        kernels[name]["options_train_launches"] = opt_count[name]
        kernels[name]["options_max_abs_err"] = opt_errs[name]
        kernels[name].update({f"options_b12_{k}": v for k, v in opt_times[name].items()})
        kernels[name].update({f"options_{label}_step_ms": v for label, v in opt_step_ms.items()})
    # phase 26's main path (the bench entry points and the trainer's logs) adds
    # to the GRU step's and the mono step's kernels
    bench_count = bench_entry_points(dev, card)
    for name, n in bench_count.items():
        kernels[name]["launches"] += n
        kernels[name]["bench_launches"] = n
    # phase 28's main path (the data-parallel ranks' steps) adds every rank's
    # launches; each rank's are given under dp_launches_per_rank
    dp_count, dp_per_rank = data_parallel(dev, card)
    for name, n in dp_count.items():
        if n:
            kernels[name]["launches"] += n
            kernels[name]["dp_launches"] = n
            kernels[name]["dp_launches_per_rank"] = {
                run: [counts[name] for counts in ranks] for run, ranks in dp_per_rank.items()}
    # phase 29's main path (the model-parallel ranks' steps) adds every rank's
    # launches; each rank's are given under mp_launches_per_rank
    mp_count, mp_per_rank, mp_errs = model_parallel(dev, card)
    for name, n in mp_count.items():
        if n:
            kernels[name]["launches"] += n
            kernels[name]["mp_launches"] = n
            kernels[name]["mp_launches_per_rank"] = {
                run: [counts[name] for counts in ranks] for run, ranks in mp_per_rank.items()}
    for (name, dt), err in mp_errs.items():
        kernels[name][f"mp_{'f32' if dt == f32 else 'bf16'}_max_abs_err"] = err
    print(f"chip_smoke wall time {time.perf_counter() - wall0:.1f} s [{card}]")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def serving(dev, card):
    """Phases 2-5: the serving slice; returns conv3x3_fwd's kernels entry."""
    import torch

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.synthetic import scene_frames
    from ssde_tpu_torch.eval.gru_runners import GRUStreamEvaluator
    from ssde_tpu_torch.models.common import sample_
    from ssde_tpu_torch.models.resnet import randomize_bn_stats_
    from ssde_tpu_torch.ops.conv3x3 import ACTS, conv3x3, conv3x3_reference
    from ssde_tpu_torch.scripts.evaluate_depth_gru_fusion import (
        build_evaluator, predict_bucketed, predict_scenes)
    from ssde_tpu_torch.train.steps_gru import GRUModels

    # ----------------------------------------------- 2. kernel vs plain twin
    convs = slice_convs(VERSION, H, W)
    shapes = sorted({c[1:5] for c in convs}, key=lambda s: (-s[3], s[1]))
    # ragged: off every tile and channel multiple of both bodies, the heads
    # and their dx (a conv from 1 channel) off the tile, the 2-pixel minimum
    ragged = [((5, 17, 37, 45), 2), ((32, 1, 37, 45), 2), ((1, 32, 9, 70), 2),
              ((192, 64, 5, 72), 1), ((3, 1, 2, 2), 1)]
    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_abs, n_cases = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0
    worst_f64 = {"kernel": 0.0, "twin": 0.0, "ratio": 0.0}  # f32 cases against float64
    worst_ratio_variant = 0.0
    print(f"kernel vs twin: {len(shapes)} shapes x B(1,8) + {len(ragged)} ragged x pad x act x "
          f"bias x dtype; bounds rel f32 {TOL_F32}, bf16 {TOL_BF16} (vs f32 twin on "
          f"bf16-rounded inputs); f32 against float64 at {F64_RATIO}x the twin's own error")
    with torch.inference_mode():
        for (cin, cout, h, w), B in list(itertools.product(shapes, (1, 8))) + ragged:
            case64 = {"kernel": 0.0, "twin": 0.0}  # the case's worst against float64
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
                worst_abs[dt] = max(worst_abs[dt], err)
                f64 = ""
                if dt == torch.float32:
                    ref64 = conv3x3_reference(x.double(), wt.double(),
                                              bt.double() if has_b else None, pad, act)
                    e64 = {name: (o.double() - ref64).abs().max().item()
                           for name, o in (("kernel", out), ("twin", ref))}
                    ratio = e64["kernel"] / max(e64["twin"], 1e-30)
                    worst_ratio_variant = max(worst_ratio_variant, ratio)
                    for name, v in e64.items():
                        case64[name] = max(case64[name], v)
                    f64 = (f"; vs float64 kernel {e64['kernel']:.3e}, twin {e64['twin']:.3e} "
                           f"({ratio:.2f}x)")
                tag = "f32 " if dt == torch.float32 else "bf16"
                print(f"  {cin:3d}->{cout:<3d} {h}x{w} B={B} {tag} {pad:7s} {act:7s} "
                      f"bias={int(has_b)} abs {err:.3e} rel {rel:.3e}{f64}")
                if rel > (TOL_F32 if dt == torch.float32 else TOL_BF16):
                    fail(f"kernel disagrees with twin: {cin}->{cout} {h}x{w} B={B} "
                         f"{dt} {pad} {act} bias={has_b}: rel {rel:.3e}")
            ratio = case64["kernel"] / max(case64["twin"], 1e-30)
            print(f"  {cin:3d}->{cout:<3d} {h}x{w} B={B} f32 worst against float64: kernel "
                  f"{case64['kernel']:.3e}, twin {case64['twin']:.3e} ({ratio:.2f}x, bound "
                  f"{F64_RATIO}x)")
            for name, v in (*case64.items(), ("ratio", ratio)):
                worst_f64[name] = max(worst_f64[name], v)
            if ratio > F64_RATIO:
                fail(f"float32 kernel off float64 by {ratio:.2f}x the twin's error: "
                     f"{cin}->{cout} {h}x{w} B={B}")
    print(f"kernel vs twin: {n_cases} cases ok; worst rel f32 {worst[torch.float32]:.3e} "
          f"(abs {worst_abs[torch.float32]:.3e}), bf16 {worst[torch.bfloat16]:.3e} (abs "
          f"{worst_abs[torch.bfloat16]:.3e})")
    print(f"float32 cases against float64: worst abs kernel {worst_f64['kernel']:.3e}, "
          f"twin {worst_f64['twin']:.3e}; worst case kernel / twin {worst_f64['ratio']:.2f}x "
          f"(bound {F64_RATIO}x; worst single variant {worst_ratio_variant:.2f}x)")

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
          f"{steps} = {per_step * steps}), every one on the float32 3xTF32 body "
          f"(csrc/conv3x3_tf32.cu)")
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
          "twin, kernel, kernel, twin; float32; inputs stay resident in L2 where they fit;"
          " the weights are ordinary tensors, as a model's are, so the kernel packs them "
          "once; library: cuDNN F.conv2d with zero padding 1 and no act, the same FLOPs)")
    per_conv = {}
    for (cin, cout, h, w, pad, act, has_b), B in itertools.product(
            sorted({c[1:] for c in convs}, key=lambda c: (-c[3], c[1], c[0])), (1, 8)):
        x = torch.randn(B, cin, h, w, device=dev, generator=g)
        wt = torch.randn(cout, cin, 3, 3, device=dev, generator=g)
        bt = torch.randn(cout, device=dev, generator=g) if has_b else None
        with torch.inference_mode():
            k = lambda: conv3x3(x, wt, bt, pad, act)
            p = lambda: conv3x3_reference(x, wt, bt, pad, act)
            tp1, tk1, tk2, tp2 = cuda_ms(p), cuda_ms(k), cuda_ms(k), cuda_ms(p)
            tl = cuda_ms(lambda: torch.nn.functional.conv2d(x, wt, bt, padding=1))
            tk, tp = (tk1 + tk2) / 2, (tp1 + tp2) / 2
            per_conv[(cin, cout, h, w, pad, act, has_b, B)] = (tk, tp, tl)
            gflop = 2 * 9 * cin * cout * h * w * B / 1e9
            print(f"  {cin:3d}->{cout:<3d} {h}x{w} B={B} {pad:7s} {act:7s} "
                  f"bias={int(has_b)}: kernel "
                  f"{tk:.4f} ms ({gflop / tk:.2f} TFLOP/s), twin {tp:.4f} ms "
                  f"({gflop / tp:.2f} TFLOP/s), library {tl:.4f} ms [{card}]")
    frame_k, frame_p, frame_l = (sum(per_conv[c[1:] + (1,)][i] for c in convs) for i in range(3))
    costs = [conv_cost(c[1], c[2], c[3], c[4], 1, 4) for c in convs]
    flops, nbytes = sum(f for f, _ in costs), sum(b for _, b in costs)
    frame_b, frame_by = bound(flops, nbytes, "float32_3xtf32")
    cuda_core_b, _ = bound(flops, nbytes, "float32")
    print(f"kernel convs of one frame-step at B=1 ({per_step} convs): kernel "
          f"{frame_k:.4f} ms, twin {frame_p:.4f} ms, library {frame_l:.4f} ms, bound "
          f"{frame_b:.4f} ms ({frame_by}, float32 as 3xTF32 at 495/3 TFLOP/s; "
          f"{cuda_core_b:.4f} ms at the 67 TFLOP/s float32 CUDA-core peak) [{card}]")

    stream_times(ev, scene, items, card, VERSION)

    conv_kernel = {"name": "conv3x3_fwd", "route": "cuda",
                   "source": "ssde_tpu_torch/csrc/conv3x3_tf32.cu",
                   "replaces": "ssde_tpu/ops/pallas/conv3x3.py:79",
                   "launches": launches, "max_abs_err": worst_abs[torch.float32],
                   "ms": frame_k, "plain_ms": frame_p, "bound_ms": frame_b,
                   "bound_by": frame_by, "library_ms": frame_l,
                   "bf16_max_abs_err": worst_abs[torch.bfloat16]}
    del ev, cpu_models, g
    torch.cuda.empty_cache()
    return conv_kernel


def stream_times(ev, scene, items, card, version):
    """Streaming latency per frame at B=1 (median, p90; host clock around
    upload, step and the disparity back) and the warm-up protocol's
    frames/s at B=8 (phases 5 and 17)."""
    import torch

    from ssde_tpu_torch.scripts.evaluate_depth_gru_fusion import predict_bucketed

    lat, carry = [], ev.initial_carry(1)
    for i in range(3 + LATENCY_FRAMES):  # 3 warm-up frames, then the samples
        t0 = time.perf_counter()
        carry, disp = ev.step(carry, ev.to_device(scene[i % len(scene)]))
        ev.to_host(disp)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.array(lat[3:])
    print(f"{version} streaming latency at B=1: median {np.median(lat):.3f} ms, p90 "
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
    print(f"{version} warm-up protocol at B={EVAL_BATCH}: median "
          f"{n_frames / np.median(runs):.2f} frames/s, range [{n_frames / runs.max():.2f}, "
          f"{n_frames / runs.min():.2f}] (n={runs.size} runs of {n_frames} frames incl. "
          f"warm-up; {EVAL_BATCH / np.median(runs):.2f} test images/s) [{card}]")


# ====================================================== the mono slice

def _mono_grids(dev, B, H, W, gen, S=S_SCALES, stereo=False):
    """S reprojection grids (S, B, H, W, 2): random depth in [1, 80] m and
    a small random pose per item, through the port's reproject_coords; with
    ``stereo``, KITTI's baseline instead of the pose, the left camera's for
    the first half of the batch and the right's for the rest (the stereo
    source's ``stereo_T``, ``data/kitti.py``)."""
    import torch

    from ssde_tpu_torch.data.kitti import KITTI_K
    from ssde_tpu_torch.ops.geometry import reproject_coords, transformation_from_parameters

    K = torch.from_numpy(KITTI_K).to(dev).repeat(B, 1, 1)
    K[:, 0, :] *= W
    K[:, 1, :] *= H
    inv_K = torch.linalg.inv(K)
    baseline = torch.eye(4, device=dev).repeat(B, 1, 1)
    baseline[:, 0, 3] = torch.where(torch.arange(B, device=dev) < B // 2, -0.1, 0.1)
    grids = []
    for _ in range(S):
        depth = torch.rand(B, 1, H, W, device=dev, generator=gen) * 79 + 1
        if stereo:
            T = baseline
        else:
            aa = torch.randn(B, 3, device=dev, generator=gen) * 0.01
            t = torch.randn(B, 3, device=dev, generator=gen) * 0.1
            T = transformation_from_parameters(aa, t)
        grids.append(reproject_coords(depth, inv_K, K, T))
    return torch.stack(grids).contiguous()


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _warp_errs(img, grids, cot):
    """The family warp's kernels against their plain versions on one input:
    (forward's abs error, grid gradient's error relative to its max, and
    absolute, the kernel's output). The backward runs twice and must be
    bit-identical (no atomics, a fixed channel order)."""
    import torch

    from ssde_tpu_torch.ops.warp import warp_family_bwd_reference, warp_family_reference
    from ssde_tpu_torch.ops.warp_banded import warp_family_bwd, warp_family_fwd

    with torch.no_grad():
        out, dgrid = warp_family_fwd(img, grids), warp_family_bwd(img, grids, cot)
        again = warp_family_bwd(img, grids, cot)
        want, dwant = (warp_family_reference(img, grids)[0],
                       warp_family_bwd_reference(img, grids, cot))
    torch.cuda.synchronize()
    if out.shape != want.shape or dgrid.shape != grids.shape or not torch.equal(dgrid, again):
        fail(f"warp kernels: shapes {tuple(out.shape)}, {tuple(dgrid.shape)}, or two "
             f"backward runs differ at grids {tuple(grids.shape)}")
    return ((out - want).abs().max().item(), _rel(dgrid, dwant),
            (dgrid - dwant).abs().max().item(), out)


def warp_cost(S, B, C, h, w):
    """(FLOPs, bytes) of the family warp's forward and backward at S grids of
    B images of C x h x w, float32, each input read once and each output
    written once; operations counted from the bodies: ~20 a pixel for the
    coordinate, its window and masks, and a value's three lerps (~10,
    forward) or its two residuals and their channel sums (~16, backward)."""
    px, vals = S * B * h * w, S * B * C * h * w
    img, grid = 4 * B * C * h * w, 8 * px
    fwd = (20 * px + 10 * vals, img + grid + 4 * vals)
    bwd = (22 * px + 16 * vals, img + 2 * grid + 4 * vals)
    return {"warp_family_fwd": fwd, "warp_family_bwd": bwd,
            "warp_family_pair": tuple(a + b for a, b in zip(fwd, bwd))}


def host_us(fn, n=300):
    """Host microseconds a call over ``n`` unsynchronised calls (the queue
    is drained before and after, outside the clock)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def warp_times(img, grids, dout, card, label):
    """The family warp's forward, backward and the pair of them, each kernel
    beside its plain version (CUDA events, order plain, kernel, kernel,
    plain), its bound and the library call of the same function, a yardstick
    only: F.grid_sample border over the S grids (the image repeated outside
    the timing) and aten's grid_sampler_2d_backward for the grid alone
    (output_mask [False, True]). Returns {name: entry}."""
    import torch

    from ssde_tpu_torch.ops.warp import warp_family_bwd_reference, warp_family_reference
    from ssde_tpu_torch.ops.warp_banded import warp_family_bwd, warp_family_fwd

    S, B, h, w, _ = grids.shape
    C = img.shape[1]
    img_s, grids_s = img.repeat(S, 1, 1, 1), grids.flatten(0, 1)
    fwd, bwd = (lambda: warp_family_fwd(img, grids)), (lambda: warp_family_bwd(img, grids, dout))
    plain_fwd = lambda: warp_family_reference(img, grids)  # noqa: E731
    plain_bwd = lambda: warp_family_bwd_reference(img, grids, dout)  # noqa: E731
    lib_fwd = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        img_s, grids_s, mode="bilinear", padding_mode="border", align_corners=False)
    lib_bwd = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
        dout, img_s, grids_s, 0, 1, False, [False, True])
    fns = {"warp_family_fwd": (fwd, plain_fwd, lib_fwd),
           "warp_family_bwd": (bwd, plain_bwd, lib_bwd),
           "warp_family_pair": (lambda: (fwd(), bwd()), lambda: (plain_fwd(), plain_bwd()),
                                lambda: (lib_fwd(), lib_bwd()))}
    cost = warp_cost(S, B, C, h, w)
    times = {}
    with torch.no_grad():
        for name, (k, p, lib) in fns.items():
            tp1, tk1, tk2, tp2 = cuda_ms(p), cuda_ms(k), cuda_ms(k), cuda_ms(p)
            tl = cuda_ms(lib)
            bms, by = bound(*cost[name], "float32")
            times[name] = {"ms": (tk1 + tk2) / 2, "plain_ms": (tp1 + tp2) / 2, "bound_ms": bms,
                           "bound_by": by, "library_ms": tl}
            print(f"  {name} {label} S={S} B={B} {w}x{h}: kernel {times[name]['ms']:.4f} ms, "
                  f"plain {times[name]['plain_ms']:.4f} ms, library {tl:.4f} ms, bound "
                  f"{bms:.4f} ms ({by}) [{card}]")
    return times


def mono_kernels(dev, card):
    """Phase 6: each new kernel against its plain version on the card."""
    import torch

    from ssde_tpu_torch.ops.photometric import (BWD_BAND, BWD_STRIP, FWD_BAND, FWD_STRIP,
                                                photometric_bwd, photometric_bwd_reference,
                                                photometric_fwd, photometric_reference)

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = dict.fromkeys(("warp_family_fwd", "warp_family_bwd", "photometric_fwd",
                          "photometric_bwd"), 0.0)
    print(f"mono kernels vs plain versions: warp abs {TOL_WARP}, its grid gradient "
          f"{TOL_WARP} of max; photometric fwd abs {TOL_PHOTO}, bwd {TOL_PHOTO_BWD} of max")
    cases = [(MONO_B, H, W, "reproject"), (BENCH_B, H, W, "reproject"),
             (FED_B, H, W, "reproject"), (MONO_B, H, W, "border"), (3, 190, 630, "reproject"),
             (2, 37, 45, "border")]
    for B, h, w, kind in cases:
        img = torch.rand(B, 3, h, w, device=dev, generator=gen)
        if kind == "reproject":
            grids = _mono_grids(dev, B, h, w, gen)
        else:  # out of range, on the border and on the pixel centres' edges
            grids = (torch.rand(1, B, h, w, 2, device=dev, generator=gen) * 2.6 - 1.3)
            grids[0, :, 0, :8] = torch.tensor([[1.0, 1.0], [-1.0, -1.0], [1 - 1 / w, 0.0],
                                               [-1 + 1 / w, 1 - 1 / h], [1.0, -1.0],
                                               [0.0, 1.0], [-1.0, 0.0], [2.0, -2.0]],
                                              device=dev)
            grids = grids.contiguous()
        S = grids.shape[0]
        cot = torch.randn(S * B, 3, h, w, device=dev, generator=gen)
        werr, gerr, gabs, got = _warp_errs(img, grids, cot)
        errs["warp_family_fwd"] = max(errs["warp_family_fwd"], werr)
        errs["warp_family_bwd"] = max(errs["warp_family_bwd"], gabs)
        # photometric on G = 10B: the warped maps, then identity maps
        preds = torch.cat([got] + [torch.rand(B, 3, h, w, device=dev, generator=gen)
                               for _ in range(10 - S)]).contiguous()
        targ = torch.rand(B, 3, h, w, device=dev, generator=gen)
        gout = torch.randn(preds.shape[0], h, w, device=dev, generator=gen) / preds[0].numel()
        with torch.no_grad():
            pf, pf_ref = photometric_fwd(preds, targ), photometric_reference(preds, targ)
            pb, pb_ref = (photometric_bwd(preds, targ, gout),
                          photometric_bwd_reference(preds, targ, gout))
        torch.cuda.synchronize()
        ferr, berr = (pf - pf_ref).abs().max().item(), _rel(pb, pb_ref)
        errs["photometric_fwd"] = max(errs["photometric_fwd"], ferr)
        errs["photometric_bwd"] = max(errs["photometric_bwd"],
                                      (pb - pb_ref).abs().max().item())
        print(f"  {kind:9s} S={S} B={B:2d} {h}x{w}: warp abs {werr:.3e}, grid grad rel "
              f"{gerr:.3e}; photometric G={preds.shape[0]} fwd abs {ferr:.3e}, bwd rel "
              f"{berr:.3e}")
        if not (werr <= TOL_WARP and gerr <= TOL_WARP and ferr <= TOL_PHOTO
                and berr <= TOL_PHOTO_BWD):
            fail(f"mono kernel disagrees with its plain version at {kind} B={B} {h}x{w}")
    # the photometric kernels alone at the edges of their partition
    # (ops/photometric.py): W = 1, 2, 3 (mod 4) (single loads where a row is
    # off a float2), W and H one off a strip or band, and G = 240 (the GRU
    # step's B*T = 24) at 640x192
    for G, B, h, w in [(10, 1, 5, 61), (10, 1, 7, 62), (10, 1, 9, 63),
                       (20, 2, FWD_BAND + 1, FWD_STRIP - 1), (20, 2, BWD_BAND - 1, BWD_STRIP + 1),
                       (20, 2, 2 * BWD_BAND + 1, 2 * BWD_STRIP - 1), (10, 1, 2, 2),
                       (240, 24, H, W)]:
        preds = torch.rand(G, 3, h, w, device=dev, generator=gen)
        targ = torch.rand(B, 3, h, w, device=dev, generator=gen)
        gout = torch.randn(G, h, w, device=dev, generator=gen) / preds[0].numel()
        with torch.no_grad():
            pf, pf_ref = photometric_fwd(preds, targ), photometric_reference(preds, targ)
            pb, pb_ref = (photometric_bwd(preds, targ, gout),
                          photometric_bwd_reference(preds, targ, gout))
        torch.cuda.synchronize()
        ferr, berr = (pf - pf_ref).abs().max().item(), _rel(pb, pb_ref)
        errs["photometric_fwd"] = max(errs["photometric_fwd"], ferr)
        errs["photometric_bwd"] = max(errs["photometric_bwd"], (pb - pb_ref).abs().max().item())
        print(f"  photometric G={G} B={B} {h}x{w}: fwd abs {ferr:.3e}, bwd rel {berr:.3e}")
        if not (ferr <= TOL_PHOTO and berr <= TOL_PHOTO_BWD):
            fail(f"photometric kernel disagrees with its plain version at G={G} {h}x{w}")
    print("mono kernels vs plain versions ok; worst abs " +
          ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


def mono_slice(dev):
    """Phase 7: one epoch of the mono trainer through the entry point."""
    import torch

    from ssde_tpu_torch.config import MonodepthOptions
    from ssde_tpu_torch.ops.photometric import photometric_bwd, photometric_fwd
    from ssde_tpu_torch.ops.warp_banded import warp_family_bwd, warp_family_fwd
    from ssde_tpu_torch.scripts.train_dpt import build_trainer

    opts = MonodepthOptions().parse(["--model", "monodepth2", "--synthetic_data",
                                     "--num_epochs", "1", "--save_frequency", "2",
                                     "--num_workers", "4"])
    if (opts.batch_size, opts.height, opts.width, opts.compute_dtype, opts.num_layers) != (
            MONO_B, H, W, "bfloat16", 18):
        fail(f"unexpected Options defaults {opts}")
    trainer = build_trainer(opts, dev)
    def tensors():
        return {f"{i}.{k}": v for i, m in enumerate(trainer.models.modules())
                for k, v in m.state_dict().items() if not k.endswith("num_batches_tracked")}

    before = {k: v.detach().clone() for k, v in tensors().items()}
    n_val = [0]
    val = trainer.val
    trainer.val = lambda: (n_val.__setitem__(0, n_val[0] + 1), val())[1]
    torch.cuda.synchronize()
    warp_family_fwd.launches = warp_family_bwd.launches = 0
    photometric_fwd.launches = photometric_bwd.launches = 0
    t0 = time.perf_counter()
    history = trainer.run_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"warp_family_fwd": warp_family_fwd.launches,
              "warp_family_bwd": warp_family_bwd.launches,
              "photometric_fwd": photometric_fwd.launches,
              "photometric_bwd": photometric_bwd.launches}
    steps = len(history)
    want = {"warp_family_fwd": 2 * (steps + n_val[0]), "warp_family_bwd": 2 * steps,
            "photometric_fwd": steps + n_val[0], "photometric_bwd": steps}
    losses = [{k: float(v) for k, v in h.items()} for h in history]
    print(f"mono slice: {steps} steps + {n_val[0]} val() at B={opts.batch_size}, "
          f"{H}x{W}, {opts.compute_dtype} autocast, in {wall:.1f} s (loader, first-step "
          f"cuDNN set-up and val included)")
    print("mono slice: loss per step " + " ".join(f"{l['loss']:.5f}" for l in losses))
    print(f"mono slice: launches {counts} (expected {want})")
    if steps != 8 or counts != want:
        fail(f"mono slice: {steps} steps, launches {counts}, expected {want}")
    if not all(np.isfinite(v) for l in losses for v in l.values()):
        fail("mono slice: a loss is not finite")
    after = tensors()
    unchanged = [k for k, v in before.items() if torch.equal(v, after[k])]
    print(f"mono slice: {len(before) - len(unchanged)} of {len(before)} parameter and "
          f"statistics tensors changed" + (f"; unchanged: {unchanged}" if unchanged else ""))
    if unchanged:
        fail("mono slice: some parameters or statistics did not change")
    return counts


def _selection(pinned=None, record=None, switches=None, rows=slice(None)):
    """``min_reprojection`` of the train step with its argmin over
    [identity, reprojection] (the reprojection alone under
    --disable_automasking) recorded (``record``) or taken from ``rows`` of
    ``pinned``, one entry per scale; ``switches`` gets the pixels where the
    run's own argmin differs from the pinned one."""
    import torch

    def select(reproj, ident, generator=None):
        combined = reproj if ident is None else torch.cat([ident, reproj], 1)
        idx = torch.argmin(combined, 1, keepdim=True)
        if pinned is None:
            record.append(idx.cpu())
        else:
            want = pinned[len(switches)][rows].to(idx.device)
            switches.append(int((idx != want).sum()))
            idx = want
        n_ident = 0 if ident is None else ident.shape[1]
        return torch.gather(combined, 1, idx), (idx >= n_ident).to(combined.dtype)
    return select


def mono_card_vs_cpu(dev, batch=None):
    """Phase 8: one step at 640x192, B=2, on the card and on the CPU with
    the same weights and batch (``batch`` defaults to the synthetic
    data's), held against each other; a float64 run of the step on the CPU
    is the reference for both."""
    import torch

    import ssde_tpu_torch.train.steps as steps
    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch

    B = 2
    opts = Options(height=H, width=W, batch_size=B, compute_dtype="float32")
    if batch is None:
        batch = make_synthetic_batch(B, H, W, seed=SEED)
    groups = ("encoder", "depth", "pose_encoder", "pose")
    selected, switches = [], {}
    f32, f64 = torch.float32, torch.float64

    def run(where, net, loss_dtype, select):
        """The step with the networks in ``net`` and the geometry, warp and
        loss in ``loss_dtype``; ``select`` replaces the automask's min."""
        models = steps.build_mono_models(opts, where, torch.Generator().manual_seed(SEED))
        for m in models.modules():
            m.to(net)
        inputs = {k: v.to(net) for k, v in to_device(batch, where).items()}
        inputs = {k: v if k.startswith("color_aug") or not v.is_floating_point()
                  else v.to(loss_dtype) for k, v in steps.preprocess_train(inputs, opts).items()}
        models.train()
        patched = {"min_reprojection": select or steps.min_reprojection,
                   "_full": lambda t: t.to(loss_dtype)}
        plain = {k: getattr(steps, k) for k in patched}
        try:
            for k, v in patched.items():
                setattr(steps, k, v)
            t0 = time.perf_counter()
            loss, losses, _ = steps.mono_loss_fn(models, inputs)
            loss.backward()
        finally:
            for k, v in plain.items():
                setattr(steps, k, v)
        grads = {(g, k): p.grad.detach().cpu().double() for g, m in zip(groups, models.modules())
                 for k, p in m.named_parameters()}
        return ({k: float(v.detach()) for k, v in losses.items()}, grads,
                time.perf_counter() - t0)

    def pinned(name):
        switches[name] = []
        return _selection(selected, switches=switches[name])

    l64, g64, t64 = run("cpu", f64, f64, _selection(record=selected))
    lg, gg, _ = run(dev, f64, f32, pinned("card"))
    lc, gc, tc = run("cpu", f64, f32, pinned("CPU"))
    float32 = {"card": run(dev, f32, f32, pinned("card float32"))[1],
               "CPU": run("cpu", f32, f32, pinned("CPU float32"))[1],
               "card unpinned": run(dev, f32, f32, None)[1]}
    lrel = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc)
    print(f"mono card vs CPU: one step at {H}x{W} B={B}, networks float64, geometry, warp "
          f"and loss float32 (CPU {tc:.1f} s, CPU all-float64 {t64:.1f} s): loss card "
          f"{lg['loss']:.8f}, CPU {lc['loss']:.8f}, float64 {l64['loss']:.8f}; worst "
          f"card-vs-CPU rel over {sorted(lc)} {lrel:.3e} (bound {TOL_STEP_LOSS})")
    ok = lrel <= TOL_STEP_LOSS
    n_px = sum(m.numel() for m in selected)
    print("  automask argmin differs from the float64 run's at " +
          ", ".join(f"{sum(v)} ({k})" for k, v in switches.items()) +
          f" of {n_px} pixel-scales; every run but 'card unpinned' takes float64's")
    print(f"  gradients, worst over each group's tensors of |d| / max|g| (bound "
          f"{TOL_STEP_GRAD}: card vs CPU, and each against float64; the all-float32 "
          f"runs are shown, not held):")
    for grp in groups:
        keys = [k for k in gc if k[0] == grp]
        d = max(_rel(gg[k], gc[k]) for k in keys)
        e = {"card": gg, "CPU": gc} | {f"{k} all-float32": v for k, v in float32.items()}
        e = {k: max(_rel(v[t], g64[t]) for t in keys) for k, v in e.items()}
        print(f"    {grp:12s} card vs CPU {d:.3e} ({len(keys)} tensors); against float64: "
              + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
        ok = ok and max(d, e["card"], e["CPU"]) <= TOL_STEP_GRAD
    if not ok:
        fail("mono card and CPU disagree")


def _device_idle_share(fn, steps):
    """(device busy ms, wall ms, profile) over ``steps`` calls of ``fn``
    under torch.profiler: the union of the kernels' intervals on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, wall, prof


def mono_times(dev, card):
    """Phase 9: step times, kernel times, idle share."""
    import torch

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.ops.photometric import (photometric_bwd, photometric_bwd_reference,
                                                photometric_fwd, photometric_reference, work)
    from ssde_tpu_torch.ops.warp_banded import warp_family_bwd, warp_family_fwd
    from ssde_tpu_torch.train.state import TrainState
    from ssde_tpu_torch.train.steps import build_mono_models, train_step

    torch.backends.cudnn.allow_tf32 = True  # the training configuration: bf16 convs
    times = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    print(f"mono times on {card} (CUDA events; kernels: 20 launches after 3 warm-up, "
          "order plain, kernel, kernel, plain)")
    for B in (MONO_B, BENCH_B):
        img = torch.rand(B, 3, H, W, device=dev, generator=gen)
        grids = _mono_grids(dev, B, H, W, gen)
        dout = torch.randn(S_SCALES * B, 3, H, W, device=dev, generator=gen)
        preds = torch.rand(10 * B, 3, H, W, device=dev, generator=gen)
        gout = torch.randn(10 * B, H, W, device=dev, generator=gen)
        warp = warp_times(img, grids, dout, card, "one source")
        for name, entry in warp.items():
            if B == MONO_B:
                times[name] = entry
            else:
                times[name].update({f"b{B}_{k}": v for k, v in entry.items()})
        if B == MONO_B:  # the host's share of a call: its enqueue, unsynchronised
            img_s, grids_s = img.repeat(S_SCALES, 1, 1, 1), grids.flatten(0, 1)
            with torch.no_grad():
                times["warp_family_fwd"]["host_us"] = hk = host_us(
                    lambda: warp_family_fwd(img, grids))
                times["warp_family_fwd"]["library_host_us"] = hl = host_us(
                    lambda: torch.nn.functional.grid_sample(
                        img_s, grids_s, padding_mode="border", align_corners=False))
                times["warp_family_bwd"]["host_us"] = hb = host_us(
                    lambda: warp_family_bwd(img, grids, dout))
            print(f"  host time a call, 300 unsynchronised calls at S={S_SCALES} B={B}: "
                  f"warp_family_fwd {hk:.1f} us, F.grid_sample {hl:.1f} us, "
                  f"warp_family_bwd {hb:.1f} us [{card}]")
            del img_s, grids_s
        with torch.no_grad():
            pairs = {"photometric_fwd": (lambda: photometric_fwd(preds, img),
                                         lambda: photometric_reference(preds, img)),
                     "photometric_bwd": (lambda: photometric_bwd(preds, img, gout),
                                         lambda: photometric_bwd_reference(preds, img, gout))}
            # (FLOPs, bytes): every input read once, every output written once,
            # float32; the photometric kernels' 52.5 and 93.5 operations a
            # value, counted from their bodies (ops/photometric.work); no
            # library call computes the photometric error or its gradient
            cost = {"photometric_fwd": work("fwd", 10 * B, B, 3, H, W),
                    "photometric_bwd": work("bwd", 10 * B, B, 3, H, W)}
            for name, (k, p) in pairs.items():
                tp1, tk1, tk2, tp2 = cuda_ms(p), cuda_ms(k), cuda_ms(k), cuda_ms(p)
                tk, tp = (tk1 + tk2) / 2, (tp1 + tp2) / 2
                bms, by = bound(*cost[name], "float32")
                if B == MONO_B:
                    times[name] = {"ms": tk, "plain_ms": tp, "bound_ms": bms, "bound_by": by,
                                   "library_ms": None}
                print(f"  {name} B={B} G={10 * B} {H}x{W}: kernel {tk:.4f} ms, plain "
                      f"{tp:.4f} ms, library none, bound {bms:.4f} ms ({by}) [{card}]")
        del img, grids, dout, preds, gout
        if B == MONO_B:  # the GRU steps' G = 240 (B=8, T=3) and 1200 (B=12, T=10): kernels
            for G in (240, 1200):  # alone (the plain backward would need tens of GB)
                preds = torch.rand(G, 3, H, W, device=dev, generator=gen)
                targ = torch.rand(G // 10, 3, H, W, device=dev, generator=gen)
                gout = torch.randn(G, H, W, device=dev, generator=gen)
                with torch.no_grad():
                    for kind, fn in (("fwd", lambda: photometric_fwd(preds, targ)),
                                     ("bwd", lambda: photometric_bwd(preds, targ, gout))):
                        bms, by = bound(*work(kind, G, G // 10, 3, H, W), "float32")
                        times[f"photometric_{kind}"][f"g{G}_ms"] = tk = cuda_ms(fn)
                        times[f"photometric_{kind}"][f"g{G}_bound_ms"] = bms
                        print(f"  photometric_{kind} G={G} {H}x{W}: kernel {tk:.4f} ms, bound "
                              f"{bms:.4f} ms ({by}) [{card}]")
                del preds, targ, gout

        torch.cuda.empty_cache()  # the step's own peak, not the plain versions
        torch.cuda.reset_peak_memory_stats()
        opts = Options(height=H, width=W, batch_size=B)  # bf16 autocast, the defaults
        models = build_mono_models(opts, dev, torch.Generator().manual_seed(SEED))
        state = TrainState(models.parameters(), opts.learning_rate, 15, 1000)
        batch = to_device(make_synthetic_batch(B, H, W, seed=SEED), dev)
        rng = torch.Generator(dev).manual_seed(SEED)
        step = lambda: train_step(models, state, batch, rng)  # noqa: E731
        for _ in range(3):
            step()
        n = 10
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            losses = step()
        end.record()
        last = float(losses["loss"])  # read back at the end of the chain
        ms = start.elapsed_time(end) / n
        busy, wall, prof = _device_idle_share(step, IDLE_STEPS)
        print(f"mono train step B={B} {H}x{W} bf16: {ms:.3f} ms, {B * 1e3 / ms:.2f} samples/s "
              f"(mean of {n} after 3 warm-up; last loss {last:.5f}); device busy "
              f"{busy:.1f} ms over {IDLE_STEPS} profiled steps: idle share "
              f"{1 - busy / (IDLE_STEPS * ms):.1%} of {IDLE_STEPS} unprofiled steps "
              f"({IDLE_STEPS * ms:.1f} ms), {1 - busy / wall:.1%} of the profiled wall "
              f"({wall:.1f} ms, the profiler's host cost included); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")
        # the residuals rdx, rdy that the warp's Function kept until the
        # backward before the backward became a kernel: two sources a step
        print(f"  the step's warp saves the image and the grids; the residuals it no longer "
              f"keeps: {2 * 2 * S_SCALES * B * 3 * H * W * 4 / 2**30:.3f} GiB a step "
              f"(computed from the shapes; scripts/bench_warp measures both bodies)")
        if not np.isfinite(last):
            fail(f"mono train step B={B}: loss {last}")
        times.setdefault("train_step_ms", {})[B] = ms
        times.setdefault("train_step_peak_gib", {})[B] = torch.cuda.max_memory_allocated() / 2**30
        if B == BENCH_B:
            table = prof.key_averages().table(sort_by="device_time_total", row_limit=25)
            os.makedirs("chiprun_out", exist_ok=True)
            with open(os.path.join("chiprun_out", "mono_profile_b48.txt"), "w") as f:
                f.write(f"{card}\n{table}\n")
            print(f"  top device kernels over {IDLE_STEPS} profiled steps at B=48:")
            for line in table.splitlines()[:14]:
                print("   ", line[:160])
        del models, state, batch, prof
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return times


# ======================================================= the GRU slice

DEC_CH = (16, 32, 64, 128)  # the decoder's pre-disp channels at scales 0-3


def _leaf(t, dtype):
    return None if t is None else t.detach().to(dtype).requires_grad_()


def _plain_grads(x, w, b, g, pad, act):
    """(dx, dw, db) of autograd of conv3x3_reference, in x's dtype."""
    from ssde_tpu_torch.ops.conv3x3 import conv3x3_reference

    xr, wr, br = (_leaf(t, x.dtype) for t in (x, w, b))
    conv3x3_reference(xr, wr, br, pad, act).backward(g.to(x.dtype))
    return tuple(None if t is None else t.grad for t in (xr, wr, br))


def _conv_bwd(x, w, b, g, pad, act, dtype):
    """One conv3x3 backward on the card and its plain version: ((dx, dw, db)
    of the kernels, (dx, dw, db) of autograd of the plain conv on the same
    operands, in float64 for float32 ones and in float32 for bf16 ones, and
    the gradient gp that both took).
    Both take the gradient gp = g * act'(out) that the backward feeds its
    kernels, act' from the forward kernel's output and gp rounded to the
    operands' dtype: a float64 act' would flip relu's mask wherever float32
    rounding crosses zero (4.7e-2 of max in dx at B=8 on an H100), and
    sigmoid's 1 - out keeps only a few bits in bf16. act' itself is plain
    torch, held to autograd in float64 by tests/test_torch_conv3x3_grad.py."""
    import torch

    from ssde_tpu_torch.ops.conv3x3 import act_grad, conv3x3

    xi, wi, bi = (_leaf(t, dtype) for t in (x, w, b))
    out = conv3x3(xi, wi, bi, pad, act)
    out.backward(g.to(dtype))
    got = tuple(None if t is None else t.grad for t in (xi, wi, bi))
    ag = act_grad(act, out.detach().float())
    gp = (g.to(dtype).float() * (1.0 if ag is None else ag)).to(dtype)
    hi = torch.float64 if dtype == torch.float32 else torch.float32
    return got, _plain_grads(*(_leaf(t, hi) for t in (xi, wi, bi)), gp, pad, "none"), gp


def gru_kernels(dev):
    """Phase 10: the conv3x3 backward (the forward kernel as dx, kernel #2,
    db) against autograd of the plain version, at every conv shape of the
    GRU v10 frame-step at B=8 (640x192), both pads, bias on and off,
    float32 and bf16; elu and tanh at one shape; ragged and 2-pixel-high
    maps. The float32 cases are also held against a float64 run, at
    F64_RATIO x the error of the plain float32 backward (cuDNN, TF32 off) on
    the same gradient gp."""
    import torch

    from ssde_tpu_torch.ops.conv3x3 import PADS, conv3x3_dw

    torch.backends.cudnn.allow_tf32 = False
    shapes = sorted({c[1:7] for c in slice_convs(VERSION, H, W)},
                    key=lambda c: (-c[3], c[0], c[1], c[5]))
    cases = [(GRU_B, cin, cout, h, w, p, act, has_b)
             for cin, cout, h, w, _, act in shapes for p in PADS for has_b in (True, False)]
    cases += [(GRU_B, 32, 64, H, W, p, act, True) for act in ("elu", "tanh") for p in PADS]
    cases += [(2, 5, 17, 37, 45, p, "relu", True) for p in PADS]  # nothing divides
    cases += [(2, 32, 1, 37, 45, "reflect", "sigmoid", True),  # a ragged head
              (2, 32, 1, 2, 45, "reflect", "sigmoid", True),   # folds on rows 1 and 0
              (2, 16, 16, 2, 45, "reflect", "none", False)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_abs = {}  # (kernel, dtype) -> worst absolute error
    worst_plain, worst_ratio = 0.0, 0.0  # cuDNN's float32 backward against float64
    print(f"gru kernels: the conv3x3 backward, {len(cases)} cases x (float32, bf16) "
          f"against autograd of the plain version; bounds of each gradient's max: "
          f"float32 {TOL_BWD_F32}, bf16 {TOL_BWD_BF16}")
    t0 = time.perf_counter()
    for B, cin, cout, h, w, pad, act, has_b in cases:
        x = torch.randn(B, cin, h, w, device=dev, generator=gen)
        wt = torch.randn(cout, cin, 3, 3, device=dev, generator=gen) / (3 * cin ** 0.5)
        bt = torch.randn(cout, device=dev, generator=gen) * 0.1 if has_b else None
        g = torch.randn(B, cout, h, w, device=dev, generator=gen)
        line = []
        for dtype in (torch.float32, torch.bfloat16):
            got, want, gp = _conv_bwd(x, wt, bt, g, pad, act, dtype)
            torch.cuda.synchronize()
            rels = []
            for name, a, r in zip(("dx", "dw", "db"), got, want):
                if r is None:
                    continue
                if a.dtype != dtype or a.shape != r.shape:
                    fail(f"gru kernels: {name} {a.dtype} {tuple(a.shape)}")
                rels.append((name, _rel(a.to(r.dtype), r)))
                if name != "db":
                    key = ("conv3x3_dx" if name == "dx" else "conv3x3_dw", dtype)
                    worst_abs[key] = max(worst_abs.get(key, 0.0),
                                         (a.to(r.dtype) - r).abs().max().item())
            ratio = ""
            if dtype == torch.float32:  # autograd of the plain version in float32 on gp
                plain = _plain_grads(*(_leaf(t, dtype) for t in (x, wt, bt)), gp, pad, "none")
                e_plain = max(_rel(a.double(), r) for a, r in zip(plain, want) if r is not None)
                r_case = max(r for _, r in rels) / max(e_plain, 1e-30)
                worst_plain, worst_ratio = max(worst_plain, e_plain), max(worst_ratio, r_case)
                ratio = f" ({r_case:.2f}x plain's {e_plain:.2e})"
                if r_case > F64_RATIO:
                    fail(f"gru kernels: {cin}->{cout} {h}x{w} B={B} {pad} {act} bias={has_b} "
                         f"float32 off float64 by {r_case:.2f}x the plain backward's error")
            tol = TOL_BWD_F32 if dtype == torch.float32 else TOL_BWD_BF16
            worst[dtype] = max([worst[dtype]] + [r for _, r in rels])
            line.append(("f32 " if dtype == torch.float32 else "bf16 ")
                        + " ".join(f"{n} {r:.2e}" for n, r in rels) + ratio)
            if max(r for _, r in rels) > tol:
                fail(f"gru kernels: {cin}->{cout} {h}x{w} B={B} {pad} {act} bias={has_b} "
                     f"{dtype}: {rels} above {tol}")
        print(f"  {cin:3d}->{cout:<3d} {h}x{w} B={B} {pad:7s} {act:7s} bias={int(has_b)}: "
              + "; ".join(line))
        del x, wt, bt, g
    # the weight gradient sums in a fixed order (no atomics): the same bits
    # twice at a GRU width, in either dtype
    x = torch.randn(GRU_B, 32, H, W, device=dev, generator=gen)
    g = torch.randn(GRU_B, 96, H, W, device=dev, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        xd, gd = x.to(dtype), g.to(dtype)
        if not torch.equal(conv3x3_dw(xd, gd, "zero"), conv3x3_dw(xd, gd, "zero")):
            fail(f"gru kernels: the {dtype} dW of 32->96 at 192x640, B=8 differs between "
                 "two runs")
    print(f"gru kernels: the float32 and bf16 dW of 32->96 at {H}x{W}, B={GRU_B} are each "
          "bit-identical twice")
    del x, g, xd, gd
    print(f"gru kernels: {2 * len(cases)} cases ok in {time.perf_counter() - t0:.1f} s; worst "
          f"of max: float32 {worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}; "
          + "; ".join(f"{'float32' if dt == torch.float32 else 'bf16'} worst abs {k[8:]} {v:.3e}"
                      for (k, dt), v in sorted(worst_abs.items(), key=str))
          + f"; autograd of the plain version in float32 (cuDNN, TF32 off) on the same gp "
          f"against the float64 reference, worst of max: {worst_plain:.3e}; float32 kernels "
          f"over it, worst case {worst_ratio:.2f}x (bound {F64_RATIO}x)")
    torch.cuda.empty_cache()
    return worst_abs


def _gru_counters():
    from ssde_tpu_torch.ops.attention_win import attend3_bwd, attend3_fwd
    from ssde_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_dw, conv3x3_dx
    from ssde_tpu_torch.ops.photometric import photometric_bwd, photometric_fwd
    from ssde_tpu_torch.ops.warp_banded import warp_family_bwd, warp_family_fwd

    return {"conv3x3_fwd": conv3x3, "conv3x3_dx": conv3x3_dx, "conv3x3_dw": conv3x3_dw,
            "attend3_fwd": attend3_fwd, "attend3_bwd": attend3_bwd,
            "warp_family_fwd": warp_family_fwd, "warp_family_bwd": warp_family_bwd,
            "photometric_fwd": photometric_fwd, "photometric_bwd": photometric_bwd}


def _block_launches(version, T, head_calls=1):
    """Kernel launches of the block unrolled over T frames with a backward,
    and of ``head_calls`` calls of the Head at all scales (once a train step,
    on all B*T frames): conv3x3 forward, dx and dW, attend3 forward and
    backward."""
    conv = (len(slice_convs(version, H, W)) * T
            + len(head_convs(version, H, W)) * head_calls)
    attn = len(slice_attention(version, H, W)) * T
    return {"conv3x3_fwd": conv, "conv3x3_dx": conv, "conv3x3_dw": conv,
            "attend3_fwd": attn, "attend3_bwd": attn}


def gru_slice(dev, version=VERSION):
    """Phase 11 (v10) and 16 (v9): one epoch of the GRU trainer through the
    entry point, its val(), then an epoch with the learned initial states
    frozen."""
    import torch

    from ssde_tpu_torch.config import MonodepthOptions
    from ssde_tpu_torch.scripts.train_gru import build_trainer

    opts = MonodepthOptions().parse(
        ["--gru_version", version, "--synthetic_data", "--batch_size", str(GRU_B),
         "--len_sequence", str(GRU_T), "--num_epochs", "2", "--save_frequency", "3",
         "--num_workers", "4"])
    if (opts.height, opts.width, opts.compute_dtype, opts.num_layers) != (H, W, "bfloat16", 18):
        fail(f"unexpected Options defaults {opts}")
    trainer = build_trainer(opts, dev)
    models = trainer.models
    trained = {id(p) for p in models.parameters()}
    h0 = {id(p) for p in models.h0_parameters()}

    def tensors(keep=lambda p: True):
        """Every trained parameter and BN statistic, by name (the dispconv
        heads, which pre_disp never runs, are neither)."""
        out = {}
        for i, m in enumerate(models.modules()):
            for k, v in m.state_dict(keep_vars=True).items():
                is_param = isinstance(v, torch.nn.Parameter)
                if k.endswith("num_batches_tracked") or (is_param and id(v) not in trained):
                    continue
                if keep(v):
                    out[f"{i}.{k}"] = v.detach().clone()
        return out

    n_skipped = sum(1 for m in models.modules() for p in m.parameters()) - len(trained)
    before = tensors()
    n_val = [0]
    val = trainer.val
    trainer.val = lambda: (n_val.__setitem__(0, n_val[0] + 1), val())[1]
    counters = _gru_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    history = trainer.run_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    steps = len(history)
    per_step = {**_block_launches(version, GRU_T), "warp_family_fwd": 2,
                "warp_family_bwd": 2, "photometric_fwd": 1, "photometric_bwd": 1}
    per_val = {k: v if k in ("conv3x3_fwd", "attend3_fwd") else 0 for k, v in per_step.items()}
    per_val.update(warp_family_fwd=2, photometric_fwd=1)
    want = {k: steps * per_step[k] + n_val[0] * per_val[k] for k in counters}
    losses = [{k: float(v) for k, v in h.items()} for h in history]
    print(f"gru slice {version}: {steps} steps + {n_val[0]} val() at B={GRU_B}, T={GRU_T}, "
          f"{H}x{W}, "
          f"{opts.compute_dtype} autocast, in {wall:.1f} s (loader, first-step set-up and "
          f"val included)")
    print("gru slice: loss per step " + " ".join(f"{l['loss']:.5f}" for l in losses))
    print(f"gru slice: launches {counts}; expected per step {per_step}, per val() "
          f"{per_val}: {want}")
    if steps != 4 or counts != want:
        fail(f"gru slice: {steps} steps, launches {counts}, expected {want}")
    if not all(np.isfinite(v) for l in losses for v in l.values()):
        fail("gru slice: a loss is not finite")
    after = tensors()
    unchanged = [k for k, v in before.items() if torch.equal(v, after[k])]
    print(f"gru slice: {len(before) - len(unchanged)} of {len(before)} parameter and "
          f"statistics tensors changed, the {len(h0)} h0_layer1 included; {n_skipped} "
          f"dispconv tensors are not trained (pre_disp: no gradient, no JAX entry)"
          + (f"; unchanged: {unchanged}" if unchanged else ""))
    if unchanged:
        fail("gru slice: some parameters or statistics did not change")

    # an epoch past h_s_epoch: the h0 freeze
    trainer.opt.h_s_epoch, trainer.epoch = 1, 1
    before = after
    frozen = trainer.run_epoch()
    torch.cuda.synchronize()
    after = tensors()
    names = {f"{i}.{k}" for i, m in enumerate(models.modules())
             for k, v in m.named_parameters() if id(v) in h0}
    moved = [k for k in before if k not in names and not torch.equal(before[k], after[k])]
    still = [k for k in names if torch.equal(before[k], after[k])]
    print(f"gru slice: frozen epoch of {len(frozen)} steps, loss per step "
          + " ".join(f"{float(h['loss']):.5f}" for h in frozen)
          + f"; h0 bit-identical {len(still)} of {len(names)}; other tensors moved "
          f"{len(moved)} of {len(before) - len(names)}")
    if len(still) != len(names) or len(moved) != len(before) - len(names):
        fail("gru slice: the h0 freeze did not hold h0 exactly while the rest trained")
    del trainer, models
    torch.cuda.empty_cache()
    return counts


class _ReluPin:
    """Every relu of the recurrent block, in call order: recorded in a float64
    run, then replayed in the float32 runs, so that rounding cannot flip a
    mask (relu's derivative jumps at 0). ``flips`` counts the values whose
    own mask differs from the recorded one. :meth:`start` begins a run;
    while :meth:`active`, ``F.relu``, ``Tensor.relu`` and the models'
    ``conv`` with a fused relu (run as the conv without act, then the
    pinned relu) go through it."""

    def __init__(self):
        self.masks, self.replay, self.i, self.flips = [], False, 0, 0
        self.rows = slice(None)

    def start(self, replay: bool, rows: slice = slice(None)) -> "_ReluPin":
        """A run; a replay takes ``rows`` of each recorded mask (a rank of a
        data-parallel run, phase 28)."""
        self.replay, self.i, self.flips, self.rows = replay, 0, 0, rows
        return self

    def relu(self, x):
        mask = x > 0
        if self.replay:
            want = self.masks[self.i][self.rows].to(mask.device)
            self.i += 1
            self.flips += int((mask != want).sum())
            mask = want
        else:
            self.masks.append(mask.cpu())
        return x * mask.to(x.dtype)

    @contextlib.contextmanager
    def active(self):
        import torch

        import ssde_tpu_torch.models.common as common

        conv = common.conv

        def unfused(x, layer, pad, act="none", kernel=False):
            if act == "relu":
                return self.relu(conv(x, layer, pad, "none", kernel))
            return conv(x, layer, pad, act, kernel)

        saved = torch.nn.functional.relu, torch.Tensor.relu, common.conv
        torch.nn.functional.relu = lambda x, inplace=False: self.relu(x)
        torch.Tensor.relu = lambda x: self.relu(x)
        common.conv = unfused
        try:
            yield self
        finally:
            torch.nn.functional.relu, torch.Tensor.relu, common.conv = saved


def _block_run(block, decs, r, q, device, dtype=None, pin=None, head=None):
    """The block unrolled over len(decs) steps on ``device`` from its learned
    initial state, the ``head`` (if given) on each step's hidden states:
    (outputs and final states, gradients of every parameter and input) of
    the scalar sum(disp * r) + sum(state * q) over every state tensor (h,
    and c of an LSTM), as float64 on the CPU. A float64 ``dtype`` runs the
    plain convs at every scale; ``pin`` (a :class:`_ReluPin`) records the
    relu masks of a float64 run and replays them in a float32 one."""
    import torch

    dtype = dtype or torch.float32
    blk = copy.deepcopy(block).to(device, dtype)
    hd = None if head is None else copy.deepcopy(head).to(device, dtype)
    if dtype == torch.float64:  # the kernels take float32 and bf16 only
        blk.kernel_scales = (False,) * blk.n_scales
        if hd is not None:
            hd.kernel_scales = (False,) * len(hd.kernel_scales)
    leaf = lambda v: torch.from_numpy(v).to(device, dtype).requires_grad_()  # noqa: E731
    ins = [dict(enumerate(leaf(v) for v in d)) if isinstance(d, list)
           else {k: leaf(v) for k, v in d.items()} for d in decs]
    hidden, outs, loss = blk.initial_state(1), {}, 0.0
    if pin:
        pin.start(replay=dtype != torch.float64)
    for t, d in enumerate(ins):
        with pin.active() if pin else contextlib.nullcontext():
            hidden, disp = blk(list(d.values()) if isinstance(decs[t], list) else d, hidden)
            if hd is not None:
                disp = hd(hidden)
        for k, v in (disp or {}).items():
            outs[f"t{t} {k}"] = v
            loss = loss + (v * torch.from_numpy(r[t][k]).to(device, dtype)).sum()
    states = [x for h in hidden for x in (h if isinstance(h, tuple) else (h,))]
    for i, h in enumerate(states):
        outs[f"hidden {i}"] = h
        loss = loss + (h * torch.from_numpy(q[i]).to(device, dtype)).sum()
    loss.backward()
    grads = {n: p.grad for n, p in blk.named_parameters()}
    if hd is not None:
        grads.update({f"head.{n}": p.grad for n, p in hd.named_parameters()})
    grads.update({f"d t{t} {k}": v.grad for t, d in enumerate(ins) for k, v in d.items()})
    host = lambda m: {k: v.detach().cpu().double() for k, v in m.items()}  # noqa: E731
    return host(outs), host(grads)


def _gru_step_run(opts, batch, where, net, block_dtype, loss_dtype, select, pin=None,
                  block_where=None):
    """One GRU step (the train step's forward and backward, without Adam)
    on ``where``, with the encoders, decoders and pose networks in ``net``,
    the recurrent block in ``block_dtype`` (on ``block_where`` if given)
    and the geometry, warp and loss in ``loss_dtype``; ``select`` replaces
    the automask's minimum and ``pin`` the block's relus. Returns (losses,
    gradients as float64 on the CPU, seconds)."""
    import torch

    import ssde_tpu_torch.train.steps as steps
    import ssde_tpu_torch.train.steps_gru as steps_gru
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.models.common import sample_

    models = steps_gru.build_gru_models(opts, where, torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    for p in models.h0_parameters():  # a non-zero learned initial state
        sample_(p, gen, lambda t: t.normal_(0.0, 0.1, generator=gen))
    for m in (models.encoder, models.depth, models.pose_encoder, models.pose):
        m.to(net)
    block_where = block_where or where
    models.gru.to(block_where, block_dtype)
    if block_dtype == torch.float64:  # the kernels take float32 and bf16 only
        models.gru.kernel_scales = (False,) * models.gru.n_scales
    block_forward = models.gru.forward

    def forward(dec, hidden):
        with pin.active() if pin else contextlib.nullcontext():
            new, disp = block_forward(
                {k: v.to(block_where, block_dtype) for k, v in dec.items()}, hidden)
        return new, {k: v.to(where) for k, v in disp.items()}

    models.gru.forward = forward
    if pin:
        pin.start(replay=block_dtype != torch.float64)
    inputs, B, T = steps_gru.preprocess_gru_batch(to_device(batch, where), opts)
    inputs = {k: v.to(net) if k.startswith("color_aug") else
              v.to(loss_dtype) if v.is_floating_point() else v for k, v in inputs.items()}
    models.train()
    patched = {"min_reprojection": select or steps.min_reprojection,
               "_full": lambda t: t.to(loss_dtype)}
    plain = {k: getattr(steps, k) for k in patched}
    t0 = time.perf_counter()
    try:
        for k, v in patched.items():
            setattr(steps, k, v)
        _, losses, _ = steps_gru.gru_loss_fn(models, inputs, B, T)
        losses["loss"].backward()
    finally:
        for k, v in plain.items():
            setattr(steps, k, v)
    groups = {"encoder": models.encoder, "depth": models.depth, "gru": models.gru,
              "pose_encoder": models.pose_encoder, "pose": models.pose}
    trained = {id(p) for p in models.parameters()}
    grads = {(g, k): p.grad.detach().cpu().double() for g, m in groups.items()
             for k, p in m.named_parameters() if id(p) in trained}
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            time.perf_counter() - t0)


def _block_inputs(version, rng):
    """One frame-step's block inputs at 640x192, B=1, N(0, 1), NCHW numpy:
    the decoder's ``disp/{s}`` (1 channel for v1/v2, which read the
    disparities; the pre-disp features for the others) or, for v5, the
    encoder's 5 feature maps as a list."""
    from ssde_tpu_torch.models.recurrent import block_version

    v = block_version(version)
    if v == "v5":
        return [rng.randn(1, c, H >> (s + 1), W >> (s + 1)).astype(np.float32)
                for s, c in enumerate((64, 64, 128, 256, 512))]
    ch = (1,) * 4 if v in ("v1", "v2") else DEC_CH
    return {f"disp/{s}": rng.randn(1, c, H >> s, W >> s).astype(np.float32)
            for s, c in enumerate(ch)}


def gru_block_card_vs_cpu(dev, version=VERSION, T=3):
    """The block alone (phase 12 (a) for v10, phase 16 for v9, phase 21 for
    the other versions at T=1) over T steps at B=1, float32, with the Head
    of v4/v6/v7 on each step's hidden states, card (kernels) vs CPU (plain
    versions) and each against float64, the relu masks taken from the
    float64 run (gru_card_vs_cpu says why). Returns the worst of the
    held errors."""
    import torch

    from ssde_tpu_torch.models import Head, make_gru
    from ssde_tpu_torch.models.common import init_weights_, sample_
    from ssde_tpu_torch.models.recurrent import (GRU_HIDDEN_SPECS, block_version,
                                                 kernel_scales, scale_shift)
    from ssde_tpu_torch.train.steps_gru import HEAD_VERSIONS

    torch.backends.cudnn.allow_tf32 = False
    counters = _gru_counters()
    block = make_gru(version, H, W)
    gen = torch.Generator().manual_seed(SEED + 11)
    init_weights_(block, gen)
    for p in block.initial_parameters():
        sample_(p, gen, lambda t: t.normal_(0.0, 0.5, generator=gen))
    head = None
    if version in HEAD_VERSIONS:
        head = Head(HEAD_VERSIONS[version], kernel_scales(version))
        init_weights_(head, gen)
    rng = np.random.RandomState(SEED + 12)
    decs = [_block_inputs(version, rng) for _ in range(T)]
    r = [{f"disp/{s}": rng.randn(1, 1, H >> s, W >> s).astype(np.float32) for s in range(4)}
         for _ in range(T)]
    spec = GRU_HIDDEN_SPECS[block_version(version)]
    q = [rng.randn(1, c, H >> scale_shift(version, s), W >> scale_shift(version, s)).astype(
        np.float32) for s, c in enumerate(spec["hid"])
        for _ in range(2 if spec["cell"] == "lstm" else 1)]
    pin = _ReluPin()
    out64, g64 = _block_run(block, decs, r, q, "cpu", torch.float64, pin, head)
    before = {k: fn.launches for k, fn in counters.items()}
    card_out, card_g = _block_run(block, decs, r, q, dev, pin=pin, head=head)
    torch.cuda.synchronize()
    want = _block_launches(version, T, head_calls=T)
    launched = {k: counters[k].launches - before[k] for k in want}
    flips = {"card": pin.flips}
    t0 = time.perf_counter()
    cpu_out, cpu_g = _block_run(block, decs, r, q, "cpu", pin=pin, head=head)
    cpu_s = time.perf_counter() - t0
    flips["CPU"] = pin.flips
    # each gradient against its own max, but an attention conv's key bias
    # against the largest gradient of its conv: the key bias shifts all 9
    # logits of a pixel alike, so its true gradient is 0 and its own max
    # is rounding
    scale = {k: v.abs().max().item() for k, v in g64.items()}
    for k in g64:
        if k.endswith("key_conv.bias"):
            conv = k[:-len("key_conv.bias")]
            scale[k] = max(v for n, v in scale.items() if n.startswith(conv))
    grel = lambda a, b, k: (a - b).abs().max().item() / max(scale[k], 1e-30)  # noqa: E731
    worst = max((_rel(card_out[k], cpu_out[k]), k) for k in cpu_out)
    worst_g = max((grel(card_g[k], cpu_g[k], k), k) for k in cpu_g)
    e64 = {name: max(grel(v[k], g64[k], k) for k in g64)
           for name, v in (("card", card_g), ("CPU", cpu_g))}
    o64 = {name: max(_rel(v[k], out64[k]) for k in out64)
           for name, v in (("card", card_out), ("CPU", cpu_out))}
    print(f"gru block card vs CPU: {version} over T={T} at B=1, {H}x{W}, float32, every relu "
          f"mask taken from a float64 CPU run (CPU {cpu_s:.1f} s); launches on the card "
          f"{launched}; worst |d| / max, card vs CPU: {len(cpu_out)} outputs and hidden states "
          f"{worst[0]:.3e} ({worst[1]}), {len(cpu_g)} gradients {worst_g[0]:.3e} "
          f"({worst_g[1]}); against float64: outputs card {o64['card']:.3e}, CPU "
          f"{o64['CPU']:.3e}, gradients card {e64['card']:.3e}, CPU {e64['CPU']:.3e}; "
          f"bound {TOL_CARD_VS_CPU}")
    print(f"    relu values whose own float32 mask differs from float64's: {flips['card']} "
          f"(card), {flips['CPU']} (CPU) of {sum(m.numel() for m in pin.masks)}")
    if launched != want:
        fail(f"gru block {version}: launches {launched}, expected {want}")
    held = max(worst[0], worst_g[0], *e64.values(), *o64.values())
    if not held <= TOL_CARD_VS_CPU:
        fail(f"gru block {version}: card and CPU disagree")
    del block, head
    return held


def gru_card_vs_cpu(dev):
    """Phase 12: (a) the v10 block alone over T=3 at B=1, float32, card
    (kernels) vs CPU (plain versions) and each against float64; (b) one
    whole GRU step at B=1, T=2, card vs CPU and each against a float64 run,
    by phase 8's recipe. Both take the relu masks of the block from the
    float64 run (:class:`_ReluPin`): a float32 pre-activation that rounds
    across zero flips relu's derivative, which moved the scale-0 h0
    gradient by 8e-3 (CPU) and 1.8e-2 (card) of its max at 640x192 in an
    unpinned run on an H100. The step is held against float64 with its
    loss in float64: the float32 loss's per-pixel rounding reaches the
    per-pixel h0 gradients undamped, whatever the block's precision (the
    run with the block in float64 and the loss in float32 shows it)."""
    import torch

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import collate
    from ssde_tpu_torch.data.synthetic import SyntheticSeqDataset

    gru_block_card_vs_cpu(dev, VERSION)
    # (b) the whole step
    opts = Options(height=H, width=W, batch_size=1, len_sequence=2, gru_version=VERSION,
                   compute_dtype="float32")
    ds = SyntheticSeqDataset(H, W, n=2, length=1, seed=SEED)
    batch = collate([ds[0]])
    f32, f64 = torch.float32, torch.float64
    selected, switches = [], {}

    def pinned(name):
        switches[name] = []
        return _selection(selected, switches=switches[name])

    pin = _ReluPin()
    l64, g64, t64 = _gru_step_run(opts, batch, "cpu", f64, f64, f64,
                                  _selection(record=selected), pin)
    # held set 1, the float32 loss: the kernels of the loss on the card
    lg, gg, _ = _gru_step_run(opts, batch, dev, f64, f32, f32, pinned("card"), pin)
    lc, gc, tc = _gru_step_run(opts, batch, "cpu", f64, f32, f32, pinned("CPU"), pin)
    # held set 2, the float64 loss on the CPU: the card runs the block only
    lg2, gg2, _ = _gru_step_run(opts, batch, "cpu", f64, f32, f64, pinned("card, loss f64"),
                                pin, block_where=dev)
    lc2, gc2, tc2 = _gru_step_run(opts, batch, "cpu", f64, f32, f64, pinned("CPU, loss f64"),
                                  pin)
    shown = {"card all-float32": _gru_step_run(opts, batch, dev, f32, f32, f32,
                                               pinned("card all-float32"), pin)[1],
             "card unpinned": _gru_step_run(opts, batch, dev, f64, f32, f32, None)[1],
             "card, block float64": _gru_step_run(opts, batch, dev, f64, f64, f32,
                                                  pinned("card, block float64"))[1]}
    lrel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in ((lg, lc), (lg2, lc2)) for k in lc)
    lrel64 = max(abs(lg2[k] - l64[k]) / abs(l64[k]) for k in l64)
    print(f"gru step card vs CPU: one step at {H}x{W}, B=1, T=2; networks float64, the block "
          f"float32; (1) geometry, warp and loss float32 (CPU {tc:.1f} s), (2) loss float64 "
          f"on the CPU, the block alone on the card (CPU {tc2:.1f} s); all-float64 on the "
          f"CPU {t64:.1f} s. Loss (1) card {lg['loss']:.8f}, CPU {lc['loss']:.8f}; (2) card "
          f"{lg2['loss']:.8f}; float64 {l64['loss']:.8f}; worst rel card vs CPU over "
          f"{sorted(lc)} {lrel:.3e}, (2) against float64 {lrel64:.3e} (bound {TOL_STEP_LOSS})")
    print("  automask argmin differs from the float64 run's at "
          + ", ".join(f"{sum(v)} ({k})" for k, v in switches.items())
          + f" of {sum(m.numel() for m in selected)} pixel-scales; relu values off float64's "
          f"mask in the last run {pin.flips}; the held runs take float64's argmin and relu "
          f"masks")
    print(f"  gradients, worst over each group's tensors of |d| / max|g| (bound "
          f"{TOL_STEP_GRAD}): held: card vs CPU in (1) and (2), each against float64 in (2); "
          f"shown: (1) against float64 (the float32 loss's per-pixel rounding reaches the "
          f"per-pixel h0 gradients, about 1e-5 of the weights' in size, undamped), the "
          f"all-float32 card run, the card run with its own argmin and relu masks, the "
          f"card run with the block in float64 and the loss in float32)")
    ok = lrel <= TOL_STEP_LOSS and lrel64 <= TOL_STEP_LOSS
    for grp in ("encoder", "depth", "gru", "pose_encoder", "pose"):
        keys = [k for k in gc if k[0] == grp]
        held = {"(1) card vs CPU": max(_rel(gg[k], gc[k]) for k in keys),
                "(2) card vs CPU": max(_rel(gg2[k], gc2[k]) for k in keys),
                "(2) card vs float64": max(_rel(gg2[k], g64[k]) for k in keys),
                "(2) CPU vs float64": max(_rel(gc2[k], g64[k]) for k in keys)}
        info = {"(1) card vs float64": gg, "(1) CPU vs float64": gc, **{
            f"{n} vs float64": v for n, v in shown.items()}}
        info = {n: max(_rel(v[k], g64[k]) for k in keys) for n, v in info.items()}
        print(f"    {grp:12s} ({len(keys)} tensors) held: "
              + ", ".join(f"{n} {v:.3e}" for n, v in held.items())
              + "; shown: " + ", ".join(f"{n} {v:.3e}" for n, v in info.items()))
        ok = ok and max(held.values()) <= TOL_STEP_GRAD
    if not ok:
        fail("gru step: card and CPU disagree")


def gru_step_times(dev, card, version):
    """The GRU train step's time, memory and idle share at B=8, T=3, bf16
    (phase 13 for v10, 17 for v9, 21 for v5); its profile table is written
    to a file. Returns (ms, frame-samples/s, peak GiB, idle share)."""
    import torch

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import collate, to_device
    from ssde_tpu_torch.data.synthetic import SyntheticSeqDataset
    from ssde_tpu_torch.train.state import TrainState
    from ssde_tpu_torch.train.steps_gru import build_gru_models, train_step

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    opts = Options(height=H, width=W, batch_size=GRU_B, len_sequence=GRU_T,
                   gru_version=version)  # bf16 autocast, the default
    models = build_gru_models(opts, dev, torch.Generator().manual_seed(SEED))
    state = TrainState(models.parameters(), opts.learning_rate, 0, 1000)
    ds = SyntheticSeqDataset(H, W, n=GRU_T, length=GRU_B, seed=SEED)
    batch = to_device(collate([ds[i] for i in range(GRU_B)]), dev)
    rng = torch.Generator(dev).manual_seed(SEED)
    step = lambda: train_step(models, state, batch, rng)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        step()
    n = 10
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        losses = step()
    end.record()
    last = float(losses["loss"])  # read back at the end of the chain
    ms = start.elapsed_time(end) / n
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy, wall, prof = _device_idle_share(step, IDLE_STEPS)
    frames = GRU_B * GRU_T
    print(f"gru {version} train step B={GRU_B} T={GRU_T} {H}x{W} bf16: {ms:.3f} ms, "
          f"{frames * 1e3 / ms:.2f} frame-samples/s (mean of {n} after 3 warm-up; last loss "
          f"{last:.5f}); peak memory {peak:.2f} GiB; device busy {busy:.1f} ms over "
          f"{IDLE_STEPS} profiled steps: idle share {1 - busy / (IDLE_STEPS * ms):.1%} of "
          f"{IDLE_STEPS} unprofiled steps ({IDLE_STEPS * ms:.1f} ms), {1 - busy / wall:.1%} "
          f"of the profiled wall ({wall:.1f} ms) [{card}]")
    if not np.isfinite(last):
        fail(f"gru {version} train step: loss {last}")
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=30)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "gru_profile_b8t3.txt" if version == VERSION else f"gru_{version}_profile_b8t3.txt"
    with open(os.path.join("chiprun_out", name), "w") as f:
        f.write(f"{card}\n{table}\n")
    print(f"  top device operations over {IDLE_STEPS} profiled steps:")
    for line in table.splitlines()[:16]:
        print("   ", line[:160])
    del models, state, batch, prof
    torch.cuda.empty_cache()
    return ms, frames * 1e3 / ms, peak, 1 - busy / (IDLE_STEPS * ms)


def gru_times(dev, card):
    """Phase 13: the v10 train step's time, memory and idle share at B=8,
    T=3, bf16; then per conv shape the forward, dx and dW kernels beside
    their plain versions and cuDNN."""
    import torch
    import torch.nn.functional as F

    from ssde_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_dw, conv3x3_dw_reference,
                                            conv3x3_dx, conv3x3_reference, rot_w)

    gru_step_times(dev, card, VERSION)

    # per conv shape at B=8: kernels vs plain versions vs cuDNN
    torch.backends.cudnn.allow_tf32 = False
    conv_bwd = torch.ops.aten.convolution_backward
    convs = slice_convs(VERSION, H, W)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    per = {}
    print(f"gru conv times at B={GRU_B} on {card} (CUDA events, 5 launches after 2 warm-up, "
          "order plain, kernel, kernel, plain; library: cuDNN F.conv2d, and "
          "aten.convolution_backward for backward-data and backward-weight, as autograd "
          "of F.conv2d calls it; zero padding 1, no act; TF32 off)")
    for dtype in (torch.float32, torch.bfloat16):
        for cin, cout, h, w, pad, act, has_b in sorted(
                {c[1:] for c in convs}, key=lambda c: (-c[3], c[0], c[1], c[5])):
            x = torch.randn(GRU_B, cin, h, w, device=dev, generator=gen).to(dtype)
            wt = (torch.randn(cout, cin, 3, 3, device=dev, generator=gen) / 8).to(dtype)
            bt = torch.randn(cout, device=dev, generator=gen).to(dtype) if has_b else None
            gp = torch.randn(GRU_B, cout, h, w, device=dev, generator=gen).to(dtype)
            wr = rot_w(wt)
            cases = {
                "fwd": (lambda: conv3x3(x, wt, bt, pad, act),
                        lambda: conv3x3_reference(x, wt, bt, pad, act),
                        lambda: F.conv2d(x, wt, bt, padding=1)),
                "dx": (lambda: conv3x3_dx(gp, wt), lambda: conv3x3_reference(gp, wr),
                       lambda: conv_bwd(gp, x, wt, None, [1, 1], [1, 1], [1, 1], False,
                                        [0, 0], 1, [True, False, False])),
                "dw": (lambda: conv3x3_dw(x, gp, pad), lambda: conv3x3_dw_reference(x, gp, pad),
                       lambda: conv_bwd(gp, x, wt, None, [1, 1], [1, 1], [1, 1], False,
                                        [0, 0], 1, [False, True, False])),
            }
            elem = 2 if dtype == torch.bfloat16 else 4
            tag = "bf16" if dtype == torch.bfloat16 else "f32 "
            row = []
            for name, (k, p, lib) in cases.items():
                t = [cuda_ms(fn, iters=5, warmup=2) for fn in (p, k, k, p)]
                tk, tp, tl = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, cuda_ms(lib, 5, 2)
                flops, nbytes = conv_cost(cin, cout, h, w, GRU_B, elem,
                                          4 if name == "dw" else None)
                per[(dtype, name, cin, cout, h, w, pad, act, has_b)] = (
                    tk, tp, tl, flops, nbytes)
                row.append(f"{name} {tk:.3f} / {tp:.3f} / {tl:.3f} ms "
                           f"({flops / tk / 1e9:.1f} TFLOP/s)")
            print(f"  {tag} {cin:3d}->{cout:<3d} {h}x{w} {pad:7s} {act:7s}: kernel / plain / "
                  f"library: " + "; ".join(row) + f" [{card}]")
            del x, wt, bt, gp, wr
    # per dtype and pass, one B=8 frame-step: (ms, plain_ms, bound_ms,
    # bound_by, library_ms); float32 bound as 3xTF32 on the tensor cores
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
        peak = "bfloat16" if dtype == torch.bfloat16 else "float32_3xtf32"
        for name in ("fwd", "dx", "dw"):
            rows = [per[(dtype, name) + c[1:]] for c in convs]
            tk, tp, tl = (sum(r[i] for r in rows) for i in range(3))
            t_ops = sum(r[3] for r in rows) / PEAK_OPS[peak] * 1e3
            t_bytes = sum(r[4] for r in rows) / PEAK_BYTES * 1e3
            b_ms = sum(max(r[3] / PEAK_OPS[peak], r[4] / PEAK_BYTES) for r in rows) * 1e3
            by = "operations" if t_ops >= t_bytes else "bytes"
            b32 = sum(max(r[3] / PEAK_OPS["float32"], r[4] / PEAK_BYTES) for r in rows) * 1e3
            tflops = sum(r[3] for r in rows) / tk / 1e9
            print(f"gru frame-step at B={GRU_B} ({len(convs)} convs), {dname}, {name}: kernel "
                  f"{tk:.3f} ms ({tflops:.1f} TFLOP/s, {tk / tl:.2f}x the library), plain "
                  f"{tp:.3f} ms, library {tl:.3f} ms; bound {b_ms:.3f} ms ({by}, {peak} "
                  f"peak) and {b32:.3f} ms at the 67 TFLOP/s float32 CUDA-core peak [{card}]")
            times[(dtype, f"conv3x3_{name}")] = {"ms": tk, "plain_ms": tp, "bound_ms": b_ms,
                                                 "bound_by": by, "library_ms": tl}
    torch.cuda.empty_cache()
    return times


# ================================================== GRU v9 (attention)


def _attn_operands(dev, B, C, h, w, gen):
    """q, kp, vp (O(1)), rel and an output gradient, float32 on the card."""
    import torch

    q = torch.randn(B, C, h, w, device=dev, generator=gen)
    kp = torch.randn(B, C, h + 2, w + 2, device=dev, generator=gen)
    vp = torch.randn(B, C, h + 2, w + 2, device=dev, generator=gen)
    rel = torch.randn(9, C, device=dev, generator=gen) * 0.5
    g = torch.randn(B, C, h, w, device=dev, generator=gen)
    return q, kp, vp, rel, g


def _attn_plain_grads(q, kp, vp, rel, g):
    """(dq, dkp, dvp, drel): autograd of the plain attend3, in q's dtype."""
    import torch

    from ssde_tpu_torch.ops.attention_win import attend3_reference

    leaves = [t.detach().requires_grad_() for t in (q, kp, vp, rel)]
    return torch.autograd.grad(attend3_reference(*leaves), leaves, g)


def attn_kernels(dev):
    """Phase 14: kernels #3 and #4 against the plain attend3 and its
    autograd on the same operands, at every attention shape of the v9
    frame-step at 640x192 (B=1 and 8) and at ragged shapes, float32 (also
    held against float64) and bf16; drel of #4 bit-identical twice; the
    autograd Function gives #4's gradients."""
    import torch

    from ssde_tpu_torch.ops.attention_win import (BWD_BAND, BWD_STRIP, FWD_BAND, FWD_STRIP,
                                                  attend3, attend3_bwd, attend3_fwd,
                                                  attend3_reference)

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    cases = [(B, C, h, w) for C, h, w in sorted(set(slice_attention("v9", H, W)))
             for B in (1, GRU_B)]
    cases += [(2, 5, 1, 7), (3, 3, 2, 33), (2, 17, 9, 45), (1, 40, 37, 31)]
    # the edges of #4's bands of padded rows and strips of padded columns,
    # odd widths (unpaired rows), H = 1 and W = 1
    cases += [(1, 2, BWD_BAND - 2, BWD_STRIP - 2), (2, 3, BWD_BAND - 1, BWD_STRIP - 3),
              (1, 2, BWD_BAND, BWD_STRIP - 1), (2, 2, BWD_BAND + 1, 2 * BWD_STRIP - 1),
              (1, 3, 2 * BWD_BAND + 1, 1), (1, 4, 1, 2 * BWD_STRIP)]
    # the edges of #3's bands of output rows and strips of output columns:
    # one short of, at and one past one and two, odd widths, H = 1 and W = 1
    cases += [(1, 2, FWD_BAND - 1, FWD_STRIP - 1), (2, 3, FWD_BAND, FWD_STRIP),
              (1, 2, FWD_BAND + 1, FWD_STRIP + 1), (2, 2, 2 * FWD_BAND + 1, 2 * FWD_STRIP - 1),
              (1, 3, FWD_BAND, 2 * FWD_STRIP), (1, 2, 2 * FWD_BAND, 2 * FWD_STRIP + 1),
              (2, 3, 1, FWD_STRIP + 1), (1, 4, FWD_BAND + 1, 1)]
    errs = {"attend3_fwd": 0.0, "attend3_bwd": 0.0}
    worst = {"fwd f32": 0.0, "fwd f32 vs f64": 0.0, "plain fwd f32 vs f64": 0.0,
             "bwd f32": 0.0, "fwd bf16": 0.0, "bwd bf16": 0.0}
    print(f"attn kernels: #3/#4 against the plain attend3 and its autograd, {len(cases)} "
          f"cases x (float32, bf16); bounds: forward float32 {TOL_ATTN_FWD} absolute, "
          f"gradients float32 {TOL_ATTN_GRAD} of max against float64, bf16 {TOL_ATTN_BF16} "
          f"of max against float32 on the bf16-rounded operands")
    t0 = time.perf_counter()
    for B, C, h, w in cases:
        q, kp, vp, rel, g = _attn_operands(dev, B, C, h, w, gen)
        d64 = [t.double() for t in (q, kp, vp, rel, g)]
        out = attend3_fwd(q, kp, vp, rel)
        ref, ref64 = attend3_reference(q, kp, vp, rel), attend3_reference(*d64[:4])
        got = attend3_bwd(q, kp, vp, rel, g)
        want = _attn_plain_grads(*d64)
        torch.cuda.synchronize()
        if out.dtype != q.dtype or out.shape != q.shape or any(
                a.shape != b.shape or a.dtype != (torch.float32) for a, b in zip(got, want)):
            fail(f"attn kernels: outputs {out.dtype} {tuple(out.shape)}, "
                 f"{[(a.dtype, tuple(a.shape)) for a in got]}")
        f32 = {"fwd f32": (out - ref).abs().max().item(),
               "fwd f32 vs f64": (out.double() - ref64).abs().max().item(),
               "plain fwd f32 vs f64": (ref.double() - ref64).abs().max().item(),
               "bwd f32": max(_rel(a.double(), b) for a, b in zip(got, want))}
        errs["attend3_fwd"] = max(errs["attend3_fwd"], f32["fwd f32"])
        errs["attend3_bwd"] = max([errs["attend3_bwd"]] + [
            (a.double() - b).abs().max().item() for a, b in zip(got, want)])
        qb, kb, vb, gb = (t.bfloat16() for t in (q, kp, vp, g))
        outb = attend3_fwd(qb, kb, vb, rel)
        refb = attend3_reference(qb.float(), kb.float(), vb.float(), rel)
        gotb = attend3_bwd(qb, kb, vb, rel, gb)
        wantb = _attn_plain_grads(qb.float(), kb.float(), vb.float(), rel, gb.float())
        torch.cuda.synchronize()
        if outb.dtype != torch.bfloat16 or [a.dtype for a in gotb] != [torch.bfloat16] * 3 + [
                torch.float32]:
            fail(f"attn kernels: bf16 outputs {outb.dtype}, {[a.dtype for a in gotb]}")
        bf = {"fwd bf16": _rel(outb.float(), refb),
              "bwd bf16": max(_rel(a.float(), b) for a, b in zip(gotb, wantb))}
        for k, v in {**f32, **bf}.items():
            worst[k] = max(worst[k], v)
        print(f"  B={B} C={C:3d} {h}x{w}: f32 fwd abs {f32['fwd f32']:.2e} (vs f64 "
              f"{f32['fwd f32 vs f64']:.2e}, plain {f32['plain fwd f32 vs f64']:.2e}), grads "
              f"{f32['bwd f32']:.2e} of max; bf16 fwd {bf['fwd bf16']:.2e}, grads "
              f"{bf['bwd bf16']:.2e} of max")
        if not (f32["fwd f32"] <= TOL_ATTN_FWD and f32["bwd f32"] <= TOL_ATTN_GRAD
                and max(bf.values()) <= TOL_ATTN_BF16):
            fail(f"attn kernels disagree with the plain version at B={B} C={C} {h}x{w}")
        del q, kp, vp, rel, g, d64, out, ref, ref64, got, want, qb, kb, vb, gb, gotb, wantb
        torch.cuda.empty_cache()
    # determinism of drel, and the autograd Function against #4, at scale 0, B=8, bf16
    q, kp, vp, rel, g = (t.bfloat16() if t.dim() == 4 else t for t in
                         _attn_operands(dev, GRU_B, FEATS[0], H, W, gen))
    first, second = attend3_bwd(q, kp, vp, rel, g), attend3_bwd(q, kp, vp, rel, g)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    leaves = [t.detach().requires_grad_() for t in (q, kp, vp, rel)]
    attend3(*leaves).backward(g)
    via_fn = [torch.equal(t.grad, a) for t, a in zip(leaves, first)]
    print(f"attn kernels: {2 * len(cases)} cases ok in {time.perf_counter() - t0:.1f} s; "
          + ", ".join(f"worst {k} {v:.3e}" for k, v in worst.items())
          + f"; a second #4 at B={GRU_B} C={FEATS[0]} {H}x{W} bf16 bit-identical "
          f"(dq, dkp, dvp, drel): {same}; attend3's autograd Function gives #4's: {via_fn}")
    if not all(same + via_fn):
        fail("attn kernels: #4 is not deterministic, or autograd does not reach it")
    del q, kp, vp, rel, g, first, second, leaves
    torch.cuda.empty_cache()
    return errs


def serving_v9(dev, card):
    """Phase 15: GRU v9 streaming depth through the port's entry points, as
    phase 3 runs v10, then card vs CPU. The chained softmaxes amplify
    float32 rounding, so the card's float32 disparity is held against a
    float64 CPU run (plain versions) at twice the CPU float32 run's own
    error against it. Returns (launch counts, (evaluator, scene, items))."""
    import torch

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.synthetic import scene_frames
    from ssde_tpu_torch.eval.gru_runners import GRUStreamEvaluator
    from ssde_tpu_torch.models.common import sample_
    from ssde_tpu_torch.models.resnet import randomize_bn_stats_
    from ssde_tpu_torch.ops.attention_win import attend3_bwd, attend3_fwd
    from ssde_tpu_torch.ops.conv3x3 import conv3x3
    from ssde_tpu_torch.scripts.evaluate_depth_gru_fusion import (
        build_evaluator, predict_bucketed, predict_scenes)
    from ssde_tpu_torch.train.steps_gru import GRUModels

    opt = Options()
    opt.gru_version, opt.height, opt.width, opt.num_layers = "v9", H, W, 18
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
    per_step = {"conv3x3_fwd": len(slice_convs("v9", H, W)),
                "attend3_fwd": len(slice_attention("v9", H, W)), "attend3_bwd": 0}

    torch.cuda.synchronize()
    conv3x3.launches = attend3_fwd.launches = attend3_bwd.launches = 0
    scene_out = predict_scenes(ev, [scene], MIN_DEPTH, MAX_DEPTH)[0]
    warm_out = predict_bucketed(ev, items, EVAL_BATCH, MIN_DEPTH, MAX_DEPTH)
    torch.cuda.synchronize()
    counts = {"conv3x3_fwd": conv3x3.launches, "attend3_fwd": attend3_fwd.launches,
              "attend3_bwd": attend3_bwd.launches}
    want = {k: v * steps for k, v in per_step.items()}
    print(f"v9 serving: GRU v9, ResNet18, {H}x{W}, float32; scene {SCENE_FRAMES} frames at "
          f"B=1 + warm-up {WARMUP_FRAMES}+1 frames at B={EVAL_BATCH} = {steps} frame-steps; "
          f"launches {counts} (expected {per_step} per frame-step: {want})")
    if counts != want:
        fail(f"v9 serving: launches {counts}, expected {want}")
    lo, hi = 1.0 / MAX_DEPTH, 1.0 / MIN_DEPTH
    for name, outs in (("scene", scene_out), ("warmup", warm_out)):
        for d in outs:
            if d.shape != (H, W) or not np.isfinite(d).all() or not lo < d.min() <= d.max() < hi:
                fail(f"v9 serving {name}: output {d.shape} not finite in ({lo}, {hi})")
        print(f"v9 serving {name}: {len(outs)} x ({H}, {W}) scaled disp "
              f"[{min(d.min() for d in outs):.4f}, {max(d.max() for d in outs):.4f}]")
    if np.abs(np.stack(scene_out[1:]) - scene_out[0]).max() == 0:
        fail("v9 serving: the streamed frames all gave one output")

    def on_cpu(dtype):
        models = GRUModels(*(copy.deepcopy(m).cpu().to(dtype) for m in
                             (ev.models.encoder, ev.models.depth, ev.models.gru)),
                           None, ev.models.opts)
        cpu = GRUStreamEvaluator(models)
        if dtype == torch.float64:  # the kernels take float32 and bf16 only
            models.gru.kernel_scales = (False,) * models.gru.n_scales
            cpu.to_device = lambda f: torch.from_numpy(
                np.asarray(f, np.float64)).permute(0, 3, 1, 2).contiguous()
            cpu.to_host = lambda d: d[:, 0].numpy()
        t0 = time.perf_counter()
        out = cpu.predict_scene(scene[:4])
        return out, time.perf_counter() - t0

    (cpu32, t32), (cpu64, t64) = on_cpu(torch.float32), on_cpu(torch.float64)
    card_out = ev.predict_scene(scene[:4])
    err = lambda a, b: max(np.abs(x.astype(np.float64) - y).max() for x, y in zip(a, b))  # noqa
    e_card, e_cpu, e_cc = err(card_out, cpu64), err(cpu32, cpu64), err(card_out, cpu32)
    print(f"v9 card vs CPU over 4 streamed frames at B=1: max |d disp| card float32 vs CPU "
          f"float64 {e_card:.3e}, CPU float32 vs float64 {e_cpu:.3e}, card vs CPU float32 "
          f"{e_cc:.3e}; bound for the card: 2 x the CPU's own error = {2 * e_cpu:.3e} "
          f"(CPU float32 {t32:.1f} s, float64 {t64:.1f} s)")
    if not e_card <= 2 * e_cpu:
        fail(f"v9 serving: the card's float32 disparity is {e_card:.3e} off float64, more "
             f"than twice the CPU's {e_cpu:.3e}")
    return counts, (ev, scene, items)


def v9_times(dev, card, ev, scene, items):
    """Phase 17: the v9 train step; v9 serving latency and throughput; per
    attention shape the kernels #3 and #4 beside their plain versions (the
    plain backward is autograd of the plain forward, which it runs too) and
    the bound, at B=8 in bf16 (training) and B=1 in float32 (serving), and
    #3 alone at B=8 in float32 (the warm-up protocol's serving); at B=8 bf16
    also the ring pad of one map (models/attention.pad_ring, 2 a call).
    Returns the kernels' entries for one frame-step at B=8, bf16, #3's with
    its float32 frame-steps at B=8 and B=1 under f32_b8_* and f32_b1_*."""
    import torch

    from ssde_tpu_torch.models.attention import pad_ring
    from ssde_tpu_torch.ops.attention_win import attend3_bwd, attend3_fwd, attend3_reference

    gru_step_times(dev, card, "v9")
    # serving's own configuration (build_evaluator): the train step above
    # turned TF32 on for cuDNN's convs
    torch.backends.cudnn.allow_tf32 = False
    stream_times(ev, scene, items, card, "v9")
    del ev
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    print(f"attend3 times on {card} (CUDA events, 10 launches after 2 warm-up, order plain, "
          f"kernel, kernel, plain; bound: the larger of the bytes (q, kp, vp read, out written;"
          f" backward q, kp, vp, g read, dq, dkp, dvp written) over 3.35 TB/s and "
          f"{ATTN_OPS_FWD} / {ATTN_OPS_BWD} float32 operations per value over 67 TFLOP/s; "
          f"library: none, no single PyTorch call computes this function)")
    frame = {}
    for B, dtype in ((GRU_B, torch.bfloat16), (GRU_B, torch.float32), (1, torch.float32)):
        elem = 2 if dtype == torch.bfloat16 else 4
        tag = "bf16" if dtype == torch.bfloat16 else "f32 "
        # the B=8 float32 serving frame-step runs no backward
        names = ("attend3_fwd",) if (B, dtype) == (GRU_B, torch.float32) else (
            "attend3_fwd", "attend3_bwd")
        total = {k: [0.0] * 4 for k in names}
        calls = slice_attention("v9", H, W)
        for C, h, w in sorted(set(calls), key=lambda c: -c[1]):
            n = calls.count((C, h, w))
            q, kp, vp, rel, g = (t.to(dtype) if t.dim() == 4 else t
                                 for t in _attn_operands(dev, B, C, h, w, gen))
            leaves = [t.detach().requires_grad_() for t in (q, kp, vp, rel)]
            pairs = {"attend3_fwd": (lambda: attend3_fwd(q, kp, vp, rel),
                                     lambda: attend3_reference(q, kp, vp, rel)),
                     "attend3_bwd": (lambda: attend3_bwd(q, kp, vp, rel, g),
                                     lambda: torch.autograd.grad(
                                         attend3_reference(*leaves), leaves, g))}
            n_out, n_pad = B * C * h * w, B * C * (h + 2) * (w + 2)
            cost = {"attend3_fwd": (ATTN_OPS_FWD * n_out, elem * (2 * n_out + 2 * n_pad) + 36 * C),
                    "attend3_bwd": (ATTN_OPS_BWD * n_out,
                                    elem * (3 * n_out + 4 * n_pad) + 72 * C)}
            row = []
            for name in names:
                k, p = pairs[name]
                t = [cuda_ms(fn, iters=10, warmup=2) for fn in (p, k, k, p)]
                tk, tp = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                bms, _ = bound(*cost[name], "float32")
                for i, v in enumerate((tk, tp, cost[name][0], cost[name][1])):
                    total[name][i] += n * v
                row.append(f"{name[8:]} {tk:.4f} / {tp:.4f} ms, bound {bms:.4f} ms "
                           f"({cost[name][1] / tk / 1e6:.0f} GB/s)")
            if dtype == torch.bfloat16:
                bias = rel[0].to(dtype)
                row.append(f"pad_ring of one map {cuda_ms(lambda: pad_ring(q, bias), 10, 2):.4f}"
                           f" ms (2 a call)")
            print(f"  {tag} B={B} C={C:3d} {h}x{w} ({n} per frame-step): kernel / plain: "
                  + "; ".join(row) + f" [{card}]")
            del q, kp, vp, rel, g, leaves
        torch.cuda.empty_cache()
        for name, (tk, tp, flops, nbytes) in total.items():
            bms, by = bound(flops, nbytes, "float32")
            print(f"attend3 {name[8:]}: one v9 frame-step ({len(calls)} calls) at B={B} "
                  f"{tag.strip()}: kernel {tk:.4f} ms, plain {tp:.4f} ms, bound {bms:.4f} ms "
                  f"({by}; {nbytes / 1e9:.3f} GB) [{card}]")
            entry = {"ms": tk, "plain_ms": tp, "bound_ms": bms, "bound_by": by,
                     "library_ms": None}
            if dtype == torch.bfloat16:
                frame.setdefault(name, {}).update(entry)
            else:
                frame.setdefault(name, {}).update(
                    {f"f32_b{B}_{k}": v for k, v in entry.items()})
    return frame


# ============================================ the GRU step at the defaults


def default_size_steps(dev, card):
    """Phase 18: the GRU trainer's step (scripts/train_gru, synthetic data)
    at the Options defaults, B=12, T=10, 640x192, bf16, for v10 and v9 with
    the checkpointing --gru_remat auto picks at B*T = 120 (the JAX
    _remat_mode thresholds), then v10 without it (v9 without it does not fit
    the card)."""
    for version, remat in (("v10", "auto"), ("v9", "auto"), ("v10", "0")):
        default_size_step(dev, card, version, remat)


def default_size_step(dev, card, version, remat):
    """The GRU trainer's step at the Options defaults for ``version`` under
    ``--gru_remat remat``: one warm-up step and two timed ones (CUDA
    events), the peak memory over all three, finite losses. Returns (ms of
    the timed steps, peak GiB)."""
    import gc

    import torch

    from ssde_tpu_torch.config import MonodepthOptions
    from ssde_tpu_torch.data.pipeline import collate, to_device
    from ssde_tpu_torch.scripts.train_gru import build_trainer
    from ssde_tpu_torch.train.steps_gru import remat_mode

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    counters = _gru_counters()
    opts = MonodepthOptions().parse(
        ["--gru_version", version, "--synthetic_data", "--num_epochs", "1",
         "--save_frequency", "2", "--num_workers", "4", "--gru_remat", remat])
    if (opts.batch_size, opts.len_sequence, opts.height, opts.width,
            opts.compute_dtype) != (12, 10, H, W, "bfloat16"):
        fail(f"unexpected Options defaults {opts}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(opts, dev)
    B = opts.batch_size
    batch = to_device(collate([trainer.train_dataset[i] for i in range(B)]), dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    ms, losses = [], []
    for i in range(3):  # one warm-up step, two timed
        for fn in counters.values():
            fn.launches = 0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = trainer.step_fn(trainer.models, trainer.state, batch, gen)
        end.record()
        losses.append(float(out["loss"]))
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
    frames = B * opts.len_sequence
    print(f"defaults: gru {version} train step B={B} T={opts.len_sequence} {H}x{W} bf16, "
          f"--gru_remat {remat} ({remat_mode(opts)!r}): {ms[1]:.1f} and {ms[2]:.1f} ms "
          f"after a {ms[0]:.1f} ms warm-up ({frames * 2e3 / (ms[1] + ms[2]):.2f} "
          f"frame-samples/s); peak memory {peak:.2f} GiB of "
          f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f}; losses "
          + " ".join(f"{v:.5f}" for v in losses) + f"; launches per step {launched} "
          f"[{card}]")
    if not all(np.isfinite(losses)):
        fail(f"defaults: gru {version} --gru_remat {remat}: a loss is not finite")
    del trainer, batch, out
    gc.collect()
    torch.cuda.empty_cache()
    return ms[1:], peak


# ============================================================ KITTI training

KITTI_DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"
KITTI_FRAMES, KITTI_POINTS = 56, 120_000  # frames of the drive; points a scan (HDL-64E)
KITTI_MONO_STEPS = 4
# the calibration of 2011_09_26 (cam 2 and 3 projections, velodyne to camera)
CAM_TO_CAM = """S_rect_02: 1.242000e+03 3.750000e+02
R_rect_00: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01
P_rect_02: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 1.000000e+00 2.745884e-03
P_rect_03: 7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 0.000000e+00 7.215377e+02 1.728540e+02 2.199936e+00 0.000000e+00 0.000000e+00 1.000000e+00 2.729905e-03
"""
VELO_TO_CAM = """R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 7.280733e-04 -9.998902e-01 9.998621e-01 7.523790e-03 1.480755e-02
T: -4.069766e-03 -7.631618e-02 -2.717806e-01
"""


def _blob_canvas(rs, h, w):
    """An (h, >= w, 3) uint8 texture of smooth blobs with fine grain in
    them, from ``rs``."""
    from PIL import Image

    coarse = rs.rand(h // 25 + 2, w // 25 + 2, 3)
    big = np.asarray(Image.fromarray((coarse * 255).astype(np.uint8)).resize(
        (coarse.shape[1] * 25, coarse.shape[0] * 25), Image.BICUBIC), np.float32)
    fine = rs.rand(*big.shape[:2], 1).astype(np.float32) * 48  # texture inside the blobs
    return np.clip(big * 0.8 + fine, 0, 255).astype(np.uint8)[:h]


def write_kitti_tree(root):
    """A KITTI raw drive at KITTI's sizes under ``root``/kitti, and the lists
    under ``root``/splits (eigen_zhou): each camera's frames are crops of one
    wide texture of smooth blobs that slide 6 pixels a frame (the right
    camera 40 pixels over), each scan 120,000 points in front of the car.
    Returns (data path, splits dir, the mono train lines)."""
    from PIL import Image

    rs = np.random.RandomState(SEED)
    w, h, step = 1242, 375, 6
    canvas = _blob_canvas(rs, h, w + step * KITTI_FRAMES + 40)
    data = os.path.join(root, "kitti")
    for cam, off in (("image_02", 0), ("image_03", 40)):
        d = os.path.join(data, KITTI_DRIVE, cam, "data")
        os.makedirs(d)
        for i in range(KITTI_FRAMES):
            x = off + step * i
            Image.fromarray(canvas[:, x:x + w]).save(os.path.join(d, f"{i:010d}.jpg"),
                                                     quality=90)
    d = os.path.join(data, KITTI_DRIVE, "velodyne_points", "data")
    os.makedirs(d)
    for i in range(KITTI_FRAMES):
        pts = np.empty((KITTI_POINTS, 4), np.float32)
        pts[:, 0] = rs.uniform(2, 80, KITTI_POINTS)        # forward
        pts[:, 1] = rs.uniform(-25, 25, KITTI_POINTS)      # left
        pts[:, 2] = rs.uniform(-1.8, 2.0, KITTI_POINTS)    # up
        pts[:, 3] = rs.rand(KITTI_POINTS)                  # reflectance
        pts.tofile(os.path.join(d, f"{i:010d}.bin"))
    with open(os.path.join(data, "2011_09_26", "calib_cam_to_cam.txt"), "w") as f:
        f.write(CAM_TO_CAM)
    with open(os.path.join(data, "2011_09_26", "calib_velo_to_cam.txt"), "w") as f:
        f.write(VELO_TO_CAM)
    splits = os.path.join(root, "splits", "eigen_zhou")
    os.makedirs(splits)
    train = [f"{KITTI_DRIVE} {i} l" for i in range(1, 1 + MONO_B * KITTI_MONO_STEPS)]
    val = [f"{KITTI_DRIVE} {i} {'lr'[i // 4 % 2]}" for i in range(2, KITTI_FRAMES - 1, 4)]
    for name, lines in (("train_files", train), ("val_files", val),
                        ("train_sequences", [KITTI_DRIVE]), ("val_sequences", [KITTI_DRIVE])):
        with open(os.path.join(splits, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return data, os.path.dirname(splits), train


class _Observed:
    """Records, while in use, what a trainer class's ``train`` started
    from (every parameter and statistic), the losses of each ``run_epoch``
    and the scalars of each ``val``."""

    def __init__(self, cls):
        self.cls, self.start, self.history, self.vals = cls, None, [], []

    def __enter__(self):
        cls, obs = self.cls, self
        self.saved = {k: cls.__dict__.get(k) for k in ("train", "run_epoch", "val")}
        train, run_epoch, val = cls.train, cls.run_epoch, cls.val

        def observed_train(trainer):
            obs.start = [p.detach().clone() for p in trainer.models.parameters()]
            return train(trainer)

        def observed_run_epoch(trainer):
            h = run_epoch(trainer)
            obs.history += [{k: float(v) for k, v in d.items()} for d in h]
            return h

        def observed_val(trainer):
            out = val(trainer)
            obs.vals.append(out)
            return out

        cls.train, cls.run_epoch, cls.val = observed_train, observed_run_epoch, observed_val
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                delattr(self.cls, k)
            else:
                setattr(self.cls, k, v)


def _trainer_tensors(trainer):
    """Every parameter and buffer (BatchNorm statistics and counts) of the
    trainer's modules, by name, on the host."""
    return {f"{i}.{k}": v.detach().cpu().clone()
            for i, m in enumerate(trainer.models.modules())
            for k, v in m.state_dict().items()}


def _adam_steps(trainer):
    return sorted({int(s["step"]) for s in trainer.state.optimizer.state.values()})


def _kitti_trainer_run(name, cls, main, argv, want_files, want_launches, card,
                       gradless_ok=False):
    """One trainer's epoch on the tree through its entry point's main():
    the checks of phase 19 up to the reload. Every trained parameter must
    change; with ``gradless_ok`` (the fusion trainers) those that no
    gradient reached in the last step may stay. Returns (trainer,
    weights_0)."""
    import torch

    counters = _gru_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Observed(cls) as obs:
        trainer = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
    steps = len(obs.history)
    print(f"kitti {name}: main() {wall:.1f} s (build, an epoch of {steps} steps, "
          f"{len(obs.vals)} val(), save): losses "
          + " ".join(f"{h['loss']:.5f}" for h in obs.history)
          + f"; launches {launched} [{card}]")
    if not steps or not all(np.isfinite(v) for h in obs.history for v in h.values()):
        fail(f"kitti {name}: {steps} steps, or a loss is not finite")
    missing = [k for k in want_launches if not launched.get(k)]
    if missing:
        fail(f"kitti {name}: kernels of the path never launched: {missing}")
    unchanged = [i for i, (a, p) in enumerate(zip(obs.start, trainer.models.parameters()))
                 if torch.equal(a, p)]
    print(f"kitti {name}: {len(obs.start) - len(unchanged)} of {len(obs.start)} trained "
          "parameters changed" + (f"; unchanged: {unchanged}" if unchanged else ""))
    if gradless_ok:
        params = list(trainer.models.parameters())
        unchanged = [i for i in unchanged
                     if params[i].grad is not None and params[i].grad.abs().max() > 1e-6]
    if unchanged:
        fail(f"kitti {name}: some parameters did not change")
    if not obs.vals:
        fail(f"kitti {name}: val() never ran")
    from ssde_tpu_torch.train.trainer import DEPTH_METRICS

    for v in obs.vals:
        print(f"kitti {name}: val " + " ".join(f"{k} {v[k]:.5f}" for k in DEPTH_METRICS
                                               if k in v))
        if not all(k in v and np.isfinite(v[k]) for k in DEPTH_METRICS):
            fail(f"kitti {name}: val() did not give the 7 finite depth metrics: {v}")
    folder = os.path.join(trainer.log_path, "models", "weights_0")
    files = sorted(os.listdir(folder)) if os.path.isdir(folder) else []
    opt_json = os.path.join(trainer.log_path, "models", "opt.json")
    print(f"kitti {name}: {folder}: {files}; opt.json {os.path.isfile(opt_json)}")
    if files != sorted(want_files) or not os.path.isfile(opt_json):
        fail(f"kitti {name}: weights_0 holds {files}, expected {sorted(want_files)} "
             "and models/opt.json")
    return trainer, folder


def _kitti_reload(name, build_trainer, parse, argv, trainer, folder, card, floor=0.0):
    """A trainer built on ``folder`` against the saved one: bit-identical
    modules and Adam step count; then one further step from each on one
    batch, held at phase 8's tolerance (loss 1e-4 relative; each tensor's
    update 1e-3 of its largest, or of ``floor`` times its module's largest
    where that is more: FUSION_GRAD_FLOOR for the fusion trainers)."""
    import torch

    t0 = time.perf_counter()
    trainer.epoch = 1
    extra = trainer.save_model()
    save_s = time.perf_counter() - t0
    shutil.rmtree(extra)
    reloaded = build_trainer(parse(argv + ["--load_weights_folder", folder]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reloaded.load_model()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    a, b = _trainer_tensors(trainer), _trainer_tensors(reloaded)
    for i, (sa, sb) in enumerate(zip(trainer.state.optimizer.state.values(),
                                     reloaded.state.optimizer.state.values())):
        a.update({f"adam.{i}.{k}": v.detach().cpu() for k, v in sa.items()})
        b.update({f"adam.{i}.{k}": v.detach().cpu() for k, v in sb.items()})
    differ = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    steps = (trainer.state.step, reloaded.state.step, _adam_steps(trainer), _adam_steps(reloaded))
    print(f"kitti {name}: save_model {save_s:.3f} s, load_model {load_s:.3f} s [{card}]; "
          f"reloaded: {len(a) - len(differ)} of {len(a)} tensors bit-identical; Adam steps "
          f"{steps[0]} / {steps[1]} (per parameter {steps[2]} / {steps[3]})")
    if differ or a.keys() != b.keys() or steps[0] != steps[1] or steps[2] != steps[3]:
        fail(f"kitti {name}: the reloaded trainer differs: {differ[:5]}, steps {steps}")
    _further_step(f"kitti {name}", trainer, reloaded, ("saved", "reloaded"), floor)
    del reloaded


def _further_step(name, trainer, other, labels, floor=0.0):
    """One further step from ``trainer`` (twice: the card's own spread) and
    from ``other`` (labelled ``labels``) on one batch of the trainer's set,
    held at phase 8's tolerance (loss 1e-4 relative; each tensor's update
    1e-3 of its largest, or of ``floor`` times its module's largest where
    that is more)."""
    import torch

    from ssde_tpu_torch.data.pipeline import collate
    from ssde_tpu_torch.train.trainer import device_batch

    host = collate([trainer.train_dataset[i] for i in range(trainer.opt.batch_size)])
    # the further step in float32 with TF32 off: under bf16 autocast the card's
    # own spread between two runs of one step from one state (atomics in the
    # upsampling backwards, bf16 rounding after them) reaches 1.3e-2 of a
    # BatchNorm bias gradient's largest, above phase 8's tolerance
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    for t in (trainer, trainer, other):  # the first state twice: the card's own spread
        models, state = copy.deepcopy((t.models, t.state))
        models.opts.compute_dtype = "float32"
        gen = torch.Generator(trainer.device).manual_seed(SEED)
        out = t.step_fn(models, state, device_batch(host, trainer.device), gen)
        trained = {id(p) for p in models.parameters()}
        named = [(f"{i}.{k}", p) for i, m in enumerate(models.modules())
                 for k, p in m.named_parameters() if id(p) in trained]
        runs.append((float(out["loss"]), {k: p.grad.detach().clone() for k, p in named
                                          if p.grad is not None},
                     {k: p.detach().clone() for k, p in named}))
        del models, state, out
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    def worst(x, y):
        """The largest difference of a tensor, over its largest value (or
        ``floor`` times its module's largest), and the tensor's name."""
        top = {}
        for k, v in x.items():
            m = k.split(".")[0]
            top[m] = max(top.get(m, 0.0), v.abs().max().item())
        return max((((x[k] - y[k]).abs().max()
                     / max(x[k].abs().max().item(), floor * top[k.split(".")[0]])).item(), k)
                   for k in x if x[k].abs().max() > 0)

    for label, j in ((f"{labels[0]} vs {labels[0]}", 1), (f"{labels[0]} vs {labels[1]}", 2)):
        rel = abs(runs[0][0] - runs[j][0]) / abs(runs[0][0])
        g, p = worst(runs[0][1], runs[j][1]), worst(runs[0][2], runs[j][2])
        print(f"{name}: the further step in float32, {label}: loss {runs[0][0]:.6f} / "
              f"{runs[j][0]:.6f} ({rel:.2e} relative); worst gradient difference {g[0]:.2e} "
              f"of its tensor's largest ({g[1]}), parameter {p[0]:.2e} ({p[1]})")
    if not (rel <= TOL_STEP_LOSS and g[0] <= TOL_STEP_GRAD and p[0] <= TOL_STEP_GRAD):
        fail(f"{name}: the resumed step disagrees")


def _loader_rate(dataset, workers, passes=1):
    """items/s of ``passes`` passes of the port's Loader over ``dataset``."""
    from ssde_tpu_torch.data.pipeline import Loader

    loader = Loader(dataset, MONO_B, shuffle=True, drop_last=True, num_workers=workers)
    t0 = time.perf_counter()
    n = 0
    for _ in range(passes):
        for batch in loader:
            n += len(batch["K"])
    return n / (time.perf_counter() - t0)


def kitti_train(dev, card, mono_step_ms, root):
    """Phase 19: both trainers on a KITTI raw tree at KITTI's sizes, written
    under ``root``. Returns (data path, splits dir, the mono trainer's
    weights_0, the GRU trainer's) for phases 20 and 27."""
    import torch

    from ssde_tpu_torch.config import MonodepthOptions
    from ssde_tpu_torch.data.kitti import KITTIRAWDataset
    from ssde_tpu_torch.native import get_lib
    from ssde_tpu_torch.scripts import train_dpt, train_gru
    from ssde_tpu_torch.train.trainer import Trainer
    from ssde_tpu_torch.train.trainer_gru import GRUTrainer

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    try:
        t0 = time.perf_counter()
        data, splits, train_lines = write_kitti_tree(root)
        print(f"kitti tree: {KITTI_FRAMES} frames a camera at 1242x375, {KITTI_POINTS} points "
              f"a scan, written in {time.perf_counter() - t0:.1f} s")
        os.environ["SSDE_SPLITS_DIR"] = splits
        parse = MonodepthOptions().parse
        opts = parse([])
        ids = [0, -1, 1]
        t0 = time.perf_counter()
        get_lib()  # g++ builds the velodyne projection at its first use
        print(f"velodyne projection library: {time.perf_counter() - t0:.2f} s")
        plain = KITTIRAWDataset(data, train_lines, H, W, ids, is_train=True)
        plain[0]
        cold = _loader_rate(plain, opts.num_workers, passes=2)
        cache = os.path.join(root, "decoded")
        cached = KITTIRAWDataset(data, train_lines, H, W, ids, is_train=True,
                                 decoded_cache=cache)
        first = _loader_rate(cached, opts.num_workers)
        warm = _loader_rate(cached, opts.num_workers, passes=2)
        print(f"kitti loader (Loader, {opts.num_workers} threads on {os.cpu_count()} cores, "
              f"B={MONO_B}, frames [0, -1, 1] at {H}x{W} and depth_gt a item): JPEGs "
              f"{cold:.1f} items/s; --decoded_cache first pass {first:.1f}, warm {warm:.1f} "
              f"items/s [{card}]")

        # ---- the mono trainer
        log = os.path.join(root, "log")
        argv = ["--model", "monodepth2", "--data_path", data, "--num_epochs", "1",
                "--log_frequency", "2", "--mono_pretrained", "0", "--log_dir", log]
        o = parse(argv)
        if (o.batch_size, o.height, o.width, o.compute_dtype, o.save_frequency) != (
                MONO_B, H, W, "bfloat16", 1):
            fail(f"unexpected Options defaults {o}")
        trainer, mono_weights = _kitti_trainer_run(
            "mono", Trainer, train_dpt.main, argv,
            ["encoder.pth", "depth.pth", "pose_encoder.pth", "pose.pth", "adam.pth"],
            ["warp_family_fwd", "warp_family_bwd", "photometric_fwd", "photometric_bwd"], card)
        _kitti_reload("mono", train_dpt.build_trainer, parse, argv, trainer, mono_weights, card)
        # the loader-fed step: an unprofiled epoch on the host clock, then a
        # profiled one for the device's busy time (val() left out of both)
        trainer.val = lambda: {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(trainer.run_epoch())
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        busy, wall, _ = _device_idle_share(trainer.run_epoch, 1)
        print(f"kitti mono step B={MONO_B} {H}x{W} bf16, fed by the loader from JPEGs: "
              f"{step_ms:.1f} ms a step over an epoch of {n} (host clock); device busy "
              f"{busy / n:.1f} ms a step: idle share {1 - busy / (n * step_ms):.1%}; phase 9's "
              f"synthetic step (one batch on the card, no loader) {mono_step_ms[MONO_B]:.1f} "
              f"ms [{card}]")
        del trainer
        torch.cuda.empty_cache()

        # ---- the GRU trainer
        argv = ["--gru_version", "v10", "--data_path", data, "--batch_size", str(GRU_B),
                "--len_sequence", str(GRU_T), "--num_epochs", "1", "--train_n_tuples", "1",
                "--test_n_tuples", "1", "--mono_pretrained", "0", "--log_dir", log,
                "--model_name", "gru"]
        trainer, gru_weights = _kitti_trainer_run(
            "gru v10", GRUTrainer, train_gru.main, argv,
            ["encoder.pth", "depth.pth", "pose_encoder.pth", "pose.pth", "gru.pth", "adam.pth"],
            ["conv3x3_fwd", "conv3x3_dx", "conv3x3_dw", "warp_family_fwd", "warp_family_bwd",
             "photometric_fwd", "photometric_bwd"], card)
        _kitti_reload("gru v10", train_gru.build_trainer, parse, argv, trainer, gru_weights, card)
        trainer.val = lambda: {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(trainer.run_epoch())
        torch.cuda.synchronize()
        print(f"kitti gru v10 step B={GRU_B} T={GRU_T} {H}x{W} bf16, fed by the loader: "
              f"{(time.perf_counter() - t0) * 1e3 / n:.1f} ms a step over an epoch of {n} "
              f"(host clock) [{card}]")
        del trainer
        torch.cuda.empty_cache()

        # ---- --matmul_precision
        for value, want in (("float32", False), ("highest", False), ("default", True)):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            train_dpt.build_trainer(parse(["--model", "monodepth2", "--data_path", data,
                                           "--log_dir", log, "--matmul_precision", value,
                                           "--mono_pretrained", "0"]))
            got = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            print(f"kitti: --matmul_precision {value}: cudnn.allow_tf32, "
                  f"cuda.matmul.allow_tf32 = {got}")
            if got != (want, want):
                fail(f"--matmul_precision {value} left the TF32 switches at {got}")
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return data, splits, mono_weights, gru_weights



# ============================================================ mono eval

ODOM_FRAMES = 65  # frames of odometry sequence 09: 64 frame pairs, a test line each
SIMPLE_IMAGES = 8  # test_simple's folder
# card vs CPU of the evaluation's disparity, float32 with TF32 off: the
# largest difference over the largest value (phase 4's bound)
TOL_EVAL_CARD_VS_CPU = 1e-3


def write_odometry_sequence(data, splits):
    """KITTI odometry sequence 09 under ``data``: ODOM_FRAMES 1241x376 JPEGs
    a camera sliding along a texture, and ``poses/09.txt`` (the camera
    0.8 m forward a frame, turning 0.01 rad a frame); the test list
    ``odom/test_files_09.txt`` under ``splits``, a line per frame pair as
    KITTI's (1590 lines for 1591 poses)."""
    from PIL import Image

    rs = np.random.RandomState(SEED + 1)
    w, h, step = 1241, 376, 6
    canvas = _blob_canvas(rs, h, w + step * ODOM_FRAMES + 40)
    for cam, off in (("image_2", 0), ("image_3", 40)):
        d = os.path.join(data, "sequences", "09", cam)
        os.makedirs(d)
        for i in range(ODOM_FRAMES):
            x = off + step * i
            Image.fromarray(canvas[:, x:x + w]).save(os.path.join(d, f"{i:06d}.jpg"),
                                                     quality=90)
    rows, pos = [], np.zeros(3)
    for i in range(ODOM_FRAMES):
        yaw = 0.01 * i
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        rows.append(np.concatenate([R, pos[:, None]], 1).reshape(-1))
        pos = pos + R @ np.array([0.0, 0.0, 0.8])
    os.makedirs(os.path.join(data, "poses"))
    np.savetxt(os.path.join(data, "poses", "09.txt"), np.array(rows))
    os.makedirs(os.path.join(splits, "odom"))
    with open(os.path.join(splits, "odom", "test_files_09.txt"), "w") as f:
        f.write("\n".join(f"9 {i} l" for i in range(ODOM_FRAMES - 1)) + "\n")


def mono_eval(dev, card, root, data, splits, weights):
    """Phase 20: the mono and pose evaluation entry points on phase 19's
    tree and its mono weights_0, everything written under ``root``. Returns
    evaluate_depth's metrics (no --post_process) for phase 27."""
    import torch

    from ssde_tpu_torch.config import MonodepthOptions
    from ssde_tpu_torch.data.kitti import pil_load_resized
    from ssde_tpu_torch.eval.depth import evaluate_depth_predictions
    from ssde_tpu_torch.scripts import (evaluate_depth, evaluate_depth_gru_fusion,
                                        evaluate_pose, export_gt_depth, test_simple)
    from ssde_tpu_torch.train.steps import mono_infer

    phase0 = time.perf_counter()
    counters = _gru_counters()
    for fn in counters.values():
        fn.launches = 0
    lines = [f"{KITTI_DRIVE} {i} {side}" for side in "lr" for i in range(KITTI_FRAMES)]
    os.makedirs(os.path.join(splits, "eigen"))
    with open(os.path.join(splits, "eigen", "test_files.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    write_odometry_sequence(data, splits)
    os.environ["SSDE_SPLITS_DIR"] = splits
    t0 = time.perf_counter()
    gt_path = export_gt_depth.main(["--data_path", data, "--split", "eigen"])
    gt = np.load(gt_path, allow_pickle=True)["data"]
    print(f"eval: export_gt_depth of {len(lines)} eigen-style lines: {gt.shape} "
          f"{gt.dtype} of {gt[0].shape} {gt[0].dtype} maps, "
          f"{sum(int((g > 0).sum()) for g in gt) / len(gt):.0f} valid pixels a map, "
          f"{time.perf_counter() - t0:.2f} s")
    if gt.shape != (len(lines),) or gt[0].shape != (375, 1242):
        fail(f"eval: gt_depths.npz holds {gt.shape}, expected {len(lines)} maps")

    # ---- evaluate_depth, with and without --post_process, and mdp
    base = ["--eval_mono", "--data_path", data, "--load_weights_folder", weights,
            "--height", str(H), "--width", str(W), "--save_pred_disps"]
    names = evaluate_depth.METRIC_NAMES
    results = {}
    for label, extra in (("plain", []), ("post_process", ["--post_process"])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = evaluate_depth.main(base + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        disps = np.load(os.path.join(weights, "disps_eigen_split.npy"))
        results[label] = m, disps
        print(f"eval: evaluate_depth {label} {H}x{W} float32 (TF32 off): main() {wall:.2f} s "
              f"for {len(lines)} frames ({len(lines) / wall:.1f} frames/s, building, loading "
              f"and the ground truth included); " + " ".join(f"{n} {m[n]:.4f}" for n in names)
              + f"; med_scale {m['med_scale']:.3f} [{card}]")
        if disps.shape != (len(lines), H, W) or not np.isfinite(disps).all() or \
                not all(np.isfinite(m[n]) for n in names):
            fail(f"eval: evaluate_depth {label}: disparities {disps.shape} or metrics not "
                 "finite")
    if np.abs(results["plain"][1] - results["post_process"][1]).max() == 0:
        fail("eval: --post_process left the disparities as they were")
    m = evaluate_depth_gru_fusion.main(["--protocol", "mdp"] + base)
    worst = max(abs(m[n] - results["plain"][0][n]) / abs(results["plain"][0][n]) for n in names)
    print("eval: evaluate_depth_gru_fusion --protocol mdp: " + " ".join(
        f"{n} {m[n]:.4f}" for n in names) + f"; against evaluate_depth {worst:.2e} relative")
    if worst > 1e-6:
        fail("eval: the mdp protocol does not give evaluate_depth's metrics")

    # ---- the prediction loop alone: frames/s and the device's idle share
    opt = MonodepthOptions().parse(base)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate_depth.predict_disps(opt, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, _, _ = _device_idle_share(lambda: evaluate_depth.predict_disps(opt, dev), 1)
    print(f"eval: predict_disps (the loader's batches of 16 from the JPEGs, "
          f"{opt.num_workers} threads on {os.cpu_count()} cores): {len(lines) / wall:.1f} "
          f"frames/s over {len(lines)} (host clock, building and loading included); device "
          f"busy {busy:.1f} ms of {wall * 1e3:.1f}: idle share {1 - busy / (wall * 1e3):.1%} "
          f"[{card}]")
    t0 = time.perf_counter()
    evaluate_depth.load_mono_models(opt, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gts = evaluate_depth.load_gt_depths(opt)
    gt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluate_depth_predictions(results["plain"][1], gts)
    metrics_s = time.perf_counter() - t0
    print(f"eval: evaluate_depth's parts (host clock): the models built and loaded "
          f"{build_s:.2f} s, the prediction loop {wall:.2f} s, gt_depths.npz read {gt_s:.2f} s, "
          f"the metrics over {len(gts)} maps {metrics_s:.2f} s (numpy) [{card}]")

    # ---- the card against the CPU on the same 4 frames
    x = np.stack([pil_load_resized(os.path.join(data, KITTI_DRIVE, "image_02", "data",
                                                 f"{i:010d}.jpg"), W, H, False)
                  for i in range(4)])
    x = torch.from_numpy(x).permute(0, 3, 1, 2)
    on_card = mono_infer(evaluate_depth.load_mono_models(opt, dev), x).cpu()
    on_cpu = mono_infer(evaluate_depth.load_mono_models(opt, "cpu"), x)
    rel = ((on_card - on_cpu).abs().max() / on_cpu.abs().max()).item()
    print(f"eval: mono_infer card vs CPU on 4 frames, float32, TF32 off: max |d disp| "
          f"{(on_card - on_cpu).abs().max().item():.3e}, {rel:.3e} of the largest "
          f"(bound {TOL_EVAL_CARD_VS_CPU})")
    if not rel <= TOL_EVAL_CARD_VS_CPU:
        fail("eval: the card and the CPU disagree on the disparity")

    # ---- test_simple on a folder of frames
    folder = os.path.join(root, "simple")
    os.makedirs(folder)
    for i in range(SIMPLE_IMAGES):
        shutil.copy(os.path.join(data, KITTI_DRIVE, "image_02", "data", f"{i:010d}.jpg"),
                    os.path.join(folder, f"{i:010d}.jpg"))
    times = test_simple.main(["--image_path", folder, "--model_path", weights])
    made = sorted(os.listdir(folder))
    npy = [np.load(os.path.join(folder, f)) for f in made if f.endswith("_disp.npy")]
    jpeg = [f for f in made if f.endswith("_disp.jpeg")]
    ms = [t * 1e3 for _, t in times]
    print(f"eval: test_simple on {len(times)} images of 1242x375: median {np.median(ms):.1f} "
          f"ms an image (decode to files written; first {ms[0]:.1f}, range "
          f"{min(ms):.1f}-{max(ms):.1f}), {len(npy)} *_disp.npy, {len(jpeg)} *_disp.jpeg "
          f"[{card}]")
    if len(times) != SIMPLE_IMAGES or len(npy) != SIMPLE_IMAGES or not all(
            a.shape == (1, H, W, 1) and np.isfinite(a).all() for a in npy):
        fail("eval: test_simple did not write a finite disparity for every image")

    # ---- evaluate_pose on odom_9
    argv = ["--eval_split", "odom_9", "--data_path", data, "--load_weights_folder", weights,
            "--height", str(H), "--width", str(W)]
    pairs = ODOM_FRAMES - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean_ate, std_ate = evaluate_pose.main(argv)
    wall = time.perf_counter() - t0
    poses = np.load(os.path.join(weights, "poses.npy"))
    opt = MonodepthOptions().parse(argv)
    t0 = time.perf_counter()
    evaluate_pose.predict_poses(opt, 9, dev)
    loop = time.perf_counter() - t0
    print(f"eval: evaluate_pose odom_9, {pairs} frame pairs of 1241x376 at {H}x{W}: ATE "
          f"{mean_ate:.4f} std {std_ate:.4f}; main() {wall:.2f} s ({pairs / wall:.1f} "
          f"pairs/s), the prediction loop {pairs / loop:.1f} pairs/s (host clock, building "
          f"and loading included) [{card}]")
    if poses.shape != (pairs, 4, 4) or not np.isfinite(poses).all() or \
            not np.isfinite([mean_ate, std_ate]).all():
        fail(f"eval: evaluate_pose gave poses {poses.shape} or a non-finite ATE")
    launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
    print(f"eval: phase 20 took {time.perf_counter() - phase0:.1f} s; launches of the port's "
          f"kernels in it {launched} (its networks run in cuDNN) [{card}]")
    return results["plain"][0]



# ======================================================= native checkpoints

NATIVE_FRAMES = 4  # phase 27 (b): frames of a streamed scene at B=1


def _folder_mb(folder):
    return sum(os.path.getsize(os.path.join(folder, f)) for f in os.listdir(folder)) / 2**20


def _adam_by_parameter(trainer):
    """(step, exp_avg, exp_avg_sq) of each parameter the optimizer trains, in
    its order (None where Adam holds no state for it yet), on the host."""
    opt = trainer.state.optimizer
    return [tuple(opt.state[p][k].detach().cpu() for k in ("step", "exp_avg", "exp_avg_sq"))
            if p in opt.state else None
            for g in opt.param_groups for p in g["params"]]


def _native_resume(name, build_trainer, parse, argv, pth, root, card):
    """Phase 27 (a) for one trainer: a trainer built on phase 19's ``pth``
    folder writes the JAX package's .ckpt folder (``checkpoint.flax_state``
    through the copied converters, ``save_checkpoint`` with adam.ckpt); a
    trainer built on that folder holds the same modules, Adam moments and
    step count bit for bit (BatchNorm's ``num_batches_tracked``, which the
    JAX format has not, left out), and one further step from each agrees
    within phase 8's tolerance. Returns the .ckpt folder."""
    import torch

    from ssde_tpu_torch import checkpoint

    by_pth = build_trainer(parse(argv + ["--load_weights_folder", pth]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    by_pth.load_model()
    torch.cuda.synchronize()
    pth_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    scratch = os.path.join(root, f"pth_{name.replace(' ', '_')}")
    checkpoint.save_folder(scratch, by_pth.models, by_pth.state.optimizer, height=H, width=W)
    pth_save = time.perf_counter() - t0
    pth_mb = _folder_mb(scratch)
    shutil.rmtree(scratch)
    folder = os.path.join(root, f"native_{name.replace(' ', '_')}")
    t0 = time.perf_counter()
    trees = checkpoint.flax_state(by_pth.models, by_pth.state.optimizer, by_pth.state.step)
    checkpoint.save_checkpoint(folder, *trees, height=H, width=W, use_stereo=False)
    ckpt_save = time.perf_counter() - t0
    by_ckpt = build_trainer(parse(argv + ["--load_weights_folder", folder]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    by_ckpt.load_model()
    torch.cuda.synchronize()
    ckpt_load = time.perf_counter() - t0
    print(f"native {name}: {sorted(os.listdir(folder))}; save .pth {pth_save:.3f} s "
          f"({pth_mb:.1f} MiB), .ckpt {ckpt_save:.3f} s ({_folder_mb(folder):.1f} MiB); "
          f"load_model .pth {pth_load:.3f} s, .ckpt {ckpt_load:.3f} s [{card}]")
    a, b = _trainer_tensors(by_pth), _trainer_tensors(by_ckpt)
    differ = [k for k in a if not k.endswith("num_batches_tracked")
              and (k not in b or not torch.equal(a[k], b[k]))]
    adam_a, adam_b = _adam_by_parameter(by_pth), _adam_by_parameter(by_ckpt)
    fresh = [i for i, s in enumerate(adam_a) if s is None]  # no gradient reached them yet
    adam_differ = [i for i, (sa, sb) in enumerate(zip(adam_a, adam_b))
                   if sb is None or (sa is not None and not all(map(torch.equal, sa, sb)))
                   or (sa is None and (sb[1].any() or sb[2].any()))]
    steps = (by_pth.state.step, by_ckpt.state.step, _adam_steps(by_pth), _adam_steps(by_ckpt))
    print(f"native {name}: the trainer on .ckpt against the one on .pth: "
          f"{len(a) - len(differ)} of {len(a)} tensors bit-identical (num_batches_tracked "
          f"not compared), Adam moments of {len(adam_a) - len(adam_differ)} of {len(adam_a)} "
          f"parameters ({len(fresh)} without state in adam.pth, zero moments from adam.ckpt); "
          f"steps {steps[0]} / {steps[1]} (per parameter {steps[2]} / {steps[3]})")
    if differ or adam_differ or len(adam_a) != len(adam_b) or steps[0] != steps[1] \
            or set(steps[3]) != {steps[1]}:
        fail(f"native {name}: the trainer on the .ckpt folder differs: {differ[:5]}, Adam "
             f"{adam_differ[:5]}, steps {steps}")
    _further_step(f"native {name}", by_pth, by_ckpt, (".pth", ".ckpt"))
    del by_pth, by_ckpt
    torch.cuda.empty_cache()
    return folder


def native_checkpoints(dev, card, root, data, mono_weights, gru_weights, mono_metrics):
    """Phase 27: the JAX package's .ckpt folders in the port, on phase 19's
    weights_0 folders: (a) each trainer (mono at B=12, GRU v10 at B=8, T=3,
    bf16) resumed from a .ckpt folder written from the .pth one, against the
    trainer resumed from the .pth folder (:func:`_native_resume`); (b)
    evaluate_depth_gru_fusion's build_evaluator on the v10 .ckpt folder
    streams the .pth folder's disparity exactly, and raises on a folder
    without gru.ckpt; (c) evaluate_depth's main() on the mono .ckpt folder
    gives phase 20's metrics exactly. Returns its main path's launches."""
    import torch

    from ssde_tpu_torch.config import MonodepthOptions
    from ssde_tpu_torch.data.synthetic import scene_frames
    from ssde_tpu_torch.scripts import (evaluate_depth, evaluate_depth_gru_fusion, train_dpt,
                                        train_gru)

    phase0 = time.perf_counter()
    counters = _gru_counters()
    _zeroed(counters)
    parse = MonodepthOptions().parse
    log = os.path.join(root, "log_native")
    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    try:
        mono = _native_resume(
            "mono", train_dpt.build_trainer, parse,
            ["--model", "monodepth2", "--data_path", data, "--num_epochs", "1",
             "--mono_pretrained", "0", "--log_dir", log], mono_weights, root, card)
        gru = _native_resume(
            "gru v10", train_gru.build_trainer, parse,
            ["--gru_version", "v10", "--data_path", data, "--batch_size", str(GRU_B),
             "--len_sequence", str(GRU_T), "--num_epochs", "1", "--train_n_tuples", "1",
             "--test_n_tuples", "1", "--mono_pretrained", "0", "--log_dir", log,
             "--model_name", "gru"], gru_weights, root, card)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    # (b) the GRU evaluator on both folders, and on one without gru.ckpt
    frames = scene_frames(H, W, NATIVE_FRAMES)
    disps = {}
    for label, folder in ((".pth", gru_weights), (".ckpt", gru)):
        opt = parse(["--gru_version", "v10", "--load_weights_folder", folder])
        t0 = time.perf_counter()
        ev = evaluate_depth_gru_fusion.build_evaluator(opt, dev)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        disps[label] = np.stack(ev.predict_scene(frames))
        print(f"native gru v10: build_evaluator on the {label} folder {built:.2f} s (built "
              f"and loaded), {NATIVE_FRAMES} frames streamed at B=1 [{card}]")
        del ev
    diff = np.abs(disps[".pth"] - disps[".ckpt"]).max()
    print(f"native gru v10: streamed disparity {disps['.ckpt'].shape}, .ckpt against .pth "
          f"max |d| {diff:.3e} (must be 0), range {disps['.ckpt'].min():.5f}.."
          f"{disps['.ckpt'].max():.5f}")
    if diff != 0 or not np.isfinite(disps[".ckpt"]).all():
        fail("native gru v10: the evaluator on the .ckpt folder streams another disparity")
    partial = os.path.join(root, "native_no_gru")
    os.makedirs(partial)
    for f in os.listdir(gru):
        if f != "gru.ckpt":
            os.symlink(os.path.join(gru, f), os.path.join(partial, f))
    try:
        evaluate_depth_gru_fusion.build_evaluator(
            parse(["--gru_version", "v10", "--load_weights_folder", partial]), dev)
        fail("native gru v10: build_evaluator served a folder without gru.ckpt")
    except FileNotFoundError as e:
        print(f"native gru v10: a folder without gru.ckpt raises FileNotFoundError: {e}")
        if "gru.ckpt" not in str(e):
            fail("native gru v10: the error does not name gru.ckpt")

    # (c) evaluate_depth on the mono .ckpt folder against phase 20's run on .pth
    t0 = time.perf_counter()
    m = evaluate_depth.main(["--eval_mono", "--data_path", data, "--load_weights_folder", mono,
                             "--height", str(H), "--width", str(W)])
    names = evaluate_depth.METRIC_NAMES
    print(f"native mono: evaluate_depth main() on the .ckpt folder {time.perf_counter() - t0:.2f} "
          "s: " + " ".join(f"{n} {m[n]:.6f}" for n in names) + "; phase 20's on .pth: "
          + " ".join(f"{n} {mono_metrics[n]:.6f}" for n in names))
    if any(m[n] != mono_metrics[n] for n in names):
        fail("native mono: evaluate_depth on the .ckpt folder gives other metrics")
    launched = _read(counters)
    missing = [k for k in ("conv3x3_fwd", "conv3x3_dx", "conv3x3_dw", "warp_family_fwd",
                           "warp_family_bwd", "photometric_fwd", "photometric_bwd")
               if not launched[k]]
    print(f"native: phase 27 took {time.perf_counter() - phase0:.1f} s; launches of its main "
          f"path {launched} [{card}]")
    if missing:
        fail(f"native: {missing} launched no time on phase 27's main path")
    return launched


# ============================================== the rest of the GRU family

FAMILY = ("v1", "v2", "v2_wo_att", "v3", "v4", "v5", "v6", "v7", "v8")
FAMILY_FRAMES = 6  # serving: a scene of this many frames at B=1
FAMILY_B, FAMILY_T = 2, 2  # one train step of each version but v5
# the new small-channel convs: (Cin, Cout) of v1's and v2's cells, conv
# units and heads, and of their dx (the same conv from Cout to Cin)
FAMILY_CONVS = ((1, 3), (1, 2), (1, 1), (2, 6), (2, 4), (2, 2), (2, 1))


def family_kernels(dev):
    """Phase 21 (a): kernels #1 and #2 against their plain versions at the
    family's small-channel convs (FAMILY_CONVS and their transposes, Cin 1
    to 6, Cout 1 to 6) at 192x640 (B=1) and 37x45 (B=2), zero and reflect
    pad, float32 and bf16: the forward with acts none, relu and sigmoid,
    bias on and off (phase 2's bounds), the backward (dx, dW, db) with the
    acts of those convs (phase 10's bounds, float32 against float64); and
    #3/#4 at C = 2, v2's attention units, at its four scales (B=1) and
    37x45 (B=2), phase 14's bounds. Returns the worst absolute errors."""
    import torch

    from ssde_tpu_torch.ops.attention_win import attend3_bwd, attend3_fwd, attend3_reference
    from ssde_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_reference

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    f32, bf16 = torch.float32, torch.bfloat16
    sizes = ((1, H, W), (2, 37, 45))
    pairs = sorted(set(FAMILY_CONVS) | {(o, i) for i, o in FAMILY_CONVS})
    worst, n = {}, 0
    keep = lambda k, v: worst.__setitem__(k, max(worst.get(k, 0.0), v))  # noqa: E731
    t0 = time.perf_counter()
    with torch.inference_mode():
        for (cin, cout), (B, h, w) in itertools.product(pairs, sizes):
            x = torch.randn(B, cin, h, w, device=dev, generator=gen)
            wt = torch.randn(cout, cin, 3, 3, device=dev, generator=gen) / (3 * cin ** 0.5)
            bt = torch.randn(cout, device=dev, generator=gen) * 0.1
            for dt, pad, act, has_b in itertools.product(
                    (f32, bf16), ("zero", "reflect"), ("none", "relu", "sigmoid"), (True, False)):
                xi, wi, bi = x.to(dt), wt.to(dt), bt.to(dt) if has_b else None
                out = conv3x3(xi, wi, bi, pad, act)
                ref = conv3x3_reference(xi.float(), wi.float(),
                                        None if bi is None else bi.float(), pad, act)
                err = (out.float() - ref).abs().max().item()
                rel = err / max(ref.abs().max().item(), 1e-12)
                keep(("conv3x3_fwd", dt), err)
                keep(("rel fwd", dt), rel)
                n += 1
                if out.dtype != dt or rel > (TOL_F32 if dt == f32 else TOL_BF16):
                    fail(f"family kernels: {cin}->{cout} {h}x{w} B={B} {dt} {pad} {act} "
                         f"bias={has_b}: rel {rel:.3e}")
    print(f"family kernels: conv3x3 forward, {n} cases ({len(pairs)} channel pairs x "
          f"{len(sizes)} sizes x pad x act x bias x dtype) against the plain version: worst rel "
          f"f32 {worst[('rel fwd', f32)]:.3e} (bound {TOL_F32}), bf16 "
          f"{worst[('rel fwd', bf16)]:.3e} (bound {TOL_BF16})")
    n = 0
    for (cin, cout), (B, h, w), pad in itertools.product(FAMILY_CONVS, sizes, ("zero", "reflect")):
        act = "sigmoid" if cout == 1 else "relu"
        x = torch.randn(B, cin, h, w, device=dev, generator=gen)
        wt = torch.randn(cout, cin, 3, 3, device=dev, generator=gen) / (3 * cin ** 0.5)
        bt = torch.randn(cout, device=dev, generator=gen) * 0.1
        g = torch.randn(B, cout, h, w, device=dev, generator=gen)
        for dt in (f32, bf16):
            got, want, _ = _conv_bwd(x, wt, bt, g, pad, act, dt)
            for name, a, r in zip(("conv3x3_dx", "conv3x3_dw", "db"), got, want):
                if a.dtype != dt or a.shape != r.shape:
                    fail(f"family kernels: {name} {a.dtype} {tuple(a.shape)}")
                keep((name, dt), (a.to(r.dtype) - r).abs().max().item())
                rel = _rel(a.to(r.dtype), r)
                keep(("rel bwd", dt), rel)
                if rel > (TOL_BWD_F32 if dt == f32 else TOL_BWD_BF16):
                    fail(f"family kernels: {name} of {cin}->{cout} {h}x{w} B={B} {pad} {act} "
                         f"{dt}: {rel:.3e} of max")
            n += 1
    print(f"family kernels: conv3x3 backward (dx, dW, db), {n} cases against autograd of the "
          f"plain version (float32 run against float64, bf16 against float32): worst of max "
          f"f32 {worst[('rel bwd', f32)]:.3e} (bound {TOL_BWD_F32}), bf16 "
          f"{worst[('rel bwd', bf16)]:.3e} (bound {TOL_BWD_BF16})")
    n = 0
    for B, h, w in [(1, H >> s, W >> s) for s in range(4)] + [(2, 37, 45)]:
        q, kp, vp, rel, g = _attn_operands(dev, B, 2, h, w, gen)
        for dt in (f32, bf16):
            ops = [t.to(dt) for t in (q, kp, vp)]
            out = attend3_fwd(*ops, rel)
            grads = attend3_bwd(*ops, rel, g.to(dt))
            if dt == f32:
                ref = attend3_reference(q, kp, vp, rel)
                e_fwd = (out - ref).abs().max().item()
                want = _attn_plain_grads(*(t.double() for t in (q, kp, vp, rel, g)))
                e_rel = max(_rel(a.double(), b) for a, b in zip(grads, want))
                ok = e_fwd <= TOL_ATTN_FWD and e_rel <= TOL_ATTN_GRAD
                keep(("attend3_fwd", dt), e_fwd)
            else:
                f = [t.float() for t in ops]
                ref = attend3_reference(*f, rel)
                e_fwd = _rel(out.float(), ref)
                want = _attn_plain_grads(*f, rel, g.to(dt).float())
                e_rel = max(_rel(a.float(), b) for a, b in zip(grads, want))
                ok = e_fwd <= TOL_ATTN_BF16 and e_rel <= TOL_ATTN_BF16
                keep(("attend3_fwd", dt), (out.float() - ref).abs().max().item())
            keep(("attend3_bwd", dt), max((a.to(b.dtype) - b).abs().max().item()
                                          for a, b in zip(grads, want)))
            keep(("rel attn", dt), e_rel)
            n += 1
            if not ok:
                fail(f"family kernels: attend3 at C=2, {h}x{w} B={B} {dt}: forward {e_fwd:.3e},"
                     f" gradients {e_rel:.3e} of max")
    print(f"family kernels: attend3 forward and backward at C=2, {n} cases: worst gradient "
          f"of max f32 {worst[('rel attn', f32)]:.3e} (bound {TOL_ATTN_GRAD}, forward "
          f"{worst[('attend3_fwd', f32)]:.3e} abs, bound {TOL_ATTN_FWD}), bf16 "
          f"{worst[('rel attn', bf16)]:.3e} (bound {TOL_ATTN_BF16}); phase 21 (a) took "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return {k: v for k, v in worst.items() if k[0] in _gru_counters()}


def family_serving(dev, card, version):
    """Phase 21 (b): ``version`` streaming depth through build_evaluator and
    the scene loop at B=1, float32 (TF32 off), seeded random weights: the
    kernels' launches per frame-step, finite sigmoid disparities, the
    per-frame median ms (upload, step, disparity back; host clock) and
    card vs CPU (the plain path) over 2 frames, phase 4's bound relative to
    the largest value. Returns (launches, median ms, card vs CPU)."""
    import torch

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.synthetic import scene_frames
    from ssde_tpu_torch.eval.gru_runners import GRUStreamEvaluator
    from ssde_tpu_torch.models.common import sample_
    from ssde_tpu_torch.models.resnet import randomize_bn_stats_
    from ssde_tpu_torch.scripts.evaluate_depth_gru_fusion import build_evaluator

    opt = Options()
    opt.gru_version, opt.height, opt.width = version, H, W
    ev = build_evaluator(opt, dev, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    randomize_bn_stats_(ev.models.encoder, gen)
    for p in ev.models.h0_parameters():
        sample_(p, gen, lambda t: t.normal_(0.0, 0.1, generator=gen))
    scene = scene_frames(H, W, FAMILY_FRAMES, batch=1, seed=SEED)
    counters = _gru_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = ev.predict_scene(scene)
    torch.cuda.synchronize()
    launched = {k: fn.launches for k, fn in counters.items()}
    per_frame = {"conv3x3_fwd": len(slice_convs(version, H, W))
                 + len(head_convs(version, H, W, (0,))),
                 "attend3_fwd": len(slice_attention(version, H, W))}
    want = {k: FAMILY_FRAMES * per_frame.get(k, 0) for k in counters}
    if launched != want:
        fail(f"family serving {version}: launches {launched}, expected {want}")
    for d in out:
        if d.shape != (1, H, W) or not np.isfinite(d).all() or not 0 < d.min() <= d.max() < 1:
            fail(f"family serving {version}: disparity {d.shape} not finite in (0, 1)")
    # the recurrence carries state: the hidden states move from h0. (The
    # disparity need not move: at seed 0, v2's scale-0 fusion block sums
    # two 2-channel attention units to a map that is negative everywhere,
    # so its third unit's relu passes nothing, and its disparity is the
    # same for every frame, on the CPU as on the card.)
    lat, carry = [], ev.initial_carry(1)
    h0 = [t.clone() for h in carry[0] for t in (h if isinstance(h, tuple) else (h,))]
    for f in scene + scene:
        t0 = time.perf_counter()
        carry, disp = ev.step(carry, ev.to_device(f))
        ev.to_host(disp)
        lat.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(lat[1:]))
    hidden = [t for h in carry[0] for t in (h if isinstance(h, tuple) else (h,))]
    if any(torch.equal(a, b) for a, b in zip(hidden, h0)):
        fail(f"family serving {version}: a hidden state did not move over the scene")
    spread = float(np.abs(np.stack(out[1:]) - out[0]).max())
    cpu = copy.deepcopy(ev.models)
    for m in cpu.modules():
        m.cpu()
    on_cpu = GRUStreamEvaluator(cpu).predict_scene(scene[:2])
    delta = max(np.abs(a - b).max() / np.abs(b).max() for a, b in zip(out[:2], on_cpu))
    print(f"family serving {version}: {FAMILY_FRAMES} frames at B=1, {H}x{W}, float32; "
          f"launches per frame-step {per_frame}; median {ms:.3f} ms a frame over "
          f"{len(lat) - 1} (upload, step, disparity back; host clock); the frames' "
          f"disparities differ by up to {spread:.3e}; card vs CPU "
          f"{delta:.3e} of the largest over 2 frames (bound {TOL_CARD_VS_CPU}) [{card}]")
    if not delta <= TOL_CARD_VS_CPU:
        fail(f"family serving {version}: card and CPU disagree: {delta:.3e}")
    del ev, cpu
    torch.cuda.empty_cache()
    return launched, ms, delta


def family_v5_main(dev, card):
    """Phase 21 (c): scripts/train_gru's main() with no --gru_version (v5,
    the Options default) at B=8, T=3, bf16, synthetic data, for an epoch in
    a temporary log directory: finite losses, every trained parameter moved
    from its seeded start, the kernels launched per step and per val().
    Returns the launches."""
    import torch

    from ssde_tpu_torch.scripts import train_gru
    from ssde_tpu_torch.train.steps_gru import build_gru_models
    from ssde_tpu_torch.train.trainer_gru import GRUTrainer

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    counters = _gru_counters()
    log = tempfile.mkdtemp(prefix="ssde_v5_")
    argv = ["--synthetic_data", "--height", str(H), "--width", str(W), "--batch_size",
            str(GRU_B), "--len_sequence", str(GRU_T), "--num_epochs", "1", "--save_frequency",
            "2", "--num_workers", "4", "--log_frequency", "2", "--log_dir", log]
    histories, run_epoch = [], GRUTrainer.run_epoch
    GRUTrainer.run_epoch = lambda self: histories.append(run_epoch(self)) or histories[-1]
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = train_gru.main(argv)
        torch.cuda.synchronize()
    finally:
        GRUTrainer.run_epoch = run_epoch
        shutil.rmtree(log, ignore_errors=True)
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    opt = trainer.opt
    steps = len(histories[0])
    n_val = sum(1 for i in range(steps) if i % opt.log_frequency == 0)
    per_step = {**_block_launches("v5", GRU_T), "warp_family_fwd": 2, "warp_family_bwd": 2,
                "photometric_fwd": 1, "photometric_bwd": 1}
    per_val = {k: v if k in ("conv3x3_fwd", "attend3_fwd") else 0 for k, v in per_step.items()}
    per_val.update(warp_family_fwd=2, photometric_fwd=1)
    want = {k: steps * per_step[k] + n_val * per_val[k] for k in counters}
    losses = [float(h["loss"]) for h in histories[0]]
    fresh = build_gru_models(opt, "cpu", torch.Generator().manual_seed(trainer.seed))
    params = list(trainer.models.parameters())
    moved = sum(not torch.equal(a, b.detach().cpu()) for a, b in zip(fresh.parameters(), params))
    print(f"family v5: train_gru.main() with no --gru_version: {opt.gru_version}, "
          f"B={opt.batch_size}, T={opt.len_sequence}, {H}x{W}, {opt.compute_dtype}; {steps} "
          f"steps + {n_val} val() in {wall:.1f} s (build included); losses "
          + " ".join(f"{v:.5f}" for v in losses) + f"; {moved} of {len(params)} trained "
          f"parameters moved; launches {counts}, expected per step {per_step}, per val() "
          f"{per_val} [{card}]")
    if opt.gru_version != "v5" or trainer.models.gru.version != "v5":
        fail(f"family v5: main() trained {opt.gru_version}")
    if counts != want or not np.isfinite(losses).all() or moved != len(params):
        fail(f"family v5: launches {counts} (expected {want}), losses {losses}, {moved} of "
             f"{len(params)} parameters moved")
    del trainer, fresh
    torch.cuda.empty_cache()
    return counts


def family_train_step(dev, card, version):
    """Phase 21 (d): one train step of ``version`` at B=2, T=2, 640x192,
    bf16, synthetic data: a finite loss and the kernels' launches. Returns
    (launches, loss, seconds of the first step)."""
    import torch

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import collate, to_device
    from ssde_tpu_torch.data.synthetic import SyntheticSeqDataset
    from ssde_tpu_torch.train.state import TrainState
    from ssde_tpu_torch.train.steps_gru import build_gru_models, train_step

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    opts = Options(height=H, width=W, batch_size=FAMILY_B, len_sequence=FAMILY_T,
                   gru_version=version)
    models = build_gru_models(opts, dev, torch.Generator().manual_seed(SEED))
    state = TrainState(models.parameters(), opts.learning_rate, 0, 1000)
    ds = SyntheticSeqDataset(H, W, n=FAMILY_T, length=FAMILY_B, seed=SEED)
    batch = to_device(collate([ds[i] for i in range(FAMILY_B)]), dev)
    counters = _gru_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    loss = float(train_step(models, state, batch, torch.Generator(dev).manual_seed(SEED))["loss"])
    secs = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in counters.items()}
    want = {**_block_launches(version, FAMILY_T), "warp_family_fwd": 2, "warp_family_bwd": 2,
            "photometric_fwd": 1, "photometric_bwd": 1}
    if launched != want or not np.isfinite(loss):
        fail(f"family train {version}: loss {loss}, launches {launched}, expected {want}")
    del models, state, batch
    torch.cuda.empty_cache()
    return launched, loss, secs


def gru_family(dev, card):
    """Phase 21: the rest of the GRU family, v1-v8 (v6 is v4's wiring,
    v2_wo_att v2's without attention). (a) the kernels at the family's new
    shapes; (b) serving of every version; (c) v5, the default, trained by
    scripts/train_gru's main(), its step's ms, frame-samples/s, memory and
    idle share at B=8, T=3, and its step at the Options defaults (B=12,
    T=10, --gru_remat auto); (d) one train step of each other version at
    B=2, T=2 and each block step card vs CPU (v6 shares v4's block). The
    main path's launches are those of (b), (c) and (d). Returns (the main
    path's launches, the worst absolute errors of (a))."""
    import torch

    phase0 = time.perf_counter()
    errs = family_kernels(dev)
    counters = _gru_counters()
    total = dict.fromkeys(counters, 0)
    add = lambda c: total.update({k: total[k] + v for k, v in c.items()})  # noqa: E731
    rows = {v: {} for v in FAMILY}
    for v in FAMILY:
        launched, rows[v]["serve_ms"], rows[v]["serve_cpu"] = family_serving(dev, card, v)
        add(launched)
    add(family_v5_main(dev, card))
    ms, rate, peak, idle = gru_step_times(dev, card, "v5")
    # (v5 at the Options defaults, B=12, T=10: phase 26's bench_gru)
    rows["v5"]["train"] = (f"B={GRU_B} T={GRU_T} {ms:.1f} ms, {rate:.1f} frame-samples/s, "
                           f"{peak:.2f} GiB, idle {idle:.1%}")
    for v in FAMILY:
        if v != "v5":
            launched, loss, secs = family_train_step(dev, card, v)
            add(launched)
            rows[v]["train"] = f"B={FAMILY_B} T={FAMILY_T} loss {loss:.5f} ({secs:.1f} s)"
        if v != "v6":  # v4's block
            rows[v]["block"] = gru_block_card_vs_cpu(dev, v, T=1)
    print(f"gru family summary [{card}]:")
    for v in FAMILY:
        r = rows[v]
        conv = len(slice_convs(v, H, W)) + len(head_convs(v, H, W, (0,)))
        train = {k: n for k, n in _block_launches(v, 1, head_calls=0).items()
                 if n and k.endswith("fwd")}
        print(f"  {v:9s} serving {r['serve_ms']:8.3f} ms a frame (B=1, float32), card vs CPU "
              f"{r['serve_cpu']:.2e}; kernel launches per serving frame-step conv3x3 {conv}, "
              f"attend3 {len(slice_attention(v, H, W))}; per training frame-step {train} "
              f"(+ {len(head_convs(v, H, W))} Head convs a step); train {r['train']}; block "
              f"card vs CPU " + (f"{r['block']:.2e}" if "block" in r else "(v4's)"))
    missing = [k for k, n in total.items() if not n]
    print(f"gru family: main path launches {total}; phase 21 took "
          f"{time.perf_counter() - phase0:.1f} s [{card}]")
    if missing:
        fail(f"gru family: {missing} launched no time on the main path")
    torch.cuda.empty_cache()
    return total, errs


# ====================================== the 3-frame attention-fusion models

# phase 22's runs of evaluate_depth_fusion: (label, --fusion_variant, extra
# arguments), and attend3's launches per batch of each
FUSION_RUNS = (("pyramid", "pyramid", []), ("v3", "v3", []),
               ("v3 --disable_attention", "v3", ["--disable_attention"]),
               ("scale_loop", "scale_loop", []))
FUSION_ATTEND3 = {"pyramid": 24, "v3": 24, "v3 --disable_attention": 0, "scale_loop": 24}
FUSION_CPU_ITEMS = 4  # card vs CPU


def fusion_attention(label: str, height: int, width: int):
    """The attend3 calls of one fusion pass over a batch: (C, h, w) of each.
    The pyramid's blocks (ssde_tpu_torch.models.fusion.FUSION_SPECS) run 3
    units of 2 AttentionConvs at their features and scale 3 .. 0; a
    Fusion_v3 block runs 2 units at C = 2 and one at C = 4 a scale; the
    scale-loop block 3 units at C = 2 a scale; v3's conv units none."""
    from ssde_tpu_torch.models.fusion import FUSION_SPECS

    hw = lambda s: (height >> s, width >> s)  # noqa: E731
    if label == "pyramid":
        return [(feat, *hw(3 - n)) for n, (feat, _, _) in enumerate(FUSION_SPECS)
                for _ in range(6)]
    if label == "v3":
        return [(c, *hw(s)) for s in range(3, -1, -1) for c in (2, 2, 2, 2, 4, 4)]
    if label == "scale_loop":
        return [(2, *hw(s)) for s in range(3, -1, -1) for _ in range(6)]
    return []


def _shared_rel(C: int, gen):
    """A channel-shared (9, C) relative-embedding table on the CPU, as the
    fusion blocks' AttentionConv(shared_rel=True) builds it."""
    from ssde_tpu_torch.models.attention import AttentionConv

    conv = AttentionConv(C, C, 3, use_bias=True, shared_rel=True)
    conv.init_weights_(gen)
    return conv.rel_table().detach()


def fusion_kernels(dev):
    """Phase 22 (a): kernel #3 against the plain attend3 at every attention
    shape of the fusion models at 640x192, with channel-shared embedding
    tables, by phase 14's recipe: float32 at B=1 and B=8, held against the
    plain version in float32 and in float64 (TOL_ATTN_FWD absolute), and
    bf16 against the plain float32 version on the bf16-rounded operands
    (TOL_ATTN_BF16 of the largest). Returns the worst errors."""
    import torch

    from ssde_tpu_torch.ops.attention_win import attend3_fwd, attend3_reference

    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    cpu_gen = torch.Generator().manual_seed(SEED + 22)
    shapes = sorted({c for label, _, _ in FUSION_RUNS for c in fusion_attention(label, H, W)},
                    key=lambda c: (c[0], -c[1]))
    print(f"fusion kernels: #3 against the plain attend3 at the fusion models' {len(shapes)} "
          f"attention shapes (C, h, w) {shapes} at B=1 and {EVAL_BATCH}, shared embedding "
          f"tables; bounds: float32 {TOL_ATTN_FWD} absolute against float32 and float64, bf16 "
          f"{TOL_ATTN_BF16} of max against float32 on the bf16-rounded operands")
    worst = {"f32": 0.0, "f32 vs f64": 0.0, "plain f32 vs f64": 0.0, "bf16": 0.0}
    t0 = time.perf_counter()
    for (C, h, w), B in itertools.product(shapes, (1, EVAL_BATCH)):
        q, kp, vp, _, _ = _attn_operands(dev, B, C, h, w, gen)
        rel = _shared_rel(C, cpu_gen).to(dev)
        out = attend3_fwd(q, kp, vp, rel)
        ref = attend3_reference(q, kp, vp, rel)
        ref64 = attend3_reference(q.double(), kp.double(), vp.double(), rel.double())
        qb, kb, vb = (t.bfloat16() for t in (q, kp, vp))
        outb = attend3_fwd(qb, kb, vb, rel)
        refb = attend3_reference(qb.float(), kb.float(), vb.float(), rel)
        torch.cuda.synchronize()
        if out.dtype != torch.float32 or outb.dtype != torch.bfloat16 or out.shape != q.shape:
            fail(f"fusion kernels: outputs {out.dtype} {outb.dtype} {tuple(out.shape)}")
        e = {"f32": (out - ref).abs().max().item(),
             "f32 vs f64": (out.double() - ref64).abs().max().item(),
             "plain f32 vs f64": (ref.double() - ref64).abs().max().item(),
             "bf16": _rel(outb.float(), refb)}
        for k, v in e.items():
            worst[k] = max(worst[k], v)
        print(f"  B={B} C={C:3d} {h}x{w}: f32 {e['f32']:.2e} (vs f64 {e['f32 vs f64']:.2e}, "
              f"plain {e['plain f32 vs f64']:.2e}); bf16 {e['bf16']:.2e} of max")
        if not (e["f32"] <= TOL_ATTN_FWD and e["f32 vs f64"] <= TOL_ATTN_FWD
                and e["bf16"] <= TOL_ATTN_BF16):
            fail(f"fusion kernels: #3 disagrees with the plain version at B={B} C={C} {h}x{w}")
        del q, kp, vp, rel, out, ref, ref64, qb, kb, vb, outb, refb
    torch.cuda.empty_cache()
    print(f"fusion kernels: {2 * len(shapes)} cases ok in {time.perf_counter() - t0:.1f} s; "
          + ", ".join(f"worst {k} {v:.3e}" for k, v in worst.items()))
    return worst


def fusion_kernel_times(dev, card):
    """Phase 22 (c): #3 per call at each fusion shape at B=8, float32 (the
    evaluation's batches), beside the plain attend3 and the bound (phase
    17's timing and cost); and per run the sums over one batch's calls.
    Returns {label: {ms, plain_ms, bound_ms, bound_by}} of a batch."""
    import torch

    from ssde_tpu_torch.ops.attention_win import attend3_fwd, attend3_reference

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    cpu_gen = torch.Generator().manual_seed(SEED + 23)
    B, elem = EVAL_BATCH, 4
    per_shape = {}
    print(f"fusion attend3 times on {card}, B={B} float32 (CUDA events, 10 launches after 2 "
          f"warm-up, order plain, kernel, kernel, plain; bound: the larger of the bytes (q, kp, "
          f"vp read, out written) over 3.35 TB/s and {ATTN_OPS_FWD} float32 operations per "
          f"value over 67 TFLOP/s; library: none)")
    shapes = sorted({c for label, _, _ in FUSION_RUNS for c in fusion_attention(label, H, W)},
                    key=lambda c: (c[0], -c[1]))
    for C, h, w in shapes:
        q, kp, vp, _, _ = _attn_operands(dev, B, C, h, w, gen)
        rel = _shared_rel(C, cpu_gen).to(dev)
        t = [cuda_ms(fn, iters=10, warmup=2) for fn in (
            lambda: attend3_reference(q, kp, vp, rel), lambda: attend3_fwd(q, kp, vp, rel),
            lambda: attend3_fwd(q, kp, vp, rel), lambda: attend3_reference(q, kp, vp, rel))]
        n_out, n_pad = B * C * h * w, B * C * (h + 2) * (w + 2)
        cost = (ATTN_OPS_FWD * n_out, elem * (2 * n_out + 2 * n_pad) + 36 * C)
        per_shape[(C, h, w)] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2) + cost
        bms, by = bound(*cost, "float32")
        print(f"  C={C:3d} {h}x{w}: kernel {per_shape[(C, h, w)][0]:.4f} ms, plain "
              f"{per_shape[(C, h, w)][1]:.4f} ms, bound {bms:.4f} ms ({by}; "
              f"{cost[1] / per_shape[(C, h, w)][0] / 1e6:.0f} GB/s) [{card}]")
        del q, kp, vp, rel
    torch.cuda.empty_cache()
    out = {}
    for label, _, _ in FUSION_RUNS:
        calls = fusion_attention(label, H, W)
        if not calls:
            continue
        tk, tp, flops, nbytes = (sum(per_shape[c][i] for c in calls) for i in range(4))
        bms, by = bound(flops, nbytes, "float32")
        out[label] = {"ms": tk, "plain_ms": tp, "bound_ms": bms, "bound_by": by}
        print(f"fusion attend3: one {label} batch ({len(calls)} calls) at B={B} float32: "
              f"kernel {tk:.4f} ms, plain {tp:.4f} ms, bound {bms:.4f} ms ({by}; "
              f"{nbytes / 1e9:.3f} GB) [{card}]")
    return out


def fusion_serving(dev, card, root, data, splits):
    """Phase 22: the 3-frame fusion models in serving, on phase 19's tree
    with phase 20's eigen-style list and gt_depths.npz (``splits``): (a)
    #3 at the fusion shapes; (b) scripts/evaluate_depth_fusion's main() for
    pyramid, v3, v3 --disable_attention and scale_loop on seed-0 weights
    that save_folder wrote (ResNet18, 640x192, float32, TF32 off): finite
    disparities, the metrics printed, attend3 launches per batch, card vs
    CPU on FUSION_CPU_ITEMS items (phase 4's bound); (c) the prediction
    loop's frames/s and device idle share, and #3's times. Returns
    (attend3 launches of the main path, the worst errors of (a), the times
    of (c))."""
    import torch

    from ssde_tpu_torch import checkpoint
    from ssde_tpu_torch.config import MonodepthOptions, Options
    from ssde_tpu_torch.data.kitti import KITTIRAWDataset
    from ssde_tpu_torch.data.pipeline import collate, to_device
    from ssde_tpu_torch.data.transforms import preprocess_batch
    from ssde_tpu_torch.models.resnet import randomize_bn_stats_
    from ssde_tpu_torch.scripts import evaluate_depth_fusion
    from ssde_tpu_torch.train.steps_fusion import (CONTEXT_IDS, build_fusion_models,
                                                   fusion_infer)

    phase0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = fusion_kernels(dev)
    os.environ["SSDE_SPLITS_DIR"] = splits
    with open(os.path.join(splits, "eigen", "test_files.txt")) as f:
        lines = f.read().splitlines()
    n_items = len(lines)
    n_batches = -(-n_items // evaluate_depth_fusion.BATCH)
    counters = _gru_counters()
    total = 0
    for label, variant, extra in FUSION_RUNS:
        opts = Options(height=H, width=W, disable_attention="--disable_attention" in extra)
        gen = torch.Generator().manual_seed(SEED)
        models = build_fusion_models(opts, variant, "cpu", gen)
        randomize_bn_stats_(models.encoder, gen)
        weights = os.path.join(root, "fusion_" + label.replace(" --", "_"))
        checkpoint.save_folder(weights, models, height=H, width=W)
        del models
        argv = ["--fusion_variant", variant, "--data_path", data, "--load_weights_folder",
                weights, "--height", str(H), "--width", str(W), *extra]
        seen = []
        score = evaluate_depth_fusion.evaluate_depth_predictions
        evaluate_depth_fusion.evaluate_depth_predictions = lambda d, *a, **k: (  # noqa: E731
            seen.append(d), score(d, *a, **k))[1]
        try:
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            metrics = evaluate_depth_fusion.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: fn.launches for k, fn in counters.items()}
        finally:
            evaluate_depth_fusion.evaluate_depth_predictions = score
        disps = seen[0]
        want = {k: (FUSION_ATTEND3[label] * n_batches if k == "attend3_fwd" else 0)
                for k in counters}
        total += launched["attend3_fwd"]
        names = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
        print(f"fusion: evaluate_depth_fusion {label}, {n_items} items in {n_batches} batches "
              f"of {evaluate_depth_fusion.BATCH}, {H}x{W} float32 (TF32 off): main() {wall:.2f} s "
              f"({n_items / wall:.1f} frames/s, building, loading, the ground truth and the "
              f"metrics included); " + " ".join(f"{n} {metrics[n]:.4f}" for n in names)
              + f"; scaled disparity [{disps.min():.4f}, {disps.max():.4f}]; launches "
              f"{ {k: v for k, v in launched.items() if v} } (expected attend3_fwd "
              f"{FUSION_ATTEND3[label]} a batch) [{card}]")
        if disps.shape != (n_items, H, W) or not np.isfinite(disps).all():
            fail(f"fusion {label}: disparities {disps.shape} not finite")
        if launched != want:
            fail(f"fusion {label}: launches {launched}, expected {want}")
        if np.abs(disps - disps[0]).max() == 0:
            fail(f"fusion {label}: every item gave one disparity")

        # the prediction loop alone: frames/s and the device's idle share
        opt = MonodepthOptions().parse(argv[2:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_depth_fusion.predict_disps(opt, variant, dev)
        torch.cuda.synchronize()
        loop = time.perf_counter() - t0
        busy, wall_ms, _ = _device_idle_share(
            lambda: evaluate_depth_fusion.predict_disps(opt, variant, dev), 1)
        print(f"fusion: {label} prediction loop (the loader's batches of "
              f"{evaluate_depth_fusion.BATCH} from the JPEGs, {opt.num_workers} threads on "
              f"{os.cpu_count()} cores): {n_items / loop:.1f} frames/s over {n_items} (host "
              f"clock, building and loading included); device busy {busy:.1f} ms of "
              f"{wall_ms:.1f}: idle share {1 - busy / wall_ms:.1%} [{card}]")

        # the card against the CPU on the same items
        ds = KITTIRAWDataset(data, lines[:FUSION_CPU_ITEMS], H, W, frame_idxs=list(CONTEXT_IDS),
                             is_train=False, load_depth=False)
        batch = collate([ds[i] for i in range(FUSION_CPU_ITEMS)])
        out = {}
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            models = evaluate_depth_fusion.load_fusion_models(opt, variant, where)
            inputs = preprocess_batch(to_device(batch, where), H, W, opt.num_scales,
                                      list(CONTEXT_IDS), is_train=False)
            t0 = time.perf_counter()
            out[side] = fusion_infer(models, inputs)["disp/0"].cpu()
            out[side + " s"] = time.perf_counter() - t0
        diff = (out["card"] - out["cpu"]).abs().max().item()
        rel = diff / out["cpu"].abs().max().item()
        print(f"fusion: {label} card vs CPU on {FUSION_CPU_ITEMS} items, float32, TF32 off: "
              f"max |d disp| {diff:.3e}, {rel:.3e} of the largest (bound "
              f"{TOL_EVAL_CARD_VS_CPU}; CPU {out['cpu s']:.1f} s)")
        if not rel <= TOL_EVAL_CARD_VS_CPU:
            fail(f"fusion {label}: the card and the CPU disagree on the disparity")
    times = fusion_kernel_times(dev, card)
    print(f"fusion: phase 22 took {time.perf_counter() - phase0:.1f} s; attend3 launches of "
          f"its main path {total} [{card}]")
    return total, errs, times


# =============================================================== fusion training

# phase 23's runs of the fusion trainers through their entry points: (label,
# script module, extra arguments); scale_loop's FusionScaleLoopTrainer has
# no script and is built from its class
FUSION_TRAIN_RUNS = (("pyramid", "train_fusion", []), ("v3", "train_fusion_v3", []),
                     ("v3 --disable_attention", "train_fusion_v3", ["--disable_attention"]),
                     ("rn_fusion", "train_dpt", ["--model", "rn_fusion"]),
                     ("scale_loop", None, []))
FUSION_CPU_HW = (64, 128)  # phase 23 (c): card vs CPU, B=2
# phase 23 (c) and (d) hold a gradient tensor whose max is below this share
# of its module's largest against that share instead: the 2-channel
# attention units of a seeded fusion model have near-dead channels whose
# gradients (a rel_w of 4e-9, a query bias of 1e-20 in float64) are sums of
# cancelling module-sized terms, which float32 rounds to 2e-3 of their own
# size (v3 at 64x128 on the CPU, where the card's kernels do not run)
FUSION_GRAD_FLOOR = 1e-3
FUSION_KITTI_STEPS = 3  # phase 23 (d): the seq list's batches


def fusion_bwd_kernels(dev, card):
    """Phase 23 (a): kernel #4 against autograd of the plain attend3 at every
    attention shape of the fusion models at 640x192, with channel-shared
    embedding tables, at B=1 and the trainers' B=12: float32 against a
    float64 run (TOL_ATTN_GRAD of each gradient's max; the plain float32
    version's own error shown), bf16 against float32 on the bf16-rounded
    operands (TOL_ATTN_BF16, dq, dkp, dvp and drel each); then #4 per call at
    B=12 bf16 (the trainers' configuration) beside the plain backward and
    the bound, and per variant the sums over one step's calls. Returns (the
    worst errors, {label: {ms, plain_ms, bound_ms, bound_by}} of a step)."""
    import torch

    from ssde_tpu_torch.ops.attention_win import attend3_bwd, attend3_reference

    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    cpu_gen = torch.Generator().manual_seed(SEED + 24)
    shapes = sorted({c for label, _, _ in FUSION_RUNS for c in fusion_attention(label, H, W)},
                    key=lambda c: (c[0], -c[1]))
    names = ("dq", "dkp", "dvp", "drel")
    print(f"fusion bwd kernels: #4 against autograd of the plain attend3 at the fusion models' "
          f"{len(shapes)} attention shapes at B=1 and {MONO_B}, shared embedding tables; "
          f"bounds: float32 {TOL_ATTN_GRAD} of each gradient's max against float64, bf16 "
          f"{TOL_ATTN_BF16} of max against float32 on the bf16-rounded operands")
    worst = {"f32": 0.0, "plain f32": 0.0, **{f"bf16 {n}": 0.0 for n in names}}
    t0 = time.perf_counter()
    for (C, h, w), B in itertools.product(shapes, (1, MONO_B)):
        q, kp, vp, _, g = _attn_operands(dev, B, C, h, w, gen)
        rel = _shared_rel(C, cpu_gen).to(dev)
        got = attend3_bwd(q, kp, vp, rel, g)
        want = _attn_plain_grads(*(t.double() for t in (q, kp, vp, rel, g)))
        plain = _attn_plain_grads(q, kp, vp, rel, g)
        qb, kb, vb, gb = (t.bfloat16() for t in (q, kp, vp, g))
        gotb = attend3_bwd(qb, kb, vb, rel, gb)
        wantb = _attn_plain_grads(qb.float(), kb.float(), vb.float(), rel, gb.float())
        torch.cuda.synchronize()
        if [a.dtype for a in got] != [torch.float32] * 4 or [a.dtype for a in gotb] != [
                torch.bfloat16] * 3 + [torch.float32]:
            fail(f"fusion bwd kernels: dtypes {[a.dtype for a in got + gotb]}")
        e = {"f32": max(_rel(a.double(), b) for a, b in zip(got, want)),
             "plain f32": max(_rel(a.double(), b) for a, b in zip(plain, want)),
             **{f"bf16 {n}": _rel(a.float(), b) for n, a, b in zip(names, gotb, wantb)}}
        for k, v in e.items():
            worst[k] = max(worst[k], v)
        print(f"  B={B:2d} C={C:3d} {h}x{w}: f32 {e['f32']:.2e} of max against float64 (plain "
              f"{e['plain f32']:.2e}); bf16 " + ", ".join(f"{n} {e['bf16 ' + n]:.2e}"
                                                          for n in names))
        if not (e["f32"] <= TOL_ATTN_GRAD and all(e[f"bf16 {n}"] <= TOL_ATTN_BF16
                                                  for n in names)):
            fail(f"fusion bwd kernels: #4 disagrees with the plain version at B={B} C={C} "
                 f"{h}x{w}")
        del q, kp, vp, rel, g, got, want, plain, qb, kb, vb, gb, gotb, wantb
    torch.cuda.empty_cache()
    print(f"fusion bwd kernels: {2 * len(shapes)} cases ok in {time.perf_counter() - t0:.1f} s; "
          + ", ".join(f"worst {k} {v:.3e}" for k, v in worst.items()))

    B, elem = MONO_B, 2
    print(f"fusion attend3_bwd times on {card}, B={B} bf16 (CUDA events, 10 launches after 2 "
          f"warm-up, order plain, kernel, kernel, plain; plain: autograd of the plain forward, "
          f"which it runs too; bound: the larger of the bytes (q, kp, vp, g read, dq, dkp, dvp "
          f"written, bf16; drel) over 3.35 TB/s and {ATTN_OPS_BWD} float32 operations per value "
          f"over 67 TFLOP/s; library: none)")
    per_shape = {}
    for C, h, w in shapes:
        q, kp, vp, rel, g = (t.bfloat16() if t.dim() == 4 else t
                             for t in _attn_operands(dev, B, C, h, w, gen))
        rel = _shared_rel(C, cpu_gen).to(dev)
        leaves = [t.detach().requires_grad_() for t in (q, kp, vp, rel)]
        kernel = lambda: attend3_bwd(q, kp, vp, rel, g)  # noqa: E731
        ref = lambda: torch.autograd.grad(attend3_reference(*leaves), leaves, g)  # noqa: E731
        t = [cuda_ms(fn, iters=10, warmup=2) for fn in (ref, kernel, kernel, ref)]
        n_out, n_pad = B * C * h * w, B * C * (h + 2) * (w + 2)
        cost = (ATTN_OPS_BWD * n_out, elem * (3 * n_out + 4 * n_pad) + 72 * C)
        per_shape[(C, h, w)] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2) + cost
        bms, by = bound(*cost, "float32")
        print(f"  C={C:3d} {h}x{w}: kernel {per_shape[(C, h, w)][0]:.4f} ms, plain "
              f"{per_shape[(C, h, w)][1]:.4f} ms, bound {bms:.4f} ms ({by}; "
              f"{cost[1] / per_shape[(C, h, w)][0] / 1e6:.0f} GB/s) [{card}]")
        del q, kp, vp, rel, g, leaves
    torch.cuda.empty_cache()
    times = {}
    for label, _, _ in FUSION_RUNS:
        calls = fusion_attention(label, H, W)
        if not calls:
            continue
        tk, tp, flops, nbytes = (sum(per_shape[c][i] for c in calls) for i in range(4))
        bms, by = bound(flops, nbytes, "float32")
        times[label] = {"ms": tk, "plain_ms": tp, "bound_ms": bms, "bound_by": by}
        print(f"fusion attend3_bwd: one {label} step ({len(calls)} calls) at B={B} bf16: kernel "
              f"{tk:.4f} ms, plain {tp:.4f} ms, bound {bms:.4f} ms ({by}; {nbytes / 1e9:.3f} GB) "
              f"[{card}]")
    return worst, times


def _fusion_main(script):
    """The entry point's main() of a phase 23 run: the script's, or for
    scale_loop the trainer class built and trained as a script would."""
    import importlib

    from ssde_tpu_torch.config import MonodepthOptions
    from ssde_tpu_torch.train.trainer import FusionScaleLoopTrainer

    if script is not None:
        return importlib.import_module(f"ssde_tpu_torch.scripts.{script}").main

    def main(argv):
        trainer = FusionScaleLoopTrainer(MonodepthOptions().parse(argv))
        trainer.train()
        return trainer
    return main


def _moved(obs, trainer):
    """(modules of the trainer with no parameter moved, the unchanged
    parameters that had a gradient in the last step): every module moves,
    and a parameter stays only where no gradient reached it (Fusion_v3's
    last upscale conv; a 2-channel attention unit's dead channel)."""
    import torch

    start = {id(p): a for a, p in zip(obs.start, trainer.models.parameters())}
    still, stuck = [], []
    for m in trainer.models.modules():
        ps = [p for p in m.parameters() if id(p) in start]
        same = [torch.equal(start[id(p)], p) for p in ps]
        if all(same):
            still.append(type(m).__name__)
        stuck += [p for p, s in zip(ps, same)
                  if s and p.grad is not None and p.grad.abs().max() > 1e-6]
    return still, stuck


def fusion_train_runs(dev, card):
    """Phase 23 (b): each fusion trainer through its entry point's main() at
    640x192, B=12, bf16 (the Options defaults), synthetic data, one epoch:
    finite losses, every module moved, the launches per step; then the step
    alone (CUDA events, chained after warm-up, as phase 9): ms, samples/s,
    peak memory, the device idle share. Returns the launches of the runs."""
    import torch

    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.train.steps_fusion import TRAIN_FRAMES
    from ssde_tpu_torch.train.trainer import (FusionScaleLoopTrainer, FusionTrainer,
                                              FusionV3Trainer)

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    classes = {"pyramid": FusionTrainer, "scale_loop": FusionScaleLoopTrainer}
    counters = _gru_counters()
    total = dict.fromkeys(counters, 0)
    log = tempfile.mkdtemp(prefix="ssde_fusion_log_")
    batch = make_synthetic_batch(MONO_B, H, W, frame_idxs=TRAIN_FRAMES, seed=SEED)
    try:
        for label, script, extra in FUSION_TRAIN_RUNS:
            cls = classes.get(label, FusionV3Trainer)
            argv = ["--synthetic_data", "--num_epochs", "1", "--mono_pretrained", "0",
                    "--log_dir", log, "--model_name", label.replace(" --", "_"), *extra]
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            with _Observed(cls) as obs:
                trainer = _fusion_main(script)(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: fn.launches for k, fn in counters.items()}
            for k, v in launched.items():
                total[k] += v
            steps, vals = len(obs.history), len(obs.vals)
            n = FUSION_ATTEND3["v3" if label == "rn_fusion" else label]
            want = {**dict.fromkeys(counters, 0), "attend3_fwd": n * (steps + vals),
                    "attend3_bwd": n * steps, "warp_family_fwd": 2 * (steps + vals),
                    "warp_family_bwd": 2 * steps, "photometric_fwd": steps + vals,
                    "photometric_bwd": steps}
            still, stuck = _moved(obs, trainer)
            opt = trainer.opt
            print(f"fusion train {label}: main() {wall:.1f} s ({type(trainer).__name__}, "
                  f"{opt.height}x{opt.width} B={opt.batch_size} {opt.compute_dtype}, frames "
                  f"{trainer._frame_idxs()}; build, {steps} steps, {vals} val(), save): losses "
                  + " ".join(f"{h['loss']:.5f}" for h in obs.history)
                  + f"; launches {({k: v for k, v in launched.items() if v})} (attend3 "
                  f"{n}/{n} a step); {len(obs.start)} trained parameters [{card}]")
            if type(trainer) is not cls or (opt.batch_size, opt.height, opt.width,
                                             opt.compute_dtype) != (MONO_B, H, W, "bfloat16"):
                fail(f"fusion train {label}: {type(trainer).__name__} at {opt}")
            if not steps or not all(np.isfinite(v) for h in obs.history for v in h.values()):
                fail(f"fusion train {label}: {steps} steps, or a loss is not finite")
            if launched != want:
                fail(f"fusion train {label}: launches {launched}, expected {want}")
            if still or stuck:
                fail(f"fusion train {label}: modules that did not move {still}, "
                     f"{len(stuck)} parameters with a gradient that did not move")

            # the step alone: chained steps on one batch on the card
            models, state = trainer.models, trainer.state
            dbatch = to_device(batch, dev)
            rng = torch.Generator(dev).manual_seed(SEED)
            step = lambda: trainer.step_fn(models, state, dbatch, rng)  # noqa: E731
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0
            k = 5
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(k):
                losses = step()
            end.record()
            last = float(losses["loss"])
            ms = start.elapsed_time(end) / k
            per = {name: fn.launches / k for name, fn in counters.items() if fn.launches}
            peak = torch.cuda.max_memory_allocated() / 2**30
            busy, pwall, _ = _device_idle_share(step, IDLE_STEPS)
            print(f"fusion train {label} step B={MONO_B} {H}x{W} bf16: {ms:.3f} ms, "
                  f"{MONO_B * 1e3 / ms:.2f} samples/s (mean of {k} chained after 2 warm-up; "
                  f"last loss {last:.5f}); launches a step {per}; peak memory {peak:.2f} GiB; "
                  f"device busy {busy:.1f} ms over {IDLE_STEPS} profiled steps: idle share "
                  f"{1 - busy / (IDLE_STEPS * ms):.1%} of {IDLE_STEPS} unprofiled steps, "
                  f"{1 - busy / pwall:.1%} of the profiled wall ({pwall:.1f} ms) [{card}]")
            if not np.isfinite(last) or per.get("attend3_fwd", 0) != n or per.get(
                    "attend3_bwd", 0) != n:
                fail(f"fusion train {label} step: loss {last}, launches a step {per}")
            del trainer, models, state, dbatch, obs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(log, ignore_errors=True)
        torch.backends.cudnn.allow_tf32 = False
    return total


def _fusion_step_run(opts, variant, batch, where, net, fusion_dtype, loss_dtype, select,
                     pin=None):
    """One fusion step (forward and backward, without Adam) on ``where``
    with the encoders, decoder and pose networks in ``net``, the fusion
    module in ``fusion_dtype`` (its relus through ``pin``) and the geometry,
    warp and loss in ``loss_dtype``; ``select`` replaces the automask's
    minimum. Returns (losses, gradients by (module, name) as float64 on the
    CPU)."""
    import torch

    import ssde_tpu_torch.train.steps as steps
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.train import steps_fusion

    models = steps_fusion.build_fusion_models(opts, variant, where,
                                              torch.Generator().manual_seed(SEED))
    for m in (models.encoder, models.depth, models.pose_encoder, models.pose):
        m.to(net)
    models.fusion.to(fusion_dtype)
    forward = models.fusion.forward
    cast = lambda x: ({k: v.to(fusion_dtype) for k, v in x.items()}  # noqa: E731
                      if isinstance(x, dict) else x.to(fusion_dtype))

    def fusion_forward(*args):
        with pin.active() if pin else contextlib.nullcontext():
            return forward(*map(cast, args))

    models.fusion.forward = fusion_forward
    if pin:
        pin.start(replay=fusion_dtype != torch.float64)
    inputs = steps_fusion.preprocess_fusion_train(to_device(batch, where), opts)
    inputs = {k: v.to(net) if k.startswith("color_aug") else
              v.to(loss_dtype) if v.is_floating_point() else v for k, v in inputs.items()}
    models.train()
    patched = {"min_reprojection": select or steps.min_reprojection,
               "_full": lambda t: t.to(loss_dtype)}
    plain = {k: getattr(steps, k) for k in patched}
    try:
        for k, v in patched.items():
            setattr(steps, k, v)
        _, losses, _ = steps_fusion.fusion_loss_fn(models, inputs)
        losses["loss"].backward()
    finally:
        for k, v in plain.items():
            setattr(steps, k, v)
    groups = dict(zip(("encoder", "depth", "fusion", "pose_encoder", "pose"), models.modules()))
    trained = {id(p) for p in models.parameters()}
    grads = {(g, k): (torch.zeros(p.shape, dtype=torch.float64) if p.grad is None
                      else p.grad.detach().cpu().double())
             for g, m in groups.items() for k, p in m.named_parameters() if id(p) in trained}
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def fusion_card_vs_cpu(dev):
    """Phase 23 (c): one fusion step of each variant at 64x128, B=2, card vs
    CPU and each against an all-float64 CPU run, by phase 12 (b)'s recipe:
    the networks in float64, the fusion module and the loss in float32 (the
    kernels on the card, their plain versions on the CPU), the fusion
    module's relu masks and the automask argmin from the float64 run.
    Bounds: losses TOL_STEP_LOSS relative; each gradient TOL_STEP_GRAD of
    its float64 max, or of FUSION_GRAD_FLOOR of its module's largest where
    its max is below that."""
    import torch

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.train.steps_fusion import TRAIN_FRAMES

    h, w = FUSION_CPU_HW
    batch = make_synthetic_batch(2, h, w, frame_idxs=TRAIN_FRAMES, seed=SEED + 3)
    f32, f64 = torch.float32, torch.float64
    for label, variant, extra in FUSION_RUNS:
        opts = Options(height=h, width=w, batch_size=2, compute_dtype="float32",
                       disable_attention="--disable_attention" in extra)
        selected, switches = [], {}

        def pinned(name):
            switches[name] = []
            return _selection(selected, switches=switches[name])

        pin = _ReluPin()
        t0 = time.perf_counter()
        l64, g64 = _fusion_step_run(opts, variant, batch, "cpu", f64, f64, f64,
                                    _selection(record=selected), pin)
        lg, gg = _fusion_step_run(opts, variant, batch, dev, f64, f32, f32, pinned("card"), pin)
        lc, gc = _fusion_step_run(opts, variant, batch, "cpu", f64, f32, f32, pinned("CPU"),
                                  pin)
        secs = time.perf_counter() - t0
        lrel = {"card vs CPU": max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc),
                "card vs float64": max(abs(lg[k] - l64[k]) / abs(l64[k]) for k in l64),
                "CPU vs float64": max(abs(lc[k] - l64[k]) / abs(l64[k]) for k in l64)}
        ok = max(lrel.values()) <= TOL_STEP_LOSS and all(np.isfinite(v) for v in lg.values())
        rows = []
        for grp in ("encoder", "depth", "fusion", "pose_encoder", "pose"):
            keys = [k for k in g64 if k[0] == grp]
            size = {k: g64[k].abs().max().item() for k in keys}
            scale = {k: max(size[k], FUSION_GRAD_FLOOR * max(size.values())) for k in keys}

            def err(a, b):  # worst over the group of |a - b| / scale
                return max((a[k] - b[k]).abs().max().item() / scale[k] for k in keys)

            e = {"card vs CPU": err(gg, gc), "card vs float64": err(gg, g64),
                 "CPU vs float64": err(gc, g64)}
            ok = ok and max(e.values()) <= TOL_STEP_GRAD
            rows.append(f"{grp} " + "/".join(f"{v:.2e}" for v in e.values()))
        print(f"fusion card vs CPU {label}: one step at {h}x{w} B=2 (networks float64, fusion "
              f"and loss float32; {secs:.1f} s): loss card {lg['loss']:.8f}, CPU "
              f"{lc['loss']:.8f}, float64 {l64['loss']:.8f}; worst rel " + ", ".join(
                  f"{k} {v:.2e}" for k, v in lrel.items()) + f" (bound {TOL_STEP_LOSS}); "
              f"automask switches " + ", ".join(f"{sum(v)} ({k})" for k, v in switches.items())
              + f"; relu flips {pin.flips}; gradients card vs CPU / card vs float64 / CPU vs "
              f"float64 of max (bound {TOL_STEP_GRAD}): " + "; ".join(rows))
        if not ok:
            fail(f"fusion card vs CPU {label}: the card and the CPU disagree")


def fusion_kitti(dev, card, root, data, splits):
    """Phase 23 (d): FusionV3Trainer through train_fusion_v3.main() for one
    epoch on phase 19's tree, with a train_files_seq.txt beside its lists:
    the seq list is the one read, phase 19's checks (finite losses, moved
    parameters, the 7 depth metrics of val(), the launches, weights_0 with
    fusion.pth), a trainer reloaded with no --models_to_load bit-identical
    and the further step within phase 8's tolerance (_kitti_reload); the
    loader's items/s over the list (4 JPEGs an item). Returns the run's
    launches."""
    import torch

    from ssde_tpu_torch.config import MonodepthOptions
    from ssde_tpu_torch.data.kitti import KITTIRAWDataset
    from ssde_tpu_torch.scripts import train_fusion_v3
    from ssde_tpu_torch.train.steps_fusion import TRAIN_FRAMES
    from ssde_tpu_torch.train.trainer import FusionV3Trainer

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    seq_path = os.path.join(splits, "eigen_zhou", "train_files_seq.txt")
    # frames whose neighbours -2 .. +1 all exist, unlike train_files.txt's first
    seq = [f"{KITTI_DRIVE} {i} l" for i in range(2, 2 + MONO_B * FUSION_KITTI_STEPS)]
    with open(seq_path, "w") as f:
        f.write("\n".join(seq) + "\n")
    counters = _gru_counters()
    try:
        parse = MonodepthOptions().parse
        argv = ["--data_path", data, "--num_epochs", "1", "--log_frequency", "2",
                "--mono_pretrained", "0", "--log_dir", os.path.join(root, "log"),
                "--model_name", "fusion_v3"]
        trainer, folder = _kitti_trainer_run(
            "fusion v3", FusionV3Trainer, train_fusion_v3.main, argv,
            ["encoder.pth", "depth.pth", "pose_encoder.pth", "pose.pth", "fusion.pth",
             "adam.pth"],
            ["attend3_fwd", "attend3_bwd", "warp_family_fwd", "warp_family_bwd",
             "photometric_fwd", "photometric_bwd"], card, gradless_ok=True)
        launched = {k: fn.launches for k, fn in counters.items()}
        read = trainer.train_dataset.filenames
        with open(os.path.join(splits, "eigen_zhou", "train_files.txt")) as f:
            plain = f.read().splitlines()
        print(f"kitti fusion v3: trained on {len(read)} lines, {read[0]!r} .. {read[-1]!r} "
              f"(train_files_seq.txt has {len(seq)} from {seq[0]!r}, train_files.txt "
              f"{len(plain)} from {plain[0]!r}) in {trainer.step} steps")
        if read != seq or trainer.step != FUSION_KITTI_STEPS:
            fail(f"kitti fusion v3: read {len(read)} lines in {trainer.step} steps, not the "
                 f"{len(seq)} of train_files_seq.txt")
        _kitti_reload("fusion v3", train_fusion_v3.build_trainer, parse, argv, trainer, folder,
                      card, FUSION_GRAD_FLOOR)
        del trainer
        torch.cuda.empty_cache()
        rate = _loader_rate(KITTIRAWDataset(data, seq, H, W, list(TRAIN_FRAMES), is_train=True),
                            parse([]).num_workers)
        print(f"kitti fusion loader (Loader, B={MONO_B}, frames {list(TRAIN_FRAMES)} at {H}x{W}, "
              f"4 JPEGs and depth_gt an item): {rate:.1f} items/s [{card}]")
    finally:
        os.remove(seq_path)
        torch.backends.cudnn.allow_tf32 = False
    return launched


def fusion_training(dev, card, root, data, splits):
    """Phase 23: fusion training. (a) #4 at the fusion shapes; (b) each
    trainer through its entry point; (c) card vs CPU; (d) the v3 trainer
    on phase 19's tree. Returns (launches of the main path, (b) and (d),
    by kernel; #4's worst errors; #4's times per step of each variant)."""
    import torch

    phase0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errs, times = fusion_bwd_kernels(dev, card)
    total = fusion_train_runs(dev, card)  # leaves TF32 off again
    fusion_card_vs_cpu(dev)
    for k, v in fusion_kitti(dev, card, root, data, splits).items():
        total[k] += v
    print(f"fusion: phase 23 took {time.perf_counter() - phase0:.1f} s; launches of its main "
          f"path {({k: v for k, v in total.items() if v})} [{card}]")
    return total, errs, times


# ==================================================== train_dpt: DPT and attention

# phase 24's runs of train_dpt.main(): (label, extra arguments, trainer class
# name, the depth network's module files in weights_0)
DPT_TRAIN_RUNS = (("dpt_gru", [], "DPTTrainer", ("dpt",)),
                  ("rn_encoder_with_attention", ["--model", "rn_encoder_with_attention"],
                   "AttentionTrainer", ("encoder", "depth")))
DPT_CPU_HW = (64, 128)  # phase 24 (d): card vs CPU, B=2
# the DPT step's photometric launch: scale 0 only, 2 sources, warped and
# identity maps: G = (S + 1) * F * B with S = 1, F = 2
DPT_G = 4 * MONO_B


def dpt_kernels(dev, card):
    """Phase 24 (a): the family warp (#7, forward and grid gradient) at S = 1
    (the DPT step warps one full-resolution disparity per source) and the
    photometric forward and
    backward (#5/#6) at the DPT step's G = 4B = 48, B=12, 640x192, against
    their plain versions (phase 6's tolerances), then each timed beside its
    plain version, the bound and a library call where one computes the same
    function. Returns (worst errors, times) by kernel."""
    import torch

    from ssde_tpu_torch.ops.photometric import (photometric_bwd, photometric_bwd_reference,
                                                photometric_fwd, photometric_reference, work)

    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    B, S = MONO_B, 1
    img = torch.rand(B, 3, H, W, device=dev, generator=gen)
    grids = _mono_grids(dev, B, H, W, gen, S=S)
    cot = torch.randn(S * B, 3, H, W, device=dev, generator=gen)
    werr, gerr, gabs, got = _warp_errs(img, grids, cot)
    # the step's pairs: the 2 warped maps of each item, then the 2 identity maps
    preds = torch.cat([got] + [torch.rand(B, 3, H, W, device=dev, generator=gen)
                               for _ in range(DPT_G // B - S)]).contiguous()
    gout = torch.randn(DPT_G, H, W, device=dev, generator=gen) / preds[0].numel()
    with torch.no_grad():
        pf, pf_ref = photometric_fwd(preds, img), photometric_reference(preds, img)
        pb, pb_ref = photometric_bwd(preds, img, gout), photometric_bwd_reference(preds, img, gout)
    torch.cuda.synchronize()
    ferr, berr = (pf - pf_ref).abs().max().item(), _rel(pb, pb_ref)
    errs = {"warp_family_fwd": werr, "warp_family_bwd": gabs, "photometric_fwd": ferr,
            "photometric_bwd": (pb - pb_ref).abs().max().item()}
    print(f"dpt kernels vs plain versions at B={B} {H}x{W}: warp S={S} abs {werr:.3e}, grid "
          f"grad rel {gerr:.3e} (bound {TOL_WARP}); photometric G={DPT_G} fwd abs {ferr:.3e} "
          f"(bound {TOL_PHOTO}), bwd rel {berr:.3e} (bound {TOL_PHOTO_BWD})")
    if not (werr <= TOL_WARP and gerr <= TOL_WARP and ferr <= TOL_PHOTO
            and berr <= TOL_PHOTO_BWD):
        fail("dpt kernels: a kernel disagrees with its plain version at the DPT step's shapes")

    pairs = {"photometric_fwd": (lambda: photometric_fwd(preds, img),
                                 lambda: photometric_reference(preds, img),
                                 work("fwd", DPT_G, B, 3, H, W)),
             "photometric_bwd": (lambda: photometric_bwd(preds, img, gout),
                                 lambda: photometric_bwd_reference(preds, img, gout),
                                 work("bwd", DPT_G, B, 3, H, W))}
    print(f"dpt kernel times on {card} (CUDA events; 20 launches after 3 warm-up, order plain, "
          f"kernel, kernel, plain; the warp's library calls: F.grid_sample border and aten's "
          f"grid_sampler_2d_backward for the grid; none for the photometric kernels)")
    times = warp_times(img, grids, cot, card, "the DPT step's")
    times["warp_family_bwd"].update({f"pair_{k}": v
                                     for k, v in times.pop("warp_family_pair").items()})
    with torch.no_grad():
        for name, (k, p, cost) in pairs.items():
            tp1, tk1, tk2, tp2 = cuda_ms(p), cuda_ms(k), cuda_ms(k), cuda_ms(p)
            bms, by = bound(*cost, "float32")
            times[name] = {"ms": (tk1 + tk2) / 2, "plain_ms": (tp1 + tp2) / 2, "bound_ms": bms,
                           "bound_by": by, "library_ms": None}
            print(f"  {name} B={B} G={DPT_G} {H}x{W}: kernel {times[name]['ms']:.4f} ms, plain "
                  f"{times[name]['plain_ms']:.4f} ms, library none, bound {bms:.4f} ms ({by}) "
                  f"[{card}]")
    del img, grids, cot, got, preds, gout, pf, pf_ref, pb, pb_ref
    torch.cuda.empty_cache()
    return errs, times


def _time_train_step(what, trainer, batch, dev, card, want):
    """The step of ``trainer`` alone, phases 24 and 25: 5 chained steps on
    one device batch after 2 warm-up (CUDA events), its launches a step
    (they must be ``want``), peak memory, the device's idle share over
    IDLE_STEPS profiled steps and the top device operations (also written
    to chiprun_out/). ``what`` starts the printed lines. Returns the ms."""
    import torch

    from ssde_tpu_torch.data.pipeline import to_device

    counters = _gru_counters()
    models, state = trainer.models, trainer.state
    dbatch = to_device(batch, dev)
    rng = torch.Generator(dev).manual_seed(SEED)
    step = lambda: trainer.step_fn(models, state, dbatch, rng)  # noqa: E731
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    k = 5
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(k):
        losses = step()
    end.record()
    last = float(losses["loss"])
    ms = start.elapsed_time(end) / k
    per = {name: fn.launches / k for name, fn in counters.items() if fn.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy, pwall, prof = _device_idle_share(step, IDLE_STEPS)
    print(f"{what} step B={MONO_B} {H}x{W} bf16: {ms:.3f} ms, "
          f"{MONO_B * 1e3 / ms:.2f} samples/s (mean of {k} chained after 2 warm-up; "
          f"last loss {last:.5f}); launches a step {per}; peak memory {peak:.2f} GiB; "
          f"device busy {busy:.1f} ms over {IDLE_STEPS} profiled steps: idle share "
          f"{1 - busy / (IDLE_STEPS * ms):.1%} of {IDLE_STEPS} unprofiled steps, "
          f"{1 - busy / pwall:.1%} of the profiled wall ({pwall:.1f} ms) [{card}]")
    if not np.isfinite(last) or per != want:
        fail(f"{what} step: loss {last}, launches a step {per}, expected {want}")
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=25)
    os.makedirs("chiprun_out", exist_ok=True)
    name = what.replace(" train ", "_profile_").replace(" ", "_")
    with open(os.path.join("chiprun_out", f"{name}.txt"), "w") as f:
        f.write(f"{card}\n{table}\n")
    print(f"  top device operations of the {what} step over {IDLE_STEPS} profiled steps:")
    for line in table.splitlines()[:12]:
        print("   ", line[:160])
    return ms


def dpt_train_runs(dev, card, log):
    """Phase 24 (b) and (c): train_dpt.main() with no --model (DPTTrainer)
    and with --model rn_encoder_with_attention at the Options defaults
    (640x192, B=12, bf16, synthetic data, one epoch of 8 steps and its
    val()): finite losses, every module moved, the launches (attend3 none:
    the attention encoder's 7x7 convs take the plain path); then the step
    alone as phase 23 times it (ms, samples/s, peak memory, idle share) and
    its top device operations. After the DPT's epoch, (e) on its
    weights_0 (:func:`dpt_resume`). Returns the launches of the runs."""
    import torch

    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.scripts import train_dpt
    from ssde_tpu_torch.train import trainer as trainer_mod

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    counters = _gru_counters()
    total = dict.fromkeys(counters, 0)
    batch = make_synthetic_batch(MONO_B, H, W, seed=SEED)
    try:
        for label, extra, cls_name, depth_files in DPT_TRAIN_RUNS:
            cls = getattr(trainer_mod, cls_name)
            argv = ["--synthetic_data", "--num_epochs", "1", "--mono_pretrained", "0",
                    "--log_dir", log, "--model_name", label, *extra]
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            with _Observed(cls) as obs:
                trainer = train_dpt.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: fn.launches for k, fn in counters.items()}
            for k, v in launched.items():
                total[k] += v
            steps, vals = len(obs.history), len(obs.vals)
            want = {**dict.fromkeys(counters, 0), "warp_family_fwd": 2 * (steps + vals),
                    "warp_family_bwd": 2 * steps, "photometric_fwd": steps + vals,
                    "photometric_bwd": steps}
            still, stuck = _moved(obs, trainer)
            opt = trainer.opt
            print(f"dpt train {label}: main() {wall:.1f} s ({type(trainer).__name__}, "
                  f"{opt.height}x{opt.width} B={opt.batch_size} {opt.compute_dtype}, frames "
                  f"{opt.frame_ids}, scales {opt.scales}; build, {steps} steps, {vals} val(), "
                  f"save): losses " + " ".join(f"{h['loss']:.5f}" for h in obs.history)
                  + f"; launches {({k: v for k, v in launched.items() if v})}; "
                  f"{len(obs.start)} trained parameters, "
                  f"{sum(p.numel() for p in trainer.models.parameters()) / 1e6:.1f} M values "
                  f"[{card}]")
            if type(trainer) is not cls or (opt.batch_size, opt.height, opt.width,
                                             opt.compute_dtype) != (MONO_B, H, W, "bfloat16"):
                fail(f"dpt train {label}: {type(trainer).__name__} at {opt}")
            if label == "dpt_gru" and (opt.model, opt.frame_ids, opt.scales) != (
                    "dpt_gru", [0, -1, 1], [0]):
                fail(f"dpt train: no --model gave {opt.model}, frames {opt.frame_ids}, "
                     f"scales {opt.scales}")
            if not steps or not all(np.isfinite(v) for h in obs.history for v in h.values()):
                fail(f"dpt train {label}: {steps} steps, or a loss is not finite")
            if launched != want:
                fail(f"dpt train {label}: launches {launched}, expected {want}")
            if still or stuck:
                fail(f"dpt train {label}: modules that did not move {still}, "
                     f"{len(stuck)} parameters with a gradient that did not move")
            folder = os.path.join(log, label, "models", "weights_0")
            files = sorted(os.listdir(folder))
            need = sorted(["adam.pth", "pose.pth", "pose_encoder.pth"]
                          + [f"{m}.pth" for m in depth_files])
            print(f"dpt train {label}: {folder}: {files}")
            if files != need:
                fail(f"dpt train {label}: weights_0 holds {files}, expected {need}")
            if label == "dpt_gru":  # (e), on the state that weights_0 holds
                dpt_resume(dev, card, trainer, folder, argv)

            _time_train_step(f"dpt train {label}", trainer, batch, dev, card,
                             {"warp_family_fwd": 2, "warp_family_bwd": 2, "photometric_fwd": 1,
                              "photometric_bwd": 1})
            del trainer, obs
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return total


def _step_run(models, loss_fn, opts, batch, where, net, loss_dtype, select):
    """One step of ``models`` (forward and backward, without Adam) on
    ``where`` with the networks in ``net`` and the geometry, warp and loss
    in ``loss_dtype`` (``steps._full``); ``select`` replaces the automask's
    minimum. Returns (losses, gradients by (module, name) as float64 on the
    CPU)."""
    import ssde_tpu_torch.train.steps as steps
    from ssde_tpu_torch.data.pipeline import to_device

    for m in models.modules():
        m.to(net)
    inputs = steps.preprocess_train(to_device(batch, where), opts)
    inputs = {k: v.to(net) if k.startswith("color_aug") else
              v.to(loss_dtype) if v.is_floating_point() else v for k, v in inputs.items()}
    models.train()
    patched = {"min_reprojection": select or steps.min_reprojection,
               "_full": lambda t: t.to(loss_dtype)}
    plain = {k: getattr(steps, k) for k in patched}
    try:
        for k, v in patched.items():
            setattr(steps, k, v)
        _, losses, _ = loss_fn(models, inputs)
        losses["loss"].backward()
    finally:
        for k, v in plain.items():
            setattr(steps, k, v)
    groups = [g for g in ("encoder", "depth", "dpt", "pose_encoder", "pose", "predictive_mask")
              if getattr(models, g, None) is not None]
    grads = {(g, k): p.grad.detach().cpu().double()
             for g in groups for k, p in getattr(models, g).named_parameters()}
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def _dpt_step_run(label, batch, where, net, loss_dtype, select):
    """:func:`_step_run` of ``label``'s model at 64x128, B=2."""
    import torch

    import ssde_tpu_torch.train.steps as steps
    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.train import steps_dpt

    h, w = DPT_CPU_HW
    gen = torch.Generator().manual_seed(SEED)
    if label == "dpt_gru":
        opts = Options(height=h, width=w, batch_size=2, compute_dtype="float32",
                       frame_ids=[0, -1, 1], scales=[0])
        models, loss_fn = steps_dpt.build_dpt_models(opts, where, gen), steps_dpt.dpt_loss_fn
    else:
        opts = Options(height=h, width=w, batch_size=2, compute_dtype="float32")
        models = steps.build_mono_models(opts, where, gen, attention_encoder=True)
        loss_fn = steps.mono_loss_fn
    return _step_run(models, loss_fn, opts, batch, where, net, loss_dtype, select)


def _hold_card_vs_cpu(what, dev, run):
    """One step by phase 8's recipe, card vs CPU and each against an
    all-float64 CPU run: ``run(where, net, loss_dtype, select)`` gives
    (losses, gradients by (module, name)); the float64 run records the
    automask argmin, the other two take it. Prints ``what``'s line and
    fails past TOL_STEP_LOSS (losses, relative) or TOL_STEP_GRAD (each
    gradient, of its float64 max)."""
    import torch

    f32, f64 = torch.float32, torch.float64
    selected, switches = [], {}

    def pinned(name):
        switches[name] = []
        return _selection(selected, switches=switches[name])

    t0 = time.perf_counter()
    l64, g64 = run("cpu", f64, f64, _selection(record=selected))
    lg, gg = run(dev, f64, f32, pinned("card"))
    lc, gc = run("cpu", f64, f32, pinned("CPU"))
    secs = time.perf_counter() - t0
    lrel = {"card vs CPU": max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc),
            "card vs float64": max(abs(lg[k] - l64[k]) / abs(l64[k]) for k in l64),
            "CPU vs float64": max(abs(lc[k] - l64[k]) / abs(l64[k]) for k in l64)}
    ok = max(lrel.values()) <= TOL_STEP_LOSS and all(np.isfinite(v) for v in lg.values())
    rows = []
    for grp in dict.fromkeys(k[0] for k in g64):
        keys = [k for k in g64 if k[0] == grp]
        e = {n: max(_rel(a[k], g64[k] if n != "card vs CPU" else gc[k]) for k in keys)
             for n, a in (("card vs CPU", gg), ("card vs float64", gg),
                          ("CPU vs float64", gc))}
        ok = ok and max(e.values()) <= TOL_STEP_GRAD
        rows.append(f"{grp} " + "/".join(f"{v:.2e}" for v in e.values()))
    print(f"{what} (networks float64, loss float32; {secs:.1f} s): loss card "
          f"{lg['loss']:.8f}, CPU {lc['loss']:.8f}, float64 {l64['loss']:.8f}; worst rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in lrel.items()) + f" (bound {TOL_STEP_LOSS}); "
          f"automask switches " + ", ".join(f"{sum(v)} ({k})" for k, v in switches.items())
          + f"; gradients card vs CPU / card vs float64 / CPU vs float64 of max (bound "
          f"{TOL_STEP_GRAD}): " + "; ".join(rows))
    if not ok:
        fail(f"{what}: the card and the CPU disagree")


def dpt_card_vs_cpu(dev):
    """Phase 24 (d): one step of each model at 64x128, B=2, card vs CPU and
    each against an all-float64 CPU run, by phase 8's and 23 (c)'s recipe:
    the networks in float64, the geometry, warp and loss in float32 (the
    kernels on the card, their plain versions on the CPU), the automask
    argmin of the float64 run. The networks run in float64 on both sides,
    so no relu mask needs pinning (phase 23 pins those of its float32 fusion
    module). Bounds: losses TOL_STEP_LOSS relative, each gradient
    TOL_STEP_GRAD of its float64 max."""
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch

    h, w = DPT_CPU_HW
    batch = make_synthetic_batch(2, h, w, seed=SEED + 5)
    for label, *_ in DPT_TRAIN_RUNS:
        _hold_card_vs_cpu(f"dpt card vs CPU {label}: one step at {h}x{w} B=2", dev,
                          lambda *a, label=label: _dpt_step_run(label, batch, *a))


def dpt_resume(dev, card, trainer, folder, argv):
    """Phase 24 (e): a DPTTrainer built on phase 24's weights_0 with the
    default --models_to_load (which does not name dpt) against the saved
    one: every module and Adam's state bit-identical, the step count too;
    then the attention maps of a forward at 640x192 (eval mode, float32):
    each sums to 1 over the keys, and get_mean_attention_map gives
    (B, 12, 40)."""
    import torch

    from ssde_tpu_torch.config import MonodepthOptions
    from ssde_tpu_torch.models.dpt import get_mean_attention_map
    from ssde_tpu_torch.scripts.train_dpt import build_trainer

    t0 = time.perf_counter()
    reloaded = build_trainer(MonodepthOptions().parse(argv + ["--load_weights_folder", folder]))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    a, b = _trainer_tensors(trainer), _trainer_tensors(reloaded)
    for i, (sa, sb) in enumerate(zip(trainer.state.optimizer.state.values(),
                                     reloaded.state.optimizer.state.values())):
        a.update({f"adam.{i}.{k}": v.detach().cpu() for k, v in sa.items()})
        b.update({f"adam.{i}.{k}": v.detach().cpu() for k, v in sb.items()})
    differ = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    steps = (trainer.state.step, reloaded.state.step, _adam_steps(trainer), _adam_steps(reloaded))
    print(f"dpt resume: {type(reloaded).__name__} built on {folder} with --models_to_load "
          f"{reloaded.opt.models_to_load} in {load_s:.1f} s (build and load) [{card}]: "
          f"{len(a) - len(differ)} of {len(a)} tensors bit-identical; Adam steps {steps[0]} / "
          f"{steps[1]} (per parameter {steps[2]} / {steps[3]})")
    if differ or a.keys() != b.keys() or steps[0] != steps[1] or steps[2] != steps[3] \
            or not any(k.startswith("0.") for k in a):
        fail(f"dpt resume: the reloaded trainer differs: {differ[:5]}, steps {steps}")
    del reloaded
    torch.cuda.empty_cache()
    dpt = trainer.models.dpt.eval()
    x = torch.rand(2, 3, H, W, device=dev, generator=torch.Generator(dev).manual_seed(SEED))
    with torch.no_grad():
        out = dpt(x, capture_attention=True)
    grid = (H // 16, W // 16)
    n = grid[0] * grid[1] + 1
    sums = {k: (v.sum(-1) - 1).abs().max().item() for k, v in out["attention"].items()}
    maps = {t: tuple(get_mean_attention_map(out["attention"]["attn_4"], t, grid).shape)
            for t in (1, -1)}
    shapes = {k: tuple(v.shape) for k, v in out["attention"].items()}
    print(f"dpt attention at {H}x{W}, B=2, float32: maps {shapes}, worst |sum over keys - 1| "
          + ", ".join(f"{k} {v:.2e}" for k, v in sums.items())
          + f"; get_mean_attention_map {maps}; disp/0 {tuple(out['disp/0'].shape)} in "
          f"[{out['disp/0'].min().item():.4f}, {out['disp/0'].max().item():.4f}]")
    if any(s != (2, 12, n, n) for s in shapes.values()) or max(sums.values()) > 1e-5 \
            or set(maps.values()) != {(2,) + grid}:
        fail("dpt attention: the maps do not have their shape or do not sum to 1")
    dpt.train()


def dpt_training(dev, card):
    """Phase 24: train_dpt for every model it did not train before. (a) #5,
    #6 and #7 at the DPT step's shapes; (b)-(c) train_dpt.main() with no
    --model (the DPT) and with rn_encoder_with_attention; (d) card vs CPU;
    (e) save, reload and resume, and the attention maps. Returns (launches
    of the main path, (b)-(c), by kernel; the worst errors and the times of
    (a))."""
    import torch

    phase0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errs, times = dpt_kernels(dev, card)
    log = tempfile.mkdtemp(prefix="ssde_dpt_log_")
    try:
        total = dpt_train_runs(dev, card, log)
        dpt_card_vs_cpu(dev)
    finally:
        shutil.rmtree(log, ignore_errors=True)
    print(f"dpt: phase 24 took {time.perf_counter() - phase0:.1f} s; launches of its main path "
          f"{({k: v for k, v in total.items() if v})} [{card}]")
    return total, errs, times



# phase 25: the Monodepth2 options of the mono step. (b): train_dpt.main()
# runs (label, extra arguments, the modules weights_0 holds beside encoder
# and depth, the warp sources)
OPTIONS_TRAIN_RUNS = (("ms", ["--use_stereo"], ("pose_encoder", "pose"), 3),
                      ("s", ["--use_stereo", "--frame_ids", "0"], (), 1))
# (c): one step at full width of every other configuration
OPTIONS_STEP_CONFIGS = (("posecnn", {"pose_model_type": "posecnn"}),
                        ("shared", {"pose_model_type": "shared"}),
                        ("pose_input_all", {"pose_model_input": "all"}),
                        ("predictive_mask", {"predictive_mask": True,
                                             "disable_automasking": True}),
                        ("v1_multiscale", {"v1_multiscale": True}),
                        ("no_ssim_avg", {"no_ssim": True, "avg_reprojection": True}))
# (d): every configuration card vs CPU
OPTIONS_CPU_CONFIGS = (("ms", {"use_stereo": True}),
                       ("s", {"use_stereo": True, "frame_ids": [0]})) + OPTIONS_STEP_CONFIGS
OPTIONS_CPU_HW = (64, 128)
# the MS step's photometric launch: 4 scales, 3 sources, the warped and the
# identity maps, G = (S + 1) * F * B = 180; under --v1_multiscale one launch a
# scale with G = 2 * F * B = 48 at that scale's size
OPTIONS_G, V1_G = (S_SCALES + 1) * 3 * MONO_B, 2 * 2 * MONO_B
V1_SIZES = tuple((H >> s, W >> s) for s in range(1, S_SCALES))


def _option_launches(kw):
    """The kernels' launches in one train step of the mono step under the
    options ``kw`` (Options fields): a warp per source (per scale and source
    under --v1_multiscale), one photometric forward and backward (one a
    scale under --v1_multiscale, none under --no_ssim); each warp's
    backward once."""
    temporal = [f for f in kw.get("frame_ids", [0, -1, 1]) if f != "s"]
    F = (2 if temporal != [0] else 0) + (1 if kw.get("use_stereo") else 0)
    v1 = kw.get("v1_multiscale", False)
    photo = 0 if kw.get("no_ssim") else (S_SCALES if v1 else 1)
    warps = F * (S_SCALES if v1 else 1)
    return {"warp_family_fwd": warps, "warp_family_bwd": warps, "photometric_fwd": photo,
            "photometric_bwd": photo}


def options_kernels(dev, card):
    """Phase 25 (a): the family warp (#7, forward and grid gradient) on the
    stereo source's grids (S = 4, B=12, 640x192: MS warps three sources) and
    at S = 1 on the
    --v1_multiscale sources (320x96, 160x48, 80x24), and the photometric
    forward and backward (#5/#6) at the MS step's G = 180 and at
    --v1_multiscale's G = 48 at those sizes, against their plain versions
    (phase 6's tolerances); then each timed beside its plain version, the
    bound and, for the warp, the library calls of the same functions, and the
    warp's host time a call at 80x24. Returns (worst errors, times by kernel
    and case)."""
    import torch

    from ssde_tpu_torch.ops.photometric import (photometric_bwd, photometric_bwd_reference,
                                                photometric_fwd, photometric_reference, work)
    from ssde_tpu_torch.ops.warp_banded import warp_family_fwd

    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    B = MONO_B
    errs = dict.fromkeys(("warp_family_fwd", "warp_family_bwd", "photometric_fwd",
                          "photometric_bwd"), 0.0)
    times = {k: {} for k in errs}
    warps = [("stereo_s4_640x192", torch.rand(B, 3, H, W, device=dev, generator=gen),
              _mono_grids(dev, B, H, W, gen, stereo=True))]
    warps += [(f"v1_s1_{w}x{h}", torch.rand(B, 3, h, w, device=dev, generator=gen),
               _mono_grids(dev, B, h, w, gen, S=1)) for h, w in V1_SIZES]
    photos = [(f"g{OPTIONS_G}_640x192", OPTIONS_G, H, W)]
    photos += [(f"v1_g{V1_G}_{w}x{h}", V1_G, h, w) for h, w in V1_SIZES]
    print(f"options kernels vs plain versions at B={B} (warp abs {TOL_WARP}, its grid "
          f"gradient {TOL_WARP} of max; photometric fwd abs {TOL_PHOTO}, bwd {TOL_PHOTO_BWD} "
          f"of max); times on {card} (CUDA events; 20 launches after 3 warm-up, order plain, "
          f"kernel, kernel, plain; the warp's library calls: F.grid_sample border over the S "
          f"grids and aten's grid_sampler_2d_backward for the grid)")

    def timed(name, case, k, p, lib, cost):
        with torch.no_grad():
            tp1, tk1, tk2, tp2 = cuda_ms(p), cuda_ms(k), cuda_ms(k), cuda_ms(p)
            tl = None if lib is None else cuda_ms(lib)
        bms, by = bound(*cost, "float32")
        entry = {"ms": (tk1 + tk2) / 2, "plain_ms": (tp1 + tp2) / 2, "bound_ms": bms,
                 "bound_by": by, "library_ms": tl}
        times[name].update({f"{case}_{key}": v for key, v in entry.items()})
        return entry

    for case, img, grids in warps:
        S, _, h, w, _ = grids.shape
        cot = torch.randn(S * B, 3, h, w, device=dev, generator=gen)
        werr, gerr, gabs, _ = _warp_errs(img, grids, cot)
        errs["warp_family_fwd"] = max(errs["warp_family_fwd"], werr)
        errs["warp_family_bwd"] = max(errs["warp_family_bwd"], gabs)
        print(f"  warp {case} S={S} B={B} {w}x{h}: abs {werr:.3e}, grid grad rel {gerr:.3e}")
        if not (werr <= TOL_WARP and gerr <= TOL_WARP):
            fail(f"options kernels: the warp disagrees with its plain version at {case}")
        t = warp_times(img, grids, cot, card, case)
        for key, v in t.pop("warp_family_pair").items():
            times["warp_family_bwd"][f"{case}_pair_{key}"] = v
        for name, entry in t.items():
            times[name].update({f"{case}_{key}": v for key, v in entry.items()})
        if case == f"v1_s1_{V1_SIZES[-1][1]}x{V1_SIZES[-1][0]}":  # the smallest: a floor?
            img_s = img.repeat(S, 1, 1, 1)
            with torch.no_grad():
                hk = host_us(lambda: warp_family_fwd(img, grids))
                hl = host_us(lambda: torch.nn.functional.grid_sample(
                    img_s, grids[0], padding_mode="border", align_corners=False))
            times["warp_family_fwd"][f"{case}_host_us"] = hk
            times["warp_family_fwd"][f"{case}_library_host_us"] = hl
            print(f"  host time a call, 300 unsynchronised calls at {case}: warp_family_fwd "
                  f"{hk:.1f} us, F.grid_sample {hl:.1f} us [{card}]")
        del cot
    for case, G, h, w in photos:
        preds = torch.rand(G, 3, h, w, device=dev, generator=gen)
        targ = torch.rand(B, 3, h, w, device=dev, generator=gen)
        gout = torch.randn(G, h, w, device=dev, generator=gen) / preds[0].numel()
        with torch.no_grad():
            pf, pf_ref = photometric_fwd(preds, targ), photometric_reference(preds, targ)
            pb, pb_ref = (photometric_bwd(preds, targ, gout),
                          photometric_bwd_reference(preds, targ, gout))
        torch.cuda.synchronize()
        ferr, berr = (pf - pf_ref).abs().max().item(), _rel(pb, pb_ref)
        errs["photometric_fwd"] = max(errs["photometric_fwd"], ferr)
        errs["photometric_bwd"] = max(errs["photometric_bwd"], (pb - pb_ref).abs().max().item())
        tf = timed("photometric_fwd", case, lambda: photometric_fwd(preds, targ),
                   lambda: photometric_reference(preds, targ), None,
                   work("fwd", G, B, 3, h, w))
        tb = timed("photometric_bwd", case, lambda: photometric_bwd(preds, targ, gout),
                   lambda: photometric_bwd_reference(preds, targ, gout), None,
                   work("bwd", G, B, 3, h, w))
        print(f"  photometric {case} G={G} B={B} {w}x{h}: fwd abs {ferr:.3e}, bwd rel "
              f"{berr:.3e}; fwd kernel {tf['ms']:.4f} ms, plain {tf['plain_ms']:.4f} ms, bound "
              f"{tf['bound_ms']:.4f} ms ({tf['bound_by']}); bwd kernel {tb['ms']:.4f} ms, plain "
              f"{tb['plain_ms']:.4f} ms, bound {tb['bound_ms']:.4f} ms ({tb['bound_by']}) "
              f"[{card}]")
        if not (ferr <= TOL_PHOTO and berr <= TOL_PHOTO_BWD):
            fail(f"options kernels: a photometric kernel disagrees with its plain version "
                 f"at {case}")
        del preds, targ, gout, pf, pf_ref, pb, pb_ref
    torch.cuda.empty_cache()
    return errs, times


def options_train_runs(dev, card, log):
    """Phase 25 (b): train_dpt.main() --model monodepth2 for MS (--use_stereo,
    frames 0 -1 1) and S (--use_stereo --frame_ids 0) at the Options defaults
    (640x192, B=12, bf16, synthetic data, one epoch of 8 steps and its
    val()): finite losses, every module moved (S builds no pose network),
    the launches (a warp per source, one photometric forward and backward a
    step), weights_0 with its files; then the step alone as phase 24 times
    it (ms, samples/s, peak memory, idle share) and its top device
    operations. Returns (the launches of the runs, the step times)."""
    import torch

    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.scripts import train_dpt
    from ssde_tpu_torch.train import steps as steps_mod
    from ssde_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    counters = _gru_counters()
    total = dict.fromkeys(counters, 0)
    step_ms = {}
    try:
        for label, extra, pose_files, F in OPTIONS_TRAIN_RUNS:
            argv = ["--model", "monodepth2", "--synthetic_data", "--num_epochs", "1",
                    "--mono_pretrained", "0", "--log_dir", log, "--model_name", label, *extra]
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            with _Observed(Trainer) as obs:
                trainer = train_dpt.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: fn.launches for k, fn in counters.items()}
            for k, v in launched.items():
                total[k] += v
            steps, vals = len(obs.history), len(obs.vals)
            want = {**dict.fromkeys(counters, 0), "warp_family_fwd": F * (steps + vals),
                    "warp_family_bwd": F * steps, "photometric_fwd": steps + vals,
                    "photometric_bwd": steps}
            still, stuck = _moved(obs, trainer)
            opt, models = trainer.opt, trainer.models
            built = [type(m).__name__ for m in models.modules()]
            print(f"options train {label}: main() {wall:.1f} s ({type(trainer).__name__}, "
                  f"{opt.height}x{opt.width} B={opt.batch_size} {opt.compute_dtype}, frames "
                  f"{steps_mod.frame_ids(opt)}, sources {list(models.source_ids)}, modules "
                  f"{built}; build, {steps} steps, {vals} val(), save): losses "
                  + " ".join(f"{h['loss']:.5f}" for h in obs.history)
                  + f"; launches {({k: v for k, v in launched.items() if v})} [{card}]")
            if type(trainer) is not Trainer or (opt.batch_size, opt.height, opt.width,
                                                 opt.compute_dtype) != (MONO_B, H, W, "bfloat16"):
                fail(f"options train {label}: {type(trainer).__name__} at {opt}")
            if len(models.source_ids) != F or (models.pose is None) != (label == "s") \
                    or (models.pose_encoder is None) != (label == "s"):
                fail(f"options train {label}: sources {models.source_ids}, modules {built}")
            if not steps or not all(np.isfinite(v) for h in obs.history for v in h.values()):
                fail(f"options train {label}: {steps} steps, or a loss is not finite")
            if launched != want:
                fail(f"options train {label}: launches {launched}, expected {want}")
            if still or stuck:
                fail(f"options train {label}: modules that did not move {still}, "
                     f"{len(stuck)} parameters with a gradient that did not move")
            folder = os.path.join(log, label, "models", "weights_0")
            files = sorted(os.listdir(folder))
            need = sorted(["adam.pth", "encoder.pth", "depth.pth"]
                          + [f"{m}.pth" for m in pose_files])
            print(f"options train {label}: {folder}: {files}")
            if files != need:
                fail(f"options train {label}: weights_0 holds {files}, expected {need}")

            step_ms[label] = _time_train_step(
                f"options train {label}", trainer,
                make_synthetic_batch(MONO_B, H, W, steps_mod.frame_ids(opt), seed=SEED), dev,
                card, {"warp_family_fwd": F, "warp_family_bwd": F, "photometric_fwd": 1,
                       "photometric_bwd": 1})
            del trainer, models, obs
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return total, step_ms


def options_steps(dev, card):
    """Phase 25 (c): one train step at full width (ResNet18, B=12, 640x192,
    bf16, synthetic data) of each other configuration: the launches it
    states (:func:`_option_launches`) and finite losses; then three chained
    steps timed (CUDA events) and the peak memory."""
    import torch

    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.train import steps
    from ssde_tpu_torch.train.state import TrainState

    torch.backends.cudnn.allow_tf32 = True
    counters = _gru_counters()
    try:
        for label, kw in OPTIONS_STEP_CONFIGS:
            opts = Options(**kw)
            models = steps.build_mono_models(opts, dev, torch.Generator().manual_seed(SEED))
            state = TrainState(models.parameters(), opts.learning_rate,
                               opts.scheduler_step_size, 8)
            batch = to_device(make_synthetic_batch(MONO_B, H, W, steps.frame_ids(opts),
                                                   seed=SEED), dev)
            rng = torch.Generator(dev).manual_seed(SEED)
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            losses = {k: float(v) for k, v in steps.train_step(models, state, batch, rng).items()}
            launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
            want = {k: v for k, v in _option_launches(kw).items() if v}
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(3):
                steps.train_step(models, state, batch, rng)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"options step {label} ({kw}): modules "
                  f"{[type(m).__name__ for m in models.modules()]}, loss {losses['loss']:.5f}; "
                  f"launches {launched}; {ms:.3f} ms a step at B={MONO_B} {H}x{W} bf16 (mean of "
                  f"3 chained after 1), peak memory {peak:.2f} GiB [{card}]")
            if launched != want or not all(np.isfinite(v) for v in losses.values()):
                fail(f"options step {label}: launches {launched}, expected {want}; "
                     f"losses {losses}")
            del models, state, batch
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = False


def _options_step_run(kw, batch, where, net, loss_dtype, select):
    """:func:`_step_run` of the mono step under the options ``kw`` (Options
    fields) at 64x128, B=2."""
    import torch

    import ssde_tpu_torch.train.steps as steps
    from ssde_tpu_torch.config import Options

    h, w = OPTIONS_CPU_HW
    opts = Options(height=h, width=w, batch_size=2, compute_dtype="float32", **kw)
    models = steps.build_mono_models(opts, where, torch.Generator().manual_seed(SEED))
    return _step_run(models, steps.mono_loss_fn, opts, batch, where, net, loss_dtype, select)


def options_card_vs_cpu(dev):
    """Phase 25 (d): one step of every configuration at 64x128, B=2, card vs
    CPU and each against an all-float64 CPU run, by phase 8's recipe (the
    networks in float64, the geometry, warp and loss in float32: the kernels
    on the card, their plain versions on the CPU; the automask argmin of the
    float64 run). Bounds: losses TOL_STEP_LOSS relative, each gradient
    TOL_STEP_GRAD of its float64 max."""
    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.train import steps

    h, w = OPTIONS_CPU_HW
    for label, kw in OPTIONS_CPU_CONFIGS:
        batch = make_synthetic_batch(2, h, w, steps.frame_ids(Options(**kw)), seed=SEED + 5)
        _hold_card_vs_cpu(f"options card vs CPU {label}: one step at {h}x{w} B=2", dev,
                          lambda *a, kw=kw, batch=batch: _options_step_run(kw, batch, *a))


def options_training(dev, card):
    """Phase 25: the Monodepth2 options of the mono step. (a) #5, #6 and #7
    at their new shapes; (b) train_dpt.main() for MS and S; (c) one step of
    each other configuration; (d) card vs CPU. Returns (launches of the main
    path, (b), by kernel; the worst errors and the times of (a); (b)'s step
    ms)."""
    import torch

    phase0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errs, times = options_kernels(dev, card)
    log = tempfile.mkdtemp(prefix="ssde_options_log_")
    try:
        total, step_ms = options_train_runs(dev, card, log)
    finally:
        shutil.rmtree(log, ignore_errors=True)
    options_steps(dev, card)
    options_card_vs_cpu(dev)
    print(f"options: phase 25 took {time.perf_counter() - phase0:.1f} s; launches of its main "
          f"path {({k: v for k, v in total.items() if v})} [{card}]")
    return total, errs, times, step_ms


# phase 26: the bench entry points and the trainer's logs
BENCH_GRU_VERSIONS = ("v10", "v9", "v5")  # at B=8, T=3 (scripts/bench_gru.py:34-37)
BENCH_GRU_STEPS, BENCH_DEFAULTS_STEPS = 10, 3  # v5 also at the Options defaults B=12, T=10
BENCH_LOADER_IMAGES, BENCH_FED_IMAGES = 192, 96  # JPEGs of the tables and of the fed rows
BENCH_LOADER_WORKERS = "2,8"  # the tables' worker counts (the script's default is 1,2,4,8)
HM_LINE = (r"step +\d+ \| examples/s: +[0-9.]+ \| loss: [0-9.]+ \| "
           r"time elapsed: \d{2,}h\d\dm\d\ds \| time left: \d{2,}h\d\dm\d\ds")


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.lines)


def _zeroed(counters):
    import torch

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0


def _read(counters):
    import torch

    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counters.items()}


def _gru_step_launches(version, T=GRU_T, remat="0"):
    """Kernel launches of one GRU train step of ``version`` over T frames (the
    block and the Head unrolled over T with a backward; the loss's warp of 2
    sources and its photometric forward and backward). Under a ``remat``
    mode other than "0" (steps_gru.remat_mode) the block's forward runs
    again in the backward."""
    launches = {**_block_launches(version, T), "warp_family_fwd": 2, "warp_family_bwd": 2,
                "photometric_fwd": 1, "photometric_bwd": 1}
    if remat != "0":
        launches["conv3x3_fwd"] += len(slice_convs(version, H, W)) * T
        launches["attend3_fwd"] += len(slice_attention(version, H, W)) * T
    return launches


def bench_scripts(dev, card):
    """Phase 26 (a)-(c): bench_infer, bench_gru and bench_loader through their
    main() on the card. Returns the launches of their runs by kernel."""
    import torch

    from ssde_tpu_torch.scripts import bench_gru, bench_infer, bench_loader
    from ssde_tpu_torch.train.steps_gru import remat_mode

    counters = _gru_counters()
    total = dict.fromkeys(counters, 0)
    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    keep = {k: os.environ.get(k) for k in ("BENCH_BATCH", "BENCH_LAYERS", "BENCH_GRU_VERSIONS",
                                           "BENCH_T", "BENCH_STEPS", "BENCH_H", "BENCH_W",
                                           "BENCH_GRU_REMAT")}
    try:
        for k in keep:
            os.environ.pop(k, None)
        # (a) the deploy path's frames/s at the script's defaults (B=32, ResNet18, bf16)
        _zeroed(counters)
        result, disp = bench_infer.main(dev, H, W)
        launched = _read(counters)
        for k, v in launched.items():
            total[k] += v
        print(f"bench_infer: disparity {tuple(disp.shape)} in [{disp.min().item():.5f}, "
              f"{disp.max().item():.5f}]; launches {({k: v for k, v in launched.items() if v})} "
              f"(the decoder's convs are cuDNN's) [{card}]")
        if set(result) != {"metric", "value", "unit", "batch", "ms_per_batch"} \
                or result["metric"] != f"kitti_{W}x{H}_depth_infer_frames_per_sec_per_chip" \
                or result["batch"] != 32 or not result["value"] > 0:
            fail(f"bench_infer: {result}")
        if tuple(disp.shape) != (32, 1, H, W) or not torch.isfinite(disp).all() \
                or not 0 < disp.min() <= disp.max() < 1:
            fail(f"bench_infer: disparity {tuple(disp.shape)} not finite in (0, 1)")
        del disp
        # (b) the GRU train steps at B=8, T=3, and v5 at the Options defaults
        os.environ.update(BENCH_GRU_VERSIONS=",".join(BENCH_GRU_VERSIONS),
                          BENCH_BATCH=str(GRU_B), BENCH_T=str(GRU_T),
                          BENCH_STEPS=str(BENCH_GRU_STEPS), BENCH_H=str(H), BENCH_W=str(W))
        _zeroed(counters)
        results = bench_gru.main(dev)
        launched = _read(counters)
        for k, v in launched.items():
            total[k] += v
        runs = bench_gru.WARMUP + BENCH_GRU_STEPS
        want = {k: runs * sum(_gru_step_launches(v)[k] for v in BENCH_GRU_VERSIONS)
                for k in counters}
        print(f"bench_gru {BENCH_GRU_VERSIONS} at B={GRU_B}, T={GRU_T}: launches {launched}, "
              f"expected {want} ({runs} steps each) [{card}]")
        keys = {"metric", "value", "unit", "batch", "seq_len", "ms_per_step"}
        for v, r in zip(BENCH_GRU_VERSIONS, results):
            metric = f"kitti_{W}x{H}_gru_{v}_train_frame_samples_per_sec"
            if set(r) != keys or r["metric"] != metric \
                    or (r["batch"], r["seq_len"]) != (GRU_B, GRU_T) or not r["value"] > 0:
                fail(f"bench_gru {v}: {r}")
        if launched != want:
            fail(f"bench_gru: launches {launched}, expected {want}")
        os.environ.update(BENCH_GRU_VERSIONS="v5", BENCH_BATCH="12", BENCH_T="10",
                          BENCH_STEPS=str(BENCH_DEFAULTS_STEPS))
        _zeroed(counters)
        (r,) = bench_gru.main(dev)
        launched = _read(counters)
        for k, v in launched.items():
            total[k] += v
        mode = remat_mode(types.SimpleNamespace(gru_remat="auto", batch_size=12, len_sequence=10))
        runs = bench_gru.WARMUP + BENCH_DEFAULTS_STEPS
        want = {k: runs * v for k, v in _gru_step_launches("v5", 10, mode).items()}
        print(f"bench_gru v5 at the Options defaults B=12, T=10 (--gru_remat auto -> {mode!r}: "
              f"the encoder, decoder and block checkpointed): launches {launched}, expected "
              f"{want} ({runs} steps) [{card}]")
        if r["metric"] != f"kitti_{W}x{H}_gru_v5_train_frame_samples_per_sec" \
                or (r["batch"], r["seq_len"]) != (12, 10) or not r["value"] > 0 \
                or launched != want:
            fail(f"bench_gru v5 at the defaults: {r}, launches {launched}, expected {want}")
        torch.cuda.empty_cache()
        # (c) the loader: threads and processes, then the mono step fed by it
        _zeroed(counters)
        rows = bench_loader.main(["--n_images", str(BENCH_LOADER_IMAGES), "--width", str(W),
                                  "--height", str(H), "--workers", BENCH_LOADER_WORKERS], dev)
        if _read(counters) != dict.fromkeys(counters, 0) or len(rows) != 4 \
                or not all(items > 0 for _, _, items, _ in rows):
            fail(f"bench_loader: rows {rows}")
        best = {kind: max((items, w) for k2, w, items, _ in rows if k2 == kind)
                for kind in ("thread", "process")}
        print(f"bench_loader: best thread {best['thread'][0]:.1f} items/s ({best['thread'][1]} "
              f"workers), best process {best['process'][0]:.1f} ({best['process'][1]}); "
              f"process/thread {best['process'][0] / best['thread'][0]:.2f}x [{card}]")
        for extra in ([], ["--cache"]):
            argv = ["--fed", "--n_images", str(BENCH_FED_IMAGES), "--fed_epochs", "1",
                    "--batch_size", str(FED_B), "--width", str(W), "--height", str(H), *extra]
            _zeroed(counters)
            rates = bench_loader.main(argv, dev)
            launched = _read(counters)
            for k, v in launched.items():
                total[k] += v
            steps = 1 + 4 * (BENCH_FED_IMAGES // FED_B)  # the warm-up, then 4 rows of an epoch
            want = {**dict.fromkeys(counters, 0), "warp_family_fwd": 2 * steps,
                    "warp_family_bwd": 2 * steps, "photometric_fwd": steps,
                    "photometric_bwd": steps}
            print(f"bench_loader {' '.join(argv)}: samples/s {rates}; launches {launched}, "
                  f"expected {want} [{card}]")
            if launched != want or list(rates) != ["direct", "device_prefetch",
                                                   "plain_put_prefetch", "direct2"] \
                    or not all(v > 0 for v in rates.values()):
                fail(f"bench_loader {argv}: rates {rates}, launches {launched}")
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.backends.cudnn.allow_tf32 = False
    return total


def trainer_logs(dev, card, log):
    """Phase 26 (d): one synthetic epoch of the mono trainer through
    train_dpt.main(--model monodepth2) at the Options defaults (640x192,
    B=12, bf16) with --log_frequency 1: the examples/s lines in the JAX
    format, and the TensorBoard event files of train/ and val/ read back (or,
    without the tensorboard package, none written). Returns the launches."""
    import re

    import torch

    from ssde_tpu_torch.scripts import train_dpt

    counters = _gru_counters()
    torch.backends.cudnn.allow_tf32 = True  # the training configuration
    tee = _Tee(sys.stdout)
    argv = ["--model", "monodepth2", "--synthetic_data", "--num_epochs", "1", "--height", str(H),
            "--width", str(W), "--batch_size", str(MONO_B), "--mono_pretrained", "0",
            "--log_frequency", "1", "--log_dir", log]
    try:
        _zeroed(counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            trainer = train_dpt.main(argv)
        launched = _read(counters)
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = False
    opt, steps = trainer.opt, trainer.step
    want = {**dict.fromkeys(counters, 0), "warp_family_fwd": 4 * steps,
            "warp_family_bwd": 2 * steps, "photometric_fwd": 2 * steps,
            "photometric_bwd": steps}  # a val() a step
    lines = [ln for ln in tee.text().splitlines() if "examples/s" in ln]
    bad = [ln for ln in lines if not re.fullmatch(HM_LINE, ln)]
    print(f"logs: train_dpt.main() {opt.height}x{opt.width} B={opt.batch_size} "
          f"{opt.compute_dtype}, {steps} steps and {steps} val() in {wall:.1f} s; "
          f"{len(lines)} examples/s lines, {len(bad)} off the JAX format; launches {launched}, "
          f"expected {want} [{card}]")
    if (opt.height, opt.width, opt.batch_size, opt.compute_dtype) != (H, W, MONO_B, "bfloat16") \
            or len(lines) != steps or bad or launched != want:
        fail(f"logs: {len(lines)} lines for {steps} steps, off the format {bad[:2]}, "
             f"launches {launched}")
    root = os.path.join(log, opt.model_name)
    events = sorted(os.path.relpath(os.path.join(d, f), root)
                    for d, _, files in os.walk(root) for f in files if "tfevents" in f)
    try:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
        import torch.utils.tensorboard  # noqa: F401
    except ImportError as e:
        print(f"logs: tensorboard does not import here ({e}): the writers are a no-op, as in "
              f"the JAX package; event files {events}")
        if events or "the writers are a no-op" not in tee.text():
            fail(f"logs: no tensorboard, yet event files {events} or no no-op line")
        return launched
    losses = {"loss"} | {f"loss/{s}" for s in range(S_SCALES)}
    panels = {f"{kind}_{s}/{j}" for s in range(S_SCALES) for j in range(min(4, MONO_B))
              for kind in ("color_0", "disp", "automask")}
    for mode, want_scalars, want_images in (("train", losses, set()),
                                            ("val", losses, panels)):
        acc = EventAccumulator(os.path.join(root, mode), size_guidance={"scalars": 0,
                                                                          "images": 0})
        acc.Reload()
        tags = acc.Tags()
        got_steps = {t: [e.step for e in acc.Scalars(t)] for t in tags["scalars"]}
        got_steps.update({t: [e.step for e in acc.Images(t)] for t in tags["images"]})
        print(f"logs: {mode}/ holds {len(tags['scalars'])} scalar and {len(tags['images'])} "
              f"image tags, steps {sorted(set(s for v in got_steps.values() for s in v))}")
        if set(tags["scalars"]) != want_scalars or set(tags["images"]) != want_images \
                or any(v != list(range(steps)) for v in got_steps.values()):
            fail(f"logs: {mode}/ tags {tags['scalars']} {tags['images']}, steps {got_steps}")
    return launched


def bench_entry_points(dev, card):
    """Phase 26: the bench entry points and the trainer's logs. Returns the
    launches of its main path by kernel."""
    phase0 = time.perf_counter()
    total = bench_scripts(dev, card)
    log = tempfile.mkdtemp(prefix="ssde_logs_")
    try:
        for k, v in trainer_logs(dev, card, log).items():
            total[k] += v
    finally:
        shutil.rmtree(log, ignore_errors=True)
    print(f"bench: phase 26 took {time.perf_counter() - phase0:.1f} s; launches of its main "
          f"path {({k: v for k, v in total.items() if v})} [{card}]")
    return total


# phase 28: data parallelism (ssde_tpu_torch.parallel): the
# mono and GRU v10 steps run by parallel.launch, one process per mesh entry.
# (a) the NCCL path at world size 1 on cuda:0, DP_STEPS mono steps at B=12,
# float32, under torch's deterministic algorithms, against the same steps in
# this process: bit-identical parameters, Adam moments and BatchNorm
# statistics. (b) two gloo ranks sharing cuda:0 (NCCL refuses two ranks on
# one card; gloo takes CUDA tensors through the host): one mono step at
# B=12 (6 a rank) and one GRU v10 step at B=8, T=3 (4 a rank) against the
# one-process step, by phase 8's recipe: the preprocessing and the networks
# in float64, the recurrent block, geometry, warp and photometric loss
# float32 on the kernels, deterministic algorithms on. The float32 step's
# gradients are ill-conditioned, and float32 work on a split batch rounds
# otherwise than on the whole batch (reductions and the block's convs tile
# by the batch's shape): with the preprocessing in float32 the split
# batch's disparities moved off the whole batch's by float32's rounding,
# enough to move a mono gradient past the bound on an H100; the block's
# float32 convs flip a few relu values and automask pixels the same way,
# which moves the per-pixel h0 gradients past it. So the GRU step takes the
# one-process run's relu masks of the block and its automask argmin, each
# rank its rows (phase 12's pins), and prints how many of its own differ.
# Losses TOL_STEP_LOSS relative,
# gradients and statistics TOL_CARD_VS_CPU of each tensor's max, the ranks
# bit-identical. (c) (b)'s mono step over NCCL on two cards, where the
# machine has them.
DP_STEPS = 3
DP_GRU_VERSION = "v10"
# the sizes of the phase (a CPU rehearsal passes smaller ones): height,
# width, the mono batch, the GRU batch and sequence length
DP_SIZES = dict(h=H, w=W, mono_b=MONO_B, gru_b=GRU_B, gru_t=GRU_T)


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _dp_device(dev):
    """``dev`` outside a process group; a rank's own device inside one."""
    from ssde_tpu_torch import parallel

    return parallel.current_mesh()[parallel.rank()] if parallel.in_group() else dev


def _dp_sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dp_peak_gib(dev):
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0


def _dp_state(models, state, grads=False):
    """A step's state as CPU tensors: parameters, Adam moments, buffers
    (and the gradients)."""
    params = [p for m in models.modules() for p in m.parameters()]
    out = {"params": [p.detach().cpu() for p in params],
           "moments": [st[k].cpu() for p in params
                       for st in [state.optimizer.state.get(p, {})]
                       for k in ("exp_avg", "exp_avg_sq") if k in st],
           "buffers": [b.cpu() for m in models.modules() for b in m.buffers()]}
    if grads:
        out["grads"] = [None if p.grad is None else p.grad.cpu() for p in params]
    return out


def _dp_identical(a, b):
    import torch

    return all(len(a[k]) == len(b[k]) and all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
               for k in ("params", "moments", "buffers"))


def dp_mono_steps(n_steps, dev=None, sizes=DP_SIZES):
    """(a): ``n_steps`` float32 mono train steps at the mono batch of
    ``sizes``, this process's rows of each seeded batch (all of them
    outside a group) on ``dev`` (a rank: its own), deterministic algorithms
    on; the state after, the step ms, the peak memory and the kernels'
    launches."""
    import torch

    from ssde_tpu_torch import parallel
    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import to_device
    from ssde_tpu_torch.data.synthetic import make_synthetic_batch
    from ssde_tpu_torch.train.state import TrainState
    from ssde_tpu_torch.train.steps import build_mono_models, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = _gru_counters()
    dev = _dp_device(dev)
    h, w, B = sizes["h"], sizes["w"], sizes["mono_b"]
    opts = Options(height=h, width=w, batch_size=B, compute_dtype="float32")
    models = build_mono_models(opts, dev, torch.Generator().manual_seed(SEED))
    state = TrainState(models.parameters(), 1e-4, 15, 1)
    parallel.replicate_(models.modules())
    gen = torch.Generator(dev).manual_seed(SEED)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    ms, nondeterministic = [], []
    with _deterministic(nondeterministic):
        for i in range(n_steps):
            rows = parallel.shard_batch(make_synthetic_batch(B, h, w, seed=SEED + i),
                                        parallel.rank(), parallel.world_size())
            _dp_sync(dev)
            t0 = time.perf_counter()
            train_step(models, state, to_device(rows, dev), gen)
            _dp_sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
    return {**_dp_state(models, state), "ms": ms, "peak_gib": _dp_peak_gib(dev),
            "launches": {k: fn.launches for k, fn in counters.items()},
            "nondeterministic": nondeterministic}


@contextlib.contextmanager
def _deterministic(seen):
    """torch's deterministic algorithms (cuDNN's too) for the duration: the
    float32 step is not bit-reproducible on the card without them (the
    index_add of resize_bilinear's backward, cuDNN's algorithms), and its
    ill-conditioned gradients amplify the difference. An operation that has
    none warns and runs as it is; ``seen`` gets those warnings."""
    import warnings

    import torch

    keep = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        seen.extend(sorted({str(w.message).split(".")[0] for w in caught}))
    finally:
        torch.use_deterministic_algorithms(keep[0])
        torch.backends.cudnn.deterministic = keep[1]


def _dp_gru_models(opts, dev, pin):
    """GRU v10 at the seed, a non-zero h0, the networks in float64 and the
    block float32 (phase 12's recipe: the kernels take float32), its relus
    through ``pin`` (a :class:`_ReluPin`)."""
    import torch

    import ssde_tpu_torch.train.steps_gru as steps_gru
    from ssde_tpu_torch.models.common import sample_

    models = steps_gru.build_gru_models(opts, dev, torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    for p in models.h0_parameters():
        sample_(p, gen, lambda t: t.normal_(0.0, 0.1, generator=gen))
    for m in (models.encoder, models.depth, models.pose_encoder, models.pose):
        m.double()
    block_forward = models.gru.forward

    def forward(dec, hidden):
        with pin.active():
            return block_forward({k: v.float() for k, v in dec.items()}, hidden)

    models.gru.forward = forward
    return models


def _dp_one_step(models, state, batch, preprocess, loss_fn, dev, select=None):
    """One train step of ``models`` on a device batch with the preprocessing
    and the networks in float64 and the geometry, warp and loss in float32
    (phase 8's recipe), ``select`` in place of the automask's minimum:
    preprocess, forward, backward, ``state.apply_gradients`` (the gradient
    mean over the ranks); the losses (their mean over the ranks) and the
    step's ms."""
    import torch

    import ssde_tpu_torch.train.steps as steps
    from ssde_tpu_torch import parallel

    _dp_sync(dev)
    t0 = time.perf_counter()
    batch = {k: v.double() / 255 if v.dtype == torch.uint8 else
             v.double() if v.is_floating_point() else v for k, v in batch.items()}
    inputs, extra = preprocess(batch)
    inputs = {k: v.double() if k.startswith("color_aug") else
              v.float() if v.is_floating_point() else v for k, v in inputs.items()}
    models.train()
    state.optimizer.zero_grad(set_to_none=True)
    patched = {"min_reprojection": select or steps.min_reprojection,
               "_full": lambda t: t.float()}
    plain = {k: getattr(steps, k) for k in patched}
    try:
        for k, v in patched.items():
            setattr(steps, k, v)
        _, losses, _ = loss_fn(models, inputs, *extra)
        losses["loss"].backward()
    finally:
        for k, v in plain.items():
            setattr(steps, k, v)
    state.apply_gradients()
    losses = {k: v.detach() for k, v in losses.items()}
    parallel.all_reduce_mean_(list(losses.values()))
    _dp_sync(dev)
    return {k: float(v) for k, v in losses.items()}, (time.perf_counter() - t0) * 1e3


def _model_axis_ms(trace):
    """The model axis' gather and reduction ms of a ``torch.profiler``
    trace: the host spans of ``parallel.tensor``'s ``model_axis:`` ranges,
    each from the call to the collective's end (the wait for the other ranks
    and for the device's queued work included); 0 without a trace."""
    ms = {"gather_ms": 0.0, "reduction_ms": 0.0}
    for e in trace.key_averages() if trace is not None else ():
        if e.key.startswith("model_axis:"):
            ms[e.key.split(":")[1] + "_ms"] += e.cpu_time_total / 1e3
    return ms


def dp_held_steps(pins, dev=None, sizes=DP_SIZES, names=("mono", "gru")):
    """(b) and (c), and phase 29's steps: one mono step and one GRU v10 step
    (those of ``names``) at ``sizes`` of this process's rows of seeded
    batches (all of them outside a group; on a (data, model) mesh the rows
    of its data rank) on ``dev`` (a rank: its own), by :func:`_dp_one_step`;
    for each the losses, the state with the gradients, the step's ms, the
    gradient all-reduce's ms (the same tensors once more, outside the step,
    over the data group), the peak memory, the kernels' launches and the
    bytes of the parameters and Adam moments the rank holds. On a mesh with
    a model axis the networks are sharded over it after ``replicate_``, the
    model axis' collectives counted (``parallel.tensor.STATS``) and timed
    (:func:`_model_axis_ms`: the step runs under ``torch.profiler``, whose
    host cost its ms then include), and the state is taken after
    ``unshard_params``. The GRU step's block relu masks and automask argmin
    are written to the file ``pins`` outside a group, and a rank replays its
    rows of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssde_tpu_torch.parallel import tensor as model_axis

    import ssde_tpu_torch.train.steps as steps
    import ssde_tpu_torch.train.steps_gru as steps_gru
    from ssde_tpu_torch import parallel
    from ssde_tpu_torch.config import Options
    from ssde_tpu_torch.data.pipeline import collate, to_device
    from ssde_tpu_torch.data.synthetic import SyntheticSeqDataset, make_synthetic_batch
    from ssde_tpu_torch.train.state import TrainState

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = _gru_counters()
    dev = _dp_device(dev)
    r, n = parallel.data_rank(), parallel.data_world()
    sharded = parallel.model_world() > 1
    h, w = sizes["h"], sizes["w"]
    mono = Options(height=h, width=w, batch_size=sizes["mono_b"], compute_dtype="float32")
    gru = Options(height=h, width=w, batch_size=sizes["gru_b"], len_sequence=sizes["gru_t"],
                  gru_version=DP_GRU_VERSION, compute_dtype="float32")
    ds = SyntheticSeqDataset(h, w, n=gru.len_sequence, length=gru.batch_size, seed=SEED)

    def mono_models():
        models = steps.build_mono_models(mono, dev, torch.Generator().manual_seed(SEED))
        for m in models.modules():
            m.double()
        return models

    def gru_inputs(batch):
        inputs, B, T = steps_gru.preprocess_gru_batch(batch, gru)
        return inputs, (B, T)

    pin, selected, switches = _ReluPin(), [], []
    if parallel.in_group():  # B-major rows: a rank's sequences, every frame
        k = gru.batch_size // n
        recorded = torch.load(pins, mmap=True)
        pin.masks = recorded["relu"]
        pin.start(replay=True, rows=slice(r * k, (r + 1) * k))
        select = _selection(recorded["argmin"], switches=switches,
                            rows=slice(r * k * gru.len_sequence, (r + 1) * k * gru.len_sequence))
    else:
        pin.start(replay=False)
        select = _selection(record=selected)

    runs = {  # name: (models, host batch, preprocess, loss function, automask)
        "mono": (mono_models, make_synthetic_batch(mono.batch_size, h, w, seed=SEED),
                 lambda b: (steps.preprocess_train(b, mono), ()), steps.mono_loss_fn, None),
        "gru": (lambda: _dp_gru_models(gru, dev, pin), collate([ds[i] for i in range(len(ds))]),
                gru_inputs, steps_gru.gru_loss_fn, select),
    }
    out = {}
    nondeterministic = []
    for name, (build, batch, preprocess, loss_fn, select) in runs.items():
        if name not in names:
            continue
        models = build()
        state = TrainState(models.parameters(), 1e-4, 15, 1)
        parallel.replicate_(models.modules())
        if sharded:
            parallel.model_sharded_params(models.modules(), parallel.make_mesh_2d(
                *parallel.mesh_shape(), parallel.current_mesh()))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        for fn in counters.values():
            fn.launches = 0
        model_axis.reset_stats()
        trace = profile(activities=[ProfilerActivity.CPU]) if sharded else None
        with _deterministic(nondeterministic), trace or contextlib.nullcontext():
            losses, ms = _dp_one_step(models, state,
                                      to_device(parallel.shard_batch(batch, r, n), dev),
                                      preprocess, loss_fn, dev, select)
        launched = {k: fn.launches for k, fn in counters.items()}
        params = state.optimizer.param_groups[0]["params"]
        held = {"param_bytes": sum(p.numel() * p.element_size() for p in params),
                "moment_bytes": sum(st[k].numel() * st[k].element_size() for p in params
                                    for st in [state.optimizer.state.get(p, {})]
                                    for k in ("exp_avg", "exp_avg_sq") if k in st),
                "model_axis": {**model_axis.STATS, **_model_axis_ms(trace)}}
        if sharded:
            parallel.unshard_params(models.modules(), state.optimizer)
        grads = [p.grad.clone() for p in params if p.grad is not None]
        _dp_sync(dev)
        t0 = time.perf_counter()
        if n > 1:
            parallel.all_reduce_mean_(grads, parallel.data_group())
        _dp_sync(dev)
        out[name] = {**_dp_state(models, state, grads=True), "losses": losses, "ms": ms,
                     "all_reduce_ms": (time.perf_counter() - t0) * 1e3,
                     "grad_mib": sum(g.numel() * g.element_size() for g in grads) / 2**20,
                     "peak_gib": _dp_peak_gib(dev), "launches": launched,
                     "nondeterministic": sorted(set(nondeterministic)), **held}
        del models, state, grads, params
        if dev.type == "cuda":  # give the card back to the ranks that run next
            torch.cuda.empty_cache()
    if not parallel.in_group():
        torch.save({"relu": pin.masks, "argmin": selected}, pins)
    if "gru" in out:
        out["gru"].update(relu_flips=pin.flips, automask_switches=sum(switches),
                          relu_values=sum(m.numel() for m in pin.masks))
    return out


def _dp_hold(label, got, want):
    """The worst of ``got`` (a rank of a data-parallel run) against ``want``
    (the one-process run): (loss rel, gradient rel, statistics rel)."""
    lrel = max(abs(got["losses"][k] - v) / abs(v) for k, v in want["losses"].items())
    grels = [(_rel(g.double(), w.double()), i, tuple(w.shape))
             for i, (g, w) in enumerate(zip(got["grads"], want["grads"]))
             if w is not None and w.abs().max() > 0]
    grel, worst, shape = max(grels)
    brel = max(_rel(g.double(), w.double()) for g, w in zip(got["buffers"], want["buffers"])
               if w.is_floating_point() and w.abs().max() > 0)
    ok = (lrel <= TOL_STEP_LOSS and grel <= TOL_CARD_VS_CPU and brel <= TOL_CARD_VS_CPU
          and len(got["grads"]) == len(want["grads"])
          and all((g is None) == (w is None) for g, w in zip(got["grads"], want["grads"])))
    print(f"  {label}: loss {got['losses']['loss']:.8f} (one process "
          f"{want['losses']['loss']:.8f}), worst rel over the losses {lrel:.3e} (bound "
          f"{TOL_STEP_LOSS}), gradients {grel:.3e} (parameter {worst} of {len(grels)}, "
          f"{shape}) and BatchNorm statistics {brel:.3e} of each tensor's max (bound "
          f"{TOL_CARD_VS_CPU}); without a deterministic algorithm: "
          f"{want['nondeterministic'] or 'none'}")
    return ok


def data_parallel(dev, card, sizes=DP_SIZES):
    """Phase 28: (a) NCCL at world size 1, (b) two gloo ranks on cuda:0,
    (c) NCCL on two cards where present; returns the ranks' kernel launches
    summed, and per run and rank. On the CPU (``dev``, a rehearsal at small
    ``sizes``) (a) runs over gloo and (c) is skipped."""
    import torch

    from ssde_tpu_torch import parallel

    phase0 = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    total, per_rank = {}, {}
    # (a) NCCL, world size 1. cuBLAS is deterministic only with a fixed
    # workspace, which a process reads when it first uses cuBLAS: the ranks
    # take it from the environment
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    ranks = parallel.launch(dp_mono_steps, [dev], DP_STEPS, None, sizes)
    t_launch = time.perf_counter() - t0
    here = dp_mono_steps(DP_STEPS, dev, sizes)
    ok = _dp_identical(ranks[0], here)
    print(f"dp (a) {'NCCL' if cuda else 'gloo'} world size 1 on {dev}: {DP_STEPS} mono steps "
          f"at B={sizes['mono_b']}, {sizes['h']}x{sizes['w']}, float32, "
          f"deterministic algorithms: parameters, Adam moments and BatchNorm statistics "
          f"bit-identical to the same steps in this process: {ok}; step ms world 1 "
          + ", ".join(f"{t:.1f}" for t in ranks[0]["ms"]) + ", in process "
          + ", ".join(f"{t:.1f}" for t in here["ms"])
          + f"; peak {ranks[0]['peak_gib']:.2f} GiB (in process {here['peak_gib']:.2f}); "
          f"launch {t_launch:.1f} s; launches {_nonzero(ranks[0]['launches'])}; operations "
          f"without a "
          f"deterministic algorithm: {here['nondeterministic'] or 'none'} [{card}]")
    if not ok:
        fail("dp (a): the NCCL world-1 steps differ from the in-process steps")
    per_rank["a"] = [ranks[0]["launches"]]
    # (b) two gloo ranks sharing cuda:0, against one process
    folder = tempfile.mkdtemp(prefix="ssde_dp_pins_")
    pins = os.path.join(folder, "pins.pt")
    try:
        want = dp_held_steps(pins, dev, sizes)
        t0 = time.perf_counter()
        ranks = parallel.launch(dp_held_steps, [dev, dev], pins, None, sizes, backend="gloo")
        t_launch = time.perf_counter() - t0
        if cuda and torch.cuda.device_count() >= 2:
            two_cards = parallel.launch(dp_held_steps,
                                        [torch.device("cuda", i) for i in (0, 1)], pins, None,
                                        sizes)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    ok = True
    print(f"dp (b) gloo, 2 ranks on {dev} (launch {t_launch:.1f} s), each step against the "
          f"one-process step; preprocessing and networks float64, the GRU block, geometry, "
          f"warp and loss float32; the GRU step takes the one-process run's relu masks of the "
          f"block ({want['gru']['relu_values']} values) and automask argmin: its own differ at "
          + ", ".join(f"rank {i} {x['gru']['relu_flips']} and {x['gru']['automask_switches']}"
                      for i, x in enumerate(ranks)) + f" [{card}]:")
    for name in ("mono", "gru"):
        same = _dp_identical(ranks[0][name], ranks[1][name])
        held = _dp_hold(f"{name} rank 0 vs one process", ranks[0][name], want[name])
        ok = ok and same and held
        print(f"  {name}: ranks bit-identical {same}; step ms "
              + ", ".join(f"rank {r} {x[name]['ms']:.1f}" for r, x in enumerate(ranks))
              + f" (one process {want[name]['ms']:.1f}); gradient all-reduce over gloo "
              + ", ".join(f"{x[name]['all_reduce_ms']:.1f}" for x in ranks)
              + f" ms for {ranks[0][name]['grad_mib']:.0f} MiB; peak "
              + ", ".join(f"{x[name]['peak_gib']:.2f}" for x in ranks)
              + f" GiB (one process {want[name]['peak_gib']:.2f}); launches "
              + "; ".join(f"rank {r} {_nonzero(x[name]['launches'])}"
                          for r, x in enumerate(ranks)))
        per_rank[f"b_{name}"] = [x[name]["launches"] for x in ranks]
    if not ok:
        fail("dp (b): the two gloo ranks disagree with each other or with one process")
    # (c) NCCL over two cards, where there are two
    if cuda and torch.cuda.device_count() >= 2:
        ranks = two_cards
        same = _dp_identical(ranks[0]["mono"], ranks[1]["mono"])
        print(f"dp (c) NCCL on cuda:0 and cuda:1: ranks bit-identical {same}; step ms "
              + ", ".join(f"{x['mono']['ms']:.1f}" for x in ranks) + "; all-reduce ms "
              + ", ".join(f"{x['mono']['all_reduce_ms']:.1f}" for x in ranks))
        held = _dp_hold("mono rank 0 vs one process", ranks[0]["mono"], want["mono"])
        if not (same and held):
            fail("dp (c): NCCL over two cards disagrees")
        per_rank["c"] = [x["mono"]["launches"] for x in ranks]
    else:
        print(f"dp (c) not run: the machine has {torch.cuda.device_count()} card")
        if cuda:
            print("  (NCCL across cards is not measured here; (a) and (b) ran)")
    for launches in per_rank.values():
        for counts in launches:
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    want_launch = {"a": {"warp_family_fwd": 2 * DP_STEPS, "warp_family_bwd": 2 * DP_STEPS,
                         "photometric_fwd": DP_STEPS, "photometric_bwd": DP_STEPS},
                   "b_mono": {"warp_family_fwd": 2, "warp_family_bwd": 2,
                              "photometric_fwd": 1, "photometric_bwd": 1},
                   "b_gru": _gru_step_launches(DP_GRU_VERSION, sizes["gru_t"])}
    want_launch["c"] = want_launch["b_mono"]
    if not cuda:  # the plain versions run on the CPU
        want_launch = {run: {} for run in want_launch}
    for run, launches in per_rank.items():
        for counts in launches:
            want_counts = {k: want_launch[run].get(k, 0) for k in counts}
            if counts != want_counts:
                fail(f"dp ({run}): a rank launched {counts}, expected {want_counts}")
    print(f"dp: phase 28 took {time.perf_counter() - phase0:.1f} s; launches of its main path "
          f"(every rank) {_nonzero(total)} [{card}]")
    return total, per_rank



# phase 29: the model axis (ssde_tpu_torch.parallel.make_mesh_2d,
# model_sharded_params; parallel/tensor.py's column-parallel layers). The
# card machine has one card and NCCL refuses two ranks on one, so the
# ranks share cuda:0 over gloo, as phase 28 (b)'s do; gloo stages every
# gather and reduction through the host, so the batches are cut (mono B=4,
# GRU B=2 at T=3), never the width or the depth. Held as phase 28 (b).
MP_SIZES = dict(h=H, w=W, mono_b=4, gru_b=2, gru_t=3)
MP_MODEL = 2  # the model axis of the (1, 2) and (2, 2) meshes


def mp_slice_convs(version=VERSION, m=MP_MODEL):
    """The kernel convs of one frame-step of ``version``'s block at scales
    0-1 as a rank of a model axis of size ``m`` runs them: (name, Cin, local
    Cout, whole Cout, h, w, pad, act, bias); a conv whose Cout does not
    divide by m (the 1-channel heads) stays whole."""
    out = []
    for name, cin, cout, h, w, pad, act, has_b in slice_convs(version, H, W):
        if name.startswith(("s0.", "s1.")):
            local = cout // m if cout % m == 0 else cout
            out.append((name, cin, local, cout, h, w, pad, act, has_b))
    return out


def mp_kernels(dev, card):
    """Phase 29 (a): #1 (forward and dx) and #2 at the slice shapes a rank
    of the (1, 2) mesh runs in the GRU v10 step (B=2 a frame-step), float32
    and bf16: the forward against the plain version (phase 2's bounds), the
    backward by phase 10's method and bounds, and each slice's forward
    against the same output channels of the whole conv (bit-identical or
    not, and how far). Returns the worst absolute errors by (kernel,
    dtype)."""
    import torch

    from ssde_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_reference, fwd_tiles

    torch.backends.cudnn.allow_tf32 = False
    B = MP_SIZES["gru_b"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    worst_abs, worst = {}, {torch.float32: 0.0, torch.bfloat16: 0.0}
    same = {}
    t0 = time.perf_counter()
    print(f"mp (a): #1/#2 at the model axis' slice shapes (m={MP_MODEL}) of {VERSION}'s kernel "
          f"convs at scales 0-1, B={B}, {H}x{W} [{card}]")
    for name, cin, cout, whole, h, w, pad, act, has_b in mp_slice_convs():
        x = torch.randn(B, cin, h, w, device=dev, generator=gen)
        wt = torch.randn(whole, cin, 3, 3, device=dev, generator=gen) / (3 * cin ** 0.5)
        bt = torch.randn(whole, device=dev, generator=gen) * 0.1 if has_b else None
        g = torch.randn(B, cout, h, w, device=dev, generator=gen)
        rows = slice(whole - cout, whole)  # the last rank's slice
        ws, bs = wt[rows].contiguous(), None if bt is None else bt[rows].contiguous()
        line = []
        for dtype in (torch.float32, torch.bfloat16):
            xd, wd, bd = (None if t is None else t.to(dtype) for t in (x, ws, bs))
            with torch.no_grad():
                got = conv3x3(xd, wd, bd, pad, act)
                plain = conv3x3_reference(xd.float(), wd.float(),
                                          None if bd is None else bd.float(), pad, act)
                full = conv3x3(xd, wt.to(dtype), None if bt is None else bt.to(dtype), pad,
                               act)[:, rows]
            torch.cuda.synchronize()
            f_rel = _rel(got.float(), plain)
            key = ("conv3x3_fwd", dtype)
            worst_abs[key] = max(worst_abs.get(key, 0.0), (got.float() - plain).abs().max().item())
            identical = torch.equal(got, full)
            same[dtype] = same.get(dtype, True) and identical
            grads, want, _ = _conv_bwd(x, ws, bs, g, pad, act, dtype)
            rels = [("fwd", f_rel)]
            for kname, a, r in zip(("dx", "dw", "db"), grads, want):
                if r is None:
                    continue
                rels.append((kname, _rel(a.to(r.dtype), r)))
                if kname != "db":
                    key = ("conv3x3_dx" if kname == "dx" else "conv3x3_dw", dtype)
                    worst_abs[key] = max(worst_abs.get(key, 0.0),
                                         (a.to(r.dtype) - r).abs().max().item())
            tol_f = TOL_F32 if dtype == torch.float32 else TOL_BF16
            tol_b = TOL_BWD_F32 if dtype == torch.float32 else TOL_BWD_BF16
            worst[dtype] = max([worst[dtype]] + [r for _, r in rels])
            line.append(f"{'f32' if dtype == torch.float32 else 'bf16'} "
                        + " ".join(f"{n} {r:.2e}" for n, r in rels)
                        + f" (tiles {fwd_tiles(cin, cout, dtype)} against the whole conv's "
                        f"{fwd_tiles(cin, whole, dtype)}; slice == whole's channels: {identical}"
                        + ("" if identical else f", {_rel(got.float(), full.float()):.2e}") + ")")
            if f_rel > tol_f or max(r for n, r in rels if n != "fwd") > tol_b:
                fail(f"mp (a): {name} {cin}->{cout} of {whole} {dtype}: {rels}")
        print(f"  {name} {cin}->{cout} (of {whole}) {h}x{w} {pad} {act}: " + "; ".join(line))
    print(f"mp (a): ok in {time.perf_counter() - t0:.1f} s; worst of max float32 "
          f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}; every slice's forward "
          f"bit-identical to the whole conv's channels: float32 {same[torch.float32]}, bf16 "
          f"{same[torch.bfloat16]}")
    torch.cuda.empty_cache()
    return worst_abs


def _mp_report(label, ranks, want, names):
    """Print and hold a model-parallel run: every rank's state the same
    after unshard_params, rank 0 against the one-process ``want``; each
    rank's step ms, model-axis collectives, peak memory and held bytes."""
    ok = True
    for name in names:
        same = all(_dp_identical(ranks[0][name], x[name]) for x in ranks[1:])
        held = _dp_hold(f"{label} {name} rank 0 vs one process", ranks[0][name], want[name])
        ok = ok and same and held
        one = want[name]["param_bytes"] + want[name]["moment_bytes"]
        print(f"  {label} {name}: ranks the same after unshard_params {same}; one process "
              f"{want[name]['ms']:.1f} ms, peak {want[name]['peak_gib']:.2f} GiB, parameters "
              f"and Adam moments {one / 2**20:.1f} MiB")
        for i, x in enumerate(ranks):
            st = x[name]["model_axis"]
            mine = x[name]["param_bytes"] + x[name]["moment_bytes"]
            print(f"    rank {i}: step {x[name]['ms']:.1f} ms (under torch.profiler); gathers "
                  f"{st['gathers']} "
                  f"({st['gather_bytes'] / 2**20:.1f} MiB sent) {st['gather_ms']:.1f} ms; "
                  f"model-group reductions {st['reductions']} "
                  f"({st['reduction_bytes'] / 2**20:.1f} MiB) {st['reduction_ms']:.1f} ms; "
                  f"gradient mean over the data group {x[name]['all_reduce_ms']:.1f} ms; peak "
                  f"{x[name]['peak_gib']:.2f} GiB; parameters {x[name]['param_bytes'] / 2**20:.1f}"
                  f" MiB and Adam moments {x[name]['moment_bytes'] / 2**20:.1f} MiB "
                  f"({mine / one:.3f} of one process's); launches "
                  f"{_nonzero(x[name]['launches'])}")
    return ok


def model_parallel(dev, card, sizes=MP_SIZES):
    """Phase 29: (a) the kernels at the slice shapes (on a card), (b) a (1, 2)
    mesh of two gloo ranks on ``dev``, (c) a (2, 2) mesh of four, (d) NCCL
    over two cards where present; returns the ranks' kernel launches summed,
    per run and rank, and (a)'s worst errors. On the CPU (a rehearsal at
    small ``sizes``) (a) and (d) are skipped."""
    import torch

    from ssde_tpu_torch import parallel

    phase0 = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    errs = mp_kernels(dev, card) if cuda else {}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    folder = tempfile.mkdtemp(prefix="ssde_mp_pins_")
    pins = os.path.join(folder, "pins.pt")
    runs = {"b": ((1, MP_MODEL), ("mono", "gru")), "c": ((2, MP_MODEL), ("mono",))}
    got, seconds = {}, {}
    try:
        want = dp_held_steps(pins, dev, sizes)
        for run, (shape, names) in runs.items():
            t0 = time.perf_counter()
            mesh = parallel.make_mesh_2d(*shape, [dev] * (shape[0] * shape[1]))
            got[run] = parallel.launch(dp_held_steps, mesh, pins, None, sizes, names,
                                       backend="gloo")
            seconds[run] = time.perf_counter() - t0
        if cuda and torch.cuda.device_count() >= 2:
            mesh = parallel.make_mesh_2d(1, MP_MODEL, [torch.device("cuda", i) for i in (0, 1)])
            got["d"] = parallel.launch(dp_held_steps, mesh, pins, None, sizes, ("mono",))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"mp: the one-process steps (mono B={sizes['mono_b']}, GRU {DP_GRU_VERSION} "
          f"B={sizes['gru_b']}, T={sizes['gru_t']}, {sizes['h']}x{sizes['w']}; networks float64, "
          f"the GRU block, geometry, warp and loss float32), the ranks' after unshard_params "
          f"[{card}]:")
    ok, per_rank = True, {}
    for run, (shape, names) in runs.items():
        print(f"mp ({run}) a {shape} mesh of {shape[0] * shape[1]} gloo ranks on {dev} "
              f"(launch and steps {seconds[run]:.1f} s):")
        ok = _mp_report(f"({run})", got[run], want, names) and ok
        for name in names:
            per_rank[f"{run}_{name}"] = [x[name]["launches"] for x in got[run]]
    if "gru" in want:
        print("  the GRU step takes the one-process run's relu masks of the block "
              f"({want['gru']['relu_values']} values) and automask argmin: its own differ at "
              + ", ".join(f"rank {i} {x['gru']['relu_flips']} and {x['gru']['automask_switches']}"
                          for i, x in enumerate(got["b"])))
    if "d" in got:
        print("mp (d) NCCL on cuda:0 and cuda:1, a (1, 2) mesh:")
        ok = _mp_report("(d)", got["d"], want, ("mono",)) and ok
        per_rank["d_mono"] = [x["mono"]["launches"] for x in got["d"]]
    else:
        print(f"mp (d) not run: the machine has {torch.cuda.device_count()} card"
              + (" (the model axis over NCCL across cards is not measured here)" if cuda else ""))
    if not ok:
        fail("mp: a model-parallel run disagrees with one process or its ranks differ")
    want_launch = {"mono": {"warp_family_fwd": 2, "warp_family_bwd": 2,
                            "photometric_fwd": 1, "photometric_bwd": 1},
                   "gru": _gru_step_launches(DP_GRU_VERSION, sizes["gru_t"])}
    total = {}
    for run, launches in per_rank.items():
        for counts in launches:
            want_counts = {k: want_launch[run.split("_")[1]].get(k, 0) if cuda else 0
                           for k in counts}
            if counts != want_counts:
                fail(f"mp ({run}): a rank launched {counts}, expected {want_counts}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    print(f"mp: phase 29 took {time.perf_counter() - phase0:.1f} s; launches of its main path "
          f"(every rank) {_nonzero(total)} [{card}]")
    return total, per_rank, errs

if __name__ == "__main__":
    main()
