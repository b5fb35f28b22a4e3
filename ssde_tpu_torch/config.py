"""Config / flag system of the port (a copy of ``ssde_tpu/config.py``).

The same dataclass-backed registry as the JAX package's: the reference's
``options.py`` flags (~70, reference options.py:15-287) with identical
names, defaults and choices, plus the JAX package's TPU knobs, which the
port accepts so that one command line drives both packages. The port
keeps its own copy so that it imports nothing of ``ssde_tpu``;
``tests/test_torch_config.py`` holds the copy to the original.

The per-module GPU-id flags of the reference (options.py:133-162) are
accepted but inert. ``--no_cuda`` is not: it is how a caller of the port's
entry points asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Options:
    # PATHS
    data_path: str = "kitti_data"
    log_dir: str = os.path.join(os.path.expanduser("~"), "tmp")

    # TRAINING
    model: str = "dpt_gru"
    model_name: str = "mdp"
    split: str = "eigen_zhou"
    disable_attention: bool = False
    num_layers: int = 18
    len_sequence: int = 10
    train_n_tuples: int = 60
    test_n_tuples: int = 10
    # accepted-but-inert: the reference declares --pose_mask (options.py:66)
    # but no trainer ever reads it
    pose_mask: int = 1
    mono_pretrained: int = 1
    gru_pre_disp: int = 1
    h_s_epoch: int = 10
    gru_version: str = "v5"
    # hidden-state aggregation for v4/v6: (h_t + h_{t-1})/2. The reference
    # force-overrides this to True at startup (trainer_gru.py:62), so its
    # concat branch (trainer_gru.py:577) is unreachable — and shape-broken
    # (2C-channel concat added to C-channel features). GRUTrainer mirrors
    # the force and warns if --fuse 0 is passed.
    fuse: int = 1
    dataset: str = "kitti"
    png: bool = False
    height: int = 192
    width: int = 640
    disparity_smoothness: float = 1e-3
    scales: List[int] = field(default_factory=lambda: [0, 1, 2, 3])
    min_depth: float = 0.1
    max_depth: float = 100.0
    use_stereo: bool = False
    frame_ids: List[int] = field(default_factory=lambda: [0, -1, 1])

    # accepted-but-inert GPU placement flags (reference options.py:133-162)
    depth_encoder_gpu_id: int = 0
    depth_decoder_gpu_id: int = 0
    pose_encoder_gpu_id: int = 0
    pose_decoder_gpu_id: int = 0
    gru_gpu_id: int = 0
    main_gpu_id: int = 0

    # OPTIMIZATION
    batch_size: int = 12
    learning_rate: float = 1e-4
    num_epochs: int = 20
    scheduler_step_size: int = 15
    # The reference GRU trainer constructs a StepLR but never steps it
    # (trainer_gru.py:316 is commented out), so its effective LR is
    # constant; set True to decay the GRU run like the mono trainers.
    gru_lr_decay: bool = False

    # ABLATION
    v1_multiscale: bool = False
    avg_reprojection: bool = False
    disable_automasking: bool = False
    predictive_mask: bool = False
    no_ssim: bool = False
    weights_init: str = "pretrained"
    pose_model_input: str = "pairs"
    pose_model_type: str = "separate_resnet"

    # SYSTEM
    # run the port's trainers on the CPU; without it they run on the card
    # and raise when there is none
    no_cuda: bool = False
    num_workers: int = 12

    # LOADING
    load_weights_folder: Optional[str] = None
    models_to_load: List[str] = field(
        default_factory=lambda: ["pose_encoder", "pose", "encoder", "depth", "gru", "head"]
    )

    # LOGGING
    log_frequency: int = 250
    save_frequency: int = 1

    # EVALUATION
    eval_stereo: bool = False
    eval_mono: bool = False
    disable_median_scaling: bool = False
    pred_depth_scale_factor: float = 1.0
    ext_disp_to_eval: Optional[str] = None
    eval_split: str = "eigen"
    save_pred_disps: bool = False
    no_eval: bool = False
    eval_eigen_to_benchmark: bool = False
    eval_out_dir: Optional[str] = None
    post_process: bool = False

    # --- TPU-native knobs (new in this framework) ---
    # compute dtype for model forward/backward: "float32" | "bfloat16"
    compute_dtype: str = "bfloat16"
    # f32 matmul handling when compute_dtype=float32: "default" lets XLA use
    # bf16 passes (fast), "float32" forces exact f32 (parity eval)
    matmul_precision: str = "default"
    # number of data-parallel shards (devices); 0 = all visible devices
    num_devices: int = 0
    # fused Pallas SSIM+L1 photometric-error kernel (ops/pallas/photometric)
    # on the batched loss path: used when True, on TPU, no_ssim is off and
    # the resolution fits VMEM (fits_photometric); else the jnp formulation
    use_pallas: bool = True
    # bilinear warp backend: "auto" | "banded" (banded lane-gather Pallas,
    # whole scale family per source; TPU training default) | "onehot"
    # (VMEM one-hot MXU Pallas) | "family" (plain lane-gather, W<=128
    # only) | "pallas" (per-pair kernel) | "mxu" (XLA one-hot einsum) |
    # "gather" (XLA gather, f32-exact)
    warp_backend: str = "auto"
    # vertical band height of the banded warp kernel (multiple of 8, min 8).
    # Kernel VPU work scales ~linearly with it; the per-output-row source-y
    # span budget is vband - 2 pixels (the kernel roll-aligns the exact band
    # start, so no 8-alignment slack is lost). KITTI reprojection spans are
    # ~1-3 px (8/16/40 agree exactly on bench grids); rows beyond the budget
    # clamp to the band edge and warp/band_violation in the losses dict
    # reports the violating fraction — raise vband if sustained non-zero.
    # Measured B=48 warp fwd+bwd: vband 40 = 85.5 ms, 24 = 65.2, 16 = 47.7
    # (pre-roll); rolled vband 8 = see PLAN.md.
    warp_vband: int = 8
    # rematerialization of the GRU sequence step in the backward pass:
    # "1" remats the B*T-frame encoder/decoder AND the scan body, "scan"
    # remats the scan body only (the scan MUST remat — without it XLA
    # stacks every cell intermediate over T and OOMs a 16 GB chip even
    # at B=8,T=3), "0" nothing, "auto" = "scan" for B*T <= 32 else "1".
    gru_remat: str = "auto"
    # synthetic data (hermetic runs without a KITTI tree)
    synthetic_data: bool = False
    # decode-once uint8 frame cache directory (data/kitti.load_resized_uint8):
    # first epoch decodes+resizes and caches; later visits skip the JPEG
    # decode (the host bottleneck at ~8-9 items/s/core) and frames ship to
    # the device as uint8 (4x less H2D traffic). None = decode every visit.
    decoded_cache: Optional[str] = None
    # capture a jax.profiler trace of N training steps into <log_dir>/profile
    profile_steps: int = 0

    @property
    def num_scales(self) -> int:
        return len(self.scales)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "Options":
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


_CHOICES = {
    "split": ["eigen_zhou", "eigen_full", "odom", "benchmark"],
    "num_layers": [18, 34, 50, 101, 152],
    "dataset": ["kitti", "kitti_odom", "kitti_depth", "kitti_test"],
    "weights_init": ["pretrained", "scratch"],
    "pose_model_input": ["pairs", "all"],
    "pose_model_type": ["posecnn", "separate_resnet", "shared"],
    "eval_split": ["eigen", "eigen_benchmark", "benchmark", "odom_9", "odom_10"],
    "compute_dtype": ["float32", "bfloat16"],
    "matmul_precision": ["default", "float32", "highest"],
}


class MonodepthOptions:
    """argparse front-end with the reference's exact flag surface."""

    def __init__(self):
        self.parser = argparse.ArgumentParser(description="Monodepthv2 options (TPU)")
        self.parser.add_argument("-f", help=argparse.SUPPRESS)  # jupyter compat
        for f_ in dataclasses.fields(Options):
            name = "--" + f_.name
            default = (
                f_.default
                if f_.default is not dataclasses.MISSING
                else f_.default_factory()
            )
            if f_.type in ("bool", bool):
                self.parser.add_argument(name, action="store_true", default=default)
            elif f_.type in ("List[int]", List[int]):
                self.parser.add_argument(name, nargs="+", type=int, default=default)
            elif f_.type in ("List[str]", List[str]):
                self.parser.add_argument(name, nargs="+", type=str, default=default)
            else:
                base = {"int": int, "float": float}.get(str(f_.type), str)
                if f_.type in ("Optional[str]",):
                    base = str
                kwargs = {"type": base, "default": default}
                if f_.name in _CHOICES:
                    kwargs["choices"] = _CHOICES[f_.name]
                self.parser.add_argument(name, **kwargs)

    def parse(self, argv=None) -> Options:
        ns = self.parser.parse_args(argv)
        d = vars(ns)
        d.pop("f", None)
        return Options(**d)
