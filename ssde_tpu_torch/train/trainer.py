"""The mono, attention-encoder, fusion and DPT trainers (counterpart of
``ssde_tpu/train/trainer.py`` ``TrainerBase`` and ``Trainer``, :55-392,
``AttentionTrainer``, :394-400, the fusion trainers, :403-458, and
``DPTTrainer``, :460-494).

An epoch loop around :func:`ssde_tpu_torch.train.steps.train_step`: the
loader decodes KITTI items from ``--data_path`` (``--dataset`` kitti,
kitti_odom or kitti_depth, the ``--split`` lists; ``--synthetic_data`` for
the hermetic generator) and collates numpy batches in worker threads, and
each batch goes to the device from pinned memory. At the JAX trainer's
logging points the loss line is printed and :meth:`TrainerBase.val` runs
one validation batch: its losses and, where the batch has velodyne ground
truth, the 7 depth metrics (:func:`depth_metrics`). Every
``--save_frequency`` epochs :meth:`TrainerBase.save_model` writes
``<log_dir>/<model_name>/models/weights_<epoch>/`` in the reference's
per-module ``.pth`` layout (:mod:`ssde_tpu_torch.checkpoint`);
``--load_weights_folder`` with ``--models_to_load`` reads one back, and
``--mono_pretrained`` warm-starts from ``models/mono_640x192`` where that
folder exists. ``--matmul_precision float32`` (or ``highest``) turns TF32
off for cuDNN and cuBLAS, process-wide. ``--profile_steps N`` traces steps
5 .. 5+N with ``torch.profiler`` into ``<log_dir>/<model_name>/profile/``
(:class:`ProfileWindow`).

``--num_devices`` picks the data-parallel mesh by the JAX rule
(:func:`train_mesh`: 0 every visible card, or ``--no_cuda`` one CPU rank;
clamped to a count that divides ``--batch_size``). One device trains in
this process. More train one process per device (:func:`train_main`
through :func:`ssde_tpu_torch.parallel.launch`): each rank builds the same
seeded models, takes rank 0's parameters and buffers, decodes its rows of
every global batch (``Loader(shard=...)``), feeds them through
``parallel.device_prefetch``, and its step averages the gradients over the
ranks (``TrainState.apply_gradients``) with BatchNorm over the global batch
(``models/resnet.BatchNorm2d``); the losses are averaged over the ranks.
Rank 0 alone logs, validates (the whole validation batch: eval mode has no
cross-sample term), profiles and saves.

The logs are the JAX trainer's (:mod:`ssde_tpu_torch.logging_utils`):
``Writers`` writes TensorBoard event files under
``<log_dir>/<model_name>/train`` (each logging point's losses) and ``val``
(the validation batch's losses and depth metrics, and image panels of
colour, disparity and automask at every scale for 4 samples) where the
``tensorboard`` package imports, and nothing where it does not (the
trainer says which); ``TimeLogger`` prints the console line and
``save_opts`` writes ``models/opt.json``. A validation batch that fails is
reported and skipped; the fifth failure in a row raises. The port's warp is
exact, so it reports no ``warp/band_violation``: its ``train`` tags are the
JAX trainer's without that one, and the JAX trainer's
``_check_band_violation`` guard has nothing to check.

``AttentionTrainer`` is the mono trainer with ``ResnetEncoderAttention``
as the depth encoder; its ``--mono_pretrained`` warm start loads the
ResNet part of a Monodepth2 ``encoder.pth`` and leaves the attention convs
at their init. The fusion trainers (``FusionTrainer``, ``FusionV3Trainer``,
``FusionScaleLoopTrainer``) run :func:`ssde_tpu_torch.train.steps_fusion.train_step`
on frames [0, -1, -2, 1] and save ``fusion.pth`` beside the mono modules;
``DPTTrainer`` runs :func:`ssde_tpu_torch.train.steps_dpt.train_step` on
frames [0, -1, 1] at scale 0 and saves ``dpt.pth`` beside the pose modules.
Resuming from a folder with the default ``--models_to_load`` restores
``fusion.pth`` or ``dpt.pth`` too (the default list, a copy of the JAX
package's, names neither); a list given that leaves them out leaves them
out.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import checkpoint, parallel
from ..config import Options
from ..data.kitti import KITTIDepthDataset, KITTIOdomDataset, KITTIRAWDataset
from ..data.pipeline import Loader, to_device
from ..data.splits import readlines, split_file
from ..data.synthetic import SyntheticKittiDataset
from ..data.transforms import preprocess_batch
from ..eval.depth import _resize_bilinear_np, compute_errors
from ..logging_utils import TimeLogger, Writers, save_opts
from . import steps_dpt, steps_fusion
from .state import TrainState
from .steps import build_mono_models, check_supported, frame_ids, mono_loss_fn, train_step

# train-time GT crop (garg) rows/cols of 375x1242 (reference trainer.py:639-640)
GARG_CROP = (153, 371, 44, 1197)
DEPTH_METRICS = ("de/abs_rel", "de/sq_rel", "de/rms", "de/log_rms", "da/a1", "da/a2", "da/a3")
# the monodepth2 warm start's folder, relative to the working directory
MONO_PRETRAINED = os.path.join("models", "mono_640x192")


def run_device(opt: Optional[Options], device=None) -> torch.device:
    """The entry points' device (the trainers' and the evaluation
    scripts'): ``device`` if given (``opt`` is then not read), else the CPU
    under ``--no_cuda`` and the card otherwise. A card that is asked for and
    absent is an error: nothing falls back to the CPU."""
    if device is None:
        device = "cpu" if opt.no_cuda else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: the port runs on the card; "
                           "pass --no_cuda (or device='cpu') to run on the CPU")
    return device


def apply_matmul_precision(opt: Options) -> None:
    """``--matmul_precision`` (``ssde_tpu/train/trainer.py:72-74``):
    ``float32`` and ``highest`` turn TF32 off for cuDNN convolutions and
    cuBLAS matmuls, process-wide, so that float32 means float32 on the
    card; ``default`` leaves torch's settings as they are."""
    if opt.matmul_precision in ("float32", "highest"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def train_mesh(opt: Options, device=None) -> List[torch.device]:
    """``--num_devices``'s mesh (``ssde_tpu/train/trainer.py:76``,
    ``parallel.make_mesh``'s rule): every visible card (0) or the first
    ``--num_devices``, clamped to the largest count that divides
    ``--batch_size``; under ``--no_cuda`` that many CPU ranks (0: one). A
    trainer given its ``device`` runs on that one device, and then a
    ``--num_devices`` above 1 is an error, not a one-device run."""
    if opt.num_devices < 0:
        raise ValueError(f"--num_devices {opt.num_devices}: 0 (all) or a device count")
    if device is not None:
        if opt.num_devices > 1:
            raise ValueError(
                f"--num_devices {opt.num_devices} with a trainer given one device "
                f"({device}): train through the entry point's main(), which starts one "
                "process per device")
        return [run_device(opt, device)]
    devices = parallel.cpu_devices(opt.num_devices) if run_device(opt).type == "cpu" else None
    return parallel.make_mesh(opt.num_devices, devices, batch_size=opt.batch_size)


def _train_rank(trainer_cls, opts: Options) -> None:
    """One rank of :func:`train_main`: its trainer and its epochs."""
    trainer_cls(opts).train()


def train_main(trainer_cls, opts: Options):
    """The entry points' training: on a mesh of one device the trainer
    trains in this process and is returned; on more, one process per
    device (``parallel.launch``) and None."""
    mesh = train_mesh(opts)
    if len(mesh) == 1:
        trainer = trainer_cls(opts)
        trainer.train()
        return trainer
    print(f"--num_devices {opts.num_devices}: one process per device of the mesh "
          f"{parallel.describe_mesh(mesh, parallel.default_backend(mesh))}", flush=True)
    parallel.launch(_train_rank, mesh, trainer_cls, opts)
    return None


class ProfileWindow:
    """``--profile_steps N``: a ``torch.profiler`` trace (CPU, and CUDA on
    the card) of the steps 5 .. 5+N, the JAX trainer's window
    (``ssde_tpu/train/trainer.py:224-227``), written as a Chrome trace
    ``steps_5-<5+N>.pt.trace.json`` under ``folder``. :meth:`at` runs
    before each step with its global index; :meth:`close` ends a window
    that training left open (the JAX trainer leaves its trace open)."""

    FIRST = 5

    def __init__(self, steps: int, folder: str, device: torch.device):
        self.steps, self.folder, self.device = steps, folder, device
        self.profiler = None

    def at(self, step: int) -> None:
        if not self.steps:
            return
        if step == self.FIRST:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=activities)
            self.profiler.start()
        elif step == self.FIRST + self.steps:
            self.close()

    def close(self) -> None:
        if self.profiler is None:
            return
        self.profiler.stop()
        os.makedirs(self.folder, exist_ok=True)
        path = os.path.join(self.folder,
                            f"steps_{self.FIRST}-{self.FIRST + self.steps}.pt.trace.json")
        self.profiler.export_chrome_trace(path)
        self.profiler = None
        print(f"profile of steps {self.FIRST}-{self.FIRST + self.steps} written to {path}",
              flush=True)


def depth_metrics(depth_pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """The 7 depth metrics of (N, h, w) predicted depth against (N, H, W)
    velodyne ground truth (``ssde_tpu/train/trainer.py:319-347``): each
    prediction resized bilinearly to its ground truth, the Garg crop of
    the valid pixels, the clip to [1e-3, 80], median scaling and the clip
    again; the mean over the images with a valid pixel (none: {})."""
    errors = []
    for i in range(gt.shape[0]):
        g = gt[i]
        pred = _resize_bilinear_np(depth_pred[i], g.shape)
        mask = g > 0
        crop_mask = np.zeros_like(mask)
        crop_mask[GARG_CROP[0]:GARG_CROP[1], GARG_CROP[2]:GARG_CROP[3]] = 1
        mask = np.logical_and(mask, crop_mask)
        if not mask.any():
            continue
        p = np.clip(pred[mask], 1e-3, 80)
        gm = g[mask]
        p *= np.median(gm) / np.median(p)
        p = np.clip(p, 1e-3, 80)
        errors.append(compute_errors(gm, p))
    if not errors:
        return {}
    return {n: float(v) for n, v in zip(DEPTH_METRICS, np.mean(errors, axis=0))}


def device_batch(host: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The batch on the device without ``depth_gt``: the depth metrics read
    the ground truth on the host, and no step uses it."""
    return to_device({k: v for k, v in host.items() if k != "depth_gt"}, device)


class TrainerBase:
    """Data, models, optimizer and the epoch loop; the step itself is
    :attr:`step_fn`, :func:`ssde_tpu_torch.train.steps.train_step` here,
    and :attr:`loss_fn` the forward that :meth:`process_batch` runs.
    Runs on the card unless ``device`` or ``--no_cuda`` asks for the CPU.
    Built in a rank of ``parallel.launch`` it is that rank of the mesh
    (:attr:`rank` of :attr:`world`); built elsewhere on a mesh of more than
    one device it raises (:func:`train_main` starts the ranks)."""

    step_fn = staticmethod(train_step)
    loss_fn = staticmethod(mono_loss_fn)
    check_supported = staticmethod(check_supported)
    # modules of the subclass that the default --models_to_load does not name
    # but a resume from its own weights_N/ restores (_models_to_load)
    own_modules: tuple = ()
    # this process's place on the mesh (__init__ sets them); rank 0 leads:
    # it logs, validates, profiles and saves
    rank, world, lead = 0, 1, True

    def __init__(self, options: Options, device=None, seed: int = 0):
        self.opt = options
        self.log_path = os.path.join(self.opt.log_dir, self.opt.model_name)
        assert self.opt.height % 32 == 0, "'height' must be a multiple of 32"
        assert self.opt.width % 32 == 0, "'width' must be a multiple of 32"
        assert self.opt.frame_ids[0] == 0, "frame_ids must start with 0"
        self.check_supported(self.opt)
        apply_matmul_precision(self.opt)
        self.rank, self.world = parallel.rank(), parallel.world_size()
        if parallel.in_group():
            self.mesh = parallel.current_mesh()
            self.device = run_device(self.opt, self.mesh[self.rank])
        else:
            self.mesh = train_mesh(self.opt, device)
            if len(self.mesh) > 1:
                raise RuntimeError(
                    f"--num_devices {self.opt.num_devices}: the mesh "
                    f"{parallel.describe_mesh(self.mesh, None)} trains one process per "
                    "device: run the entry point's main() (train.trainer.train_main)")
            self.device = run_device(self.opt, device)
        self.lead = self.rank == 0
        self.profile = ProfileWindow(self.opt.profile_steps if self.lead else 0,
                                     os.path.join(self.log_path, "profile"), self.device)
        self.step = 0
        self.epoch = 0
        self.seed = seed
        self._build_data()
        self._build_models_and_state()
        self.writers = Writers(self.log_path, ("train", "val") if self.lead else ())
        self.num_total_steps = len(self.train_loader) * self.opt.num_epochs
        self.time_logger = TimeLogger(self.num_total_steps, self.opt.batch_size)
        print(f"Device: {self.device}"
              + (f" ({torch.cuda.get_device_name(self.device)})"
                 if self.device.type == "cuda" else "")
              + (f", rank {self.rank} of {self.world}" if parallel.in_group() else ""),
              flush=True)
        if not self.lead:
            return
        save_opts(self.log_path, self.opt)
        print(f"Training model named: {self.opt.model_name}")
        print(f"Training is using mesh: {parallel.describe_mesh(self.mesh, parallel.backend())}")
        print(f"TensorBoard event files under {self.log_path}/{{train,val}}"
              if self.writers.writers else
              "TensorBoard is not installed: the writers are a no-op, as in the JAX package")

    def _models_dir(self) -> str:
        """``<log_dir>/<model_name>/models``, made if missing."""
        path = os.path.join(self.log_path, "models")
        os.makedirs(path, exist_ok=True)
        return path

    # ------------------------------------------------------------- data
    def _frame_idxs(self):
        """``--frame_ids``, and "s" under ``--use_stereo`` (reference
        trainer.py:59-60): the frames the data carry (``steps.frame_ids``)."""
        return frame_ids(self.opt)

    def _train_files(self) -> List[str]:
        """The training split's lines (``ssde_tpu/train/trainer.py:102-103``)."""
        return readlines(split_file(self.opt.split, "train"))

    def _build_data(self):
        opt = self.opt
        ids = self._frame_idxs()
        if opt.synthetic_data:
            self.train_dataset = SyntheticKittiDataset(
                opt.height, opt.width, length=opt.batch_size * 8, frame_idxs=ids)
            self.val_dataset = SyntheticKittiDataset(
                opt.height, opt.width, length=opt.batch_size * 2, frame_idxs=ids,
                is_train=False)
        else:
            # the reference's map has kitti and kitti_odom (trainer.py:139-141);
            # the JAX trainer adds kitti_depth, the improved ground truth
            ds_cls = {"kitti": KITTIRAWDataset, "kitti_odom": KITTIOdomDataset,
                      "kitti_depth": KITTIDepthDataset}.get(opt.dataset, KITTIRAWDataset)
            img_ext = ".png" if opt.png else ".jpg"
            self.train_dataset = ds_cls(
                opt.data_path, self._train_files(), opt.height,
                opt.width, ids, is_train=True, img_ext=img_ext,
                decoded_cache=opt.decoded_cache)
            self.val_dataset = ds_cls(
                opt.data_path, readlines(split_file(opt.split, "val")), opt.height,
                opt.width, ids, is_train=False, img_ext=img_ext,
                decoded_cache=opt.decoded_cache)
        self._make_loaders()

    def _make_loaders(self):
        opt = self.opt
        self.train_loader = Loader(self.train_dataset, opt.batch_size, shuffle=True,
                                   drop_last=True, num_workers=opt.num_workers,
                                   shard=(parallel.data_rank(), parallel.data_world()))
        self.val_loader = Loader(self.val_dataset, opt.batch_size, shuffle=False,
                                 drop_last=True, num_workers=opt.num_workers)
        self._val_iter = None
        self._val_failures = 0

    # ------------------------------------------------- models and state
    def _build_models(self):
        return build_mono_models(self.opt, self.device,
                                 torch.Generator().manual_seed(self.seed))

    def _scheduler_step_size(self) -> int:
        return self.opt.scheduler_step_size

    def _build_models_and_state(self):
        """Seeded models; the monodepth2 warm start where it applies
        (``ssde_tpu/train/trainer.py:160-170``: ``--mono_pretrained``, no
        folder to load, ``models/mono_640x192`` present: every module file
        there that the trainer has); Adam; then ``--load_weights_folder``;
        then, on a mesh, rank 0's parameters and buffers on every rank."""
        opt = self.opt
        self.models = self._build_models()
        if opt.mono_pretrained and opt.load_weights_folder is None \
                and os.path.isdir(MONO_PRETRAINED):
            self._warm_start()
        self.state = TrainState(self.models.parameters(), opt.learning_rate,
                                self._scheduler_step_size(), max(1, len(self.train_loader)))
        if opt.load_weights_folder is not None:
            self.load_model()
        parallel.replicate_(self.models.modules())

    def _warm_start(self) -> None:
        """``--mono_pretrained``: the module files of ``models/mono_640x192``
        that the bundle has (``checkpoint.WARM_START_NAMES``), strictly."""
        _, loaded = checkpoint.load_folder(MONO_PRETRAINED, self.models,
                                           checkpoint.WARM_START_NAMES)
        print(f"---> Load monodepth2 weights: {loaded} from {MONO_PRETRAINED}")

    # ------------------------------------------------------------ train
    def train(self):
        """``num_epochs`` epochs, a checkpoint after every
        ``--save_frequency``-th (rank 0's); a ``--profile_steps`` window still
        open at the end is closed and written, and the TensorBoard writers
        closed."""
        try:
            for self.epoch in range(self.opt.num_epochs):
                self.run_epoch()
                if (self.epoch + 1) % self.opt.save_frequency == 0 and self.lead:
                    self.save_model()
        finally:
            self.profile.close()
            self.writers.close()

    def _train_batches(self):
        """The train loader's host batches without ``depth_gt``."""
        for host in self.train_loader:
            yield {k: v for k, v in host.items() if k != "depth_gt"}

    def run_epoch(self) -> List[Dict[str, torch.Tensor]]:
        """One pass over the training set, the batches handed to the device
        through ``parallel.device_prefetch`` (``ssde_tpu/train/trainer.py
        :219-221``); the losses of every step, on the device (reading them
        back waits for the steps), averaged over the ranks on a mesh: the
        global batch's. At each logging point rank 0 prints the console
        line, writes the step's losses to the ``train`` writer and runs
        :meth:`val`."""
        if self.lead:
            print(f"Training epoch {self.epoch}", flush=True)
        self.train_dataset.set_epoch(self.epoch)
        gen = torch.Generator(self.device).manual_seed(self.epoch)
        history = []
        for batch_idx, batch in enumerate(
                parallel.device_prefetch(self._train_batches(), self.device)):
            before = time.time()
            self.profile.at(self.step)
            losses = self.step_fn(self.models, self.state, device_batch(batch, self.device), gen)
            parallel.all_reduce_mean_(list(losses.values()))
            history.append(losses)
            early_phase = batch_idx % self.opt.log_frequency == 0 and self.step < 2000
            if self.lead and (early_phase or self.step % 2000 == 0):
                loss = float(losses["loss"])  # waits for the step
                self.time_logger.log(self.step, time.time() - before, loss)
                self.writers.scalars("train", self.step,
                                     {k: float(v) for k, v in losses.items()})
                self.val()
            self.step += 1
        return history

    # -------------------------------------------------------------- val
    def process_batch(self, batch, generator=None):
        """Forward one device batch in eval mode: (inputs, outputs, losses)."""
        inputs = preprocess_batch(batch, self.opt.height, self.opt.width,
                                  self.opt.num_scales, self._frame_idxs(), is_train=False)
        self.models.train(False)
        with torch.no_grad():
            _, losses, outputs = self.loss_fn(self.models, inputs, generator)
        return inputs, outputs, losses

    def val(self) -> Optional[Dict[str, float]]:
        """The losses of the next validation batch and, where it has
        ``depth_gt``, its depth metrics: printed on one line, written to the
        ``val`` writer with the batch's image panels, and returned. A batch
        whose forward fails is reported and skipped (None); the fifth such
        failure in a row raises (``ssde_tpu/train/trainer.py:273-283``)."""
        if self._val_iter is None:
            self._val_iter = iter(self.val_loader)
        try:
            host = next(self._val_iter)
        except StopIteration:
            self._val_iter = iter(self.val_loader)
            host = next(self._val_iter)
        batch = device_batch(host, self.device)
        try:
            inputs, outputs, losses = self.process_batch(batch)
        except Exception as e:
            # one flaky batch must not end a long run; a val path that is
            # broken for good must not shrink to a line nobody reads
            self._val_failures += 1
            print(f"val failed ({self._val_failures} consecutive): {e}", flush=True)
            if self._val_failures >= 5:
                raise
            return None
        self._val_failures = 0
        scalars = {k: float(v) for k, v in losses.items()}
        if "depth_gt" in host:
            scalars.update(self.compute_depth_losses(host, outputs))
        print("val " + " ".join(f"{k} {v:.5f}" for k, v in sorted(scalars.items())),
              flush=True)
        self.writers.scalars("val", self.step, scalars)
        self.writers.images("val", self.step, inputs, outputs, self.opt.scales, [0])
        return scalars

    def compute_depth_losses(self, batch, outputs) -> Dict[str, float]:
        """:func:`depth_metrics` of ``depth/0/0`` against the host batch's
        (B, 375, 1242) ``depth_gt``."""
        depth = outputs["depth/0/0"][:, 0].detach().float().cpu().numpy()
        return depth_metrics(depth, np.asarray(batch["depth_gt"]))

    # ------------------------------------------------------ checkpoints
    def save_model(self) -> str:
        """``<log_dir>/<model_name>/models/weights_<epoch>/``: one ``.pth``
        per module and ``adam.pth`` (``ssde_tpu/train/trainer.py:350-360``)."""
        folder = os.path.join(self._models_dir(), f"weights_{self.epoch}")
        checkpoint.save_folder(folder, self.models, self.state.optimizer,
                               height=self.opt.height, width=self.opt.width,
                               use_stereo=bool(self.opt.use_stereo))
        print(f"saved model to {folder}")
        return folder

    def load_model(self) -> None:
        """``--models_to_load`` from ``--load_weights_folder`` (a missing
        file is skipped, a mismatched one raises), then ``adam.pth`` where
        it is present and fits; the schedule resumes from its step count. A
        folder without ``.pth`` files is the JAX package's ``.ckpt`` folder
        (``ssde_tpu/train/trainer.py:360-383``): its modules, and
        ``adam.ckpt``'s moments with the step at its count."""
        folder = os.path.expanduser(self.opt.load_weights_folder)
        if not os.path.isdir(folder):
            raise FileNotFoundError(f"Cannot find folder {folder}")
        print(f"loading model from folder {folder}")
        _, loaded = checkpoint.load_folder(folder, self.models, self._models_to_load())
        print(f"loaded {loaded}")
        ext = checkpoint.folder_format(folder)
        adam = os.path.join(folder, "adam" + ext)
        if not os.path.isfile(adam):
            print("Cannot find Adam weights so Adam is randomly initialized")
        elif ext == ".ckpt":
            count = checkpoint.load_adam_ckpt(adam, self.models, self.state.optimizer)
            if count is None:
                print(f"Adam moments not loaded from {adam}: Adam is randomly initialized")
            else:
                self.state.step = count
                print(f"Adam moments loaded from {adam} at step {count}")
        elif checkpoint.load_adam(adam, self.state.optimizer):
            steps = [int(s["step"]) for s in self.state.optimizer.state.values() if "step" in s]
            self.state.step = max(steps, default=0)

    def _models_to_load(self) -> List[str]:
        """The modules :meth:`load_model` reads: ``--models_to_load``, and
        :attr:`own_modules` (and ``predictive_mask`` where the bundle has
        one) when that is the default list, which does not name them: a run
        resumed from its own ``weights_N/`` restores them with the rest (the
        JAX trainer leaves them fresh, ``ROADMAP.md`` Queue 3). A list given
        that leaves them out leaves them out."""
        names = list(self.opt.models_to_load)
        own = list(self.own_modules)
        if getattr(self.models, "predictive_mask", None) is not None:
            own.append("predictive_mask")
        return names + own if names == Options().models_to_load else names


class Trainer(TrainerBase):
    """Plain monodepth2-style training."""


class AttentionTrainer(Trainer):
    """``--model rn_encoder_with_attention``: the mono step with
    ``ResnetEncoderAttention`` as the depth encoder
    (``ssde_tpu/train/trainer.py:394-400``)."""

    def _build_models(self):
        return build_mono_models(self.opt, self.device,
                                 torch.Generator().manual_seed(self.seed),
                                 attention_encoder=True)

    def _warm_start(self) -> None:
        """A Monodepth2 ``encoder.pth`` has no ``atten*`` keys: its ResNet part
        is loaded (strictly) and the attention convs keep their init; the
        other module files as :meth:`TrainerBase._warm_start` loads them.
        (The JAX trainer puts the plain ResNet tree in the attention
        encoder's place, and its first step fails: ``ROADMAP.md`` Queue 3.)"""
        names = [n for n in checkpoint.WARM_START_NAMES if n != "encoder"]
        _, loaded = checkpoint.load_folder(MONO_PRETRAINED, self.models, names)
        path = os.path.join(MONO_PRETRAINED, "encoder.pth")
        if os.path.exists(path):
            checkpoint.load_resnet_part(self.models.encoder, checkpoint.read_module(path)[0])
            loaded.insert(0, "encoder (its ResNet; atten1..4 left at their init)")
        print(f"---> Load monodepth2 weights: {loaded} from {MONO_PRETRAINED}")


class _FusionTrainerBase(TrainerBase):
    """The 3-frame fusion trainers: frames [0, -1, -2, 1] and the fusion
    train step of the subclass's ``fusion_variant``."""

    step_fn = staticmethod(steps_fusion.train_step)
    loss_fn = staticmethod(steps_fusion.fusion_loss_fn)
    check_supported = staticmethod(functools.partial(check_supported, trainer="fusion"))
    own_modules = ("fusion",)

    def __init__(self, options: Options, device=None, seed: int = 0):
        # the reference trainer forces the 3-frame context (trainer.py:55)
        options.frame_ids = [0, -2, -1, 1]
        super().__init__(options, device, seed)

    def _frame_idxs(self):
        """Frames 0, -1, -2, 1, and "s" under ``--use_stereo``, which the
        data carry and the step does not read: the JAX fusion step warps
        from (-1, 1) alone (``ssde_tpu/train/trainer.py:413-417``,
        ``steps_fusion.py:58``)."""
        ids = list(steps_fusion.TRAIN_FRAMES)
        return ids + ["s"] if self.opt.use_stereo else ids

    def _build_models(self):
        return steps_fusion.build_fusion_models(self.opt, self.fusion_variant, self.device,
                                                torch.Generator().manual_seed(self.seed))


class FusionTrainer(_FusionTrainerBase):
    """The pre-disp PixelShuffle pyramid (``Fusion``; reference
    trainer_fusion.py)."""

    fusion_variant = "pyramid"


class FusionV3Trainer(_FusionTrainerBase):
    """``Fusion_v3`` on the sigmoid disparities, attention units or, under
    ``--disable_attention``, conv units (reference trainer_fusion_v3.py,
    whose optimizer step is commented out; this one optimizes, as the JAX
    trainer does)."""

    fusion_variant = "v3"

    def _train_files(self) -> List[str]:
        """``train_files_seq.txt`` (frames whose neighbours at +-2 all exist,
        reference trainer_fusion_v3.py:168) where the split has it, else
        ``train_files.txt`` (``ssde_tpu/train/trainer.py:445-452``)."""
        path = split_file(self.opt.split, "train")
        seq = os.path.join(os.path.dirname(path), "train_files_seq.txt")
        return readlines(seq if os.path.exists(seq) else path)


class FusionScaleLoopTrainer(_FusionTrainerBase):
    """One shared ``FeatureFusionBlock`` applied per scale (reference
    trainer.py)."""

    fusion_variant = "scale_loop"


class DPTTrainer(TrainerBase):
    """``--model dpt_gru``: the DPT-hybrid depth model
    (``ssde_tpu/train/trainer.py:460-494``). Frames forced to [0, -1, 1] and
    scales to [0], as the reference forces them (trainer_dpt.py:63): the
    DPT gives one full-resolution disparity, so the loss runs at scale 0."""

    step_fn = staticmethod(steps_dpt.train_step)
    loss_fn = staticmethod(steps_dpt.dpt_loss_fn)
    check_supported = staticmethod(functools.partial(check_supported, trainer="dpt"))
    own_modules = ("dpt",)

    def __init__(self, options: Options, device=None, seed: int = 0):
        options.frame_ids = [0, -1, 1]
        options.scales = [0]
        super().__init__(options, device, seed)

    def _build_models(self):
        return steps_dpt.build_dpt_models(self.opt, self.device,
                                          torch.Generator().manual_seed(self.seed))
