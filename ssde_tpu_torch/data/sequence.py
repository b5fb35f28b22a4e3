"""Sequence (video-tuple) datasets for recurrent training (numpy copy of
``ssde_tpu/data/sequence.py`` :40-253).

Items of :class:`KITTISeqDataset` are (scene, frame range) windows of
length T+2: centre, left and right frame stacks of length T each, plus the
centre frames' velodyne ground truth. The host emits scale-0 frames only;
the pyramid and the jitter (one per item) run on the device.

Item contract (numpy):
  f"color/{i}": (T, H, W, 3) for i in {-1, 0, 1}
  "depth_gt":   (T, 375, 1242) float32
  "K":          (4, 4) normalized
  "jitter":     (4,)
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .kitti import (FULL_RES_SHAPE, IDENTITY_JITTER, KITTI_K, _resize_nn, item_rng,
                    load_resized_uint8, pil_load_resized, sample_jitter)
from .kitti_utils import generate_depth_map


def count_scene_frames(scenes: Sequence[str], data_path: str) -> Dict[str, int]:
    """Number of frames per scene (reference gru_utils.py:88-99)."""
    out = {}
    for scene in scenes:
        date, name = scene.split("/")
        out[scene] = len(os.listdir(os.path.join(data_path, date, name, "image_02", "data")))
    return out


def generate_frame_tuples(n_frames: Dict[str, int], scenes: Sequence[str], n: int, k: int,
                          n_tuples: int, seed: int = 0) -> List[Tuple[str, range]]:
    """Random (scene, range(x, x+n+k)) windows per scene
    (reference gru_utils.py:101-122)."""
    rng = random.Random(seed)
    dataset = []
    for scene in scenes:
        total = n_frames[scene]
        per_scene = max(total // n, n_tuples)
        right = total - 1 - n - k
        starts = rng.sample(range(right), min(per_scene, right))
        dataset.extend((scene, range(x, x + n + k)) for x in starts)
    return dataset


def _velodyne_depth(data_path: str, scene: str, frame_index: int, cam: int,
                    do_flip: bool) -> np.ndarray:
    date, name = scene.split("/")
    velo = os.path.join(data_path, date, name,
                        "velodyne_points/data/{:010d}.bin".format(frame_index))
    depth = generate_depth_map(os.path.join(data_path, date), velo, cam)
    depth = _resize_nn(depth, FULL_RES_SHAPE[::-1])
    if do_flip:
        depth = np.fliplr(depth).copy()
    return depth.astype(np.float32)


class KITTISeqDataset:
    def __init__(self, data_path: str, sequences: Sequence[Tuple[str, range]], height: int,
                 width: int, n: int, is_train: bool = False, img_ext: str = ".jpg",
                 load_depth: bool = True, seed: int = 0, decoded_cache: str | None = None):
        self.data_path = data_path
        self.sequences = list(sequences)
        self.height = height
        self.width = width
        self.n = n
        self.is_train = is_train
        self.img_ext = img_ext
        self.load_depth = load_depth
        self.K = KITTI_K
        self.seed = seed
        self._epoch = 0
        self.decoded_cache = decoded_cache

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return len(self.sequences)

    def get_image_path(self, frame_index: int, scene: str) -> str:
        date, name = scene.split("/")
        f_str = "{:010d}{}".format(frame_index, self.img_ext)
        return os.path.join(self.data_path, date, name, "image_02", "data", f_str)

    def get_depth(self, frame_index: int, scene: str, do_flip: bool) -> np.ndarray:
        return _velodyne_depth(self.data_path, scene, frame_index, 2, do_flip)

    def __getitem__(self, index):
        scene, frame_range = self.sequences[index]
        frames = list(frame_range)  # length n + 2 (the centre window is 1..n)
        rng = item_rng(self.seed, self._epoch, index)
        do_flip = self.is_train and rng.random() > 0.5
        do_jitter = self.is_train and rng.random() > 0.5
        if self.decoded_cache is not None:
            imgs = {f: load_resized_uint8(self.get_image_path(f, scene), self.width,
                                          self.height, do_flip, self.decoded_cache)
                    for f in frames}
        else:
            imgs = {f: pil_load_resized(self.get_image_path(f, scene), self.width,
                                        self.height, do_flip)
                    for f in frames}
        n = self.n
        inputs = {
            "color/0": np.stack([imgs[f] for f in frames[1:n + 1]]),
            "color/-1": np.stack([imgs[f] for f in frames[:n]]),
            "color/1": np.stack([imgs[f] for f in frames[2:n + 2]]),
            "K": self.K.copy(),
            "jitter": sample_jitter(rng) if do_jitter else IDENTITY_JITTER,
        }
        if self.load_depth:
            inputs["depth_gt"] = np.stack(
                [self.get_depth(f, scene, do_flip) for f in frames[1:len(frames) - 1]])
        return inputs


class KITTIImagePairDataset:
    """Single-image (rgb, depth) pairs (reference kitti_dataset_seq.py
    KITTIDataset_v2, :202-306). Items: (rgb (H, W, 3) float32, depth
    (375, 1242) float32). ``config`` keys: height, width, data_path."""

    def __init__(self, config: dict, filenames: Sequence[str], is_train: bool = False,
                 seed: int = 0):
        self.config = config
        self.filenames = list(filenames)
        self.is_train = is_train
        self.height = config["height"]
        self.width = config["width"]
        self.data_path = config["data_path"]
        self.side_map = {"l": 2, "r": 3}
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return len(self.filenames)

    def get_image_path(self, frame_index: int, scene: str, side: int) -> str:
        date, name = scene.split("/")
        return os.path.join(self.data_path, date, name, f"image_0{side}", "data",
                            "{:010d}.jpg".format(frame_index))

    def __getitem__(self, index):
        scene, frame_index, side = self.filenames[index].split()
        frame_index = int(frame_index)
        do_flip = self.is_train and item_rng(self.seed, self._epoch, index).random() > 0.5
        rgb = pil_load_resized(self.get_image_path(frame_index, scene, self.side_map[side]),
                               self.width, self.height, do_flip)
        depth = _velodyne_depth(self.data_path, scene, frame_index, self.side_map[side],
                                do_flip)
        return rgb, depth


class KITTISceneDataset:
    """Whole-scene ordered frames with GT only at test ids, for streaming
    evaluation (reference kitti_dataset_seq.py KITTIDataset_v3, :308-373).
    Items are (rgb, depth or None, frame_index)."""

    def __init__(self, config: dict, scene: str, test_frames=None):
        self.config = config
        self.scene = scene
        self.data_path = config["data_path"]
        self.height = config["height"]
        self.width = config["width"]
        self.test_frames = set(test_frames or [])
        date, name = scene.split("/")
        imgs = os.path.join(self.data_path, date, name, "image_02", "data")
        self.frame_ids = sorted(int(f.split(".")[0]) for f in os.listdir(imgs)
                                if f[0].isdigit())

    def __len__(self):
        return len(self.frame_ids)

    def __getitem__(self, index):
        frame_index = self.frame_ids[index]
        date, name = self.scene.split("/")
        path = os.path.join(self.data_path, date, name, "image_02", "data",
                            "{:010d}.jpg".format(frame_index))
        rgb = pil_load_resized(path, self.width, self.height, False)
        depth = None
        if not self.test_frames or frame_index in self.test_frames:
            velo = os.path.join(self.data_path, date, name,
                                "velodyne_points/data/{:010d}.bin".format(frame_index))
            if os.path.exists(velo):
                depth = _velodyne_depth(self.data_path, self.scene, frame_index, 2, False)
        return rgb, depth, frame_index
