"""Synthetic KITTI-like data (numpy copy of ``ssde_tpu/data/synthetic.py``).

The JAX package's module cannot be imported without JAX (``ssde_tpu.data``
imports its device-side transforms), so the generator is copied here; its
items are bit-identical to the JAX package's, but for the stereo frame.
With "s" among the frames, ``color/s`` is the plane one pixel further on
(the JAX generator's is frame 0 itself, so the stereo identity error is 0
everywhere and no warp's error can win the minimum), and the item carries
``stereo_T``, the left camera's as the KITTI datasets give it
(``data/kitti.py``), which the JAX generator leaves out (its stereo
training on synthetic data stops at a ``KeyError``). A textured fronto-parallel
plane slides horizontally across frames, which gives the photometric loss
genuine parallax to learn from without a KITTI tree.
"""

from __future__ import annotations

import numpy as np

from .kitti import IDENTITY_JITTER, KITTI_K, item_rng, sample_jitter

# the left camera's stereo_T, unflipped: a 0.1 baseline to the right camera
# with the sign the KITTI datasets give it
LEFT_STEREO_T = np.eye(4, dtype=np.float32)
LEFT_STEREO_T[0, 3] = -0.1


def _texture(h, w, seed):
    rng = np.random.RandomState(seed)
    base = rng.rand(h // 8 + 2, w // 8 + 2, 3).astype(np.float32)
    img = np.kron(base, np.ones((8, 8, 1), dtype=np.float32))[:h, :w]
    return np.clip(img, 0, 1)


def _shifted_frame(tex, h, w, shift):
    """Horizontal integer-shift crop out of a wider texture."""
    return tex[:, shift : shift + w, :]


class SyntheticKittiDataset:
    """Quacks like KITTIDataset: items with f"color/{i}" (H, W, 3), "K",
    "jitter", with "s" among the frames "stereo_T", and with
    ``load_depth`` "depth_gt"."""

    def __init__(self, height=64, width=128, length=32, frame_idxs=(0, -1, 1),
                 is_train=True, load_depth=False, seed=0):
        self.height = height
        self.width = width
        self.length = length
        self.frame_idxs = list(frame_idxs)
        self.is_train = is_train
        self.load_depth = load_depth
        self.seed = seed
        self._epoch = 0
        self._tex = _texture(height, width + 64, seed)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        base_shift = (index * 3) % 32
        inputs = {}
        for i in self.frame_idxs:
            shift = int(np.clip(base_shift + (2 * i if i != "s" else 1), 0, 63))
            inputs[f"color/{i}"] = _shifted_frame(self._tex, self.height,
                                                  self.width, shift)
        inputs["K"] = KITTI_K.copy()
        rng = item_rng(self.seed, self._epoch, index)
        inputs["jitter"] = (sample_jitter(rng)
                            if self.is_train and rng.random() > 0.5
                            else IDENTITY_JITTER.copy())
        if self.load_depth:
            inputs["depth_gt"] = np.full((375, 1242), 10.0, dtype=np.float32)
        if "s" in self.frame_idxs:
            inputs["stereo_T"] = LEFT_STEREO_T.copy()
        return inputs


def make_synthetic_batch(batch_size, height, width, frame_idxs=(0, -1, 1), seed=0):
    """One collated (numpy, NHWC) batch straight from the synthetic dataset."""
    from .pipeline import collate

    ds = SyntheticKittiDataset(height, width, length=batch_size,
                               frame_idxs=frame_idxs, seed=seed)
    return collate([ds[i] for i in range(batch_size)])


class SyntheticSeqDataset:
    """Sequence-shaped fixture matching KITTISeqDataset's contract."""

    def __init__(self, height=64, width=128, n=3, length=8, is_train=True, seed=0):
        self.height = height
        self.width = width
        self.n = n
        self.length = length
        self.is_train = is_train
        self.seed = seed
        self._epoch = 0
        self._tex = _texture(height, width + 96, seed)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        h, w, n = self.height, self.width, self.n
        shifts = [(index * 2 + t * 3) % 64 for t in range(n + 2)]
        frames = [_shifted_frame(self._tex, h, w, s) for s in shifts]
        return {
            "color/0": np.stack(frames[1 : n + 1]),
            "color/-1": np.stack(frames[:n]),
            "color/1": np.stack(frames[2 : n + 2]),
            "K": KITTI_K.copy(),
            "jitter": IDENTITY_JITTER.copy(),
        }


def scene_frames(height: int, width: int, n_frames: int, batch: int = 1,
                 seed: int = 0):
    """``n_frames`` consecutive (batch, H, W, 3) frames of one synthetic
    scene: item ``b`` of the batch is the sequence at index ``b``."""
    ds = SyntheticSeqDataset(height, width, n=n_frames, length=batch, seed=seed)
    seqs = np.stack([ds[b]["color/0"] for b in range(batch)])  # (B, T, H, W, 3)
    return [np.ascontiguousarray(seqs[:, t]) for t in range(n_frames)]
