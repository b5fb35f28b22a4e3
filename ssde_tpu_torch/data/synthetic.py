"""Synthetic KITTI-like sequences (numpy copy of ``ssde_tpu/data/synthetic.py``
``_texture`` and ``SyntheticSeqDataset``).

The JAX package's module cannot be imported without JAX (``ssde_tpu.data``
imports its device-side transforms), so the generator is copied here; its
frames are bit-identical to the JAX package's. A textured fronto-parallel
plane slides horizontally across frames.
"""

from __future__ import annotations

import numpy as np

# normalized KITTI intrinsics (ssde_tpu/data/kitti.py:40-43)
KITTI_K = np.array(
    [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    dtype=np.float32,
)
IDENTITY_JITTER = np.array([1.0, 1.0, 1.0, 0.0], dtype=np.float32)


def _texture(h, w, seed):
    rng = np.random.RandomState(seed)
    base = rng.rand(h // 8 + 2, w // 8 + 2, 3).astype(np.float32)
    img = np.kron(base, np.ones((8, 8, 1), dtype=np.float32))[:h, :w]
    return np.clip(img, 0, 1)


def _shifted_frame(tex, h, w, shift):
    """Horizontal integer-shift crop out of a wider texture."""
    return tex[:, shift : shift + w, :]


class SyntheticSeqDataset:
    """Sequence-shaped fixture matching KITTISeqDataset's contract."""

    def __init__(self, height=64, width=128, n=3, length=8, is_train=True, seed=0):
        self.height = height
        self.width = width
        self.n = n
        self.length = length
        self.is_train = is_train
        self.seed = seed
        self._tex = _texture(height, width + 96, seed)

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
