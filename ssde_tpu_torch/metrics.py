"""Streaming metric aggregation (reference gru_utils.py:12-72).

numpy-based running averages of the seven depth metrics over a stream of
(prediction, target) pairs — used by the sequence evaluation protocols.
A copy of ``ssde_tpu/metrics.py``, so that the port imports nothing of
``ssde_tpu``; ``tests/test_torch_eval_copies.py`` holds it to the original.
"""

from __future__ import annotations

import numpy as np

from .eval.depth import compute_errors


class MetricAggregator:
    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0.0
        self.sum_rmse = 0.0
        self.sum_absrel = 0.0
        self.sum_sq_rel = 0.0
        self.sum_rmse_log = 0.0
        self.sum_delta1 = 0.0
        self.sum_delta2 = 0.0
        self.sum_delta3 = 0.0

    def evaluate(self, output, target):
        """Accumulate metrics over valid (target > 0) pixels."""
        output = np.asarray(output)
        target = np.asarray(target)
        mask = target > 0
        if not mask.any():
            return
        abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 = compute_errors(
            target[mask], output[mask]
        )
        self.sum_rmse += rmse
        self.sum_absrel += abs_rel
        self.sum_sq_rel += sq_rel
        self.sum_rmse_log += rmse_log
        self.sum_delta1 += a1
        self.sum_delta2 += a2
        self.sum_delta3 += a3
        self.count += 1

    def average(self) -> dict:
        c = max(self.count, 1.0)
        return {
            "rmse": self.sum_rmse / c,
            "absrel": self.sum_absrel / c,
            "sq_rel": self.sum_sq_rel / c,
            "rmse_log": self.sum_rmse_log / c,
            "delta1": self.sum_delta1 / c,
            "delta2": self.sum_delta2 / c,
            "delta3": self.sum_delta3 / c,
        }


# --- temporal-context helpers (reference gru_utils.py:124-163) ---------------
# Part of the reference's public gru_utils surface; no trainer ever calls
# them there (dead code), kept for API completeness as plain numpy.

def banded_mask(n_seq: int, k: int) -> np.ndarray:
    """(n_seq, n_seq) mask with 1 on the k sub-diagonals below the main
    one — position (i, j) attends iff i-k <= j < i (reference
    get_mask_func, gru_utils.py:124-131)."""
    return np.sum([np.eye(n_seq, n_seq, -i) for i in range(1, k + 1)],
                  axis=0)


def context_vectors(layer_1_vec: np.ndarray, layer_2_vec: np.ndarray,
                    k: int) -> np.ndarray:
    """Causal-banded attention over a sequence of feature maps.

    layer_1_vec (B, T, ...) provides the similarity keys/queries,
    layer_2_vec (B, T, ...) the values; each timestep attends to its k
    predecessors with dot-product scores normalized by the row sum (NOT
    a softmax — the exp is commented out in the reference,
    gru_utils.py:140). Returns the (B, T-k, ...) context stack
    (reference get_context_vectors, gru_utils.py:133-154).
    """
    bs, n_seq = layer_1_vec.shape[:2]
    v1 = layer_1_vec.reshape(bs, n_seq, -1).astype(np.float64)
    v2 = layer_2_vec.reshape(bs, n_seq, -1).astype(np.float64)
    scores = np.matmul(v1, v1.transpose(0, 2, 1))
    scores = banded_mask(n_seq, k)[None] * scores
    scores = scores / (scores.sum(axis=2, keepdims=True) + 1e-6)
    ctx = np.matmul(scores.astype(np.float32), v2.astype(np.float32))
    return ctx[:, k:].reshape(layer_2_vec[:, k:].shape)


def context_vector(x: np.ndarray, prev_states_1, prev_states_2,
                   l2_shape) -> np.ndarray:
    """Single-step variant: one query ``x`` against stacked previous
    states (reference get_context_vector, gru_utils.py:157-163)."""
    q = np.asarray(x).reshape(1, -1)
    keys = np.concatenate([np.asarray(p).reshape(1, -1)
                           for p in prev_states_1], axis=0)
    vals = np.concatenate([np.asarray(p).reshape(1, -1)
                           for p in prev_states_2], axis=0)
    scores = q @ keys.T
    scores = scores / (scores.sum(axis=1, keepdims=True) + 1e-6)
    return (scores @ vals).reshape(l2_shape)
