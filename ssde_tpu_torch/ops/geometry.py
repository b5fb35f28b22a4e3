"""Geometry ops (counterpart of ``ssde_tpu/ops/geometry.py``).

Only ``disp_to_depth``, which inference needs; the rest of the geometry
belongs to training.
"""

from __future__ import annotations


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth).

    depth = 1 / (1/max_depth + (1/min_depth - 1/max_depth) * disp)
    (reference: layers.py:16-25). Works on tensors and numpy arrays.
    """
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth
