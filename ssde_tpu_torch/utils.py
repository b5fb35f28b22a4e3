"""Host helpers of the training logs (copies of ``ssde_tpu/utils.py``
:85-105): the image rescale of the disparity panels and the clock format of
the console line."""

from __future__ import annotations

import numpy as np


def normalize_image(x):
    """Rescale image pixels to span range [0, 1] (reference utils.py:22-27)."""
    ma = float(np.max(x))
    mi = float(np.min(x))
    d = ma - mi if ma != mi else 1e5
    return (x - mi) / d


def sec_to_hm(t):
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    t //= 60
    return t, m, s


def sec_to_hm_str(t):
    """10239 -> '02h50m39s' (reference utils.py:41-49)."""
    h, m, s = sec_to_hm(t)
    return "{:02d}h{:02d}m{:02d}s".format(h, m, s)
