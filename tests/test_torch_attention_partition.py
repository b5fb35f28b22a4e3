"""The partition of the backward attention kernel #4
(``ssde_attend3_bwd``, ssde_tpu_torch/csrc/attention_win.cu), checked on
the CPU from the wrapper's constants and ``bwd_partition`` alone.

A warp takes one (b, c) plane, one strip of padded columns and one band of
padded rows. The warp of strip s holds BWD_WARP_COLS padded columns from
BWD_STRIP * s - halo, 2 a lane; it computes the outputs at the columns of
every lane but the last, and owns the columns of every lane but the first
and the last. Band b owns the padded rows [BWD_BAND * b, BWD_BAND * (b + 1))
and computes the output rows from 2 above it to its last. The checks: every
output pixel is owned once (dq, drel), every padded position once (dk, dv),
every output that adds to an owned padded position is computed by the same
warp from what the warp holds, and the drel scratch has one row per warp
(what the wrapper allocates and passes to the entry point).
"""

import numpy as np
import pytest
import torch

from ssde_tpu_torch.ops import attention_win
from ssde_tpu_torch.ops.attention_win import (BWD_BAND, BWD_STRIP, BWD_WARP_COLS,
                                              bwd_partition)

LANES = BWD_WARP_COLS // 2  # 2 columns a lane
HALO = (BWD_WARP_COLS - BWD_STRIP) // 2

# ragged (H, W) from 1x1 to 192x640: each side 1 and 2, the bands' and
# strips' edges (H + 2 and W + 2 one short of, at and one past a multiple),
# and the GRU v9 attention shapes at 640x192
SHAPES = [(1, 1), (1, 2), (2, 1), (2, 2), (3, 57), (BWD_BAND - 2, BWD_STRIP - 2),
          (BWD_BAND - 1, BWD_STRIP - 3), (BWD_BAND, BWD_STRIP - 1),
          (BWD_BAND + 1, 2 * BWD_STRIP - 1), (2 * BWD_BAND + 1, 1), (1, 2 * BWD_STRIP),
          (2 * BWD_BAND - 2, 3 * BWD_STRIP - 2), (9, 45), (37, 31), (17, 178), (100, 3),
          (24, 80), (48, 160), (96, 320), (192, 640)]


def _warps(H, W):
    """Each warp of one plane: (owned outputs, owned padded positions,
    computed outputs) as boolean masks over (H, W) and (H + 2, W + 2)."""
    strips, bands, _ = bwd_partition(1, 1, H, W)
    for s in range(strips):
        x0 = s * BWD_STRIP - HALO
        lane_cols = [(x0 + 2 * l, x0 + 2 * l + 1) for l in range(LANES)]
        computed_cols = [x for cols in lane_cols[:-1] for x in cols]
        owned_cols = [x for cols in lane_cols[1:-1] for x in cols]
        assert owned_cols == list(range(s * BWD_STRIP, (s + 1) * BWD_STRIP))
        for b in range(bands):
            p0, p1 = b * BWD_BAND, min((b + 1) * BWD_BAND, H + 2)
            owned_o, owned_p = np.zeros((H, W), bool), np.zeros((H + 2, W + 2), bool)
            computed = np.zeros((H, W), bool)
            ox = [x for x in owned_cols if 0 <= x < W]
            owned_o[p0:min(p1, H)][:, ox] = True
            owned_p[p0:p1][:, [x for x in owned_cols if x < W + 2]] = True
            computed[max(p0 - 2, 0):min(p1, H)][:, [x for x in computed_cols
                                                   if 0 <= x < W]] = True
            yield owned_o, owned_p, computed, x0


@pytest.mark.parametrize("H,W", SHAPES)
def test_every_position_is_owned_once_and_computed_by_its_owner(H, W):
    out_count = np.zeros((H, W), int)
    pad_count = np.zeros((H + 2, W + 2), int)
    warps = 0
    for owned_o, owned_p, computed, x0 in _warps(H, W):
        warps += 1
        out_count += owned_o
        pad_count += owned_p
        # an owned output is computed (its dq and drel come from this warp)
        assert not (owned_o & ~computed).any()
        # every output that adds to an owned padded position, output (y, x)
        # by tap (kh, kw) to padded (y + kh, x + kw), is computed by this
        # warp, on the lane of x + kw or the one to its left (the taps that
        # cross lanes go one lane right)
        lane = (np.arange(W) - x0) // 2
        for kh in range(3):
            for kw in range(3):
                adds = owned_p[kh:kh + H, kw:kw + W]
                assert not (adds & ~computed).any(), (kh, kw)
                assert np.isin((np.arange(W) + kw - x0) // 2 - lane, (0, 1))[adds.any(0)].all()
        # a computed output reads padded columns x .. x + 2: its own lane's
        # and the next one's, all held by the warp
        xs = np.nonzero(computed.any(0))[0]
        assert ((xs + 2 - x0) // 2 - (xs - x0) // 2 <= 1).all()
        assert (xs + 2 < x0 + BWD_WARP_COLS).all()
    assert (out_count == 1).all() and (pad_count == 1).all()
    strips, bands, n = bwd_partition(3, 5, H, W)
    assert warps == strips * bands and n == 3 * 5 * warps


@pytest.mark.parametrize("B,C,H,W", [(1, 1, 1, 1), (2, 3, BWD_BAND + 1, BWD_STRIP - 3),
                                     (8, 32, 192, 640)])
def test_wrapper_allocates_one_drel_row_per_warp(monkeypatch, B, C, H, W):
    calls, empties = [], []
    empty = torch.empty

    def spy_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        empties.append(tuple(t.shape))
        return t

    monkeypatch.setattr(attention_win, "_cuda_only", lambda t, name: None)
    monkeypatch.setattr(attention_win, "launch", lambda name, dev, *args: calls.append(args))
    monkeypatch.setattr(torch, "empty", spy_empty)
    rng = np.random.default_rng(0)
    q, g = (torch.from_numpy(rng.standard_normal((B, C, H, W), np.float32)) for _ in range(2))
    kp, vp = (torch.from_numpy(rng.standard_normal((B, C, H + 2, W + 2), np.float32))
              for _ in range(2))
    rel = torch.from_numpy(rng.standard_normal((9, C), np.float32))
    attention_win.attend3_bwd(q, kp, vp, rel, g)
    strips, bands, n = bwd_partition(B, C, H, W)
    assert n == B * C * strips * bands
    assert len(calls) == 1 and calls[0][-2] == n  # n_partials, then the dtype
    assert (n, 9) in empties and (9, C) in empties
