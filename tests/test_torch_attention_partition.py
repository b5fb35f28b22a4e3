"""The partitions of the attention kernels #3 (``ssde_attend3_fwd``) and #4
(``ssde_attend3_bwd``, ssde_tpu_torch/csrc/attention_win.cu), checked on
the CPU from the wrapper's constants and ``fwd_partition`` and
``bwd_partition`` alone.

#3: a warp takes one (b, c) plane, one strip of output columns and one band
of output rows. The warp of strip s writes the outputs at columns from
FWD_STRIP * s, 2 a lane; the lane of outputs x, x + 1 reads padded columns
x .. x + 3, and the band's output rows read 2 padded rows past the band.
The checks: every output pixel is written by one warp, every tap of an
output a warp writes lies in the padded columns and rows its lane reads
and in the map, and the grid covers the warps.

#4:
a warp takes one (b, c) plane, one strip of padded columns and one band of
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
from ssde_tpu_torch.ops.attention_win import (BWD_BAND, BWD_STRIP, BWD_WARP_COLS, FWD_BAND,
                                              FWD_STRIP, FWD_WARPS, bwd_partition,
                                              fwd_partition)

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


# #3's own edges: H one short of, at and one past a band and past 2 bands;
# W one short of, at and one past a strip and 2 strips
FWD_SHAPES = [(FWD_BAND - 1, FWD_STRIP - 1), (FWD_BAND, FWD_STRIP), (FWD_BAND + 1, FWD_STRIP + 1),
              (2 * FWD_BAND + 1, 2 * FWD_STRIP - 1), (FWD_BAND, 2 * FWD_STRIP),
              (2 * FWD_BAND, 2 * FWD_STRIP + 1), (1, FWD_STRIP + 1), (FWD_BAND + 1, 1)]


@pytest.mark.parametrize("H,W", SHAPES + FWD_SHAPES)
def test_forward_writes_every_output_once_from_what_its_warp_holds(H, W):
    strips, bands, blocks = fwd_partition(1, 1, H, W)
    lanes = FWD_STRIP // 2
    written = np.zeros((H, W), int)
    for s in range(strips):
        x0 = s * FWD_STRIP
        for b in range(bands):
            y0 = b * FWD_BAND
            rows = range(y0, min(y0 + FWD_BAND, H))
            held_rows = set(range(y0, min(y0 + FWD_BAND + 2, H + 2)))
            for l in range(lanes):
                # lane l: outputs x0 + 2l and x0 + 2l + 1, padded x0 + 2l .. + 3
                held = set(range(x0 + 2 * l, x0 + 2 * l + 4))
                for x in (x0 + 2 * l, x0 + 2 * l + 1):
                    if x >= W:
                        continue
                    # the taps of output x: padded x .. x + 2
                    assert {x, x + 1, x + 2} <= held and x + 2 < W + 2
                    for y in rows:
                        assert {y, y + 1, y + 2} <= held_rows and y + 2 < H + 2
                        written[y, x] += 1
    assert (written == 1).all()
    assert (blocks - 1) * FWD_WARPS < strips * bands <= blocks * FWD_WARPS
    assert fwd_partition(3, 5, H, W) == (strips, bands, -(-15 * strips * bands // FWD_WARPS))


def test_grid_limit_is_the_kernels_own():
    # B * C past 65535 fits the warp grids; a grid past 2^31 - 1 blocks does not
    # (meta tensors: shapes without storage)
    def args(B, C, H, W):
        maps = [torch.empty(s, device="meta") for s in
                ((B, C, H, W), (B, C, H + 2, W + 2), (B, C, H + 2, W + 2))]
        return (*maps, torch.empty((9, C), device="meta"))

    attention_win._check_args(*args(70000, 1, 1, 1))
    assert fwd_partition(70000, 1, 1, 1)[2] <= 2**31 - 1
    big = (2**16, 2**12, FWD_BAND * 2**6, FWD_STRIP)
    assert fwd_partition(*big)[2] > 2**31 - 1
    with pytest.raises(ValueError, match="grid"):
        attention_win._check_args(*args(*big))


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
