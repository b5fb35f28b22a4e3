"""The partitions of the photometric kernels #5 (``ssde_photometric_fwd``)
and #6 (``ssde_photometric_bwd``, ssde_tpu_torch/csrc/photometric.cu),
checked on the CPU from ``fwd_partition`` and ``bwd_partition`` alone.

A warp takes one pair g, one band of output rows and one strip of columns;
the lane of columns x, x + 1 loads columns x - 1 .. x + 2 of every row it
walks, reflected into the image, and the warp loads the band's rows and one
more above and below (two for the backward's coefficients), reflected.
The checks: every output (g, y, x) is written exactly once; every load lies
inside the image; each written output's window (forward) or coefficient
rows and columns (backward) are what the warp loads; the backward's
fold-back multiplicities, applied as the kernel applies them, are the
transpose of the reflect-pad 3x3 box sum; the forward and the adjoint,
run in float64 on those indices, equal the plain versions; and the
backward's live test meets the clip's ties as the plain version does.
"""

import numpy as np
import pytest
import torch

from ssde_tpu_torch.ops import photometric
from ssde_tpu_torch.ops.photometric import (BWD_BAND, BWD_COLS, BWD_STRIP, FWD_BAND, FWD_STRIP,
                                            LANES, WARPS, bwd_partition, fold, fwd_partition,
                                            photometric_bwd_reference, photometric_reference,
                                            reflect)

SIZES = (2, 3, 4, 5, 17, 33)
# H, W at the sizes above and at the bands and strips +- 1
SHAPES = ([(h, w) for h in SIZES for w in (2, 5, 33)]
          + [(FWD_BAND - 1, FWD_STRIP - 1), (FWD_BAND, FWD_STRIP), (FWD_BAND + 1, FWD_STRIP + 1),
             (BWD_BAND - 1, BWD_STRIP - 1), (BWD_BAND + 1, BWD_STRIP + 1),
             (2 * BWD_BAND + 1, 2 * BWD_STRIP), (3, 2 * FWD_STRIP + 2), (2 * FWD_BAND - 1, 4)])
LENGTHS = sorted(set(SIZES) | {FWD_BAND - 1, FWD_BAND, FWD_BAND + 1, FWD_STRIP - 1,
                               FWD_STRIP, FWD_STRIP + 1, BWD_BAND - 1, BWD_BAND,
                               BWD_BAND + 1, BWD_STRIP - 1, BWD_STRIP, BWD_STRIP + 1})


def _parts(G, B, H, W):
    return [(fwd_partition(G, B, H, W, vec), bwd_partition(G, B, H, W, vec))
            for vec in ((False, True) if W % 2 == 0 else (False,))]


def _check_loads(part, unit):
    H, W = part.H, part.W
    assert all(0 <= r < H for r in unit.rows)
    for c in unit.cols:
        assert all(0 <= i < W for i in c)
        if part.vec:  # one aligned float2
            assert c[1] % 2 == 0 and c[2] == c[1] + 1


@pytest.mark.parametrize("H,W", SHAPES)
def test_forward_writes_every_output_once_from_its_window(H, W):
    G, B = 4, 2
    for part, _ in _parts(G, B, H, W):
        written = np.zeros((G, H, W), int)
        units = list(part.units())
        for unit in units:
            _check_loads(part, unit)
            assert unit.g % B == unit.b
            assert len(unit.rows) == len(unit.out_rows) + 2
            for i, y in enumerate(unit.out_rows):
                assert unit.rows[i:i + 3] == (reflect(y - 1, H), y, reflect(y + 1, H))
            for x, c, own in zip(unit.x, unit.cols, unit.own):
                for j, (xo, mine) in enumerate(zip((x, x + 1), own)):
                    if mine:
                        assert c[j:j + 3] == (reflect(xo - 1, W), xo, reflect(xo + 1, W))
                        written[unit.g, list(unit.out_rows), xo] += 1
        assert (written == 1).all()
        assert len(units) == G * part.strips * part.bands
        assert (part.blocks - 1) * WARPS < len(units) <= part.blocks * WARPS
        # the pairs of one target are the grid's fastest index
        assert [u.g for u in units[:G // B]] == [k * B for k in range(G // B)]


@pytest.mark.parametrize("H,W", SHAPES)
def test_backward_writes_every_output_once_from_what_its_warp_computes(H, W):
    G, B = 4, 2
    for _, part in _parts(G, B, H, W):
        written = np.zeros((G, H, W), int)
        for unit in part.units():
            _check_loads(part, unit)
            assert len(unit.x) == LANES and unit.x[-1] + 2 - unit.x[0] == BWD_COLS
            # coefficient row q from loaded rows q - 1, q, q + 1
            assert len(unit.rows) == len(unit.coef_rows) + 2
            for i, q in enumerate(unit.coef_rows):
                assert unit.rows[i:i + 3] == (reflect(q - 1, H), q, reflect(q + 1, H))
            # an output row reads the coefficients of the rows around it
            for r in unit.out_rows:
                assert {q for q in (r - 1, r, r + 1) if 0 <= q < H} <= set(unit.coef_rows)
            # lane l computes the coefficients at its columns x, x + 1 from
            # the columns it takes (cols[l]: l, a0, a1, r)
            window = {}
            for lane, (x, c) in enumerate(zip(unit.x, unit.cols)):
                window[x], window[x + 1] = (lane, c[0:3]), (lane, c[1:4])
            for lane, (x, own) in enumerate(zip(unit.x, unit.own)):
                for xo, mine in zip((x, x + 1), own):
                    if not mine:
                        continue
                    written[unit.g, list(unit.out_rows), xo] += 1
                    # the coefficients it reads: from its own lane or a
                    # neighbour's (a shuffle), each from its true window
                    for qx in (xo - 1, xo, xo + 1):
                        if 0 <= qx < W:
                            src, cols = window[qx]
                            assert abs(src - lane) <= 1
                            assert cols == (reflect(qx - 1, W), qx, reflect(qx + 1, W))
        assert (written == 1).all()


def _box_sum(n):
    """The reflect-pad 3-sum as a dense (n, n) matrix: S[q, j] counts the
    offsets d with reflect(q + d) = j."""
    S = np.zeros((n, n), int)
    for q in range(n):
        for d in (-1, 0, 1):
            S[q, reflect(q + d, n)] += 1
    return S


@pytest.mark.parametrize("n", LENGTHS)
def test_fold_back_is_the_transpose_of_the_box_sum(n):
    K = np.zeros((n, n), int)
    for p in range(n):
        for q in (p - 1, p, p + 1):
            if 0 <= q < n:
                K[p, q] = fold(q, p, n)
    assert (K == _box_sum(n).T).all()


@pytest.mark.parametrize("H,W", [(h, w) for h in SIZES for w in SIZES]
                         + [(BWD_BAND + 1, BWD_STRIP - 1), (BWD_BAND - 1, BWD_STRIP + 1),
                            (BWD_BAND, BWD_STRIP), (2 * BWD_BAND + 1, 2 * BWD_STRIP + 1)])
def test_fold_back_as_the_kernel_applies_it(H, W):
    """The weights with which the backward's warps add coefficient (qy, qx)
    into output (y, x): the lane's column fold-backs times the row's,
    against the transpose of the 2-D reflect-pad box sum. Coefficients at
    columns outside the image are zero in the kernel, so they are left out."""
    for part in (bwd_partition(1, 1, H, W, vec) for vec in {False, W % 2 == 0}):
        M = np.zeros((H, W, H, W), int)
        for unit in part.units():
            for x, own, m in zip(unit.x, unit.own, unit.mcol):
                cols = [((x, ((x - 1, m[0]), (x, 1), (x + 1, m[1])))),
                        ((x + 1, ((x, m[2]), (x + 1, 1), (x + 2, m[3]))))]
                for (xo, taps), mine in zip(cols, own):
                    if not mine:
                        continue
                    for r, (mlo, mhi) in zip(unit.out_rows, unit.mrow):
                        for qy, my in ((r - 1, mlo), (r, 1), (r + 1, mhi)):
                            for qx, mx in taps:
                                if 0 <= qy < H and 0 <= qx < W:
                                    M[r, xo, qy, qx] += my * mx
        want = np.kron(_box_sum(H), _box_sum(W)).T.reshape(H, W, H, W)
        assert (M == want).all()


def _sums(a, b, rows, cols):
    """Window sums of x, y, x^2, y^2, xy at a lane's columns x, x + 1 from
    loaded rows and columns (cols: (32, 4)): (5, 32, 2)."""
    out = np.zeros((5, len(cols), 2))
    for r in rows:
        xs, ys = a[r][cols], b[r][cols]
        for i, v in enumerate((xs, ys, xs * xs, ys * ys, xs * ys)):
            for j in range(2):
                out[i, :, j] += v[:, j] + v[:, j + 1] + v[:, j + 2]
    return out


def _stats(s):
    mx, my = s[0] / 9, s[1] / 9
    vx, vy, cxy = s[2] / 9 - mx * mx, s[3] / 9 - my * my, s[4] / 9 - mx * my
    u, v = 2 * mx * my + 0.01 ** 2, 2 * cxy + 0.03 ** 2
    w, z = mx * mx + my * my + 0.01 ** 2, vx + vy + 0.03 ** 2
    return mx, my, u, v, w, z


def _emulate(part, pred, targ, gout=None):
    """The kernel's arithmetic in float64 on the partition's indices:
    the forward's output, or with ``gout`` the backward's d pred."""
    G, C, H, W = pred.shape
    out = np.full((G, H, W) if gout is None else (G, C, H, W), np.nan)
    for unit in part.units():
        cols = np.array(unit.cols)
        x = np.array(unit.x)
        inimg = np.stack([(x >= 0) & (x < W), (x + 1 >= 0) & (x + 1 < W)], 1)
        acc = np.zeros((len(unit.out_rows), LANES, 2))
        for c in range(C):
            a, b = pred[unit.g, c], targ[unit.b, c]
            if gout is None:
                for i, y in enumerate(unit.out_rows):
                    mx, my, u, v, w, z = _stats(_sums(a, b, unit.rows[i:i + 3], cols))
                    s = np.clip((1 - u * v / (w * z)) / 2, 0, 1)
                    acc[i] += 0.85 * s + 0.15 * np.abs(a[y][cols[:, 1:3]] - b[y][cols[:, 1:3]])
                continue
            adj = {}
            for i, q in enumerate(unit.coef_rows):
                mx, my, u, v, w, z = _stats(_sums(a, b, unit.rows[i:i + 3], cols))
                n, d = u * v, w * z
                s_raw = (1 - n / d) / 2
                gq = np.where((s_raw >= 0) & (s_raw <= 1),
                              gout[unit.g, q][cols[:, 1:3]] * 2 * 0.85 * -0.5 / 9 / C, 0)
                co = [np.where(inimg, gq * t, 0) for t in
                      ((my * (v - u) - n / d * mx * (z - w)) / d, u / d, n / d / d * w)]
                m = np.array(unit.mcol)
                # the lane below's x + 1 and the lane above's x, by shuffles
                adj[q] = [np.stack([m[:, 0] * np.r_[t[:1, 1], t[:-1, 1]] + t[:, 0]
                                    + m[:, 1] * t[:, 1],
                                    m[:, 2] * t[:, 0] + t[:, 1]
                                    + m[:, 3] * np.r_[t[1:, 0], t[-1:, 0]]], 1) for t in co]
            zero = [np.zeros((LANES, 2))] * 3
            for r, (mlo, mhi) in zip(unit.out_rows, unit.mrow):
                A, Bs, Cs = (mlo * lo + md + mhi * hi for lo, md, hi in
                             zip(adj.get(r - 1, zero), adj[r], adj.get(r + 1, zero)))
                xv, yv = a[r][cols[:, 1:3]], b[r][cols[:, 1:3]]
                dx = A + Bs * yv - Cs * xv + gout[unit.g, r][cols[:, 1:3]] * 0.15 / C * np.sign(
                    xv - yv)
                for j in range(2):
                    mine = np.array([o[j] for o in unit.own])
                    out[unit.g, c, r, x[mine] + j] = dx[mine, j]
        if gout is None:
            for j in range(2):
                mine = np.array([o[j] for o in unit.own])
                out[unit.g][np.ix_(unit.out_rows, x[mine] + j)] = acc[:, mine, j] / C
    return out


@pytest.mark.parametrize("H,W", [(2, 2), (3, 5), (4, 33), (5, 4), (17, 17), (33, 2),
                                 (BWD_BAND + 1, BWD_STRIP + 1), (FWD_BAND - 1, FWD_STRIP + 2),
                                 (2 * BWD_BAND + 1, 2 * BWD_STRIP - 1)])
def test_kernel_arithmetic_on_the_partition_matches_the_plain_versions(H, W):
    """The forward and the adjoint run in float64 on the partition's rows,
    columns, lanes and fold-backs equal the plain versions in float64."""
    G, B, C = 4, 2, 3
    rng = np.random.default_rng(H * 100 + W)
    pred, targ = rng.random((G, C, H, W)), rng.random((B, C, H, W))
    gout = rng.standard_normal((G, H, W))
    tp, tt, tg = (torch.from_numpy(a) for a in (pred, targ, gout))
    want_f = photometric_reference(tp, tt).numpy()
    want_b = photometric_bwd_reference(tp, tt, tg).numpy()
    for fwd, bwd in _parts(G, B, H, W):
        np.testing.assert_allclose(_emulate(fwd, pred, targ), want_f, rtol=0, atol=1e-12)
        got = _emulate(bwd, pred, targ, gout)
        np.testing.assert_allclose(got, want_b, rtol=0, atol=1e-11 * np.abs(want_b).max())


def test_grid_limit_is_the_kernels_own():
    # G past 65535 fits the 1-D grid; a grid past 2^31 - 1 blocks does not
    # (meta tensors: shapes without storage)
    def args(G, B, H, W):
        return torch.empty((G, 1, H, W), device="meta"), torch.empty((B, 1, H, W), device="meta")

    photometric._check_args(*args(70000, 1, 2, 2))
    big = (2**21, 1, BWD_BAND * 2**6, BWD_STRIP * 2**6)
    assert bwd_partition(*big).blocks > 2**31 - 1
    with pytest.raises(ValueError, match="grid"):
        photometric._check_args(*args(*big))


def test_live_test_decides_as_the_plain_clip():
    """The backward's live test, n <= d and n >= -d (csrc/photometric.cu
    ``coefs``), against the plain clip's 0 <= (1 - n / d) / 2 <= 1 in
    float32: alike on random n and d > 0, at the tie n = d and one float to
    either side of n = d and of n = -d. Below -d the plain clip also passes
    the quotients whose 1 - n / d still rounds to 2; SSIM >= -1 keeps them
    out of reach but for rounding."""
    rng = np.random.default_rng(5)
    d = np.exp(rng.uniform(np.log(1e-8), np.log(4.0), 20000)).astype(np.float32)
    r = rng.uniform(-1.5, 1.5, d.size).astype(np.float32)
    n = np.concatenate([(r * d).astype(np.float32), d, np.nextafter(d, np.inf),
                        np.nextafter(d, -np.inf), -d, np.nextafter(-d, np.inf),
                        np.nextafter(-d, -np.inf)])
    d = np.tile(d, 7)
    q = n / d
    s = (np.float32(1) - q) * np.float32(0.5)
    plain = (s >= 0) & (s <= 1)
    kernel = (n <= d) & (n >= -d)
    differ = plain != kernel
    assert (plain[n == d]).all() and (kernel[n == d]).all()
    assert ((n < -d) & plain & (q >= np.float32(-1 - 2.0 ** -22)))[differ].all()


def test_equal_windows_meet_the_tie_exactly():
    """A window with x = y gives n = d bit for bit with the backward's
    rounding (each product rounded on its own, csrc/photometric.cu
    ``window_stats``), as it does in the plain version: the clip passes its
    gradient there as the plain version's does."""
    f = np.float32
    rng = np.random.default_rng(6)
    for w in rng.random((2000, 9)).astype(f):
        sx = sxx = f(0)
        for v in w:
            sx, sxx = f(sx + v), f(sxx + f(v * v))
        sy, syy, sxy = sx, sxx, sxx  # the same sums in the same order
        mx, my = f(sx * f(1 / 9)), f(sy * f(1 / 9))
        mxx, myy, mxy = f(mx * mx), f(my * my), f(mx * my)
        vx, vy = f(f(sxx * f(1 / 9)) - mxx), f(f(syy * f(1 / 9)) - myy)
        cxy = f(f(sxy * f(1 / 9)) - mxy)
        u, v = f(f(2) * mxy + f(0.01 ** 2)), f(f(2) * cxy + f(0.03 ** 2))
        wd, z = f(f(mxx + myy) + f(0.01 ** 2)), f(f(vx + vy) + f(0.03 ** 2))
        assert f(u * v) == f(wd * z)
