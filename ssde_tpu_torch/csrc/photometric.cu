// Fused photometric error, 0.85 * SSIM + 0.15 * L1, forward (kernel #5) and
// backward (kernel #6); float32, NCHW, plain C interface, for Hopper
// (sm_90a).
//
// Replaces: ssde_tpu/ops/pallas/photometric.py
//   forward  `_photo_fwd_kernel` (:97) and its channel-grid (:181) and
//            H-blocked (:279) variants, via `_photo_call` (:328) and
//            `_photo_call_cgrid` (:229);
//   backward `_photo_bwd_kernel` (:110) and its channel-grid (:202) and
//            blocked (:296) variants, via `_photo_bwd_call` (:365) and
//            `_photo_bwd_call_cgrid` (:245).
// The three TPU variants exist only to fit VMEM; one kernel serves every
// (H, W) here.
//
// Contract: pred (G, C, H, W), targ (B, C, H, W), pair g reads targ[g % B].
//   forward:  out[g, y, x] = mean_c 0.85 * clip((1 - SSIM) / 2, 0, 1)
//                                 + 0.15 * |p - t|
//             with 3x3 box means under reflect padding, C1 = 0.01^2,
//             C2 = 0.03^2 (ssde_tpu/ops/losses.py `ssim`).
//   backward: dpred only (the target is raw data). The box statistics are
//             recomputed, not saved; the coefficient maps a = gq * t_const,
//             b = gq * t_y and c = gq * t_x go through the exact adjoint of
//             the reflect-pad box sum, separably as `_adjoint_box3` (:67):
//             dx[p] = sum over in-image q of the 3x3 neighbourhood of p of
//             coef[q] * m(qy, py, H) * m(qx, px, W), where the fold-back
//             multiplicity m(q, p, n) counts the offsets d in {-1, 0, 1}
//             with reflect(q + d) = p (2 for q = 0, p = 1 and q = n-1,
//             p = n-2; else 1; 0 for q outside [0, n)). Then dx = A + B y
//             - C x + g 0.15 sign(x - y) / C for the adjoint sums A, B, C
//             of a, b, c. The clip passes gradient on the closed interval
//             [0, 1] and sign(0) = 0, as jax.grad of the plain formulation
//             gives (`coefs` says how the live test keeps the ties).
//
// What bounds them on the H100. The forward reads 2 C floats a pixel (the
// target once for its G / B pairs) and writes 1: at G = 120, C = 3, 640x192,
// 254 MB, 0.076 ms at 3.35 TB/s. The backward reads 2 C + 1 and writes C,
// 430 MB, 0.129 ms. Their arithmetic, 52.5 and 93.5 floating-point operations
// a value (counted in ops/photometric.py), is below those times at 67
// TFLOP/s, but close enough that instructions, registers and load latency
// decide what is reached: the walks below keep each at about 60-90 % of
// the issue rate (PERF.md, Findings).
//
// Design. One warp walks a band of rows of one strip of columns of one pair
// g, once per channel, with no shared memory and no barrier. The lane of
// columns x, x + 1 loads one float2 a row and tensor (where W is even and
// the planes 8-byte aligned); its halo columns x - 1 and x + 2 come from
// the neighbour lanes by shuffles, are reflected at the image's first and
// last columns, and only the warp's edge lanes load theirs. Its pointers
// move a row at a time; rows are reflected only at the walk's first and
// last. Each loaded row's horizontal 3-sums of x, y, x^2, y^2 and xy are
// formed once, and a window's sums are the vertical 3-sum of the last
// three rows', carried as (rows r - 1 + r) and row r.
//   Forward: strips of 64 output columns, bands of kFwdBand output rows,
//   unrolled; the channel sums of the band stay in registers and each output
//   is written once. Channels inside the row step (all C carried at once)
//   needed 178 registers and ran 2.4x slower; longer bands spill or lose
//   warps (PERF.md).
//   Backward: one pipeline along the band. Loading input row q + 1 gives
//   the window sums at row q, hence the coefficients at row q (zero outside
//   the image; one reciprocal of d, no division), whose horizontal adjoint
//   with the column fold-back takes the neighbour lanes' coefficients by
//   shuffles. Three rows of those sums make output row q - 1, the row
//   fold-back applied where the row is 1 or H - 2. A lane that lacks a
//   neighbour's coefficients (lanes 0 and 31) owns no output: a warp holds
//   64 columns and owns the 60 of lanes 1..30, strips overlap by 4, and a
//   band recomputes the coefficients of the rows above and below it. The
//   next rows' loads are issued first and without a branch, L2 is asked
//   for rows further ahead, and the row loop is unrolled by 3 by hand.
//   The channels are walked one after another, so gout is read once per
//   channel (from L1 or L2 after the first); carrying all C channels through
//   a row step, which reads it once, needed 255 registers and spilled.
//   The G / B = 10 pairs that share targ[b] are the fastest index of the
//   1-D grid, so they run side by side and the target comes from device
//   memory about once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ssde_tpu_torch/ops/build.py); bound with ctypes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps a block, each on its own unit
// ops/photometric.py mirrors these as FWD_STRIP, FWD_BAND, BWD_COLS,
// BWD_STRIP, BWD_BAND and WARPS
constexpr int kFwdStrip = 2 * kLanes;  // output columns of a forward warp
constexpr int kFwdBand = 4;            // output rows of a forward warp
constexpr int kBwdCols = 2 * kLanes;   // columns a backward warp holds ...
constexpr int kBwdStrip = kBwdCols - 4;  // ... and owns (lanes 1..30)
constexpr int kBwdBand = 16;           // output rows of a backward warp
// blocks an SM must hold: caps the registers (65536 / (128 x blocks))
constexpr int kFwdBlocks = 6, kBwdBlocks = 4;
// rows ahead of the one in registers that the backward asks L2 to fetch
constexpr int kL2Ahead = 2;

constexpr float C1 = 0.01f * 0.01f, C2 = 0.03f * 0.03f;
constexpr float SSIM_W = 0.85f, L1_W = 0.15f;

// reflect(-1) = 1, reflect(n) = n - 2; indices further out are clamped into
// the image (they feed only columns or rows that no owned output reads)
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i > n - 1 ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// the fold-back multiplicity of the reflect-pad 3x3 box sum's adjoint: how
// many offsets d in {-1, 0, 1} take q + d to p under reflect, for |q - p| <= 1
__device__ __forceinline__ float fold(int q, int p, int n) {
  if (q < 0 || q >= n) return 0.f;
  return (q == 0 && p == 1) || (q == n - 1 && p == n - 2) ? 2.f : 1.f;
}

// The columns a lane reads for its pair x, x + 1: x - 1, the pair and
// x + 2, reflected into the image. VEC (W even, planes 8-byte aligned): the
// lane loads only its pair, one float2 at an even column a0 (x, clamped
// into the image), from one pointer a row; its halo is the neighbour lanes'
// pair values (shuffles), or where the image ends its own other value
// (reflect(-1) = 1, reflect(W) = W - 2), or, at the warp's edge lanes and
// only where they need it (EDGE, the forward), a load at a0 - 1 or a0 + 2.
// Otherwise each column is reflected and loaded on its own, and the
// pointer is the row's start.
struct Cols {
  int l, a0, a1, r;                   // not VEC: the four columns
  bool refl_l, refl_r, mem_l, mem_r;  // VEC: where the halo comes from
};

template <bool VEC, bool EDGE>
__device__ __forceinline__ Cols lane_cols(int x, int W, int lane) {
  Cols c{};
  if (VEC) {
    c.a0 = min(max(x, 0), W - 2);
    c.a1 = c.a0 + 1;
    c.refl_l = c.a0 == 0;
    c.refl_r = c.a0 + 2 >= W;
    c.mem_l = EDGE && lane == 0 && !c.refl_l;
    c.mem_r = EDGE && lane == kLanes - 1 && !c.refl_r;
  } else {
    c.l = reflect(x - 1, W);
    c.a0 = reflect(x, W);
    c.a1 = reflect(x + 1, W);
    c.r = reflect(x + 2, W);
  }
  return c;
}

// the offset of a lane's row pointer from the row's start
template <bool VEC>
__device__ __forceinline__ int lane_offset(const Cols& c) {
  return VEC ? c.a0 : 0;
}

// one row's values at a lane's four columns; as loaded (VEC: the pair, and
// the halo only where mem_l or mem_r), then completed by with_halo
struct Quad {
  float l, a0, a1, r;
};

// columns a0, a1 of the row at the lane's pointer p
template <bool VEC>
__device__ __forceinline__ float2 load_pair(const float* __restrict__ p, const Cols& c) {
  if (VEC) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p + c.a0), __ldg(p + c.a1));
}

template <bool VEC>
__device__ __forceinline__ Quad load_quad(const float* __restrict__ p, const Cols& c) {
  const float2 a = load_pair<VEC>(p, c);
  if (VEC) return {c.mem_l ? __ldg(p - 1) : 0.f, a.x, a.y, c.mem_r ? __ldg(p + 2) : 0.f};
  return {__ldg(p + c.l), a.x, a.y, __ldg(p + c.r)};
}

// the halo of a loaded row (the whole warp, at the row's use)
template <bool VEC>
__device__ __forceinline__ Quad with_halo(Quad q, const Cols& c) {
  if (VEC) {
    const float up = __shfl_up_sync(kFull, q.a1, 1), down = __shfl_down_sync(kFull, q.a0, 1);
    q.l = c.refl_l ? q.a1 : c.mem_l ? q.l : up;
    q.r = c.refl_r ? q.a0 : c.mem_r ? q.r : down;
  }
  return q;
}

// store v0, v1 to the lane's columns x (if own0) and x + 1 (if own1) of the
// row at the lane's pointer p; with VEC own0 == own1 and p is at x
template <bool VEC>
__device__ __forceinline__ void store_pair(float* __restrict__ p, int x, float v0, float v1,
                                           bool own0, bool own1) {
  if (VEC) {
    if (own0) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (own0) p[x] = v0;
    if (own1) p[x + 1] = v1;
  }
}

// sums of x, y, x^2, y^2 and xy at the lane's two columns: over three
// columns of one row (horizontal), or over a 3x3 window
struct Sums {
  float x[2], y[2], xx[2], yy[2], xy[2];
};

// The products and the statistics below round each product on its own
// (__fmul_rn: no fused multiply-add), so that a window with x = y gives
// u = w, v = z and n = d bit for bit, as the plain version does: its clip
// and its sign meet their ties where the plain version meets them.

// the horizontal 3-sums of one loaded row of pred (xl) and targ (yl):
// column x sums columns l, a0, a1, column x + 1 sums a0, a1, r
template <bool VEC>
__device__ __forceinline__ Sums row_sums(const Quad& xl, const Quad& yl, const Cols& c) {
  const Quad xq = with_halo<VEC>(xl, c), yq = with_halo<VEC>(yl, c);
  const float xs[4] = {xq.l, xq.a0, xq.a1, xq.r}, ys[4] = {yq.l, yq.a0, yq.a1, yq.r};
  float xx[4], yy[4], xy[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xx[i] = __fmul_rn(xs[i], xs[i]);
    yy[i] = __fmul_rn(ys[i], ys[i]);
    xy[i] = __fmul_rn(xs[i], ys[i]);
  }
  // the pair's sum is shared by both columns
  const float mx = xs[1] + xs[2], my = ys[1] + ys[2], mxx = xx[1] + xx[2],
              myy = yy[1] + yy[2], mxy = xy[1] + xy[2];
  return {{xs[0] + mx, mx + xs[3]}, {ys[0] + my, my + ys[3]}, {xx[0] + mxx, mxx + xx[3]},
          {yy[0] + myy, myy + yy[3]}, {xy[0] + mxy, mxy + xy[3]}};
}

__device__ __forceinline__ Sums add(const Sums& a, const Sums& b) {
  Sums s;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s.x[j] = a.x[j] + b.x[j];
    s.y[j] = a.y[j] + b.y[j];
    s.xx[j] = a.xx[j] + b.xx[j];
    s.yy[j] = a.yy[j] + b.yy[j];
    s.xy[j] = a.xy[j] + b.xy[j];
  }
  return s;
}

// SSIM's factors at column j of the window sums: n = u v, d = w z
struct Stats {
  float mx, my, u, v, w, z;
};

__device__ __forceinline__ Stats window_stats(const Sums& s, int j) {
  constexpr float k9 = 1.f / 9.f;
  Stats st;
  st.mx = s.x[j] * k9;
  st.my = s.y[j] * k9;
  const float mxx = __fmul_rn(st.mx, st.mx), myy = __fmul_rn(st.my, st.my);
  const float mxy = __fmul_rn(st.mx, st.my);
  const float vx = __fmul_rn(s.xx[j], k9) - mxx, vy = __fmul_rn(s.yy[j], k9) - myy;
  const float cxy = __fmul_rn(s.xy[j], k9) - mxy;
  st.u = 2.f * mxy + C1;
  st.v = 2.f * cxy + C2;
  st.w = mxx + myy + C1;
  st.z = vx + vy + C2;
  return st;
}

// ask L2 for the line at p (no register, no wait)
__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// 1 / x on the special-function unit (rcp.approx, 1 ulp); x = d lies in
// [C1 C2, 4], far from the flush range
__device__ __forceinline__ float rcp_sfu(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the coefficients (a, b, c) at one column of the window sums s, for the
// scaled upstream gradient gk = g * 2 * 0.85 * (-0.5 / 9) / C
struct Coef {
  float a, b, c;
};

__device__ __forceinline__ Coef coefs(const Sums& s, int j, float gk) {
  const Stats st = window_stats(s, j);
  const float n = st.u * st.v, d = st.w * st.z;
  const float inv_d = rcp_sfu(d), ratio = n * inv_d;
  // The plain version's clip passes gradient where 0 <= (1 - n / d) / 2 <= 1
  // with n / d rounded. For d > 0 the rounded quotient is at most 1 exactly
  // when n <= d (it is monotone and leaves 1 only past n = d), so the
  // exact tie of a window with x = y (n = d bit for bit, as above) passes.
  // n >= -d holds without rounding (SSIM >= -1: |2 cov| <= var x + var y),
  // so this test only drops what rounding puts below it, as the plain clip
  // drops a quotient rounded below -1.
  const float gqi = n <= d && n >= -d ? gk * inv_d : 0.f;
  // d(n/d)/dx_i: the window-constant part and the y_i, x_i cofactors
  const float t = st.my * (st.v - st.u) - ratio * st.mx * (st.z - st.w);
  return {gqi * t, gqi * st.u, gqi * ratio * st.w};
}

// unit = ((b * bands + band) * strips + strip) * pairs + k reads pair
// g = k * B + b: the pairs of one target are the fastest index
struct Unit {
  long g;
  int b, band, strip;
};

__device__ __forceinline__ Unit decompose(long unit, int B, int pairs, int strips, int bands) {
  Unit u;
  const int k = (int)(unit % pairs);
  long rest = unit / pairs;
  u.strip = (int)(rest % strips);
  rest /= strips;
  u.band = (int)(rest % bands);
  u.b = (int)(rest / bands);
  u.g = (long)k * B + u.b;
  return u;
}

// The forward of one channel over output rows y0 .. y0 + rows - 1 into acc;
// pp and tp are the lane's pointers into row 0 of the channel's planes.
// FULL: rows = kFwdBand, so the unrolled walk needs no row test.
template <bool VEC, bool FULL>
__device__ __forceinline__ void fwd_band(const float* pp, const float* tp, const Cols& cols,
                                         int y0, int rows, int H, int W,
                                         float (&acc)[kFwdBand][2]) {
  const long above = (long)reflect(y0 - 1, H) * W;
  Quad p = load_quad<VEC>(pp + (long)y0 * W, cols), t = load_quad<VEC>(tp + (long)y0 * W, cols);
  Sums cur = row_sums<VEC>(p, t, cols);  // row y
  Sums part = add(row_sums<VEC>(load_quad<VEC>(pp + above, cols),
                                load_quad<VEC>(tp + above, cols), cols),
                  cur);       // rows y - 1 + y
  // the L1 term of an output row is added when its row arrives
  acc[0][0] += L1_W * fabsf(p.a0 - t.a0);
  acc[0][1] += L1_W * fabsf(p.a1 - t.a1);
  // the pointers walk the input rows y + 1 .. y0 + rows, the last reflected
  // where it is the image's row H
  const long back = y0 + rows == H ? 2L * W : 0L;
  pp += (long)(y0 + 1) * W - (rows == 1 ? back : 0);
  tp += (long)(y0 + 1) * W - (rows == 1 ? back : 0);
  Quad np = load_quad<VEC>(pp, cols), nt = load_quad<VEC>(tp, cols);
#pragma unroll
  for (int i = 0; i < kFwdBand; ++i) {
    if (!FULL && i >= rows) break;  // the whole warp
    p = np, t = nt;
    if (i + 1 < kFwdBand && (FULL || i + 1 < rows)) {  // prefetch input row y + 2
      const long step = (FULL ? i + 2 == kFwdBand : i + 2 == rows) ? W - back : W;
      pp += step;
      tp += step;
      np = load_quad<VEC>(pp, cols);
      nt = load_quad<VEC>(tp, cols);
      acc[i + 1][0] += L1_W * fabsf(p.a0 - t.a0);
      acc[i + 1][1] += L1_W * fabsf(p.a1 - t.a1);
    }
    const Sums h = row_sums<VEC>(p, t, cols);
    const Sums win = add(part, h);
    part = add(cur, h);
    cur = h;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // SSIM from the window's sums S (means S / 9), every factor scaled by
      // 81: u = 2 Sx Sy + 81 C1, v = 2 (9 Sxy - Sx Sy) + 81 C2, w = Sx^2 +
      // Sy^2 + 81 C1, z = 9 (Sxx + Syy) - Sx^2 - Sy^2 + 81 C2
      const float sx = win.x[j], sy = win.y[j];
      const float sxy = sx * sy, m2 = fmaf(sx, sx, sy * sy);
      const float u = fmaf(2.f, sxy, 81.f * C1), w = m2 + 81.f * C1;
      const float v = fmaf(18.f, win.xy[j], fmaf(-2.f, sxy, 81.f * C2));
      const float z = fmaf(9.f, win.xx[j] + win.yy[j], 81.f * C2 - m2);
      const float s = fminf(fmaxf((1.f - u * v * rcp_sfu(w * z)) * 0.5f, 0.f), 1.f);
      acc[i][j] += SSIM_W * s;
    }
  }
}

// One warp per (pair, band, strip) unit; the source note says how it walks.
template <bool VEC>
__global__ void __launch_bounds__(kWarps * kLanes, kFwdBlocks) photometric_fwd_kernel(
    const float* __restrict__ pred, const float* __restrict__ targ, float* __restrict__ out,
    int B, int C, int H, int W, int pairs, int strips, int bands, long units) {
  const long unit = (long)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (unit >= units) return;  // the whole warp
  const int lane = threadIdx.x % kLanes;
  const Unit u = decompose(unit, B, pairs, strips, bands);
  const int x = u.strip * kFwdStrip + 2 * lane;
  const bool own0 = x < W, own1 = x + 1 < W;
  const Cols cols = lane_cols<VEC, true>(x, W, lane);
  const int off = lane_offset<VEC>(cols);
  const int y0 = u.band * kFwdBand, rows = min(kFwdBand, H - y0);
  const long plane = (long)H * W;
  float acc[kFwdBand][2];  // the band's channel sums
#pragma unroll
  for (int i = 0; i < kFwdBand; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* const pp = pred + (u.g * C + c) * plane + off;
    const float* const tp = targ + ((long)u.b * C + c) * plane + off;
    if (rows == kFwdBand)
      fwd_band<VEC, true>(pp, tp, cols, y0, rows, H, W, acc);
    else
      fwd_band<VEC, false>(pp, tp, cols, y0, rows, H, W, acc);
  }
  float* const orow = out + u.g * plane + (long)y0 * W + off;
  const float inv_c = 1.f / C;
#pragma unroll
  for (int i = 0; i < kFwdBand; ++i) {
    if (i >= rows) break;
    store_pair<VEC>(orow + (long)i * W, x, acc[i][0] * inv_c, acc[i][1] * inv_c, own0, own1);
  }
}

// the horizontal adjoint sums of the coefficients at the lane's two columns
struct Adj {
  float a[2], b[2], c[2];
};

// the horizontal adjoint sums o at columns x, x + 1 of one coefficient map
// (c0 at x, c1 at x + 1), left to right: x takes x - 1 (from the lane
// below, by shuffle), x and x + 1; x + 1 takes x, x + 1 and x + 2 (from the
// lane above); m holds the four column fold-backs
__device__ __forceinline__ void adjoint_row(float c0, float c1, const float (&m)[4],
                                            float (&o)[2]) {
  const float left = __shfl_up_sync(kFull, c1, 1), right = __shfl_down_sync(kFull, c0, 1);
  o[0] = fmaf(m[1], c1, fmaf(m[0], left, c0));
  o[1] = fmaf(m[3], right, fmaf(m[2], c0, c1));
}

// One warp per (pair, band, strip) unit; the source note says how it walks.
template <bool VEC>
__global__ void __launch_bounds__(kWarps * kLanes, kBwdBlocks) photometric_bwd_kernel(
    const float* __restrict__ pred, const float* __restrict__ targ,
    const float* __restrict__ gout, float* __restrict__ dpred, int B, int C, int H, int W,
    int pairs, int strips, int bands, long units) {
  const long unit = (long)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (unit >= units) return;  // the whole warp
  const int lane = threadIdx.x % kLanes;
  const Unit u = decompose(unit, B, pairs, strips, bands);
  // this lane's columns x, x + 1; lanes 1..30 own theirs
  const int x = u.strip * kBwdStrip - 2 + 2 * lane;
  const bool mine = lane >= 1 && lane <= kLanes - 2;
  const bool own0 = mine && x < W, own1 = mine && x + 1 < W;
  const bool in0 = x >= 0 && x < W, in1 = x + 1 >= 0 && x + 1 < W;
  const Cols cols = lane_cols<VEC, false>(x, W, lane);
  const int off = lane_offset<VEC>(cols);
  // column fold-back: x - 1 and x + 1 into x, x and x + 2 into x + 1
  const float mcol[4] = {fold(x - 1, x, W), fold(x + 1, x, W), fold(x, x + 1, W),
                         fold(x + 2, x + 1, W)};
  // output rows [p0, p1); coefficient rows qa..qb reach them, from input
  // rows qa - 1 .. qb + 1
  const int p0 = u.band * kBwdBand, p1 = min(p0 + kBwdBand, H);
  const int qa = max(p0 - 1, 0), qb = min(p1, H - 1);
  const long plane = (long)H * W;
  const float gscale = 2.f * SSIM_W * (-0.5f / 9.f) / C, lscale = L1_W / C;
  for (int c = 0; c < C; ++c) {
    // the lane's pointers walk input row q + 1 (pred, targ), gout row q + 1
    // and output row q - 1
    const float* pp = pred + (u.g * C + c) * plane + off;
    const float* tp = targ + ((long)u.b * C + c) * plane + off;
    const float* gp = gout + u.g * plane + off + (long)qa * W;
    float* dp = dpred + (u.g * C + c) * plane + off + (long)p0 * W;
    const long above = (long)reflect(qa - 1, H) * W;
    pp += (long)qa * W;
    tp += (long)qa * W;
    Quad p = load_quad<VEC>(pp, cols), t = load_quad<VEC>(tp, cols);
    Sums cur = row_sums<VEC>(p, t, cols);  // input row q
    Sums part = add(row_sums<VEC>(load_quad<VEC>(pp - (long)qa * W + above, cols),
                                  load_quad<VEC>(tp - (long)qa * W + above, cols), cols),
                    cur);       // input rows q - 1 + q
    // pred, targ at rows q - 1 and q
    float rx[2][2] = {{0.f, 0.f}, {p.a0, p.a1}}, ry[2][2] = {{0.f, 0.f}, {t.a0, t.a1}};
    pp += W;  // row qa + 1 <= H - 1
    tp += W;
    Quad np = load_quad<VEC>(pp, cols), nt = load_quad<VEC>(tp, cols);
    // gout at rows q - 1 and q, and row q + 1 prefetched
    float2 gprev = make_float2(0.f, 0.f), gcur = load_pair<VEC>(gp, cols), gnext = gprev;
    if (qa + 1 <= qb) gnext = load_pair<VEC>(gp + W, cols);
    Adj lo = {}, md = {};  // adjoint sums of coefficient rows q - 2, q - 1

    // output row r from the adjoint sums of coefficient rows r - 1 (lo), r
    // (md) and r + 1 (hi), with the row fold-back
    auto emit = [&](int r, const Adj& hi) {
      const float mlo = fold(r - 1, r, H), mhi = fold(r + 1, r, H);
      const float gs[2] = {gprev.x, gprev.y};
      float d[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float A = fmaf(mhi, hi.a[j], fmaf(mlo, lo.a[j], md.a[j]));
        const float Bs = fmaf(mhi, hi.b[j], fmaf(mlo, lo.b[j], md.b[j]));
        const float Cs = fmaf(mhi, hi.c[j], fmaf(mlo, lo.c[j], md.c[j]));
        const float xv = rx[0][j], yv = ry[0][j];
        const float sgn = (float)((xv > yv) - (xv < yv));
        d[j] = A + Bs * yv - Cs * xv + gs[j] * lscale * sgn;
      }
      store_pair<VEC>(dp, x, d[0], d[1], own0, own1);
      dp += W;
    };

    auto row_step = [&](int q) {
      // prefetch input row q + 2 (reflected past the image) and gout row
      // q + 2 with no branch, so that the loads issue first; past the band's
      // last row the pointers stay and load their row again
      p = np, t = nt;
      const long step = q + 1 > qb ? 0 : q + 2 == H ? -W : W;
      pp += step;
      tp += step;
      np = load_quad<VEC>(pp, cols);
      nt = load_quad<VEC>(tp, cols);
      gp += q + 2 <= qb ? W : 0;
      const float2 gload = load_pair<VEC>(gp + W, cols);
      if (q + 2 + kL2Ahead < H) {
        prefetch_l2(pp + kL2Ahead * W);
        prefetch_l2(tp + kL2Ahead * W);
        prefetch_l2(gp + (kL2Ahead + 1) * W);
      }
      const Sums h = row_sums<VEC>(p, t, cols);
      const Sums win = add(part, h);
      part = add(cur, h);
      cur = h;
      Coef cf0 = coefs(win, 0, gcur.x * gscale), cf1 = coefs(win, 1, gcur.y * gscale);
      if (!in0) cf0 = {0.f, 0.f, 0.f};
      if (!in1) cf1 = {0.f, 0.f, 0.f};
      Adj hi;
      adjoint_row(cf0.a, cf1.a, mcol, hi.a);
      adjoint_row(cf0.b, cf1.b, mcol, hi.b);
      adjoint_row(cf0.c, cf1.c, mcol, hi.c);
      if (q - 1 >= p0) emit(q - 1, hi);
      lo = md;
      md = hi;
#pragma unroll
      for (int j = 0; j < 2; ++j) rx[0][j] = rx[1][j], ry[0][j] = ry[1][j];
      rx[1][0] = p.a0, rx[1][1] = p.a1, ry[1][0] = t.a0, ry[1][1] = t.a1;
      gprev = gcur;
      gcur = gnext;
      gnext = gload;
    };
    int q = qa;
    for (; q + 2 <= qb; q += 3) {
      row_step(q);
      row_step(q + 1);
      row_step(q + 2);
    }
    for (; q <= qb; ++q) row_step(q);
    // the image's last row has no coefficient row below it
    if (p1 == H) emit(H - 1, Adj{});
  }
}

bool bad_shape(int G, int B, int C, int H, int W) {
  return H < 2 || W < 2 || C < 1 || B < 1 || G < 0 || G % B;
}

bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

}  // namespace

// pred (G, C, H, W), targ (B, C, H, W), out (G, H, W), float32. The grid,
// one warp per (pair, band of 4 output rows, strip of 64 output columns),
// 4 warps a block, must have at most 2^31 - 1 blocks.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssde_photometric_fwd(const void* pred, const void* targ, void* out,
                                    int G, int B, int C, int H, int W, void* stream) {
  if (bad_shape(G, B, C, H, W)) return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  const int strips = (W + kFwdStrip - 1) / kFwdStrip, bands = (H + kFwdBand - 1) / kFwdBand;
  const long units = (long)G * strips * bands, blocks = (units + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = W % 2 == 0 && aligned8(pred) && aligned8(targ) && aligned8(out);
  auto* k = vec ? photometric_fwd_kernel<true> : photometric_fwd_kernel<false>;
  k<<<(unsigned)blocks, kWarps * kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)pred, (const float*)targ, (float*)out, B, C, H, W, G / B, strips, bands,
      units);
  return (int)cudaGetLastError();
}

// gout (G, H, W) and dpred (G, C, H, W), float32. The grid, one warp per
// (pair, band of 16 output rows, strip of 60 owned columns), 4 warps a
// block, must have at most 2^31 - 1 blocks.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssde_photometric_bwd(const void* pred, const void* targ, const void* gout,
                                    void* dpred, int G, int B, int C, int H, int W,
                                    void* stream) {
  if (bad_shape(G, B, C, H, W)) return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  const int strips = (W + kBwdStrip - 1) / kBwdStrip, bands = (H + kBwdBand - 1) / kBwdBand;
  const long units = (long)G * strips * bands, blocks = (units + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = W % 2 == 0 && aligned8(pred) && aligned8(targ) && aligned8(gout) &&
                   aligned8(dpred);
  auto* k = vec ? photometric_bwd_kernel<true> : photometric_bwd_kernel<false>;
  k<<<(unsigned)blocks, kWarps * kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)pred, (const float*)targ, (const float*)gout, (float*)dpred, B, C, H, W,
      G / B, strips, bands, units);
  return (int)cudaGetLastError();
}
