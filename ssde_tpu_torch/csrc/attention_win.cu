// Fused 3x3 windowed per-channel attention, forward (kernel #3) and backward
// (kernel #4), NCHW, for Hopper (sm_90a).
//
// Replaces ssde_tpu/ops/pallas/attention_win.py: ssde_attend3_fwd the
// forward _fwd_kernel (:117, reached through _attend3_fwd_call :279) and
// ssde_attend3_bwd the backward _bwd_kernel (:150, reached through
// _attend3_bwd :332). Per channel c of every pixel, over its 3x3 window
// (tap i = kh*3 + kw reads the padded maps at (h + kh, w + kw)):
//
//   logit_i = q * (k_i + rel_i),  s = softmax(logit),  out = sum_i s_i v_i
//
// and backward, for the output gradient g:
//
//   u_i = s_i g,  dlogit_i = u_i (v_i - out),  dq = sum_i dlogit_i (k_i + rel_i)
//   dk at padded (h + kh, w + kw) += dlogit_i q,  dv there += u_i
//   drel_i = sum over b, h, w of dlogit_i q
//
// q and g are (B, C, H, W); kp and vp (B, C, H+2, W+2) with the conv bias on
// the one-pixel ring; rel (9, C) float32. Operands are float32 or bf16, the
// arithmetic float32, the outputs in the operands' dtype, drel float32.
//
// What bounds them. Per output value the forward reads q, k, v and writes
// out (4 maps) for 9 logits, their max, 9 exps and sums; the backward reads
// q, k, v, g and writes dq, dk, dv (7 maps). At the GRU v9 training shape
// (16 calls per frame-step, B=8, 640x192, bf16, 235.9 M outputs) that is
// 1.92 GB forward (0.57 ms at 3.35 TB/s) and 3.3 GB (0.99 ms) backward. The
// forward's other two bounds sit as close: 9 exps and a reciprocal an output
// on the special-function unit (16 a clock an SM, about 0.57 ms), and about
// 70 instructions an output at 4 warp instructions a clock an SM (about 0.5
// ms), so it loads each value once a pass, keeps k and v in registers, and
// spends instructions sparingly: 2^x and 1/x on the special-function unit
// and one FMA a tap into base 2. The backward is bound by instruction issue:
// its row loop is about 230 instructions per output pixel (9 logits, their
// max, exps and sums, then 5 operations per tap for u, dlogit, a, dq and
// drel, and the scatter), about 2.9 ms per frame-step, so it too takes 2^x
// and 1/x on the special-function unit, sums drel without a branch, and
// stages no k or v.
//
// Design. The channels are independent, so each unit of work lies in one
// (b, c) plane, and in both passes one warp walks one strip of columns and
// one band of rows of it: no shared memory, no barrier, no atomics.
//   Forward: the warp of strip s computes the 64 outputs from column 64 s,
//   2 a lane: the lane of outputs x, x + 1 loads padded columns x .. x + 3
//   as two pairs (a bf16 or float32 pair is one load where the row is
//   aligned; a padded row of W + 2 values starts on a pair but not on 4
//   values). Its second pair is the next lane's first, loaded again: that
//   timed faster than passing it by __shfl_down_sync, and leaves no lane
//   idle as a halo. The warp walks the 16 output rows of its band in order
//   with k and v of padded rows y, y + 1, y + 2 in registers (a rolling
//   window, the next padded row and q row prefetched), so it reads 18
//   padded rows for 16 output rows, and writes each output once. Bands of
//   16 rows with the row loop unrolled by 2 timed faster than bands of 32
//   or 8 (PERF.md, Findings).
//   Backward: the TPU kernel walks rows in order, scattering dk/dv into
//   sliding accumulators for three padded rows and emitting a row after its
//   last contribution. Here one warp does the same for one (b, c) plane,
//   one strip of padded columns and one band of rows. Each lane holds 2
//   adjacent columns x, x + 1 (a bf16 or float32 pair, one load where the
//   row is aligned), 64 a warp; it computes the outputs at x and x + 1,
//   whose taps reach columns x .. x + 3, the 2 of the next lane by
//   __shfl_down_sync. An output at x adds its taps' a_i = dlogit_i q and
//   u_i to padded x .. x + 2; what falls on the next lane's columns goes
//   there by __shfl_up_sync. The warp walks its band's output rows in
//   order with k and v of padded rows y, y + 1, y + 2 in registers (a
//   rolling window, the next row prefetched) and dk/dv of padded rows y,
//   y + 1, y + 2 as accumulators; once output row y has added its kh = 0
//   taps, padded row y is final and stored. So every padded position is
//   summed by one lane in a fixed order: no shared memory, no barrier, no
//   atomics. Halo: lane 31's outputs lack their right neighbour's k/v and
//   lane 0's padded columns their left neighbour's taps, so a strip owns
//   the 60 columns of lanes 1..30 (dq, drel of the outputs there, dk/dv
//   of the padded positions) and strips overlap by 4; a band owns 32
//   padded rows and recomputes the 2 output rows above it. drel: each lane
//   sums a_i over the outputs it owns, a fixed-order warp reduction gives
//   one partial row of 9 per warp, and a second pass adds them per channel
//   in a fixed order: the same bits on every run.
//   The TPU kernel saved the 9 softmax weights in its forward because its
//   backward was VPU-bound; here the saved (B, 9C, H, W) residual would be
//   the larger cost (9 more maps written forward and read backward, and
//   12.7 GB held across a B=8, T=3 step in bf16), so the backward
//   recomputes them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ssde_tpu_torch/ops/build.py); bound with ctypes.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;

// forward: the warp of strip s computes the 64 outputs from column 64 s, 2 a
// lane, over a band of 16 output rows, reading padded columns 64 s .. 64 s +
// 65 (ops/attention_win.py mirrors these as FWD_STRIP, FWD_BAND and
// FWD_WARPS)
constexpr int kFwdStrip = 2 * kLanes;
constexpr int kFwdBand = 16;
constexpr int kFwdWarps = 4;  // warps a block, each on its own strip, band or plane

// backward: a warp holds 64 padded columns, 2 a lane, from 60 s - 2 for
// strip s, and owns the 60 of lanes 1..30 and a band of 32 padded rows
// (ops/attention_win.py mirrors these as BWD_WARP_COLS, BWD_STRIP, BWD_BAND)
constexpr int kBwdWarpCols = 2 * kLanes;
constexpr int kBwdStrip = kBwdWarpCols - 4;
constexpr int kBwdBand = 32;
constexpr int kBwdWarps = 4;  // warps a block, each on its own strip, band or plane

constexpr int kReduceThreads = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// two adjacent values of a row, as one 4- or 8-byte load where aligned
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
__device__ __forceinline__ float2 to_f32(float2 v) { return v; }
__device__ __forceinline__ float2 to_f32(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ void set_zero(float2& v) { v = make_float2(0.f, 0.f); }
__device__ __forceinline__ void set_zero(__nv_bfloat162& v) { v = __float2bfloat162_rn(0.f); }
__device__ __forceinline__ void store(float2* p, float2 v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat162* p, float2 v) { *p = __float22bfloat162_rn(v); }

// Columns x, x + 1 of a row of n values, zero outside [0, n). VEC: n and x
// even and the row aligned, so the pair is in or out as a whole.
template <bool VEC, typename T>
__device__ __forceinline__ typename Pair<T>::type load_pair(const T* __restrict__ row, int x,
                                                            int n) {
  typename Pair<T>::type r;
  set_zero(r);
  if (VEC) {
    if (x >= 0 && x < n) r = *reinterpret_cast<const typename Pair<T>::type*>(row + x);
  } else {
    if (x >= 0 && x < n) r.x = row[x];
    if (x + 1 >= 0 && x + 1 < n) r.y = row[x + 1];
  }
  return r;
}

// Store v to columns x (if own0) and x + 1 (if own1); with VEC own0 == own1.
template <bool VEC, typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ row, int x, float2 v, bool own0,
                                           bool own1) {
  if (VEC) {
    if (own0) store(reinterpret_cast<typename Pair<T>::type*>(row + x), v);
  } else {
    if (own0) store(row + x, v.x);
    if (own1) store(row + x + 1, v.y);
  }
}

__device__ __forceinline__ float2 shfl_down2(float2 v) {
  return make_float2(__shfl_down_sync(kFull, v.x, 1), __shfl_down_sync(kFull, v.y, 1));
}

// 2^x on the special-function unit (ex2.approx, 2 ulp as exp2f; expf
// costs a range reduction of 7 more instructions). For the softmax's
// x <= 0 a result below 2^-126, a weight below 2^-126 of the largest, is
// flushed to 0 (exp2f would scale around the flush: 3 more instructions).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x on the special-function unit (rcp.approx, 1 ulp), for the
// softmax's denominator in [1, 9]; 1.f / x rounds exactly at 5 more
// instructions and a slow path.
__device__ __forceinline__ float rcp_sfu(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The forward of one output pixel from its 9 taps' k_i and v_i. The logits
// l_i = q (k_i + rel_i) round as the plain version's do (no contraction);
// the softmax goes to base 2 by one FMA a tap, 2^(l_i log2 e - m log2 e),
// which rounds once, at the small difference: the rounding of m log2 e is
// common to the 9 taps and cancels in the normalisation.
__device__ __forceinline__ float pixel_fwd(const float (&k)[9], const float (&v)[9],
                                           const float (&rl)[9], float q) {
  constexpr float kLog2e = 1.44269504088896341f;
  float l[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) l[i] = __fmul_rn(q, __fadd_rn(k[i], rl[i]));
  float m = l[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) m = fmaxf(m, l[i]);
  const float mb = __fmul_rn(m, kLog2e);
  float den = 0.f, num = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float e = exp2_sfu(fmaf(l[i], kLog2e, -mb));
    den += e;
    num = fmaf(e, v[i], num);
  }
  return num * rcp_sfu(den);
}

// One warp per (plane, band, strip) unit, strips fastest; the source note
// above says how a warp walks its band.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kFwdWarps * kLanes)
attend3_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const float* __restrict__ rel,
                   T* __restrict__ out, int C, int H, int W, int strips, int bands,
                   long units) {
  const long unit = (long)blockIdx.x * kFwdWarps + threadIdx.x / kLanes;
  if (unit >= units) return;  // the whole warp
  const int lane = threadIdx.x % kLanes;
  const int strip = (int)(unit % strips), band = (int)(unit / strips % bands);
  const long plane = unit / strips / bands;  // b * C + c
  const int c = (int)(plane % C);
  const int Wp = W + 2;
  // the outputs at x, x + 1 of this lane, whose taps read padded x .. x + 3
  const int x = strip * kFwdStrip + 2 * lane;
  const bool own0 = x < W, own1 = x + 1 < W;
  const int y0 = band * kFwdBand, y_end = min(y0 + kFwdBand, H);
  const long pplane = (long)(H + 2) * Wp, oplane = (long)H * W;
  float rl[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) rl[i] = rel[i * C + c];
  // k, v of padded rows y, y + 1 at columns x, x + 1 and x + 2, x + 3
  const T* kr = kp + plane * pplane + (long)y0 * Wp;
  const T* vr = vp + plane * pplane + (long)y0 * Wp;
  float2 k0 = to_f32(load_pair<VEC>(kr, x, Wp)), v0 = to_f32(load_pair<VEC>(vr, x, Wp));
  float2 nk0 = to_f32(load_pair<VEC>(kr, x + 2, Wp));
  float2 nv0 = to_f32(load_pair<VEC>(vr, x + 2, Wp));
  kr += Wp, vr += Wp;
  float2 k1 = to_f32(load_pair<VEC>(kr, x, Wp)), v1 = to_f32(load_pair<VEC>(vr, x, Wp));
  float2 nk1 = to_f32(load_pair<VEC>(kr, x + 2, Wp));
  float2 nv1 = to_f32(load_pair<VEC>(vr, x + 2, Wp));
  // prefetched: k, v of padded row y + 2 and q of output row y
  kr += Wp, vr += Wp;
  typename Pair<T>::type pk = load_pair<VEC>(kr, x, Wp), pv = load_pair<VEC>(vr, x, Wp);
  typename Pair<T>::type pkn = load_pair<VEC>(kr, x + 2, Wp);
  typename Pair<T>::type pvn = load_pair<VEC>(vr, x + 2, Wp);
  const T* qr = q + plane * oplane + (long)y0 * W;
  typename Pair<T>::type pq = load_pair<VEC>(qr, x, W);
  T* orow = out + plane * oplane + (long)y0 * W;

#pragma unroll 2
  for (int y = y0; y < y_end; ++y, orow += W) {
    const float2 k2 = to_f32(pk), v2 = to_f32(pv), qv = to_f32(pq);
    const float2 nk2 = to_f32(pkn), nv2 = to_f32(pvn);
    if (y + 1 < y_end) {
      kr += Wp, vr += Wp, qr += W;
      pk = load_pair<VEC>(kr, x, Wp);
      pv = load_pair<VEC>(vr, x, Wp);
      pkn = load_pair<VEC>(kr, x + 2, Wp);
      pvn = load_pair<VEC>(vr, x + 2, Wp);
      pq = load_pair<VEC>(qr, x, W);
    }
    // columns x .. x + 3 of padded rows y .. y + 2
    const float kc[3][4] = {{k0.x, k0.y, nk0.x, nk0.y}, {k1.x, k1.y, nk1.x, nk1.y},
                            {k2.x, k2.y, nk2.x, nk2.y}};
    const float vc[3][4] = {{v0.x, v0.y, nv0.x, nv0.y}, {v1.x, v1.y, nv1.x, nv1.y},
                            {v2.x, v2.y, nv2.x, nv2.y}};
    float kk[9], vv[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) kk[i] = kc[i / 3][i % 3], vv[i] = vc[i / 3][i % 3];
    const float o0 = pixel_fwd(kk, vv, rl, qv.x);
#pragma unroll
    for (int i = 0; i < 9; ++i) kk[i] = kc[i / 3][i % 3 + 1], vv[i] = vc[i / 3][i % 3 + 1];
    const float o1 = pixel_fwd(kk, vv, rl, qv.y);
    store_pair<VEC>(orow, x, make_float2(o0, o1), own0, own1);
    k0 = k1, v0 = v1, nk0 = nk1, nv0 = nv1;
    k1 = k2, v1 = v2, nk1 = nk2, nv1 = nv2;
  }
}

// The backward of one output pixel from its 9 taps' k_i + rel_i (kr) and
// v_i: a_i = dlogit_i q and u_i = s_i g into a and u, dq returned. q = g =
// 0 (a pixel outside the map) gives zeros. The softmax is taken in base 2,
// logits times log2 e: the same weights to float32 rounding.
__device__ __forceinline__ float pixel_bwd(const float (&kr)[9], const float (&v)[9], float q,
                                           float g, float (&a)[9], float (&u)[9]) {
  const float q2 = q * 1.44269504088896341f;  // log2 e
  float e[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) e[i] = q2 * kr[i];
  float m = e[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) m = fmaxf(m, e[i]);
  float den = 0.f, num = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    e[i] = exp2_sfu(e[i] - m);
    den += e[i];
    num = fmaf(e[i], v[i], num);
  }
  const float inv = rcp_sfu(den), out = num * inv, gi = g * inv;
  float dq = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    u[i] = e[i] * gi;
    const float dl = u[i] * (v[i] - out);
    a[i] = dl * q;
    dq = fmaf(dl, kr[i], dq);
  }
  return dq;
}

// One warp per (plane, band, strip) unit, strips fastest; the source note
// above says how a warp walks its band.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdWarps * kLanes)
attend3_bwd_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const float* __restrict__ rel,
                   const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dkp,
                   T* __restrict__ dvp, float* __restrict__ partial, int C, int H, int W,
                   int strips, int bands, long units) {
  const long unit = (long)blockIdx.x * kBwdWarps + threadIdx.x / kLanes;
  if (unit >= units) return;  // the whole warp
  const int lane = threadIdx.x % kLanes;
  const int strip = (int)(unit % strips), band = (int)(unit / strips % bands);
  const long plane = unit / strips / bands;  // b * C + c
  const int c = (int)(plane % C);
  const int Hp = H + 2, Wp = W + 2;
  // this lane's padded columns x, x + 1, and the outputs at x, x + 1
  const int x = strip * kBwdStrip - 2 + 2 * lane;
  const bool mine = lane >= 1 && lane <= kLanes - 2;
  const bool own_p0 = mine && x < Wp, own_p1 = mine && x + 1 < Wp;
  const bool own_o0 = mine && x < W, own_o1 = mine && x + 1 < W;
  // padded rows [p0, p1) are this band's; output rows from y0 reach them
  const int p0 = band * kBwdBand, p1 = min(p0 + kBwdBand, Hp);
  const int y0 = max(p0 - 2, 0);
  const long pplane = (long)Hp * Wp, oplane = (long)H * W;
  const T* kb = kp + plane * pplane;
  const T* vb = vp + plane * pplane;
  const T* qb = q + plane * oplane;
  const T* gb = g + plane * oplane;
  float rl[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) rl[i] = rel[i * C + c];

  // k, v of padded rows y, y + 1 at this lane's columns and the next lane's
  float2 k0 = to_f32(load_pair<VEC>(kb + (long)y0 * Wp, x, Wp));
  float2 v0 = to_f32(load_pair<VEC>(vb + (long)y0 * Wp, x, Wp));
  float2 k1 = to_f32(load_pair<VEC>(kb + (long)(y0 + 1) * Wp, x, Wp));
  float2 v1 = to_f32(load_pair<VEC>(vb + (long)(y0 + 1) * Wp, x, Wp));
  float2 nk0 = shfl_down2(k0), nv0 = shfl_down2(v0), nk1 = shfl_down2(k1), nv1 = shfl_down2(v1);
  // prefetched: k, v of padded row y + 2 and q, g of output row y
  typename Pair<T>::type pk = load_pair<VEC>(kb + (long)(y0 + 2) * Wp, x, Wp);
  typename Pair<T>::type pv = load_pair<VEC>(vb + (long)(y0 + 2) * Wp, x, Wp);
  typename Pair<T>::type pq = load_pair<VEC>(qb + (long)y0 * W, x, W);
  typename Pair<T>::type pg = load_pair<VEC>(gb + (long)y0 * W, x, W);

  float2 dk[3], dv[3];  // padded rows y, y + 1, y + 2 at this lane's columns
#pragma unroll
  for (int r = 0; r < 2; ++r) dk[r] = dv[r] = make_float2(0.f, 0.f);
  float dr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) dr[i] = 0.f;
  const int y_end = min(p1, H);  // output rows [y0, y_end); padded rows to p1

  for (int y = y0; y < p1; ++y) {
    dk[2] = dv[2] = make_float2(0.f, 0.f);
    if (y < y_end) {
      const float2 k2 = to_f32(pk), v2 = to_f32(pv), qv = to_f32(pq), gv = to_f32(pg);
      if (y + 1 < y_end) {
        pk = load_pair<VEC>(kb + (long)(y + 3) * Wp, x, Wp);
        pv = load_pair<VEC>(vb + (long)(y + 3) * Wp, x, Wp);
        pq = load_pair<VEC>(qb + (long)(y + 1) * W, x, W);
        pg = load_pair<VEC>(gb + (long)(y + 1) * W, x, W);
      }
      const float2 nk2 = shfl_down2(k2), nv2 = shfl_down2(v2);
      // columns x .. x + 3 of padded rows y .. y + 2
      const float kc[3][4] = {{k0.x, k0.y, nk0.x, nk0.y}, {k1.x, k1.y, nk1.x, nk1.y},
                              {k2.x, k2.y, nk2.x, nk2.y}};
      const float vc[3][4] = {{v0.x, v0.y, nv0.x, nv0.y}, {v1.x, v1.y, nv1.x, nv1.y},
                              {v2.x, v2.y, nv2.x, nv2.y}};
      const bool own_row = y >= p0;
      float kr[9], vv[9], a[9], u[9];
      // what goes to the next lane's columns x + 2 (s) and x + 3 (t)
      float sk[3], su[3], tk[3], tu[3];
      // the output at x: taps on columns x .. x + 2
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        kr[i] = kc[i / 3][i % 3] + rl[i];
        vv[i] = vc[i / 3][i % 3];
      }
      const float dq0 = pixel_bwd(kr, vv, qv.x, gv.x, a, u);
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        dk[kh].x += a[kh * 3];
        dv[kh].x += u[kh * 3];
        dk[kh].y += a[kh * 3 + 1];
        dv[kh].y += u[kh * 3 + 1];
        sk[kh] = a[kh * 3 + 2];
        su[kh] = u[kh * 3 + 2];
      }
      const float w0 = own_row && own_o0 ? 1.f : 0.f;  // drel: owned outputs only
#pragma unroll
      for (int i = 0; i < 9; ++i) dr[i] = fmaf(a[i], w0, dr[i]);
      // the output at x + 1: taps on columns x + 1 .. x + 3
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        kr[i] = kc[i / 3][i % 3 + 1] + rl[i];
        vv[i] = vc[i / 3][i % 3 + 1];
      }
      const float dq1 = pixel_bwd(kr, vv, qv.y, gv.y, a, u);
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        dk[kh].y += a[kh * 3];
        dv[kh].y += u[kh * 3];
        sk[kh] += a[kh * 3 + 1];
        su[kh] += u[kh * 3 + 1];
        tk[kh] = a[kh * 3 + 2];
        tu[kh] = u[kh * 3 + 2];
      }
      const float w1 = own_row && own_o1 ? 1.f : 0.f;  // drel: owned outputs only
#pragma unroll
      for (int i = 0; i < 9; ++i) dr[i] = fmaf(a[i], w1, dr[i]);
      if (own_row) store_pair<VEC>(dq + plane * oplane + (long)y * W, x, make_float2(dq0, dq1),
                                   own_o0, own_o1);
      // and what the lane to the left sent to this lane's columns
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        dk[kh].x += __shfl_up_sync(kFull, sk[kh], 1);
        dv[kh].x += __shfl_up_sync(kFull, su[kh], 1);
        dk[kh].y += __shfl_up_sync(kFull, tk[kh], 1);
        dv[kh].y += __shfl_up_sync(kFull, tu[kh], 1);
      }
      k0 = k1, v0 = v1, nk0 = nk1, nv0 = nv1;
      k1 = k2, v1 = v2, nk1 = nk2, nv1 = nv2;
    }
    // padded row y has had its last tap (kh = 0 of output row y)
    if (y >= p0) {
      const long o = plane * pplane + (long)y * Wp;
      store_pair<VEC>(dkp + o, x, dk[0], own_p0, own_p1);
      store_pair<VEC>(dvp + o, x, dv[0], own_p0, own_p1);
    }
    dk[0] = dk[1], dv[0] = dv[1];
    dk[1] = dk[2], dv[1] = dv[2];
  }

  // drel: this warp's partial sums, reduced in a fixed order
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float v = dr[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) partial[unit * 9 + i] = v;
  }
}

// drel[i, c] = the sum over b and the warps of plane (b, c) of the partial
// sums, each thread walking a fixed stride of the B * tiles rows, then a
// fixed-order tree.
__global__ void __launch_bounds__(kReduceThreads)
attend3_drel_reduce_kernel(const float* __restrict__ partial, float* __restrict__ drel,
                           int B, int C, int tiles) {
  __shared__ float red[9][kReduceThreads];
  const int c = blockIdx.x, tid = threadIdx.x;
  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.f;
  for (int j = tid; j < B * tiles; j += kReduceThreads) {
    const float* p = partial + (((long)(j / tiles) * C + c) * tiles + j % tiles) * 9;
#pragma unroll
    for (int i = 0; i < 9; ++i) acc[i] += p[i];
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) red[i][tid] = acc[i];
  __syncthreads();
  for (int n = kReduceThreads / 2; n > 0; n >>= 1) {
    if (tid < n) {
#pragma unroll
      for (int i = 0; i < 9; ++i) red[i][tid] += red[i][tid + n];
    }
    __syncthreads();
  }
  if (tid < 9) drel[tid * C + c] = red[tid][0];
}

// pairs load as one value where every row starts on a pair: W even and
// every map aligned to a pair
template <typename T>
bool on_pair(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T)) == 0;
}

template <typename T, bool VEC>
void launch_fwd_body(const void* q, const void* kp, const void* vp, const float* rel,
                     void* out, int B, int C, int H, int W, int strips, int bands,
                     cudaStream_t s) {
  const long units = (long)B * C * strips * bands;
  attend3_fwd_kernel<T, VEC><<<(unsigned)((units + kFwdWarps - 1) / kFwdWarps),
                               kFwdWarps * kLanes, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), rel,
      static_cast<T*>(out), C, H, W, strips, bands, units);
}

template <typename T>
void launch_fwd(const void* q, const void* kp, const void* vp, const float* rel, void* out,
                int B, int C, int H, int W, int strips, int bands, cudaStream_t s) {
  if (W % 2 == 0 && on_pair<T>(q) && on_pair<T>(kp) && on_pair<T>(vp) && on_pair<T>(out))
    launch_fwd_body<T, true>(q, kp, vp, rel, out, B, C, H, W, strips, bands, s);
  else
    launch_fwd_body<T, false>(q, kp, vp, rel, out, B, C, H, W, strips, bands, s);
}

template <typename T, bool VEC>
void launch_bwd_body(const void* q, const void* kp, const void* vp, const float* rel,
                     const void* g, void* dq, void* dkp, void* dvp, float* partial,
                     float* drel, int B, int C, int H, int W, int strips, int bands,
                     cudaStream_t s) {
  const long units = (long)B * C * strips * bands;
  attend3_bwd_kernel<T, VEC><<<(unsigned)((units + kBwdWarps - 1) / kBwdWarps),
                               kBwdWarps * kLanes, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), rel,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dkp),
      static_cast<T*>(dvp), partial, C, H, W, strips, bands, units);
  attend3_drel_reduce_kernel<<<C, kReduceThreads, 0, s>>>(partial, drel, B, C,
                                                          strips * bands);
}

template <typename T>
void launch_bwd(const void* q, const void* kp, const void* vp, const float* rel,
                const void* g, void* dq, void* dkp, void* dvp, float* partial, float* drel,
                int B, int C, int H, int W, int strips, int bands, cudaStream_t s) {
  if (W % 2 == 0 && on_pair<T>(q) && on_pair<T>(kp) && on_pair<T>(vp) && on_pair<T>(g) &&
      on_pair<T>(dq) && on_pair<T>(dkp) && on_pair<T>(dvp))
    launch_bwd_body<T, true>(q, kp, vp, rel, g, dq, dkp, dvp, partial, drel, B, C, H, W,
                             strips, bands, s);
  else
    launch_bwd_body<T, false>(q, kp, vp, rel, g, dq, dkp, dvp, partial, drel, B, C, H, W,
                              strips, bands, s);
}

bool bad_shape(int B, int C, int H, int W) { return B <= 0 || C <= 0 || H <= 0 || W <= 0; }

}  // namespace

// q (B, C, H, W); kp, vp (B, C, H+2, W+2); rel (9, C) float32; out like q.
// dtype: 0 float32, 1 bfloat16 (q, kp, vp, out). The grid, one warp per
// (b, c) plane, strip of 64 output columns and band of 16 output rows, 4
// warps a block, must have at most 2^31 - 1 blocks.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssde_attend3_fwd(const void* q, const void* kp, const void* vp,
                                const void* rel, void* out, int B, int C, int H, int W,
                                int dtype, void* stream) {
  if (bad_shape(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const int strips = (W + kFwdStrip - 1) / kFwdStrip;
  const int bands = (H + kFwdBand - 1) / kFwdBand;
  if (((long)B * C * strips * bands + kFwdWarps - 1) / kFwdWarps > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rel);
  if (dtype == 0)
    launch_fwd<float>(q, kp, vp, r, out, B, C, H, W, strips, bands, s);
  else if (dtype == 1)
    launch_fwd<__nv_bfloat16>(q, kp, vp, r, out, B, C, H, W, strips, bands, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Backward for the output gradient g (like q): dq like q, dkp and dvp like
// kp, drel (9, C) float32. partial is float32 scratch of n_partials * 9,
// n_partials = B * C * ceil((W + 2) / 60) * ceil((H + 2) / 32), one per
// warp (checked).
// Returns cudaGetLastError() after both launches (0 on success).
extern "C" int ssde_attend3_bwd(const void* q, const void* kp, const void* vp,
                                const void* rel, const void* g, void* dq, void* dkp,
                                void* dvp, void* partial, void* drel, int B, int C, int H,
                                int W, int n_partials, int dtype, void* stream) {
  if (bad_shape(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const int strips = (W + 2 + kBwdStrip - 1) / kBwdStrip;
  const int bands = (H + 2 + kBwdBand - 1) / kBwdBand;
  if ((long)B * C * strips * bands != n_partials) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rel);
  float* pt = static_cast<float*>(partial);
  float* dr = static_cast<float*>(drel);
  if (dtype == 0)
    launch_bwd<float>(q, kp, vp, r, g, dq, dkp, dvp, pt, dr, B, C, H, W, strips, bands,
                      s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(q, kp, vp, r, g, dq, dkp, dvp, pt, dr, B, C, H, W, strips,
                              bands, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
