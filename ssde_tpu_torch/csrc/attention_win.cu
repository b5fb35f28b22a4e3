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
// What bounds them. Both are bytes-bound on this card: per output value the
// forward reads q, k, v and writes out (4 maps) for about 70 float32
// operations and 9 exps, the backward reads q, k, v, g and writes dq, dk, dv
// (7 maps). At the GRU v9 training shape (16 calls per frame-step, B=8,
// 640x192, bf16) that is about 1.9 GB (0.56 ms at 3.35 TB/s) forward and
// 3.3 GB (0.99 ms) backward, against about 0.25 ms of float32 operations;
// the 9 exps per pixel come close (2.1 G per frame-step, about 0.5 ms at the
// MUFU rate), so no pass computes more than 9 exps per output pixel, bar the
// backward's halo.
//
// Design. The channels are independent, so a block owns one (b, c) plane
// and one tile of it, and stages the k and v tiles with their halo in shared
// memory as float32 (bf16 converted on load).
//   Forward: a 16x32 output tile, the 18x34 k and v halo tiles; each thread
//   computes the softmax of 2 pixels in registers.
//   Backward: the TPU kernel scatters dk/dv into sliding row accumulators
//   and carries them, and drel, across its sequential row grid; blocks here
//   run in no order, so dk and dv are a gather instead. A block owns an 8x32
//   tile of PADDED positions P; the output pixels whose taps reach it are the
//   tile shifted by (-1, -1) plus a one-pixel halo (10x34). The block
//   recomputes their softmax once each (from a 12x36 k/v tile), keeps
//   dlogit_i q and u_i of all 9 taps in shared memory, and then each thread
//   gathers dk and dv of one P from the (up to) 9 pixels that read it. dq is
//   written for the pixels P - (1, 1) of the tile, so every pixel once. drel
//   takes per-block partial sums (a fixed-order warp and block reduction)
//   and a second pass adds them per channel in a fixed order: no atomics,
//   the same bits on every run.
//   The TPU kernel saved the 9 softmax weights in its forward because its
//   backward was VPU-bound; here the saved (B, 9C, H, W) residual would be
//   the larger cost (9 more maps written forward and read backward, and
//   12.7 GB held across a B=8, T=3 step in bf16), so the backward
//   recomputes them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ssde_tpu_torch/ops/build.py); bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;

// forward: 16x32 output tile, 2 rows per thread
constexpr int kFwdTileH = 16;
constexpr int kFwdTileW = kThreadsX;
constexpr int kFwdHaloH = kFwdTileH + 2;
constexpr int kFwdHaloW = kFwdTileW + 2;

// backward: 8x32 tile of padded positions, one per thread (ops/attention_win.py
// mirrors these two as BWD_TILE_H and BWD_TILE_W)
constexpr int kBwdTileH = kThreadsY;
constexpr int kBwdTileW = kThreadsX;
constexpr int kRegH = kBwdTileH + 2;  // output pixels whose taps reach the tile
constexpr int kRegW = kBwdTileW + 2;
constexpr int kKvH = kRegH + 2;       // the k/v those pixels read
constexpr int kKvW = kRegW + 2;

constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Stage rows [y0, y0 + rows) x columns [x0, x0 + cols) of one padded
// (Hp, Wp) plane of k and v into shared memory, zero outside the plane.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage_kv(const T* __restrict__ kb, const T* __restrict__ vb,
                                         float (*ks)[COLS], float (*vs)[COLS], int y0,
                                         int x0, int Hp, int Wp, int tid) {
  for (int i = tid; i < ROWS * COLS; i += kThreads) {
    const int r = i / COLS, col = i % COLS;
    const int gy = y0 + r, gx = x0 + col;
    float kv = 0.f, vv = 0.f;
    if (gy >= 0 && gy < Hp && gx >= 0 && gx < Wp) {
      const long o = (long)gy * Wp + gx;
      kv = to_f32(kb[o]);
      vv = to_f32(vb[o]);
    }
    ks[r][col] = kv;
    vs[r][col] = vv;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attend3_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const float* __restrict__ rel,
                   T* __restrict__ out, int C, int H, int W) {
  __shared__ float ks[kFwdHaloH][kFwdHaloW];
  __shared__ float vs[kFwdHaloH][kFwdHaloW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kFwdTileW, y0 = blockIdx.y * kFwdTileH;
  const long plane = blockIdx.z;  // b * C + c
  const int c = blockIdx.z % C;
  const int Hp = H + 2, Wp = W + 2;
  // output (y, x) reads padded rows y..y+2, so the tile's halo starts at (y0, x0)
  stage_kv<T, kFwdHaloH, kFwdHaloW>(kp + plane * Hp * Wp, vp + plane * Hp * Wp, ks, vs,
                                    y0, x0, Hp, Wp, ty * kThreadsX + tx);
  float rl[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) rl[i] = rel[i * C + c];
  __syncthreads();

  const int ox = x0 + tx;
  if (ox >= W) return;
#pragma unroll
  for (int r = ty; r < kFwdTileH; r += kThreadsY) {
    const int oy = y0 + r;
    if (oy >= H) break;
    const long o = (plane * H + oy) * W + ox;
    const float qv = to_f32(q[o]);
    float l[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) l[i] = qv * (ks[r + i / 3][tx + i % 3] + rl[i]);
    float m = l[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) m = fmaxf(m, l[i]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float e = expf(l[i] - m);
      den += e;
      num = fmaf(e, vs[r + i / 3][tx + i % 3], num);
    }
    store(out + o, num / den);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attend3_bwd_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const float* __restrict__ rel,
                   const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dkp,
                   T* __restrict__ dvp, float* __restrict__ partial, int C, int H, int W) {
  __shared__ float ks[kKvH][kKvW];
  __shared__ float vs[kKvH][kKvW];
  __shared__ float as[9][kRegH][kRegW];  // dlogit_i * q of each region pixel
  __shared__ float us[9][kRegH][kRegW];  // u_i = s_i * g
  __shared__ float red[kThreads / 32][9];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int P0x = blockIdx.x * kBwdTileW, P0y = blockIdx.y * kBwdTileH;
  const long plane = blockIdx.z;
  const int c = blockIdx.z % C;
  const int Hp = H + 2, Wp = W + 2;
  const long pplane = (long)Hp * Wp;
  // region pixel (ry, rx) is output (P0y - 2 + ry, P0x - 2 + rx); it reads
  // padded rows from P0y - 2 on
  stage_kv<T, kKvH, kKvW>(kp + plane * pplane, vp + plane * pplane, ks, vs, P0y - 2,
                          P0x - 2, Hp, Wp, tid);
  float rl[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) rl[i] = rel[i * C + c];
  __syncthreads();

  float dr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) dr[i] = 0.f;
  for (int j = tid; j < kRegH * kRegW; j += kThreads) {
    const int ry = j / kRegW, rx = j % kRegW;
    const int oy = P0y - 2 + ry, ox = P0x - 2 + rx;
    if (oy < 0 || oy >= H || ox < 0 || ox >= W) {
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        as[i][ry][rx] = 0.f;
        us[i][ry][rx] = 0.f;
      }
      continue;
    }
    const long o = (plane * H + oy) * W + ox;
    const float qv = to_f32(q[o]), gv = to_f32(g[o]);
    float l[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) l[i] = qv * (ks[ry + i / 3][rx + i % 3] + rl[i]);
    float m = l[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) m = fmaxf(m, l[i]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      l[i] = expf(l[i] - m);
      den += l[i];
      num = fmaf(l[i], vs[ry + i / 3][rx + i % 3], num);
    }
    const float outv = num / den, inv = 1.f / den;
    // the pixels P - (1, 1) of the tile: dq and drel here, once each
    const bool own = ry >= 1 && ry <= kBwdTileH && rx >= 1 && rx <= kBwdTileW;
    float dqv = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float u = l[i] * inv * gv;
      const float dl = u * (vs[ry + i / 3][rx + i % 3] - outv);
      const float a = dl * qv;
      as[i][ry][rx] = a;
      us[i][ry][rx] = u;
      dqv = fmaf(dl, ks[ry + i / 3][rx + i % 3] + rl[i], dqv);
      if (own) dr[i] += a;
    }
    if (own) store(dq + o, dqv);
  }
  __syncthreads();

  // gather: P = (P0y + ty, P0x + tx) is read by tap (kh, kw) of output
  // P - (kh, kw), region pixel (ty + 2 - kh, tx + 2 - kw)
  const int Py = P0y + ty, Px = P0x + tx;
  if (Py < Hp && Px < Wp) {
    float dk = 0.f, dv = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      dk += as[i][ty + 2 - i / 3][tx + 2 - i % 3];
      dv += us[i][ty + 2 - i / 3][tx + 2 - i % 3];
    }
    const long o = plane * pplane + (long)Py * Wp + Px;
    store(dkp + o, dk);
    store(dvp + o, dv);
  }

  // drel: this block's partial sums, reduced in a fixed order
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float v = dr[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (tx == 0) red[ty][i] = v;
  }
  __syncthreads();
  if (tid < 9) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][tid];
    const long tile = (long)blockIdx.y * gridDim.x + blockIdx.x;
    partial[(plane * gridDim.x * gridDim.y + tile) * 9 + tid] = s;
  }
}

// drel[i, c] = the sum over b and the tiles of plane (b, c) of the partial
// sums, each thread walking a fixed stride, then a fixed-order tree.
__global__ void __launch_bounds__(kReduceThreads)
attend3_drel_reduce_kernel(const float* __restrict__ partial, float* __restrict__ drel,
                           int B, int C, int tiles) {
  __shared__ float red[9][kReduceThreads];
  const int c = blockIdx.x, tid = threadIdx.x;
  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = partial + ((long)b * C + c) * tiles * 9;
    for (int t = tid; t < tiles; t += kReduceThreads) {
#pragma unroll
      for (int i = 0; i < 9; ++i) acc[i] += p[(long)t * 9 + i];
    }
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

template <typename T>
void launch_fwd(const void* q, const void* kp, const void* vp, const float* rel, void* out,
                int B, int C, int H, int W, cudaStream_t s) {
  const dim3 grid((W + kFwdTileW - 1) / kFwdTileW, (H + kFwdTileH - 1) / kFwdTileH, B * C);
  attend3_fwd_kernel<T><<<grid, dim3(kThreadsX, kThreadsY), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), rel,
      static_cast<T*>(out), C, H, W);
}

template <typename T>
void launch_bwd(const void* q, const void* kp, const void* vp, const float* rel,
                const void* g, void* dq, void* dkp, void* dvp, float* partial, float* drel,
                int B, int C, int H, int W, dim3 grid, cudaStream_t s) {
  attend3_bwd_kernel<T><<<grid, dim3(kThreadsX, kThreadsY), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), rel,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dkp),
      static_cast<T*>(dvp), partial, C, H, W);
  attend3_drel_reduce_kernel<<<C, kReduceThreads, 0, s>>>(partial, drel, B, C,
                                                          grid.x * grid.y);
}

bool bad_shape(int B, int C, int H, int W) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || (long)B * C > 65535;
}

}  // namespace

// q (B, C, H, W); kp, vp (B, C, H+2, W+2); rel (9, C) float32; out like q.
// dtype: 0 float32, 1 bfloat16 (q, kp, vp, out). B * C <= 65535.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssde_attend3_fwd(const void* q, const void* kp, const void* vp,
                                const void* rel, void* out, int B, int C, int H, int W,
                                int dtype, void* stream) {
  if (bad_shape(B, C, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rel);
  if (dtype == 0)
    launch_fwd<float>(q, kp, vp, r, out, B, C, H, W, s);
  else if (dtype == 1)
    launch_fwd<__nv_bfloat16>(q, kp, vp, r, out, B, C, H, W, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Backward for the output gradient g (like q): dq like q, dkp and dvp like
// kp, drel (9, C) float32. partial is float32 scratch of n_partials * 9,
// n_partials = B * C * ceil((H + 2) / 8) * ceil((W + 2) / 32) (checked).
// Returns cudaGetLastError() after both launches (0 on success).
extern "C" int ssde_attend3_bwd(const void* q, const void* kp, const void* vp,
                                const void* rel, const void* g, void* dq, void* dkp,
                                void* dvp, void* partial, void* drel, int B, int C, int H,
                                int W, int n_partials, int dtype, void* stream) {
  if (bad_shape(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + 2 + kBwdTileW - 1) / kBwdTileW, (H + 2 + kBwdTileH - 1) / kBwdTileH,
                  B * C);
  if (grid.y > 65535 || (long)grid.x * grid.y * B * C != n_partials)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rel);
  float* pt = static_cast<float*>(partial);
  float* dr = static_cast<float*>(drel);
  if (dtype == 0)
    launch_bwd<float>(q, kp, vp, r, g, dq, dkp, dvp, pt, dr, B, C, H, W, grid, s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(q, kp, vp, r, g, dq, dkp, dvp, pt, dr, B, C, H, W, grid, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
