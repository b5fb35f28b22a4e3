// Fused 3x3 SAME convolution + bias + activation, NCHW, float32, for Hopper
// (sm_90a): the CUDA-core body. bf16 operands have a body of their own on the
// tensor cores (conv3x3_tc.cu); ssde_tpu_torch/ops/conv3x3.py picks the body
// by dtype, one body per dtype, and neither falls back to the other.
//
// Replaces ssde_tpu/ops/pallas/conv3x3.py::_fwd_kernel (reached through
// _conv_rows): the forward conv that the GRU v10 cell, the fusion blocks'
// ResidualConvUnits and their sigmoid disparity heads run at scales 0 and 1.
// It computes what that kernel computes -- zero or reflect padding, an
// optional bias, one of none/relu/elu/sigmoid/tanh, f32 accumulation -- but
// not the way it computes it: there is no tap-stack im2col, no 128-lane
// padding and no logical width here.
//
// What bounds it. At the slice's shapes (GRU v10 at 640x192: Cin 32 or 64,
// Cout 1..192, full and half resolution) the convs are about 45 GFLOP per
// frame at about 150-200 FLOP per byte of activations read, so on this card
// they are compute-bound, and this kernel runs them on the CUDA cores in
// f32 FMAs (float32 serving at B=1 is within 1.2x of cuDNN). Design: each
// block computes one batch item, a 16x32 output tile and a chunk of CO
// output channels. It stages an 8-channel input slab with its one-pixel halo
// in shared memory -- zero or reflect padding is resolved while loading, so
// the inner loop has no branches -- together with the matching (8 x 9 x CO)
// weights, and each thread keeps 2 rows x CO accumulators in registers, so
// one shared-memory read of an input value feeds CO FMAs and one broadcast
// weight read feeds 2. Bias and activation are fused into the store. Shared
// memory stays under the 48 KB static limit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ssde_tpu_torch/ops/build.py); bound with ctypes.

#include <cuda_runtime.h>

#include "conv3x3_common.cuh"

namespace {

constexpr int kTileW = 32;                 // output columns per block (one warp)
constexpr int kThreadRows = 8;             // warps per block
constexpr int kRowsPerThread = 2;
constexpr int kTileH = kThreadRows * kRowsPerThread;  // 16 output rows
constexpr int kCinChunk = 8;               // input channels per shared stage
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kThreads = kTileW * kThreadRows;

template <int CO>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int Cin,
                   int H, int W, int Cout, int co_chunks, bool reflect, int act) {
  __shared__ float xs[kCinChunk][kHaloH][kHaloW];
  __shared__ __align__(16) float ws[kCinChunk * 9][CO];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z / co_chunks;
  const int co0 = (blockIdx.z % co_chunks) * CO;
  const long plane = (long)H * W;
  const float* xb = x + (long)b * Cin * plane;

  float acc[kRowsPerThread][CO];
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[p][o] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kCinChunk) {
    __syncthreads();  // the previous stage's reads are done
    for (int i = tid; i < kCinChunk * kHaloH * kHaloW; i += kThreads) {
      const int c = i / (kHaloH * kHaloW);
      const int r = (i / kHaloW) % kHaloH;
      const int col = i % kHaloW;
      const int gy = source(y0 - 1 + r, H, reflect);
      const int gx = source(x0 - 1 + col, W, reflect);
      float v = 0.f;
      if (ci0 + c < Cin && gy >= 0 && gx >= 0)
        v = xb[(ci0 + c) * plane + (long)gy * W + gx];
      xs[c][r][col] = v;
    }
    for (int i = tid; i < kCinChunk * 9 * CO; i += kThreads) {
      const int o = i % CO, k = i / CO;  // k = channel * 9 + tap
      const int c = k / 9, tap = k % 9;
      float v = 0.f;
      if (ci0 + c < Cin && co0 + o < Cout)
        v = w[((long)(co0 + o) * Cin + ci0 + c) * 9 + tap];
      ws[k][o] = v;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kCinChunk; ++c)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float xv[kRowsPerThread];
#pragma unroll
          for (int p = 0; p < kRowsPerThread; ++p)
            xv[p] = xs[c][ty + p * kThreadRows + dy][tx + dx];
          const float* wk = ws[c * 9 + dy * 3 + dx];
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            const float wv = wk[o];
#pragma unroll
            for (int p = 0; p < kRowsPerThread; ++p)
              acc[p][o] = fmaf(xv[p], wv, acc[p][o]);
          }
        }
  }

  const int ox = x0 + tx;
  if (ox >= W) return;
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p) {
    const int oy = y0 + ty + p * kThreadRows;
    if (oy >= H) continue;
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      const int co = co0 + o;
      if (co >= Cout) continue;
      float v = acc[p][o];
      if (bias != nullptr) v += bias[co];
      out[((long)b * Cout + co) * plane + (long)oy * W + ox] = activate(v, act);
    }
  }
}

// ---------------------------------------------------------------------------
// Weight gradient (kernel #2). Replaces ssde_tpu/ops/pallas/conv3x3.py::
// _dw_kernel (through _dw_call): dW[co, ci, ky, kx] = sum over b, y, x of
// g[b, co, y, x] * xpad[b, ci, y + ky - 1, x + kx - 1], zero or reflect
// padding, float32 operands (bf16: conv3x3_tc.cu), float32 accumulation and
// a float32 result in torch's (Cout, Cin, 3, 3) layout.
//
// What bounds it. At the GRU v10 shapes (B=8, 640x192 and 320x96) it is a
// product with M = Cout, N = 9 Cin and K = B H W = 983,040 pixels at scale
// 0: about 2 x 9 x Cin x Cout FLOPs per pixel against (Cin + Cout) x 4
// bytes read, 100-300 FLOP per byte, so compute-bound on the CUDA cores.
//
// Design. The TPU kernel carries the sum over its sequential grid in the
// output block; blocks on this card run in no order, so the reduction over
// B*H*W is split in two deterministic passes. Pass 1: a grid of (Cout
// chunk x Cin chunk, P partitions); a block walks the 8x32 pixel tiles
// p, p + P, ... of all B images, stages the 16-channel x halo (padding
// resolved while loading, as in the forward) and the 16-channel g tile in
// shared memory, and each of its 256 threads keeps the 9 tap sums of one
// (co, ci) pair in registers, sliding a 3x3 window of x along each tile
// row (4 shared loads per 9 FMAs). At the end it writes its partial sums
// to a (P, Cout, Cin, 9) float32 scratch buffer. Pass 2 adds the P partial
// sums of each weight in a fixed order. No atomics, so every run gives the
// same bits.
// ---------------------------------------------------------------------------

constexpr int kDwTileH = 8;
constexpr int kDwTileW = 32;
constexpr int kDwTile = kDwTileH * kDwTileW;
constexpr int kDwCo = 16;                  // output channels per block
constexpr int kDwCi = 16;                  // input channels per block
constexpr int kDwThreads = kDwCo * kDwCi;  // one (co, ci) pair per thread
constexpr int kDwHaloH = kDwTileH + 2;
constexpr int kDwHaloW = kDwTileW + 2;

__global__ void __launch_bounds__(kDwThreads)
conv3x3_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ partial, int B, int Cin, int H, int W,
                  int Cout, int ci_chunks, bool reflect) {
  __shared__ float xs[kDwCi][kDwHaloH][kDwHaloW];
  __shared__ float gs[kDwCo][kDwTile + 1];  // +1: the 16 co rows on distinct banks

  const int tid = threadIdx.x;
  const int o = tid % kDwCo, c = tid / kDwCo;
  const int co0 = (blockIdx.x / ci_chunks) * kDwCo;
  const int ci0 = (blockIdx.x % ci_chunks) * kDwCi;
  const int p = blockIdx.y, P = gridDim.y;
  const int tiles_x = (W + kDwTileW - 1) / kDwTileW;
  const int tiles_y = (H + kDwTileH - 1) / kDwTileH;
  const int tiles = B * tiles_y * tiles_x;
  const long plane = (long)H * W;

  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.f;

  for (int t = p; t < tiles; t += P) {
    const int b = t / (tiles_y * tiles_x);
    const int y0 = ((t / tiles_x) % tiles_y) * kDwTileH;
    const int x0 = (t % tiles_x) * kDwTileW;
    const float* xb = x + (long)b * Cin * plane;
    const float* gb = g + (long)b * Cout * plane;
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kDwCi * kDwHaloH * kDwHaloW; i += kDwThreads) {
      const int cc = i / (kDwHaloH * kDwHaloW);
      const int r = (i / kDwHaloW) % kDwHaloH;
      const int col = i % kDwHaloW;
      const int gy = source(y0 - 1 + r, H, reflect);
      const int gx = source(x0 - 1 + col, W, reflect);
      float v = 0.f;
      if (ci0 + cc < Cin && gy >= 0 && gx >= 0)
        v = xb[(ci0 + cc) * plane + (long)gy * W + gx];
      xs[cc][r][col] = v;
    }
    for (int i = tid; i < kDwCo * kDwTile; i += kDwThreads) {
      const int oo = i / kDwTile, r = (i / kDwTileW) % kDwTileH, col = i % kDwTileW;
      const int y = y0 + r, xx = x0 + col;
      float v = 0.f;  // pixels past the edge and channels past Cout add 0
      if (co0 + oo < Cout && y < H && xx < W)
        v = gb[(co0 + oo) * plane + (long)y * W + xx];
      gs[oo][r * kDwTileW + col] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int r = 0; r < kDwTileH; ++r) {
      float win[3][3];  // win[ky][kx] = xpad at (row r + ky, column col + kx)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        win[ky][1] = xs[c][r + ky][0];
        win[ky][2] = xs[c][r + ky][1];
      }
#pragma unroll
      for (int col = 0; col < kDwTileW; ++col) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          win[ky][0] = win[ky][1];
          win[ky][1] = win[ky][2];
          win[ky][2] = xs[c][r + ky][col + 2];
        }
        const float gv = gs[o][r * kDwTileW + col];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            acc[ky * 3 + kx] = fmaf(gv, win[ky][kx], acc[ky * 3 + kx]);
      }
    }
  }

  if (co0 + o < Cout && ci0 + c < Cin) {
    float* dst = partial + (((long)p * Cout + co0 + o) * Cin + ci0 + c) * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) dst[k] = acc[k];
  }
}

void launch_dw(const float* x, const float* g, float* partial, float* dw, int B,
               int Cin, int H, int W, int Cout, int P, bool reflect,
               cudaStream_t stream) {
  const int co_chunks = (Cout + kDwCo - 1) / kDwCo;
  const int ci_chunks = (Cin + kDwCi - 1) / kDwCi;
  conv3x3_dw_kernel<<<dim3(co_chunks * ci_chunks, P), kDwThreads, 0, stream>>>(
      x, g, partial, B, Cin, H, W, Cout, ci_chunks, reflect);
  const int n = Cout * Cin * 9;
  conv3x3_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, dw, n, P);
}

void launch(const float* x, const float* w, const float* b, float* out, int B,
            int Cin, int H, int W, int Cout, bool reflect, int act,
            cudaStream_t stream) {
  const dim3 block(kTileW, kThreadRows);
  const int gx = (W + kTileW - 1) / kTileW, gy = (H + kTileH - 1) / kTileH;
  if (Cout >= 16) {
    const int chunks = (Cout + 15) / 16;
    conv3x3_fwd_kernel<16><<<dim3(gx, gy, B * chunks), block, 0, stream>>>(
        x, w, b, out, Cin, H, W, Cout, chunks, reflect, act);
  } else {
    conv3x3_fwd_kernel<1><<<dim3(gx, gy, B * Cout), block, 0, stream>>>(
        x, w, b, out, Cin, H, W, Cout, Cout, reflect, act);
  }
}

}  // namespace

// float32 x, w, b and out. reflect: 0 zero pad, 1 reflect pad.
// act: 0 none, 1 relu, 2 elu, 3 sigmoid, 4 tanh. b may be null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssde_conv3x3_fwd(const void* x, const void* w, const void* b,
                                void* out, int B, int Cin, int H, int W,
                                int Cout, int reflect, int act, void* stream) {
  if (act < kNone || act > kTanh || B <= 0 || Cin <= 0 || Cout <= 0 ||
      H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  launch(static_cast<const float*>(x), static_cast<const float*>(w),
         static_cast<const float*>(b), static_cast<float*>(out), B, Cin, H, W,
         Cout, reflect != 0, act, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Weight gradient: float32 x (B, Cin, H, W) and g (B, Cout, H, W); partial
// is float32 scratch of P * Cout * Cin * 9, dw the float32 (Cout, Cin, 3, 3)
// result. 1 <= P <= 65535.
// Returns cudaGetLastError() after both launches (0 on success).
extern "C" int ssde_conv3x3_dw(const void* x, const void* g, void* partial,
                               void* dw, int B, int Cin, int H, int W,
                               int Cout, int P, int reflect, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || P <= 0 ||
      P > 65535)
    return (int)cudaErrorInvalidValue;
  launch_dw(static_cast<const float*>(x), static_cast<const float*>(g),
            static_cast<float*>(partial), static_cast<float*>(dw), B, Cin, H, W,
            Cout, P, reflect != 0, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
