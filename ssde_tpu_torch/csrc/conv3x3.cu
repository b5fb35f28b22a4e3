// Fused 3x3 SAME convolution + bias + activation, NCHW, for Hopper (sm_90a).
//
// Replaces ssde_tpu/ops/pallas/conv3x3.py::_fwd_kernel (reached through
// _conv_rows): the forward conv that the GRU v10 cell, the fusion blocks'
// ResidualConvUnits and their sigmoid disparity heads run at scales 0 and 1.
// It computes what that kernel computes -- zero or reflect padding, an
// optional bias, one of none/relu/elu/sigmoid/tanh, f32 accumulation and the
// output in the input dtype -- but not the way it computes it: there is no
// tap-stack im2col, no 128-lane padding and no logical width here.
//
// What bounds it. At the slice's shapes (GRU v10 at 640x192: Cin 32 or 64,
// Cout 1..192, full and half resolution) the convs are about 45 GFLOP per
// frame at about 150-200 FLOP per byte of activations read, so on this card
// they are compute-bound, and this kernel runs them on the CUDA cores in
// f32 FMAs. Design: each block computes one batch item, a 16x32 output tile
// and a chunk of CO output channels. It stages an 8-channel input slab with
// its one-pixel halo in shared memory -- zero or reflect padding is resolved
// while loading, so the inner loop has no branches -- together with the
// matching (8 x 9 x CO) weights, and each thread keeps 2 rows x CO
// accumulators in registers, so one shared-memory read of an input value
// feeds CO FMAs and one broadcast weight read feeds 2. Bias and activation
// are fused into the store. Shared memory stays under the 48 KB static
// limit. An implicit GEMM on the tensor cores (mma.sync, then wgmma) is the
// step after this one.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ssde_tpu_torch/ops/build.py); bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;                 // output columns per block (one warp)
constexpr int kThreadRows = 8;             // warps per block
constexpr int kRowsPerThread = 2;
constexpr int kTileH = kThreadRows * kRowsPerThread;  // 16 output rows
constexpr int kCinChunk = 8;               // input channels per shared stage
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kThreads = kTileW * kThreadRows;

enum Act { kNone = 0, kRelu = 1, kElu = 2, kSigmoid = 3, kTanh = 4 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Source index of padded coordinate g (g >= -1) on an axis of length n, or -1
// when the tap reads zero. Reflect: -1 reads 1 and n reads n-2 (n >= 2).
// Coordinates past n only feed outputs beyond the edge, which are not stored.
__device__ __forceinline__ int source(int g, int n, bool reflect) {
  if (g < 0) return reflect ? 1 : -1;
  if (g < n) return g;
  return (reflect && g == n) ? n - 2 : -1;
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kElu: return v > 0.f ? v : expm1f(v);
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kTanh: return tanhf(v);
    default: return v;
  }
}

template <typename T, int CO>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ out, int Cin,
                   int H, int W, int Cout, int co_chunks, bool reflect, int act) {
  __shared__ float xs[kCinChunk][kHaloH][kHaloW];
  __shared__ __align__(16) float ws[kCinChunk * 9][CO];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z / co_chunks;
  const int co0 = (blockIdx.z % co_chunks) * CO;
  const long plane = (long)H * W;
  const T* xb = x + (long)b * Cin * plane;

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
        v = to_f32(xb[(ci0 + c) * plane + (long)gy * W + gx]);
      xs[c][r][col] = v;
    }
    for (int i = tid; i < kCinChunk * 9 * CO; i += kThreads) {
      const int o = i % CO, k = i / CO;  // k = channel * 9 + tap
      const int c = k / 9, tap = k % 9;
      float v = 0.f;
      if (ci0 + c < Cin && co0 + o < Cout)
        v = to_f32(w[((long)(co0 + o) * Cin + ci0 + c) * 9 + tap]);
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
      if (bias != nullptr) v += to_f32(bias[co]);
      store(out + ((long)b * Cout + co) * plane + (long)oy * W + ox,
            activate(v, act));
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* out, int B,
            int Cin, int H, int W, int Cout, bool reflect, int act,
            cudaStream_t stream) {
  const dim3 block(kTileW, kThreadRows);
  const int gx = (W + kTileW - 1) / kTileW, gy = (H + kTileH - 1) / kTileH;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  if (Cout >= 16) {
    const int chunks = (Cout + 15) / 16;
    conv3x3_fwd_kernel<T, 16><<<dim3(gx, gy, B * chunks), block, 0, stream>>>(
        xt, wt, bt, ot, Cin, H, W, Cout, chunks, reflect, act);
  } else {
    conv3x3_fwd_kernel<T, 1><<<dim3(gx, gy, B * Cout), block, 0, stream>>>(
        xt, wt, bt, ot, Cin, H, W, Cout, Cout, reflect, act);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. reflect: 0 zero pad, 1 reflect pad.
// act: 0 none, 1 relu, 2 elu, 3 sigmoid, 4 tanh. b may be null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssde_conv3x3_fwd(const void* x, const void* w, const void* b,
                                void* out, int B, int Cin, int H, int W,
                                int Cout, int dtype, int reflect, int act,
                                void* stream) {
  if (act < kNone || act > kTanh || B <= 0 || Cin <= 0 || Cout <= 0 ||
      H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, w, b, out, B, Cin, H, W, Cout, reflect != 0, act, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, w, b, out, B, Cin, H, W, Cout, reflect != 0, act, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
