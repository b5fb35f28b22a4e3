// Pieces shared by the two bodies of the 3x3 SAME conv, both on the tensor
// cores: the float32 (3xTF32) kernels (conv3x3_tf32.cu) and the bf16 kernels
// (conv3x3_tc.cu). Each source gets its own internal copy.

#pragma once

#include <cuda_runtime.h>

namespace {

enum Act { kNone = 0, kRelu = 1, kElu = 2, kSigmoid = 3, kTanh = 4 };

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

// Second pass of the weight gradient: dw[i] = sum over p of partial[p][i],
// p in increasing order, so every run gives the same bits.
__global__ void conv3x3_dw_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ dw, int n, int P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(long)p * n + i];
  dw[i] = s;
}

}  // namespace
