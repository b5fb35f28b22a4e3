// Exact bilinear border warp of one source image at S coordinate fields:
// the warped image (forward) and its gradient in the coordinates
// (backward); float32, NCHW, plain C interface, for Hopper (sm_90a).
//
// Replaces: ssde_tpu/ops/pallas/warp_banded.py `_banded_kernel` (:64),
// called by `_taps_banded_pallas` (:213, pallas_call :259) through
// `grid_sample_banded_planar` (:421), and its backward `_gsbp_bwd` (:463),
// which reads the residuals rdx = d out / d wx and rdy = d out / d wy that
// the TPU kernel writes beside `out`. The port of rows #8-#10 of the kernel
// table as well (`_warp_kernel`, `_family_kernel`, `_onehot_kernel`): every
// warp backend name of the train step runs these kernels.
//
// Semantics: torch F.grid_sample(mode=bilinear, padding_mode=border,
// align_corners=False), as ssde_tpu/ops/warp.py `grid_sample` writes it.
// The coordinate f = ((g + 1) * W - 1) / 2 is clamped to [0, W-1], the 2x2
// window is anchored at x0 = clip(floor(f), 0, W-2) and wx = f - x0 (so at
// the right border x0 = W-2 and wx = 1); the same for y. The TPU kernel's
// vertical band clamp and 3-tile column window were limits of Mosaic's
// in-register gather, and its bf16 taps and residuals only saved HBM
// traffic: here every coordinate is exact and everything stays float32.
// The gradient reaches the grids only: d grid = (sum_c dout * rdx,
// sum_c dout * rdy), each times W/2 (H/2) where the unclamped coordinate
// lies strictly inside (0, W-1) and 0 elsewhere (`_grad_masks` :390).
//
// Layout: img (B, C, H, W); grids and dgrid (S, B, Ho, Wo, 2) scale-major;
// out and dout (S*B, C, Ho, Wo) with g = s*B + b.
//
// What bounds them on the H100: memory. The forward reads each grid pair
// once (8 bytes a pixel) and the image, and writes `out`: at B=12, S=4,
// 640x192, 17.7 + 47.2 + 70.8 MB, 0.0405 ms at 3.35 TB/s. The backward
// reads the image, the grids and dout and writes dgrid: 183 MB, 0.0546 ms.
// The TPU kernel also wrote rdx and rdy (2 x 70.8 MB here, twice the
// forward's bytes) and kept them alive until the backward; on this card
// the backward recomputes the four taps instead, from the source plane
// (3 x 192 x 640 x 4 B = 1.5 MB), which stays in the 50 MB L2 while the S
// grids of one source sweep over it, so the taps cost L2 reads, not HBM.
//
// Design: the launch grid is (pixel blocks, S, B), so a block knows its
// (s, b) without a division, and the blocks of one source's S grids are
// issued together while its plane is in L2. A thread takes 4 adjacent
// output pixels of one plane: as Ho*Wo is flattened, the pixels need no row
// or column. It loads their 4 (x, y) pairs as two float4, gathers 4 taps a
// channel with __ldg, and stores one float4 a channel (forward), or reads
// dout as one float4 a channel and writes its 4 gradient pairs as two
// float4 (backward). Where Ho*Wo is not a multiple of 4 or a pointer is off 16
// bytes, a thread takes 1 pixel with scalar accesses. Each pixel owns its
// outputs and sums its channels in order: no atomics, and two runs of the
// backward are bit-identical.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// unnormalise with one rounding per operation, as the plain version does:
// a fused multiply-add here would move f by an ulp of n
__device__ __forceinline__ float unnormalize(float g, int n) {
  return __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(g, 1.f), (float)n), -1.f), 0.5f);
}

struct Window {
  int off;         // the anchor tap's offset in a plane
  float wx, wy;    // the fractions against the anchor
  float sx, sy;    // d f / d g where the coordinate was not clamped, else 0
};

__device__ __forceinline__ Window locate(float gx, float gy, int H, int W) {
  const float rx = unnormalize(gx, W), ry = unnormalize(gy, H);
  const float fx = fminf(fmaxf(rx, 0.f), (float)(W - 1));
  const float fy = fminf(fmaxf(ry, 0.f), (float)(H - 1));
  const float x0 = fminf(fmaxf(floorf(fx), 0.f), (float)(W - 2));
  const float y0 = fminf(fmaxf(floorf(fy), 0.f), (float)(H - 2));
  Window w;
  w.off = (int)y0 * W + (int)x0;
  w.wx = fx - x0;
  w.wy = fy - y0;
  w.sx = (rx > 0.f && rx < (float)(W - 1)) ? (float)W * 0.5f : 0.f;
  w.sy = (ry > 0.f && ry < (float)(H - 1)) ? (float)H * 0.5f : 0.f;
  return w;
}

// the P coordinate pairs of pixels p0 .. p0 + P - 1 of one plane
template <int P>
__device__ __forceinline__ void load_coords(const float* grid, int H, int W, Window (&win)[P]) {
  if constexpr (P == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(grid));
    const float4 b = __ldg(reinterpret_cast<const float4*>(grid) + 1);
    win[0] = locate(a.x, a.y, H, W);
    win[1] = locate(a.z, a.w, H, W);
    win[2] = locate(b.x, b.y, H, W);
    win[3] = locate(b.z, b.w, H, W);
  } else {
    win[0] = locate(__ldg(grid), __ldg(grid + 1), H, W);
  }
}

template <int P>  // output pixels a thread: 4 (vector accesses) or 1
__global__ void __launch_bounds__(kThreads) warp_family_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ grids, float* __restrict__ out,
    int B, int C, int H, int W, int HoWo) {
  const int p0 = (blockIdx.x * kThreads + threadIdx.x) * P;
  if (p0 >= HoWo) return;
  const int b = blockIdx.z;
  const long long g = (long long)blockIdx.y * B + b;  // s * B + b
  Window win[P];
  load_coords<P>(grids + (g * HoWo + p0) * 2, H, W, win);
  const long long HW = (long long)H * W;
  const float* src = img + (long long)b * C * HW;
  float* dst = out + g * C * HoWo + p0;
  for (int c = 0; c < C; ++c, src += HW, dst += HoWo) {
    float v[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float* s = src + win[i].off;
      const float t00 = __ldg(s), t01 = __ldg(s + 1);
      const float t10 = __ldg(s + W), t11 = __ldg(s + W + 1);
      const float wx = win[i].wx, wy = win[i].wy;
      const float top = t00 * (1.f - wx) + t01 * wx;
      const float bot = t10 * (1.f - wx) + t11 * wx;
      v[i] = top * (1.f - wy) + bot * wy;
    }
    if constexpr (P == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      dst[0] = v[0];
    }
  }
}

// at most 64 registers (4 blocks an SM): with 4 pixels' windows and sums
// live, the compiler would take 80-96 and leave too few warps in flight
template <int P>
__global__ void __launch_bounds__(kThreads, 4) warp_family_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ grids,
    const float* __restrict__ dout, float* __restrict__ dgrid, int B, int C, int H, int W,
    int HoWo) {
  const int p0 = (blockIdx.x * kThreads + threadIdx.x) * P;
  if (p0 >= HoWo) return;
  const int b = blockIdx.z;
  const long long g = (long long)blockIdx.y * B + b;
  Window win[P];
  load_coords<P>(grids + (g * HoWo + p0) * 2, H, W, win);
  const long long HW = (long long)H * W;
  const float* src = img + (long long)b * C * HW;
  const float* d = dout + g * C * HoWo + p0;
  float ax[P], ay[P];
#pragma unroll
  for (int i = 0; i < P; ++i) ax[i] = ay[i] = 0.f;
  for (int c = 0; c < C; ++c, src += HW, d += HoWo) {
    float go[P];
    if constexpr (P == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(d));
      go[0] = q.x, go[1] = q.y, go[2] = q.z, go[3] = q.w;
    } else {
      go[0] = __ldg(d);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float* s = src + win[i].off;
      const float t00 = __ldg(s), t01 = __ldg(s + 1);
      const float t10 = __ldg(s + W), t11 = __ldg(s + W + 1);
      const float wx = win[i].wx, wy = win[i].wy;
      const float rdx = (1.f - wy) * (t01 - t00) + wy * (t11 - t10);
      const float rdy = (1.f - wx) * (t10 - t00) + wx * (t11 - t01);
      ax[i] += go[i] * rdx;
      ay[i] += go[i] * rdy;
    }
  }
  float* o = dgrid + (g * HoWo + p0) * 2;
  if constexpr (P == 4) {
    reinterpret_cast<float4*>(o)[0] = make_float4(ax[0] * win[0].sx, ay[0] * win[0].sy,
                                                  ax[1] * win[1].sx, ay[1] * win[1].sy);
    reinterpret_cast<float4*>(o)[1] = make_float4(ax[2] * win[2].sx, ay[2] * win[2].sy,
                                                  ax[3] * win[3].sx, ay[3] * win[3].sy);
  } else {
    o[0] = ax[0] * win[0].sx;
    o[1] = ay[0] * win[0].sy;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the launch grid, or false for a shape the kernels do not take
bool plan(int S, int B, int C, int H, int W, int Ho, int Wo, int P, dim3* grid) {
  if (H < 2 || W < 2 || C < 1 || S < 0 || B < 0 || Ho < 0 || Wo < 0) return false;
  if (S > 65535 || B > 65535 || (long long)Ho * Wo > INT_MAX - P * kThreads) return false;
  if ((long long)H * W > INT_MAX) return false;
  const int HoWo = Ho * Wo;
  *grid = dim3((unsigned)((HoWo + P * kThreads - 1) / (P * kThreads)), (unsigned)S,
               (unsigned)B);
  return true;
}

}  // namespace

// img (B, C, H, W), grids (S, B, Ho, Wo, 2) -> out (S*B, C, Ho, Wo), float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssde_warp_family_fwd(const void* img, const void* grids, void* out, int S,
                                    int B, int C, int H, int W, int Ho, int Wo,
                                    void* stream) {
  const bool vec = (long long)Ho * Wo % 4 == 0 && aligned16(grids) && aligned16(out);
  dim3 grid;
  if (!plan(S, B, C, H, W, Ho, Wo, vec ? 4 : 1, &grid)) return (int)cudaErrorInvalidValue;
  if ((long long)S * B * Ho * Wo == 0) return 0;
  auto* k = vec ? warp_family_fwd_kernel<4> : warp_family_fwd_kernel<1>;
  k<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const float*)img, (const float*)grids,
                                                 (float*)out, B, C, H, W, Ho * Wo);
  return (int)cudaGetLastError();
}

// img (B, C, H, W), grids (S, B, Ho, Wo, 2), dout (S*B, C, Ho, Wo)
// -> dgrid (S, B, Ho, Wo, 2), float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssde_warp_family_bwd(const void* img, const void* grids, const void* dout,
                                    void* dgrid, int S, int B, int C, int H, int W, int Ho,
                                    int Wo, void* stream) {
  const bool vec = (long long)Ho * Wo % 4 == 0 && aligned16(grids) && aligned16(dout) &&
                   aligned16(dgrid);
  dim3 grid;
  if (!plan(S, B, C, H, W, Ho, Wo, vec ? 4 : 1, &grid)) return (int)cudaErrorInvalidValue;
  if ((long long)S * B * Ho * Wo == 0) return 0;
  auto* k = vec ? warp_family_bwd_kernel<4> : warp_family_bwd_kernel<1>;
  k<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const float*)img, (const float*)grids,
                                                 (const float*)dout, (float*)dgrid, B, C, H,
                                                 W, Ho * Wo);
  return (int)cudaGetLastError();
}
