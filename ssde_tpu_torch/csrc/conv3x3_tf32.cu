// The 3x3 SAME conv for float32 operands on the tensor cores, for Hopper
// (sm_90a): the forward (kernel #1, which also runs as dx) and the weight
// gradient (kernel #2), NCHW, as implicit GEMMs with mma.sync m16n8k8 in
// "3xTF32": each float32 operand is split into x = hi + lo with hi and lo
// tf32 (cvt.rna), and x * w is taken as lo*w_hi + hi*w_lo + hi*w_hi. The
// dropped lo*w_lo and the rounding of lo leave about 2^-21 of each product,
// near float32's own rounding. The sums need care: an MMA rounds the sum
// it returns toward zero, so chaining a whole K loop through one MMA
// accumulator builds a bias (on an H100, several times cuDNN's float32
// error against float64, growing with K). So the products of a few K steps
// (a tap's 8 or 16 channels in the forward, 16 pixels in dW) go to a fresh
// MMA accumulator, which is then added to the float32 sum in an ordinary
// round-to-nearest add. bf16 operands have their own body
// (conv3x3_tc.cu); ssde_tpu_torch/ops/conv3x3.py picks the body by dtype,
// one body per dtype, and neither falls back to the other.
//
// Replaces ssde_tpu/ops/pallas/conv3x3.py::_fwd_kernel (through _conv_rows;
// as dx through _c3z_bwd and _c3_bwd) and ::_dw_kernel (through _dw_call),
// which contract a 9*Cin-row tap stack with the weights in float32.
//
// What bounds them. A GRU v10 frame-step at B=8 (640x192 and 320x96, Cin 32
// or 64, Cout 1..192) is 363 GFLOP in 16 convs. On the 67 TFLOP/s float32
// CUDA cores that is 5.5 ms at best, and the CUDA-core body these kernels
// replace ran at 12 (dW) to 21 (forward) TFLOP/s. Three TF32 products per
// float32 one cost 3 x 363 GFLOP at the 495 TFLOP/s tensor-core peak, 2.2 ms;
// the activations' bytes are 1.1 ms at 3.35 TB/s. So operations bound them,
// and mma.sync (not wgmma) and the staging keep them above that.
//
// Shared design (as conv3x3_tc.cu's). A block of 4 warps owns a 4-row x
// 64-column pixel tile of one image, one row per warp. It stages the tile's
// input channels with their one-pixel halo channel-innermost in shared
// memory, resolving zero or reflect padding while it stages; the NCHW
// transpose goes through registers (coalesced loads along W, 16-byte shared
// stores). A tap shift moves whole pixel rows. ldmatrix .b16 moves 16-byte
// rows, which are 4 floats here: an 8x4 float32 matrix per ldmatrix matrix
// is exactly the m16n8k8 tf32 A (pixels x channels) and B (channels x output
// channels) fragment layout, so the forward loads both by ldmatrix with no
// .trans. Overlap of loads and MMAs comes from the 2-5 resident blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_common.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kTileH = 4;       // pixel rows per block, one per warp
constexpr int kTileW = 64;      // pixel columns per block: 4 fragments of 16
constexpr int kTile = kTileH * kTileW;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// tf32 of v, rounded to nearest with ties away from zero; the low 13 bits 0
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// x (float32 bits) = hi + lo, both tf32; x - hi is exact in float32
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  const float v = __uint_as_float(x);
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a * b: a 16x8 tf32 (row), b 8x8 tf32 (col), d 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b into a fresh accumulator
__device__ __forceinline__ void mma_tf32_new(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// acc += d, rounded to nearest
__device__ __forceinline__ void add4(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Channels [c0, c0 + CC) of the (kHaloH x kHaloW) halo tile at image origin
// (y0 - 1, x0 - 1) into xs, channel-innermost at a pixel stride of PS floats;
// channels past C and taps outside the image (zero pad) are 0. One thread per
// halo pixel: coalesced loads along W, one 16-byte shared store per 4
// channels.
template <int CC, int PS>
__device__ __forceinline__ void stage_halo(float* xs, const float* __restrict__ xb, int C,
                                           int c0, int H, int W, int y0, int x0,
                                           bool reflect) {
  const long plane = (long)H * W;
  for (int p = threadIdx.x; p < kHaloH * kHaloW; p += kThreads) {
    const int r = p / kHaloW, col = p - r * kHaloW;
    const int gy = source(y0 - 1 + r, H, reflect);
    const int gx = source(x0 - 1 + col, W, reflect);
    const bool in = gy >= 0 && gx >= 0;
    const float* src = xb + (long)c0 * plane + (in ? (long)gy * W + gx : 0);
    float4* dst = reinterpret_cast<float4*>(xs + p * PS);
#pragma unroll
    for (int q = 0; q < CC / 4; ++q) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * q + e;
        v[e] = (in && c0 + c < C) ? __ldg(src + c * plane) : 0.f;
      }
      dst[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward (kernel #1; as dx the same kernel on g with rotated weights).
// GEMM: M = B*H*W output pixels, N = Cout, K = 9*Cin, tap-major and
// ci-minor. A block computes a 4x64 pixel tile (M = 256) against BN output
// channels; each warp one row of it (4 m16 fragments) against all BN (BN/8
// n8 fragments). Per Cin chunk of CC channels the block stages the halo tile
// (pixel stride CC + 4 floats: an odd number of 16-byte rows, so the 8 rows
// of an ldmatrix matrix fall on distinct banks) and the chunk's packed hi
// and lo weights (two planes of BN rows of 9*CC + 4 floats, by cp.async),
// then runs 9 taps x CC/8 K steps of 8 channels. Per tap a warp loads the
// hi and lo B fragments of all BN channels and the tap's K steps once, then
// takes its A fragments IG at a time (ldmatrix, then the hi/lo split in
// registers: each split A fragment feeds 3 x BN/8 MMAs) and, JG n8
// fragments at a time, issues the lo*w_hi, hi*w_lo and hi*w_hi products of
// the tap in passes of independent MMAs into fresh accumulators, then adds
// those to the float32 sums: one round-to-nearest add per tap and output
// (at most 16 channels' products in a truncating MMA chain). BN is 8 or
// 32: with 64 the split operands spill badly. wp is the host-split operand (ops/conv3x3.py
// packed_weights): hi then lo, each (N_pad, 9, cin_pad), zero past Cout and
// Cin, so only the store masks. Epilogue: bias and act from the
// accumulators, float32 stores.
// ---------------------------------------------------------------------------

template <int CC, int BN>
__device__ __forceinline__ void fwd_tf32(const float* __restrict__ x,
                                         const float* __restrict__ wp,
                                         const float* __restrict__ bias,
                                         float* __restrict__ out, int Cin, int cin_pad, int H,
                                         int W, int Cout, int n_blocks, bool reflect, int act) {
  constexpr int PS = CC + 4;      // halo pixel stride, floats
  constexpr int KS = 9 * CC + 4;  // weight row stride, floats
  constexpr int NT = BN / 8;      // n8 fragments per warp
  constexpr int KK = CC / 8;      // K steps per tap
  constexpr int IG = NT >= 4 ? 1 : 4;   // A fragments per pass
  constexpr int JG = NT >= 4 ? 4 : NT;  // B fragments per pass
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws_hi = smem + kHaloH * kHaloW * PS;
  float* ws_lo = ws_hi + BN * KS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z / n_blocks, n0 = (blockIdx.z % n_blocks) * BN;
  const long plane = (long)H * W;
  const float* xb = x + (long)b * Cin * plane;
  const long lo_plane = (long)n_blocks * BN * 9 * cin_pad;

  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    __syncthreads();  // the previous chunk's reads are done
    constexpr int kPieces = 9 * CC / 4;  // 16-byte pieces of one weight row
    for (int i = threadIdx.x; i < 2 * BN * kPieces; i += kThreads) {
      const int hl = i / (BN * kPieces), k = i % (BN * kPieces);  // hl 0 hi, 1 lo
      const int n = k / kPieces, q = k % kPieces;  // q = tap * CC / 4 + piece
      const int tap = q / (CC / 4), piece = q % (CC / 4);
      cp_async16((hl ? ws_lo : ws_hi) + n * KS + q * 4,
                 wp + hl * lo_plane + ((long)(n0 + n) * 9 + tap) * cin_pad + c0 + piece * 4,
                 16);
    }
    stage_halo<CC, PS>(xs, xb, Cin, c0, H, W, y0, x0, reflect);
    cp_async_wait_all();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // B fragment (kk, j): b[0] channels 8 kk + 0-3, b[1] 8 kk + 4-7 of the
      // output channels 8 j .. 8 j + 7 (rows of the packed weights)
      uint32_t bh[KK][NT][2], bl[KK][NT][2];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int koff = tap * CC + 8 * kk + ((lane / 8) % 2) * 4;
        if constexpr (NT == 1) {
          ldsm_x2(bh[kk][0], ws_hi + (lane % 8) * KS + koff);
          ldsm_x2(bl[kk][0], ws_lo + (lane % 8) * KS + koff);
        } else {
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            const int row = 8 * j + (lane % 8) + (lane / 16) * 8;
            uint32_t r[4];
            ldsm_x4(r, ws_hi + row * KS + koff);
            bh[kk][j][0] = r[0];
            bh[kk][j][1] = r[1];
            bh[kk][j + 1][0] = r[2];
            bh[kk][j + 1][1] = r[3];
            ldsm_x4(r, ws_lo + row * KS + koff);
            bl[kk][j][0] = r[0];
            bl[kk][j][1] = r[1];
            bl[kk][j + 1][0] = r[2];
            bl[kk][j + 1][1] = r[3];
          }
        }
      }
      // A fragment (i, kk): pixels 16 i .. 16 i + 15 of the warp's row,
      // shifted by the tap; a[0], a[1] channels 8 kk + 0-3, a[2], a[3] 4-7
      const float* arow =
          xs + ((warp + dy) * kHaloW + (lane % 16) + dx) * PS + (lane / 16) * 4;
#pragma unroll
      for (int i0 = 0; i0 < 4; i0 += IG) {
        uint32_t ah[IG][KK][4], al[IG][KK][4];
#pragma unroll
        for (int ii = 0; ii < IG; ++ii)
#pragma unroll
          for (int kk = 0; kk < KK; ++kk) {
            uint32_t raw[4];
            ldsm_x4(raw, arow + 16 * (i0 + ii) * PS + 8 * kk);
#pragma unroll
            for (int e = 0; e < 4; ++e) split(raw[e], ah[ii][kk][e], al[ii][kk][e]);
          }
#pragma unroll
        for (int j0 = 0; j0 < NT; j0 += JG) {
          float d[IG][JG][4];  // the tap's products, then added to acc
#pragma unroll
          for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
            for (int ii = 0; ii < IG; ++ii)
#pragma unroll
              for (int jj = 0; jj < JG; ++jj) {
                if (kk == 0)
                  mma_tf32_new(d[ii][jj], al[ii][kk], bh[kk][j0 + jj]);
                else
                  mma_tf32(d[ii][jj], al[ii][kk], bh[kk][j0 + jj]);
              }
#pragma unroll
            for (int ii = 0; ii < IG; ++ii)
#pragma unroll
              for (int jj = 0; jj < JG; ++jj) mma_tf32(d[ii][jj], ah[ii][kk], bl[kk][j0 + jj]);
#pragma unroll
            for (int ii = 0; ii < IG; ++ii)
#pragma unroll
              for (int jj = 0; jj < JG; ++jj) mma_tf32(d[ii][jj], ah[ii][kk], bh[kk][j0 + jj]);
          }
#pragma unroll
          for (int ii = 0; ii < IG; ++ii)
#pragma unroll
            for (int jj = 0; jj < JG; ++jj) add4(acc[i0 + ii][j0 + jj], d[ii][jj]);
        }
      }
    }
  }

  // accumulator e of fragment (i, j): pixel 16 i + lane/4 + 8 (e / 2),
  // channel 8 j + 2 (lane % 4) + e % 2
  const int y = y0 + warp;
  if (y >= H) return;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + 8 * j + 2 * (lane % 4) + e;
      if (co >= Cout) continue;
      const float bv = bias != nullptr ? bias[co] : 0.f;
      float* o = out + (((long)b * Cout + co) * H + y) * W;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int xx = x0 + 16 * i + lane / 4 + 8 * h;
          if (xx < W) o[xx] = activate(acc[i][j][2 * h + e] + bv, act);
        }
    }
  }
}

// 32 output channels a block: at most 168 registers, so that 3 blocks (69.6
// KB of shared memory each at CC = 16) fit an SM; the few spills cost less
// than the third block gains (an A/B on an H100 at the GRU shapes, B=8)
template <int CC>
__global__ void __launch_bounds__(kThreads, 3)
conv3x3_fwd_tf32_n32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                            const float* __restrict__ bias, float* __restrict__ out, int Cin,
                            int cin_pad, int H, int W, int Cout, int n_blocks, bool reflect,
                            int act) {
  fwd_tf32<CC, 32>(x, wp, bias, out, Cin, cin_pad, H, W, Cout, n_blocks, reflect, act);
}

// 8 output channels a block (Cout <= 8, the heads): the compiler picks the
// registers (85; 72 at CC = 8)
template <int CC>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_tf32_n8_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                           const float* __restrict__ bias, float* __restrict__ out, int Cin,
                           int cin_pad, int H, int W, int Cout, int n_blocks, bool reflect,
                           int act) {
  fwd_tf32<CC, 8>(x, wp, bias, out, Cin, cin_pad, H, W, Cout, n_blocks, reflect, act);
}

template <int CC, int BN>
int launch_fwd(const float* x, const float* wp, const float* b, float* out, int B, int Cin,
               int cin_pad, int H, int W, int Cout, bool reflect, int act,
               cudaStream_t stream) {
  const int n_blocks = (Cout + BN - 1) / BN;
  const int smem = (kHaloH * kHaloW * (CC + 4) + 2 * BN * (9 * CC + 4)) * 4;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B * n_blocks);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  auto kernel = BN == 32 ? conv3x3_fwd_tf32_n32_kernel<CC> : conv3x3_fwd_tf32_n8_kernel<CC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(x, wp, b, out, Cin, cin_pad, H, W, Cout, n_blocks,
                                          reflect, act);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Weight gradient (kernel #2). dW[co, ci, ky, kx] = sum over b, y, x of
// g[b, co, y, x] * xpad[b, ci, y + ky - 1, x + kx - 1].
// GEMM: M = Cout, N = 9 x Cin (tap-major), K = B*H*W pixels, in the two
// deterministic passes of the other bodies: pass 1, a block owns 32 output
// channels (2 m16 fragments) and 32 input channels (N = 9 x 32 = 36 n8
// fragments, 9 per warp), walks the 4x64 pixel tiles p, p + P, ... of all B
// images and writes its f32 sums to the (P, Cout, Cin, 9) scratch; pass 2
// (conv3x3_dw_reduce_kernel) adds the P partial sums of each weight in a
// fixed order: no atomics, every run gives the same bits.
//
// A = g (output channels x pixels) is pixels-contiguous in NCHW: it comes by
// cp.async into rows of 256 + 4 floats and loads by ldmatrix (non-trans), as
// in bf16. B = the tap-shifted x (pixels x input channels) cannot: the bf16
// body reads it with ldmatrix.trans, which has no 32-bit form. Here each B
// register is one 32-bit shared load from the channel-innermost halo tile:
// b[0] of a fragment is channel 8 f + lane/4 of pixel lane % 4, b[1] the
// same 4 pixels on, so a load touches 4 pixel rows of 8 consecutive words.
// The halo's pixel stride is 32 + 8 = 40 words (8 mod 32), which puts those
// 4 rows on disjoint 8-bank groups: every load is conflict-free. That keeps
// the forward's staging (one transpose, in registers) instead of staging x a
// second time channel-major. Both operands are activations, so both are
// split in registers: per 8-pixel K step a warp splits its 2 A and 9 B
// fragments once and issues 3 passes of 18 independent MMAs; every
// kDwFlush K steps the fresh accumulators they went to are added to the
// float32 sums.
//
// Cout = 1 (the sigmoid disparity heads) takes a path of its own, as in
// bf16: an M = 1 product would leave 15 of the 16 rows of every MMA empty,
// so conv3x3_dw_head_kernel sums in float32 FMAs on the CUDA cores, one
// (input channel, tile row) per thread, sliding a 3x3 window along its row.
// ---------------------------------------------------------------------------

constexpr int kDwCC = 32;          // input channels per block
constexpr int kDwPS = kDwCC + 8;   // halo pixel stride, floats
constexpr int kDwMT = 2;           // m16 fragments: 32 output channels per block
constexpr int kDwGS = kTile + 4;   // g row stride, floats
constexpr int kDwFlush = 2;        // K steps (of 8 pixels) per round-to-nearest add
constexpr int kDwHalo = kHaloH * kHaloW * kDwPS;

__global__ void __launch_bounds__(kThreads)
conv3x3_dw_tf32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ partial, int B, int Cin, int H, int W, int Cout,
                       int ci_chunks, bool reflect, bool vec) {
  constexpr int BM = 16 * kDwMT;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* gs = smem + kDwHalo;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int co0 = (blockIdx.x / ci_chunks) * BM, ci0 = (blockIdx.x % ci_chunks) * kDwCC;
  const int p = blockIdx.y, P = gridDim.y;
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles = B * tiles_y * tiles_x;
  const long plane = (long)H * W;

  float acc[kDwMT][9][4];
#pragma unroll
  for (int i = 0; i < kDwMT; ++i)
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = p; t < tiles; t += P) {
    const int b = t / (tiles_y * tiles_x);
    const int y0 = ((t / tiles_x) % tiles_y) * kTileH, x0 = (t % tiles_x) * kTileW;
    const float* gb = g + (long)b * Cout * plane;
    __syncthreads();  // the previous tile's reads are done
    if (vec) {  // W % 4 == 0 and g 16-byte aligned: 4 pixels per cp.async
      for (int i = threadIdx.x; i < BM * (kTile / 4); i += kThreads) {
        const int m = i / (kTile / 4), q = i % (kTile / 4);
        const int r = q / (kTileW / 4), c = (q % (kTileW / 4)) * 4;
        const int co = co0 + m, yy = y0 + r, xx = x0 + c;
        const bool ok = co < Cout && yy < H && xx < W;
        cp_async16(gs + m * kDwGS + r * kTileW + c,
                   ok ? gb + (long)co * plane + (long)yy * W + xx : g, ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < BM * kTile; i += kThreads) {
        const int m = i / kTile, q = i % kTile;
        const int co = co0 + m, yy = y0 + q / kTileW, xx = x0 + q % kTileW;
        gs[m * kDwGS + q] = (co < Cout && yy < H && xx < W)
                                ? __ldg(gb + (long)co * plane + (long)yy * W + xx)
                                : 0.f;
      }
    }
    stage_halo<kDwCC, kDwPS>(xs, x + (long)b * Cin * plane, Cin, ci0, H, W, y0, x0,
                             reflect);
    cp_async_wait_all();
    __syncthreads();

#pragma unroll 1
    for (int s0 = 0; s0 < kTile / 8; s0 += kDwFlush) {
      float d[kDwMT][9][4];  // kDwFlush K steps' products, then added to acc
#pragma unroll
      for (int ks = 0; ks < kDwFlush; ++ks) {
        const int s = s0 + ks;
        const int r = s / (kTileW / 8), c8 = (s % (kTileW / 8)) * 8;
        // A fragment i: output channels 16 i .. 16 i + 15 x pixels c8 .. c8 + 7
        uint32_t ah[kDwMT][4], al[kDwMT][4];
#pragma unroll
        for (int i = 0; i < kDwMT; ++i) {
          uint32_t raw[4];
          ldsm_x4(raw, gs + (16 * i + lane % 16) * kDwGS + r * kTileW + c8 + (lane / 16) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(raw[e], ah[i][e], al[i][e]);
        }
        // B fragment jj of the warp (n8 fragment j = 9 warp + jj: 8 channels
        // of tap j / 4): pixels c8 + lane % 4 (+ 4) x channel lane / 4
        uint32_t bh[9][2], bl[9][2];
#pragma unroll
        for (int jj = 0; jj < 9; ++jj) {
          const int j = 9 * warp + jj, tap = j / 4;
          const float* bp = xs + ((r + tap / 3) * kHaloW + c8 + (lane % 4) + tap % 3) * kDwPS +
                            (j % 4) * 8 + lane / 4;
          split(__float_as_uint(bp[0]), bh[jj][0], bl[jj][0]);
          split(__float_as_uint(bp[4 * kDwPS]), bh[jj][1], bl[jj][1]);
        }
#pragma unroll
        for (int jj = 0; jj < 9; ++jj)
#pragma unroll
          for (int i = 0; i < kDwMT; ++i) {
            if (ks == 0)
              mma_tf32_new(d[i][jj], al[i], bh[jj]);
            else
              mma_tf32(d[i][jj], al[i], bh[jj]);
          }
#pragma unroll
        for (int jj = 0; jj < 9; ++jj)
#pragma unroll
          for (int i = 0; i < kDwMT; ++i) mma_tf32(d[i][jj], ah[i], bl[jj]);
#pragma unroll
        for (int jj = 0; jj < 9; ++jj)
#pragma unroll
          for (int i = 0; i < kDwMT; ++i) mma_tf32(d[i][jj], ah[i], bh[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < 9; ++jj)
#pragma unroll
        for (int i = 0; i < kDwMT; ++i) add4(acc[i][jj], d[i][jj]);
    }
  }

  // accumulator e of fragment (i, jj): output channel 16 i + lane/4 + 8 (e/2),
  // input channel 8 (j % 4) + 2 (lane % 4) + e % 2 of tap j / 4
#pragma unroll
  for (int jj = 0; jj < 9; ++jj) {
    const int j = 9 * warp + jj, tap = j / 4;
#pragma unroll
    for (int i = 0; i < kDwMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + 16 * i + lane / 4 + 8 * (e / 2);
        const int ci = ci0 + (j % 4) * 8 + 2 * (lane % 4) + e % 2;
        if (co < Cout && ci < Cin)
          partial[(((long)p * Cout + co) * Cin + ci) * 9 + tap] = acc[i][jj][e];
      }
  }
}

__global__ void __launch_bounds__(kThreads)
conv3x3_dw_head_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ partial, int B, int Cin, int H, int W,
                       bool reflect) {
  extern __shared__ __align__(16) float smem[];  // the halo tile
  __shared__ float gs[kTileH][kTileW];
  __shared__ float red[kTileH][9][kDwCC];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;  // tile row, channel
  const int ci0 = blockIdx.x * kDwCC;
  const int p = blockIdx.y, P = gridDim.y;
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles = B * tiles_y * tiles_x;
  const long plane = (long)H * W;

  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.f;

  for (int t = p; t < tiles; t += P) {
    const int b = t / (tiles_y * tiles_x);
    const int y0 = ((t / tiles_x) % tiles_y) * kTileH, x0 = (t % tiles_x) * kTileW;
    const float* gb = g + (long)b * plane;
    __syncthreads();  // the previous tile's reads are done
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int yy = y0 + i / kTileW, xx = x0 + i % kTileW;
      gs[i / kTileW][i % kTileW] = (yy < H && xx < W) ? __ldg(gb + (long)yy * W + xx) : 0.f;
    }
    stage_halo<kDwCC, kDwPS>(smem, x + (long)b * Cin * plane, Cin, ci0, H, W, y0, x0,
                             reflect);
    __syncthreads();

    const float* xc = smem + lane;
    float win[3][3];  // win[ky][kx] = xpad at halo (row warp + ky, column col + kx)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      win[ky][1] = xc[((warp + ky) * kHaloW) * kDwPS];
      win[ky][2] = xc[((warp + ky) * kHaloW + 1) * kDwPS];
    }
#pragma unroll 8
    for (int col = 0; col < kTileW; ++col) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        win[ky][0] = win[ky][1];
        win[ky][1] = win[ky][2];
        win[ky][2] = xc[((warp + ky) * kHaloW + col + 2) * kDwPS];
      }
      const float gv = gs[warp][col];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          acc[ky * 3 + kx] = fmaf(gv, win[ky][kx], acc[ky * 3 + kx]);
    }
  }

  // the 4 rows' sums of each (channel, tap), added in a fixed order
#pragma unroll
  for (int k = 0; k < 9; ++k) red[warp][k][lane] = acc[k];
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * kDwCC; i += kThreads) {
    const int k = i / kDwCC, c = i % kDwCC;
    if (ci0 + c >= Cin) continue;
    float s = red[0][k][c];
#pragma unroll
    for (int r = 1; r < kTileH; ++r) s += red[r][k][c];
    partial[((long)p * Cin + ci0 + c) * 9 + k] = s;
  }
}

// the dynamic shared memory of the weight-gradient kernels, bytes
constexpr int kDwSmem = (kDwHalo + 16 * kDwMT * kDwGS) * 4;
constexpr int kDwHeadSmem = kDwHalo * 4;

int launch_dw(const float* x, const float* g, float* partial, int B, int Cin, int H, int W,
              int Cout, int P, int tile_m, bool reflect, cudaStream_t stream) {
  const int ci_chunks = (Cin + kDwCC - 1) / kDwCC;
  cudaError_t err;
  if (tile_m == 1) {
    err = cudaFuncSetAttribute(conv3x3_dw_head_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDwHeadSmem);
    if (err != cudaSuccess) return (int)err;
    conv3x3_dw_head_kernel<<<dim3(ci_chunks, P), kThreads, kDwHeadSmem, stream>>>(
        x, g, partial, B, Cin, H, W, reflect);
  } else {
    const int co_chunks = (Cout + 16 * kDwMT - 1) / (16 * kDwMT);
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
    err = cudaFuncSetAttribute(conv3x3_dw_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
    if (err != cudaSuccess) return (int)err;
    conv3x3_dw_tf32_kernel<<<dim3(co_chunks * ci_chunks, P), kThreads, kDwSmem, stream>>>(
        x, g, partial, B, Cin, H, W, Cout, ci_chunks, reflect, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// float32 forward: x (B, Cin, H, W), out (B, Cout, H, W) and b (Cout,)
// float32, b may be null; wp the split weights, hi then lo, each (N_pad, 9,
// cin_pad) with N_pad a multiple of bn, cin_pad of cc, zero past Cout and
// Cin. cc in {8, 16}, bn in {8, 32}. reflect: 0 zero pad, 1 reflect pad;
// act: 0 none, 1 relu, 2 elu, 3 sigmoid, 4 tanh. Returns cudaGetLastError()
// after the launch.
extern "C" int ssde_conv3x3_fwd_tf32(const void* x, const void* wp, const void* b,
                                     void* out, int B, int Cin, int H, int W, int Cout,
                                     int cin_pad, int cc, int bn, int reflect, int act,
                                     void* stream) {
  if (act < kNone || act > kTanh || B <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 ||
      W <= 0 || cin_pad < Cin || cc <= 0 || cin_pad % cc != 0)
    return (int)cudaErrorInvalidValue;
  const auto* xt = static_cast<const float*>(x);
  const auto* wt = static_cast<const float*>(wp);
  const auto* bt = static_cast<const float*>(b);
  auto* ot = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool r = reflect != 0;
#define SSDE_FWD(CC_, BN_)                                                          \
  if (cc == CC_ && bn == BN_)                                                       \
    return launch_fwd<CC_, BN_>(xt, wt, bt, ot, B, Cin, cin_pad, H, W, Cout, r, act, s);
  SSDE_FWD(8, 8)
  SSDE_FWD(8, 32)
  SSDE_FWD(16, 8)
  SSDE_FWD(16, 32)
#undef SSDE_FWD
  return (int)cudaErrorInvalidValue;
}

// float32 weight gradient: x (B, Cin, H, W) and g (B, Cout, H, W) float32;
// partial float32 scratch of P * Cout * Cin * 9, dw the float32 (Cout, Cin,
// 3, 3) result, 1 <= P <= 65535. tile_m: output channels per block, 32 on
// the tensor cores, 1 for the Cout = 1 path on the CUDA cores. Returns
// cudaGetLastError() after both passes.
extern "C" int ssde_conv3x3_dw_tf32(const void* x, const void* g, void* partial, void* dw,
                                    int B, int Cin, int H, int W, int Cout, int P,
                                    int tile_m, int reflect, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || P <= 0 || P > 65535 ||
      (tile_m == 1) != (Cout == 1) || (tile_m != 1 && tile_m != 16 * kDwMT))
    return (int)cudaErrorInvalidValue;
  auto* pt = static_cast<float*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  const int err = launch_dw(static_cast<const float*>(x), static_cast<const float*>(g), pt,
                            B, Cin, H, W, Cout, P, tile_m, reflect != 0, s);
  if (err != 0) return err;
  const int n = Cout * Cin * 9;
  conv3x3_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(pt, static_cast<float*>(dw), n,
                                                           P);
  return (int)cudaGetLastError();
}
