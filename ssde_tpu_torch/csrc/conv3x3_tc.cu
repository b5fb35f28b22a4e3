// The 3x3 SAME conv for bf16 operands on the tensor cores, for Hopper
// (sm_90a): the forward (kernel #1, which also runs as dx) and the weight
// gradient (kernel #2), NCHW, as implicit GEMMs with mma.sync
// m16n8k16 (bf16 x bf16 -> f32). float32 operands have their own body
// (conv3x3_tf32.cu); ssde_tpu_torch/ops/conv3x3.py picks the body by dtype,
// one body per dtype, and neither falls back to the other.
//
// Replaces ssde_tpu/ops/pallas/conv3x3.py::_fwd_kernel (through _conv_rows;
// as dx through _c3z_bwd and _c3_bwd) and ::_dw_kernel (through _dw_call).
// Both contract a 9*Cin-row tap stack with the weights in f32; here every
// bf16 x bf16 product is exact in f32 and the sums are f32, in another order.
//
// What bounds them. At the GRU v10 shapes (B=8, 640x192 and 320x96, Cin 32
// or 64, Cout 1..192) a frame-step's 16 convs are 363 GFLOP, 0.37 ms of
// tensor-core time at 989 TFLOP/s, and move 1.8 GB of bf16 activations,
// 0.53 ms at 3.35 TB/s (a 32->32 conv at scale 0 reads and writes 126 MB):
// bytes bound them, by a little. A CUDA-core body ran them at 20-23
// TFLOP/s (f32 FMAs on bf16 widened in shared memory); on the tensor cores
// the work that is left is staging: the tap stack is never written out, and
// each block reads its input tile once per Cin chunk.
//
// Shared design. A block of 4 warps owns a 4-row x 64-column pixel tile of
// one image (one row per warp, four m16 fragments of 16 pixels per row). It
// stages the tile's input channels with their one-pixel halo in shared
// memory channel-innermost -- each pixel's channels are one 16-byte row,
// padded to CC + 8 elements so that 8 consecutive pixels fall on distinct
// banks -- and resolves zero or reflect padding while it stages, as the
// float32 body does. A tap shift moves a whole pixel row, so ldmatrix needs
// no shifted copies. Staging transposes NCHW in registers (coalesced 16-bit
// loads along W, 16-byte shared stores), which cp.async cannot; the
// operands that need no transpose (the packed weights, and g in the weight
// gradient) come by cp.async. Overlap of loads and MMAs comes from 2-3
// resident blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_common.cuh"

namespace {

constexpr int kTcThreads = 128;   // 4 warps
constexpr int kTileH = 4;         // pixel rows per block, one per warp
constexpr int kTileW = 64;        // pixel columns per block: 4 fragments of 16
constexpr int kTile = kTileH * kTileW;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint16_t f32_to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));  // round to nearest even
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a * b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint16_t* dst, const uint16_t* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Channels [c0, c0 + CC) of the (kHaloH x kHaloW) halo tile at image
// origin (y0 - 1, x0 - 1) into xs, channel-innermost with a pixel stride of
// CC + 8 elements; channels past C and taps outside the image (zero pad)
// are 0. One thread per halo pixel: coalesced loads along W, one 16-byte
// shared store per 8 channels.
template <int CC>
__device__ __forceinline__ void stage_halo(uint16_t* xs, const uint16_t* __restrict__ xb,
                                           int C, int c0, int H, int W, int y0,
                                           int x0, bool reflect) {
  constexpr int PS = CC + 8;
  const long plane = (long)H * W;
  for (int p = threadIdx.x; p < kHaloH * kHaloW; p += kTcThreads) {
    const int r = p / kHaloW, col = p - r * kHaloW;
    const int gy = source(y0 - 1 + r, H, reflect);
    const int gx = source(x0 - 1 + col, W, reflect);
    const bool in = gy >= 0 && gx >= 0;
    const uint16_t* src = xb + (long)c0 * plane + (in ? (long)gy * W + gx : 0);
    uint4* dst = reinterpret_cast<uint4*>(xs + p * PS);
#pragma unroll
    for (int q = 0; q < CC / 8; ++q) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = q * 8 + 2 * e;
        const uint32_t lo = (in && c0 + c < C) ? __ldg(src + c * plane) : 0u;
        const uint32_t hi = (in && c0 + c + 1 < C) ? __ldg(src + (c + 1) * plane) : 0u;
        v[e] = lo | (hi << 16);
      }
      dst[q] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward (kernel #1; as dx the same kernel on g with rotated weights).
// GEMM: M = B*H*W output pixels, N = Cout, K = 9*Cin, tap-major and
// ci-minor. A block computes a 4x64 pixel tile (M = 256) against BN output
// channels; each warp one row of it (64 pixels = 4 m16 fragments) against
// all BN (BN/8 n8 fragments): 4 x BN/8 MMAs per 16-deep K step, on 4 A
// fragments (ldmatrix.x4 from the halo tile, shifted by the tap) and BN/8 B
// fragments (ldmatrix from the weights). Per Cin chunk of CC channels the
// block stages the halo tile and the chunk's packed weights (BN x 9 x CC,
// rows padded to 9*CC + 8 elements, by cp.async), then runs 9 taps x CC/16
// K steps. wp is the host-packed (N_pad, 9, cin_pad) operand
// (ops/conv3x3.py pack_weights): zero past Cout and Cin, so only the store
// masks. Epilogue: bias, act, bf16, straight from the accumulators (each
// store instruction writes 8 consecutive pixels of 8 channels).
// ---------------------------------------------------------------------------

template <int CC, int BN>
__global__ void __launch_bounds__(kTcThreads)
conv3x3_fwd_tc_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wp,
                      const uint16_t* __restrict__ bias, uint16_t* __restrict__ out,
                      int Cin, int cin_pad, int H, int W, int Cout, int n_blocks,
                      bool reflect, int act) {
  constexpr int PS = CC + 8;      // halo pixel stride
  constexpr int KS = 9 * CC + 8;  // weight row stride
  constexpr int NT = BN / 8;      // n8 fragments per warp
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* xs = smem;
  uint16_t* ws = smem + kHaloH * kHaloW * PS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z / n_blocks, n0 = (blockIdx.z % n_blocks) * BN;
  const long plane = (long)H * W;
  const uint16_t* xb = x + (long)b * Cin * plane;

  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    __syncthreads();  // the previous chunk's reads are done
    constexpr int kPieces = 9 * CC / 8;  // 16-byte pieces of one weight row
    for (int i = threadIdx.x; i < BN * kPieces; i += kTcThreads) {
      const int n = i / kPieces, q = i % kPieces;  // q = tap * CC / 8 + piece
      const int tap = q / (CC / 8), piece = q % (CC / 8);
      cp_async16(ws + n * KS + q * 8,
                 wp + ((long)(n0 + n) * 9 + tap) * cin_pad + c0 + piece * 8, 16);
    }
    stage_halo<CC>(xs, xb, Cin, c0, H, W, y0, x0, reflect);
    cp_async_wait_all();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < CC / 16; ++kk) {
        uint32_t bf[NT][2];
        const uint16_t* wrow = ws + tap * CC + 16 * kk + ((lane / 8) % 2) * 8;
        if constexpr (NT == 1) {
          ldsm_x2(bf[0], wrow + (lane % 8) * KS);
        } else {
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t r[4];
            ldsm_x4(r, wrow + (8 * j + (lane % 8) + (lane / 16) * 8) * KS);
            bf[j][0] = r[0];
            bf[j][1] = r[1];
            bf[j + 1][0] = r[2];
            bf[j + 1][1] = r[3];
          }
        }
        const uint16_t* arow =
            xs + ((warp + dy) * kHaloW + (lane % 16) + dx) * PS + 16 * kk + (lane / 16) * 8;
        uint32_t a[4][4];  // every fragment loaded before the MMAs use them
#pragma unroll
        for (int i = 0; i < 4; ++i) ldsm_x4(a[i], arow + 16 * i * PS);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], bf[j]);
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
      const float bv = bias != nullptr ? bf16_to_f32(bias[co]) : 0.f;
      uint16_t* o = out + (((long)b * Cout + co) * H + y) * W;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int xx = x0 + 16 * i + lane / 4 + 8 * h;
          if (xx < W) o[xx] = f32_to_bf16(activate(acc[i][j][2 * h + e] + bv, act));
        }
    }
  }
}

template <int CC, int BN>
int launch_fwd(const uint16_t* x, const uint16_t* wp, const uint16_t* b, uint16_t* out,
               int B, int Cin, int cin_pad, int H, int W, int Cout, bool reflect,
               int act, cudaStream_t stream) {
  const int n_blocks = (Cout + BN - 1) / BN;
  const int smem = (kHaloH * kHaloW * (CC + 8) + BN * (9 * CC + 8)) * 2;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B * n_blocks);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  auto kernel = conv3x3_fwd_tc_kernel<CC, BN>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kTcThreads, smem, stream>>>(x, wp, b, out, Cin, cin_pad, H, W, Cout,
                                            n_blocks, reflect, act);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Weight gradient (kernel #2). dW[co, ci, ky, kx] = sum over b, y, x of
// g[b, co, y, x] * xpad[b, ci, y + ky - 1, x + kx - 1].
// GEMM: M = Cout, N = 9 x Cin (tap-major), K = B*H*W pixels. The TPU
// kernel carries the sum over its sequential grid in the output block;
// blocks on this card run in no order, so the sum over pixels is split in
// two deterministic passes, as in the float32 body. Pass 1: a block owns
// BM = 16 MT output channels and 32 input channels (N = 9 x 32 = 36 n8
// fragments, 9 per warp) and walks the 4x64 pixel tiles p, p + P, ... of
// all B images. Per tile it stages g (BM rows of 256 pixels, pixels
// contiguous as NCHW has them, by cp.async) and the x halo tile
// (channel-innermost, as the forward), then runs 16 K steps of 16 pixels:
// A = g by ldmatrix.x4, B = the tap-shifted x rows by ldmatrix.x2.trans
// (a 16-byte row is 8 channels of one pixel, so the transpose gives the
// (pixels x channels) fragment). At the end it writes its f32 sums to the
// (P, Cout, Cin, 9) scratch. Pass 2 (conv3x3_dw_reduce_kernel) adds the P
// partial sums of each weight in a fixed order: no atomics, every run gives
// the same bits. The 64-row block holds 144 accumulators a thread (255
// registers on sm_90a, so 2 blocks an SM, the 32-row one 3); the host sizes
// P to that (ops/conv3x3.py dw_partitions).
//
// Cout = 1 (the sigmoid disparity heads) takes a path of its own: an M = 1
// product would leave 15 of the 16 rows of every MMA empty, so
// conv3x3_dw_head_kernel sums on the CUDA cores, one (input channel, tile
// row) per thread, every thread busy: it slides a 3x3 window of x along
// its row, 4 shared loads per 9 f32 FMAs, and reads g as a broadcast.
// ---------------------------------------------------------------------------

template <int MT>
__global__ void __launch_bounds__(kTcThreads)
conv3x3_dw_tc_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ g,
                     float* __restrict__ partial, int B, int Cin, int H, int W,
                     int Cout, int ci_chunks, bool reflect, bool vec) {
  constexpr int CC = 32, PS = CC + 8;
  constexpr int BM = 16 * MT;
  constexpr int GS = kTile + 8;  // g row stride
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* xs = smem;
  uint16_t* gs = smem + kHaloH * kHaloW * PS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int co0 = (blockIdx.x / ci_chunks) * BM, ci0 = (blockIdx.x % ci_chunks) * CC;
  const int p = blockIdx.y, P = gridDim.y;
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles = B * tiles_y * tiles_x;
  const long plane = (long)H * W;

  float acc[MT][9][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = p; t < tiles; t += P) {
    const int b = t / (tiles_y * tiles_x);
    const int y0 = ((t / tiles_x) % tiles_y) * kTileH, x0 = (t % tiles_x) * kTileW;
    const uint16_t* gb = g + (long)b * Cout * plane;
    __syncthreads();  // the previous tile's reads are done
    if (vec) {  // W % 8 == 0 and g 16-byte aligned: 8 pixels per cp.async
      for (int i = threadIdx.x; i < BM * (kTile / 8); i += kTcThreads) {
        const int m = i / (kTile / 8), q = i % (kTile / 8);
        const int r = q / (kTileW / 8), c = (q % (kTileW / 8)) * 8;
        const int co = co0 + m, yy = y0 + r, xx = x0 + c;
        const bool ok = co < Cout && yy < H && xx < W;
        cp_async16(gs + m * GS + r * kTileW + c,
                   ok ? gb + (long)co * plane + (long)yy * W + xx : g, ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < BM * kTile; i += kTcThreads) {
        const int m = i / kTile, q = i % kTile;
        const int co = co0 + m, yy = y0 + q / kTileW, xx = x0 + q % kTileW;
        gs[m * GS + q] = (co < Cout && yy < H && xx < W)
                             ? __ldg(gb + (long)co * plane + (long)yy * W + xx)
                             : (uint16_t)0;
      }
    }
    stage_halo<CC>(xs, x + (long)b * Cin * plane, Cin, ci0, H, W, y0, x0, reflect);
    cp_async_wait_all();
    __syncthreads();

#pragma unroll 1
    for (int s = 0; s < kTile / 16; ++s) {
      const int r = s / (kTileW / 16), c16 = (s % (kTileW / 16)) * 16;
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], gs + (16 * i + lane % 16) * GS + r * kTileW + c16 + (lane / 16) * 8);
      uint32_t bf[9][2];  // every fragment loaded before the MMAs use them
#pragma unroll
      for (int jj = 0; jj < 9; ++jj) {
        const int j = 9 * warp + jj, tap = j / 4;  // n8 fragment j: 8 channels of one tap
        ldsm_x2_trans(bf[jj], xs + ((r + tap / 3) * kHaloW + c16 + (lane % 8) +
                                    ((lane / 8) % 2) * 8 + tap % 3) * PS + (j % 4) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < 9; ++jj)
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][jj], a[i], bf[jj]);
    }
  }

  // accumulator e of fragment (i, jj): output channel 16 i + lane/4 + 8 (e/2),
  // input channel 8 (j % 4) + 2 (lane % 4) + e % 2 of tap j / 4
#pragma unroll
  for (int jj = 0; jj < 9; ++jj) {
    const int j = 9 * warp + jj, tap = j / 4;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + 16 * i + lane / 4 + 8 * (e / 2);
        const int ci = ci0 + (j % 4) * 8 + 2 * (lane % 4) + e % 2;
        if (co < Cout && ci < Cin)
          partial[(((long)p * Cout + co) * Cin + ci) * 9 + tap] = acc[i][jj][e];
      }
  }
}

__global__ void __launch_bounds__(kTcThreads)
conv3x3_dw_head_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ g,
                       float* __restrict__ partial, int B, int Cin, int H, int W,
                       bool reflect) {
  constexpr int CC = 32, PS = CC + 8;
  __shared__ __align__(16) uint16_t xs[kHaloH * kHaloW * PS];
  __shared__ float gs[kTileH][kTileW];
  __shared__ float red[kTileH][9][CC];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;  // tile row, channel
  const int ci0 = blockIdx.x * CC;
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
    const uint16_t* gb = g + (long)b * plane;
    __syncthreads();  // the previous tile's reads are done
    for (int i = threadIdx.x; i < kTile; i += kTcThreads) {
      const int yy = y0 + i / kTileW, xx = x0 + i % kTileW;
      gs[i / kTileW][i % kTileW] =
          (yy < H && xx < W) ? bf16_to_f32(__ldg(gb + (long)yy * W + xx)) : 0.f;
    }
    stage_halo<CC>(xs, x + (long)b * Cin * plane, Cin, ci0, H, W, y0, x0, reflect);
    __syncthreads();

    const uint16_t* xc = xs + lane;
    float win[3][3];  // win[ky][kx] = xpad at halo (row warp + ky, column col + kx)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      win[ky][1] = bf16_to_f32(xc[((warp + ky) * kHaloW) * PS]);
      win[ky][2] = bf16_to_f32(xc[((warp + ky) * kHaloW + 1) * PS]);
    }
#pragma unroll 8
    for (int col = 0; col < kTileW; ++col) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        win[ky][0] = win[ky][1];
        win[ky][1] = win[ky][2];
        win[ky][2] = bf16_to_f32(xc[((warp + ky) * kHaloW + col + 2) * PS]);
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
  for (int i = threadIdx.x; i < 9 * CC; i += kTcThreads) {
    const int k = i / CC, c = i % CC;
    if (ci0 + c >= Cin) continue;
    float s = red[0][k][c];
#pragma unroll
    for (int r = 1; r < kTileH; ++r) s += red[r][k][c];
    partial[((long)p * Cin + ci0 + c) * 9 + k] = s;
  }
}

template <int MT>
int launch_dw_tc(const uint16_t* x, const uint16_t* g, float* partial, int B, int Cin,
                 int H, int W, int Cout, int P, bool reflect, cudaStream_t stream) {
  const int co_chunks = (Cout + 16 * MT - 1) / (16 * MT), ci_chunks = (Cin + 31) / 32;
  const int smem = (kHaloH * kHaloW * (32 + 8) + 16 * MT * (kTile + 8)) * 2;
  const bool vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  auto kernel = conv3x3_dw_tc_kernel<MT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(co_chunks * ci_chunks, P), kTcThreads, smem, stream>>>(
      x, g, partial, B, Cin, H, W, Cout, ci_chunks, reflect, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 forward: x (B, Cin, H, W), out (B, Cout, H, W) and b (Cout,) bf16, b
// may be null; wp the bf16 packed weights (N_pad, 9, cin_pad) with N_pad a
// multiple of bn, cin_pad of cc, zero past Cout and Cin. cc in {16, 32}, bn
// in {8, 32, 64}. reflect: 0 zero pad, 1 reflect pad; act: 0 none, 1 relu,
// 2 elu, 3 sigmoid, 4 tanh. Returns cudaGetLastError() after the launch.
extern "C" int ssde_conv3x3_fwd_bf16(const void* x, const void* wp, const void* b,
                                     void* out, int B, int Cin, int H, int W, int Cout,
                                     int cin_pad, int cc, int bn, int reflect, int act,
                                     void* stream) {
  if (act < kNone || act > kTanh || B <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 ||
      W <= 0 || cin_pad < Cin || cc <= 0 || cin_pad % cc != 0)
    return (int)cudaErrorInvalidValue;
  const auto* xt = static_cast<const uint16_t*>(x);
  const auto* wt = static_cast<const uint16_t*>(wp);
  const auto* bt = static_cast<const uint16_t*>(b);
  auto* ot = static_cast<uint16_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool r = reflect != 0;
#define SSDE_FWD(CC_, BN_)                                                          \
  if (cc == CC_ && bn == BN_)                                                       \
    return launch_fwd<CC_, BN_>(xt, wt, bt, ot, B, Cin, cin_pad, H, W, Cout, r, act, s);
  SSDE_FWD(16, 8)
  SSDE_FWD(16, 32)
  SSDE_FWD(16, 64)
  SSDE_FWD(32, 8)
  SSDE_FWD(32, 32)
  SSDE_FWD(32, 64)
#undef SSDE_FWD
  return (int)cudaErrorInvalidValue;
}

// bf16 weight gradient: x (B, Cin, H, W) and g (B, Cout, H, W) bf16;
// partial float32 scratch of P * Cout * Cin * 9, dw the float32 (Cout, Cin,
// 3, 3) result, 1 <= P <= 65535. tile_m: output channels per block, 32 or 64
// on the tensor cores, 1 for the Cout = 1 path on the CUDA cores. Returns
// cudaGetLastError() after both passes.
extern "C" int ssde_conv3x3_dw_bf16(const void* x, const void* g, void* partial,
                                    void* dw, int B, int Cin, int H, int W, int Cout,
                                    int P, int tile_m, int reflect, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || P <= 0 || P > 65535 ||
      (tile_m == 1) != (Cout == 1))
    return (int)cudaErrorInvalidValue;
  const auto* xt = static_cast<const uint16_t*>(x);
  const auto* gt = static_cast<const uint16_t*>(g);
  auto* pt = static_cast<float*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (tile_m == 1) {
    conv3x3_dw_head_kernel<<<dim3((Cin + 31) / 32, P), kTcThreads, 0, s>>>(
        xt, gt, pt, B, Cin, H, W, reflect != 0);
    err = (int)cudaGetLastError();
  } else if (tile_m == 32) {
    err = launch_dw_tc<2>(xt, gt, pt, B, Cin, H, W, Cout, P, reflect != 0, s);
  } else if (tile_m == 64) {
    err = launch_dw_tc<4>(xt, gt, pt, B, Cin, H, W, Cout, P, reflect != 0, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int n = Cout * Cin * 9;
  conv3x3_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(pt, static_cast<float*>(dw),
                                                           n, P);
  return (int)cudaGetLastError();
}
