// Fused inference ResNet bottleneck, for Hopper.
//
// Replaces the TPU kernel `fused_bottleneck` in
// open_world_semantic_segmentation_tpu/ops/pallas_block.py (body
// `_block_kernel`).
//
// Computes, for an NHWC batch x (N, H, W, Cin) in float32 or bfloat16 and
// BN-folded weights cast to x's type (biases float32):
//   y1  = relu(x . w1 + b1)                  w1 (Cin, Cmid)
//   y2  = relu(conv3x3_d(y1, w2) + b2)       w2 (3, 3, Cmid, Cmid), taps
//                                            (dh, dw) in (-d, 0, d)^2, y1
//                                            zero-padded
//   out = relu(y2 . w3 + b3 + skip)          w3 (Cmid, Cout); skip = x, or
//                                            x . wd + bd with wd (Cin, Cout)
// Sums are float32; y1 and y2 are rounded to x's type where the JAX kernel
// stores them, and the skip is added in float32 (ops/fused_block.py holds
// the plain version with the same rounding).
//
// Bound on an H100 SXM at the eval path's largest pyramid level (568x1000
// input: layer1 maps 142x250, layers 2-4 71x125), bf16, one image, the
// four products done once and x, the weights and the output moved once:
//   layer1.1-2  256->64->256, d 1:    4.94 GFLOP, 36.5 MB: 10.9 us, bytes
//   layer3.1-5  1024->256->1024, d 2: 19.78 GFLOP, 38.6 MB: 20.0 us, ops
//   layer4.1-2  2048->512->2048, d 4: 79.1 GFLOP, 81.6 MB:  80 us, ops
// (989 TFLOP/s bf16 tensor cores, 3.35 TB/s; chip_smoke.py computes the
// bound of every geometry it times). The early layers are bound by bytes,
// the late ones by operations.
//
// Design. One launch per block call, for the whole batch. Each CTA (256
// threads) owns an 8 x 8 tile of output pixels of one image, so CTAs are
// independent: the TPU kernel's sequential row grid with a ring buffer
// carried between steps has no counterpart. A CTA
//   1. loops over chunks of 32 conv1-output channels: computes that chunk
//      of y1 over the tile plus a d-pixel halo on every side ((8 + 2d)^2
//      pixels, at most 256), zeroed outside the image (conv2's padding is
//      of y1, and relu(b1) != 0), rounds it to x's type and keeps it in
//      shared memory; then adds its nine taps' share of conv2 into a
//      float32 accumulator of the whole tile x Cmid in shared memory
//      (which starts at b2);
//   2. loops over chunks of 64 output channels: conv3 of relu(acc) rounded
//      to x's type (y2), the skip (x, or the 1x1 downsample staged like
//      conv1), relu, and writes the output.
// Only x, the weights (through L2) and the output touch device memory; y1
// and y2 never do.
//
// Two kernels share that dataflow. bfloat16, the eval path's type, runs
// its products on the tensor cores (WMMA: bf16 operands staged in shared
// memory, float32 accumulators; conv2's taps as 8 x 32 x 16 products whose
// 8 rows are 8 neighbouring pixels of the halo'd window, so a tap is a
// plain strided load). float32 runs scalar FMAs from shared memory (4 x 4
// or 16 x 2 register tiles per thread). Shared memory at layer4 (Cmid 512,
// d 4) is 205 KB (bf16) and 207 KB (float32), so one CTA runs per SM
// there; at layer1 (Cmid 64, d 1) 75 and 51 KB.
//
// Costs of this version: the halo means conv1 runs on (8 + 2d)^2 pixels
// (rounded up to 16 for bf16) for 64 outputs, 1.75x (d 1), 2.25x (d 2)
// and 4x (d 4) the work of conv1, so layer4's blocks do about 1.7x the
// minimal operations, layer3's 1.3x, layer1's 1.15x; x's halo'd window is
// read from L2 once per conv1 chunk (Cmid / 32 times), the weights once
// per CTA. Every staging step is followed by a barrier and only a few
// tensor-core products, with no copy in flight while they run, and one
// 8-warp CTA per SM at layers 3-4 hides little latency: cp.async or TMA
// pipelines, wgmma and larger CTA tiles are a later version's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 8;                 // output tile kTile x kTile
constexpr int kTilePx = kTile * kTile;   // 64
constexpr int kThreads = 256;            // 16 x 16
constexpr int kKC = 32;                  // conv1-output channels per chunk
constexpr int kNC = 64;                  // conv2/conv3 outputs per chunk
constexpr int kKK = 32;                  // staged reduction depth
constexpr int kMaxHaloPx = 256;          // (kTile + 2d)^2, d <= 4
constexpr int kMaxSmem = 232448;         // per-block opt-in on an H100
constexpr int kLd = kKK + 1;             // padded row of y1c and xs

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__host__ __device__ inline int halo_pixels(int d) {
  return (kTile + 2 * d) * (kTile + 2 * d);
}

__host__ __device__ inline int max_int(int a, int b) { return a > b ? a : b; }

// float32 words of shared memory: conv2 accumulator [64][cmid_pad + 1],
// y1 chunk [halo][33], staged input [max(halo, 64)][33], staged weights
// [32][64]; ops/fused_block.py fused_block_smem_bytes mirrors this
__host__ __device__ inline size_t smem_floats(int cmid, int d) {
  const int halo = halo_pixels(d);
  return static_cast<size_t>(kTilePx) * (round_up(cmid, kNC) + 1) +
         static_cast<size_t>(halo) * kLd +
         static_cast<size_t>(max_int(halo, kTilePx)) * kLd +
         static_cast<size_t>(kKK) * kNC;
}

// ws[k][c] = w[(k0 + k) * ld + c0 + c] for k < kKK, c < cols; zero past
// the matrix (rows >= K or columns >= C)
__device__ __forceinline__ void stage_weights(float* ws, const float* w,
                                              int k0, int K, int c0, int C,
                                              int ld, int cols) {
  for (int i = threadIdx.x; i < kKK * cols; i += kThreads) {
    const int c = i % cols;
    const int k = i / cols;
    float v = 0.f;
    if (k0 + k < K && c0 + c < C) {
      v = w[static_cast<size_t>(k0 + k) * ld + c0 + c];
    }
    ws[k * kNC + c] = v;
  }
}

// xs[p][c] = x[pixel p of a side x side window at (wy0, wx0)][k0 + c],
// zero outside the image or past Cin
__device__ __forceinline__ void stage_pixels(float* xs, const float* xn, int H,
                                             int W, int Cin, int wy0,
                                             int wx0, int side, int k0) {
  const int n = side * side * kKK;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = i % kKK;
    const int p = i / kKK;
    const int gy = wy0 + p / side;
    const int gx = wx0 + p % side;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && k0 + c < Cin) {
      v = xn[(static_cast<size_t>(gy) * W + gx) * Cin + k0 + c];
    }
    xs[p * kLd + c] = v;
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs from shared memory.

__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const float* __restrict__ x,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        const float* __restrict__ w3,
                        const float* __restrict__ b3,
                        const float* __restrict__ wd,
                        const float* __restrict__ bd, float* __restrict__ out,
                        int H, int W, int Cin, int Cmid, int Cout, int d) {
  extern __shared__ float smem[];
  const int side = kTile + 2 * d;          // halo'd window
  const int halo = side * side;
  const int acc_ld = round_up(Cmid, kNC) + 1;
  float* acc2 = smem;                                    // [64][acc_ld]
  float* y1c = acc2 + kTilePx * acc_ld;                  // [halo][kLd]
  float* xs = y1c + halo * kLd;                          // [>=64][kLd]
  float* ws = xs + max_int(halo, kTilePx) * kLd;         // [kKK][kNC]

  const int tid = threadIdx.x;
  const int tx = tid % 16;                 // column group
  const int ty = tid / 16;                 // row group
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const float* xn = x + static_cast<size_t>(blockIdx.z) * H * W * Cin;
  float* on = out + static_cast<size_t>(blockIdx.z) * H * W * Cout;

  // the conv2 accumulator starts at b2 (zero in the padding columns)
  for (int i = tid; i < kTilePx * acc_ld; i += kThreads) {
    const int c = i % acc_ld;
    acc2[i] = c < Cmid ? b2[c] : 0.f;
  }

  for (int kc0 = 0; kc0 < Cmid; kc0 += kKC) {
    // ---- conv1 for channels [kc0, kc0 + 32) over the halo'd window:
    // thread rows m = ty + 16 i (i < 16), columns tx + 16 j (j < 2)
    float a1[16][2];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      a1[i][0] = 0.f;
      a1[i][1] = 0.f;
    }
    for (int k0 = 0; k0 < Cin; k0 += kKK) {
      __syncthreads();                     // xs, ws, y1c free
      stage_pixels(xs, xn, H, W, Cin, y0 - d, x0 - d, side, k0);
      stage_weights(ws, w1, k0, Cin, kc0, Cmid, Cmid, kKC);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kKK; ++k) {
        const float bw0 = ws[k * kNC + tx];
        const float bw1 = ws[k * kNC + tx + 16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int m = ty + 16 * i;
          if (m < halo) {
            const float a = xs[m * kLd + k];
            a1[i][0] = fmaf(a, bw0, a1[i][0]);
            a1[i][1] = fmaf(a, bw1, a1[i][1]);
          }
        }
      }
    }
    // y1 = relu(. + b1), zero outside the image and past Cmid
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = ty + 16 * i;
      if (m < halo) {
        const int gy = y0 - d + m / side;
        const int gx = x0 - d + m % side;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = kc0 + tx + 16 * j;
          float v = 0.f;
          if (inside && c < Cmid) {
            v = fmaxf(a1[i][j] + b1[c], 0.f);
          }
          y1c[m * kLd + tx + 16 * j] = v;
        }
      }
    }

    // ---- conv2, this chunk's share: rows m = ty + 16 i (i < 4) of the
    // tile, columns n0 + tx + 16 j (j < 4)
    for (int n0 = 0; n0 < Cmid; n0 += kNC) {
      float a2[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a2[i][j] = 0.f;
      }
      for (int tap = 0; tap < 9; ++tap) {
        const int idx = tap / 3;           // dh = (idx - 1) d
        const int jdx = tap % 3;           // dw = (jdx - 1) d
        __syncthreads();                   // ws free; y1c written
        stage_weights(ws, w2 + static_cast<size_t>(tap) * Cmid * Cmid, kc0,
                      Cmid, n0, Cmid, Cmid, kNC);
        __syncthreads();
        int hp[4];                         // window pixel of each row
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = ty + 16 * i;
          hp[i] = ((m / kTile) + idx * d) * side + (m % kTile) + jdx * d;
        }
#pragma unroll 4
        for (int k = 0; k < kKC; ++k) {
          float bw[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bw[j] = ws[k * kNC + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = y1c[hp[i] * kLd + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) a2[i][j] = fmaf(a, bw[j], a2[i][j]);
          }
        }
      }
      // each thread owns these accumulator entries: no barrier needed
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc2[(ty + 16 * i) * acc_ld + n0 + tx + 16 * j] += a2[i][j];
        }
      }
    }
  }
  __syncthreads();

  // ---- y2 = relu(acc2), in place
  for (int i = tid; i < kTilePx * acc_ld; i += kThreads) {
    acc2[i] = fmaxf(acc2[i], 0.f);
  }

  // ---- conv3 + skip + relu, 64 output channels at a time
  for (int n0 = 0; n0 < Cout; n0 += kNC) {
    float a3[4][4];
    float sk[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a3[i][j] = 0.f;
        sk[i][j] = 0.f;
      }
    }
    for (int k0 = 0; k0 < Cmid; k0 += kKK) {
      __syncthreads();                     // ws free; y2 final
      stage_weights(ws, w3, k0, Cmid, n0, Cout, Cout, kNC);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kKK; ++k) {
        float bw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = ws[k * kNC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = acc2[(ty + 16 * i) * acc_ld + k0 + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) a3[i][j] = fmaf(a, bw[j], a3[i][j]);
        }
      }
    }
    if (wd != nullptr) {
      // the 1x1 downsample over the tile's own pixels
      for (int k0 = 0; k0 < Cin; k0 += kKK) {
        __syncthreads();
        stage_pixels(xs, xn, H, W, Cin, y0, x0, kTile, k0);
        stage_weights(ws, wd, k0, Cin, n0, Cout, Cout, kNC);
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kKK; ++k) {
          float bw[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bw[j] = ws[k * kNC + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = xs[(ty + 16 * i) * kLd + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) sk[i][j] = fmaf(a, bw[j], sk[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
      const int gy = y0 + m / kTile;
      const int gx = x0 + m % kTile;
      if (gy >= H || gx >= W) continue;
      const size_t pix = static_cast<size_t>(gy) * W + gx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c >= Cout) continue;
        const float skip = wd != nullptr ? sk[i][j] + bd[c]
                                         : xn[pix * Cin + c];
        const float v = a3[i][j] + b3[c];
        on[pix * Cout + c] = fmaxf(v + skip, 0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the same dataflow with the products on the tensor cores (WMMA,
// bf16 operands in shared memory, float32 accumulators).

namespace wm {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kK1 = 64;     // conv1 / downsample / conv3 reduction chunk
constexpr int kLdX = 80;    // bf16 row of a 64-deep chunk; WMMA wants rows
constexpr int kLdY1 = 48;   //   of a multiple of 32 bytes: 64 + 16, 32 + 16
constexpr int kLdW1 = 48;   // bf16 row of a staged w1 chunk (32 columns)
constexpr int kLdB = 80;    // bf16 row of a staged 64-column weight chunk
constexpr int kLdS1 = 40;   // float row of the conv1 epilogue scratch
constexpr int kLdS3 = 72;   // float row of the conv3 epilogue scratch

__host__ __device__ inline int acc_ld(int cmid) {
  return round_up(cmid, kNC) + 8;        // float row of the accumulator
}

// bytes of shared memory: the conv2 accumulator [64][acc_ld], the y1 chunk
// [halo16][48] and one region shared, one phase at a time, by the conv1
// staging ([halo16][80] x + [64][48] w1), the conv1 epilogue ([halo16][40]
// float), the nine staged conv2 taps ([9][32][80]) and the conv3 staging
// ([64][80] a + [64][80] b + [64][72] float)
__host__ __device__ inline size_t smem_bytes(int cmid, int d) {
  const size_t hp = round_up(halo_pixels(d), 16);
  size_t u = hp * kLdX * 2 + kK1 * kLdW1 * 2;
  const size_t s1 = hp * kLdS1 * 4;
  const size_t w2 = 9 * kKC * kLdB * 2;
  const size_t s3 = 2 * kTilePx * kLdX * 2 + kTilePx * kLdS3 * 4;
  u = u > s1 ? u : s1;
  u = u > w2 ? u : w2;
  u = u > s3 ? u : s3;
  return static_cast<size_t>(kTilePx) * acc_ld(cmid) * 4 + hp * kLdY1 * 2 + u;
}

// dst[r][c] = row(r)[c] for c < valid, zero past it or where row(r) is
// null, for r < rows and c < COLS. With `vec` (every row pointer and
// `valid` a multiple of 8 elements, 16-byte aligned) as 16-byte cp.async
// copies, all in flight at once and zero-filled by the copy itself; the
// caller waits for them (wait_copies) before its barrier. A zero-filling
// copy reads nothing but still names a global address: `any`.
template <int COLS, typename RowFn>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, int rows,
                                           RowFn row, int valid, bool vec,
                                           const bf16* any) {
  if (vec) {
    constexpr int kV = COLS / 8;
    for (int i = threadIdx.x; i < rows * kV; i += kThreads) {
      const int r = i / kV;
      const int c = (i % kV) * 8;
      const bf16* src = row(r);
      const int bytes = (src != nullptr && c < valid) ? 16 : 0;
      const unsigned saddr = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + r * ld + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       saddr),
                   "l"(bytes ? src + c : any), "r"(bytes));
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * COLS; i += kThreads) {
    const int r = i / COLS;
    const int c = i % COLS;
    const bf16* src = row(r);
    dst[r * ld + c] = (src != nullptr && c < valid)
                          ? src[c] : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// FUSED_BLOCK_SKIP_{CONV1_COPIES,CONV1_MMA,CONV2,CONV3} compile a phase out,
// for fused_block_phases.py to attribute the kernel's time (no profiler
// runs on the card's machine); no build of the port defines them.
__global__ void __launch_bounds__(kThreads, 2)
fused_bottleneck_bf16_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ w1,
                             const float* __restrict__ b1,
                             const bf16* __restrict__ w2,
                             const float* __restrict__ b2,
                             const bf16* __restrict__ w3,
                             const float* __restrict__ b3,
                             const bf16* __restrict__ wd,
                             const float* __restrict__ bd,
                             bf16* __restrict__ out, int H, int W, int Cin,
                             int Cmid, int Cout, int d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int side = kTile + 2 * d;
  const int halo = side * side;
  const int halo16 = round_up(halo, 16);
  const int ald = acc_ld(Cmid);
  float* acc2 = reinterpret_cast<float*>(smem_raw);       // [64][ald]
  bf16* y1c = reinterpret_cast<bf16*>(acc2 + kTilePx * ald);
  unsigned char* u = reinterpret_cast<unsigned char*>(y1c + halo16 * kLdY1);
  bf16* xs = reinterpret_cast<bf16*>(u);                   // conv1 staging
  bf16* w1s = xs + halo16 * kLdX;
  float* s1 = reinterpret_cast<float*>(u);                 // conv1 epilogue
  bf16* w2s = reinterpret_cast<bf16*>(u);                  // conv2 taps
  bf16* a3s = reinterpret_cast<bf16*>(u);                  // conv3 staging
  bf16* b3s = a3s + kTilePx * kLdX;
  float* s3 = reinterpret_cast<float*>(b3s + kK1 * kLdB);  // conv3 epilogue

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const bf16* xn = x + static_cast<size_t>(blockIdx.z) * H * W * Cin;
  bf16* on = out + static_cast<size_t>(blockIdx.z) * H * W * Cout;
  // 16-byte copies where every staged row starts on 16 bytes
  const bool vec =
      Cin % 8 == 0 && Cmid % 8 == 0 && Cout % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
        reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(w3) |
        reinterpret_cast<uintptr_t>(wd)) % 16) == 0;

  // pixel p of the halo'd window, or of the tile; null outside the image
  auto window_px = [&](int p, int k0) -> const bf16* {
    const int gy = y0 - d + p / side;
    const int gx = x0 - d + p % side;
    if (p >= halo || gy < 0 || gy >= H || gx < 0 || gx >= W) return nullptr;
    return xn + (static_cast<size_t>(gy) * W + gx) * Cin + k0;
  };
  auto tile_px = [&](int m, int k0) -> const bf16* {
    const int gy = y0 + m / kTile;
    const int gx = x0 + m % kTile;
    if (gy >= H || gx >= W) return nullptr;
    return xn + (static_cast<size_t>(gy) * W + gx) * Cin + k0;
  };

  for (int i = tid; i < kTilePx * ald; i += kThreads) {
    const int c = i % ald;
    acc2[i] = c < Cmid ? b2[c] : 0.f;
  }

  const int mtiles1 = halo16 / 16;
  for (int kc0 = 0; kc0 < Cmid; kc0 += kKC) {
    // ---- conv1 chunk: warp w takes row tiles w and w + 8 of the window,
    // both 16-column halves of the 32-channel chunk
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c1[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wmma::fill_fragment(c1[i][0], 0.f);
      wmma::fill_fragment(c1[i][1], 0.f);
    }
    for (int k0 = 0; k0 < Cin; k0 += kK1) {
      __syncthreads();                     // the shared region is free
#ifndef FUSED_BLOCK_SKIP_CONV1_COPIES
      stage_rows<kK1>(xs, kLdX, halo16,
                      [&](int p) { return window_px(p, k0); }, Cin - k0,
                      vec, x);
      stage_rows<kKC>(w1s, kLdW1, kK1, [&](int k) -> const bf16* {
        return k0 + k < Cin ? w1 + static_cast<size_t>(k0 + k) * Cmid + kc0
                            : nullptr;
      }, Cmid - kc0, vec, x);
#endif
      wait_copies();
      __syncthreads();
#ifndef FUSED_BLOCK_SKIP_CONV1_MMA
#pragma unroll
      for (int ks = 0; ks < kK1; ks += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0,
            b1f;
        wmma::load_matrix_sync(b0, w1s + ks * kLdW1, kLdW1);
        wmma::load_matrix_sync(b1f, w1s + ks * kLdW1 + 16, kLdW1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int mt = warp + 8 * i;
          if (mt < mtiles1) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                a;
            wmma::load_matrix_sync(a, xs + mt * 16 * kLdX + ks, kLdX);
            wmma::mma_sync(c1[i][0], a, b0, c1[i][0]);
            wmma::mma_sync(c1[i][1], a, b1f, c1[i][1]);
          }
        }
      }
#endif
    }
    __syncthreads();                       // xs read by all: s1 aliases it
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = warp + 8 * i;
      if (mt < mtiles1) {
        wmma::store_matrix_sync(s1 + mt * 16 * kLdS1, c1[i][0], kLdS1,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(s1 + mt * 16 * kLdS1 + 16, c1[i][1], kLdS1,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    // y1 = relu(. + b1), zero outside the image and past Cmid, rounded
    for (int i = tid; i < halo16 * kKC; i += kThreads) {
      const int c = i % kKC;
      const int p = i / kKC;
      float v = 0.f;
      if (window_px(p, 0) != nullptr && kc0 + c < Cmid) {
        v = fmaxf(s1[p * kLdS1 + c] + b1[kc0 + c], 0.f);
      }
      y1c[p * kLdY1 + c] = __float2bfloat16(v);
    }

#ifndef FUSED_BLOCK_SKIP_CONV2
    // ---- conv2, this chunk's share: warp w takes tile row w (8 pixels)
    // and 64 output channels as two 8 x 32 accumulators
    for (int n0 = 0; n0 < Cmid; n0 += kNC) {
      __syncthreads();                     // y1c written; s1 read
      stage_rows<kNC>(w2s, kLdB, 9 * kKC, [&](int r) -> const bf16* {
        const int tap = r / kKC;
        const int k = r % kKC;
        return kc0 + k < Cmid
                   ? w2 + (static_cast<size_t>(tap) * Cmid + kc0 + k) * Cmid +
                         n0
                   : nullptr;
      }, Cmid - n0, vec, x);
      wait_copies();
      __syncthreads();
      wmma::fragment<wmma::accumulator, 8, 32, 16, float> c2[2];
      float* arow = acc2 + warp * kTile * ald + n0;
      wmma::load_matrix_sync(c2[0], arow, ald, wmma::mem_row_major);
      wmma::load_matrix_sync(c2[1], arow + 32, ald, wmma::mem_row_major);
      for (int tap = 0; tap < 9; ++tap) {
        const int idx = tap / 3;           // dh = (idx - 1) d
        const int jdx = tap % 3;           // dw = (jdx - 1) d
        const int hp = (warp + idx * d) * side + jdx * d;
#pragma unroll
        for (int ks = 0; ks < kKC; ks += 16) {
          wmma::fragment<wmma::matrix_a, 8, 32, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, y1c + hp * kLdY1 + ks, kLdY1);
#pragma unroll
          for (int cb = 0; cb < 2; ++cb) {
            wmma::fragment<wmma::matrix_b, 8, 32, 16, bf16, wmma::row_major>
                b;
            wmma::load_matrix_sync(b, w2s + (tap * kKC + ks) * kLdB + cb * 32,
                                   kLdB);
            wmma::mma_sync(c2[cb], a, b, c2[cb]);
          }
        }
      }
      wmma::store_matrix_sync(arow, c2[0], ald, wmma::mem_row_major);
      wmma::store_matrix_sync(arow + 32, c2[1], ald, wmma::mem_row_major);
    }
#endif
  }

  // ---- conv3 + skip + relu, 64 output channels at a time: warp w takes
  // row tile w / 2 (16 pixels) and two 16-column tiles
#ifndef FUSED_BLOCK_SKIP_CONV3
  const int mt3 = warp / 2;
  const int nt3 = (warp % 2) * 2;
  for (int n0 = 0; n0 < Cout; n0 += kNC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c3[2];
    wmma::fill_fragment(c3[0], 0.f);
    wmma::fill_fragment(c3[1], 0.f);
    auto mma64 = [&]() {
#pragma unroll
      for (int ks = 0; ks < kK1; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, a3s + mt3 * 16 * kLdX + ks, kLdX);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, b3s + ks * kLdB + (nt3 + j) * 16, kLdB);
          wmma::mma_sync(c3[j], a, b, c3[j]);
        }
      }
    };
    for (int k0 = 0; k0 < Cmid; k0 += kK1) {
      __syncthreads();                     // acc2 final; the region free
      // y2 = relu(acc2) rounded to bf16 (b2 is in the accumulator)
      for (int i = tid; i < kTilePx * kK1; i += kThreads) {
        const int k = i % kK1;
        const int m = i / kK1;
        a3s[m * kLdX + k] = __float2bfloat16(
            k0 + k < Cmid ? fmaxf(acc2[m * ald + k0 + k], 0.f) : 0.f);
      }
      stage_rows<kNC>(b3s, kLdB, kK1, [&](int k) -> const bf16* {
        return k0 + k < Cmid ? w3 + static_cast<size_t>(k0 + k) * Cout + n0
                             : nullptr;
      }, Cout - n0, vec, x);
      wait_copies();
      __syncthreads();
      mma64();
    }
    if (wd != nullptr) {                   // the 1x1 downsample skip
      for (int k0 = 0; k0 < Cin; k0 += kK1) {
        __syncthreads();
        stage_rows<kK1>(a3s, kLdX, kTilePx,
                        [&](int m) { return tile_px(m, k0); }, Cin - k0,
                        vec, x);
        stage_rows<kNC>(b3s, kLdB, kK1, [&](int k) -> const bf16* {
          return k0 + k < Cin ? wd + static_cast<size_t>(k0 + k) * Cout + n0
                              : nullptr;
        }, Cout - n0, vec, x);
        wait_copies();
        __syncthreads();
        mma64();
      }
    }
    wmma::store_matrix_sync(s3 + mt3 * 16 * kLdS3 + nt3 * 16, c3[0], kLdS3,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(s3 + mt3 * 16 * kLdS3 + (nt3 + 1) * 16, c3[1],
                            kLdS3, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kTilePx * kNC; i += kThreads) {
      const int c = i % kNC;
      const int m = i / kNC;
      const bf16* px = tile_px(m, 0);
      if (px == nullptr || n0 + c >= Cout) continue;
      float v = s3[m * kLdS3 + c] + b3[n0 + c];
      v += wd != nullptr ? bd[n0 + c] : __bfloat162float(px[n0 + c]);
      const size_t pix = (px - xn) / Cin;
      on[pix * Cout + n0 + c] = __float2bfloat16(fmaxf(v, 0.f));
    }
  }
#endif
}

}  // namespace wm

// the launch configuration of both kernels; 0 or a cudaError_t
template <typename Kernel, typename T>
int launch(Kernel kernel, size_t smem, const void* x, const void* w1,
           const float* b1, const void* w2, const float* b2, const void* w3,
           const float* b3, const void* wd, const float* bd, void* out,
           int N, int H, int W, int Cin, int Cmid, int Cout, int d,
           cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cmid <= 0 || Cout <= 0 ||
      d < 1 || halo_pixels(d) > kMaxHaloPx || smem > kMaxSmem ||
      (wd == nullptr && Cin != Cout) || (wd == nullptr) != (bd == nullptr) ||
      (H + kTile - 1) / kTile > 65535 || N > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<const T*>(w3), b3,
      static_cast<const T*>(wd), bd, static_cast<T*>(out), H, W, Cin, Cmid,
      Cout, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of one block for (Cmid, d), in bytes: the larger of the
// float32 and the bfloat16 kernel's.
size_t fused_bottleneck_smem_bytes(int Cmid, int d) {
  const size_t f32 = sizeof(float) * smem_floats(Cmid, d);
  const size_t bf = wm::smem_bytes(Cmid, d);
  return f32 > bf ? f32 : bf;
}

// dtype 0: float32, 1: bfloat16 (x, the weights and out). x (N, H, W, Cin)
// and out (N, H, W, Cout) contiguous NHWC; w1 (Cin, Cmid), w2 (3, 3, Cmid,
// Cmid), w3 (Cmid, Cout), wd (Cin, Cout) contiguous; biases float32. wd and
// bd are both null for the identity skip (Cin == Cout). Launches on
// `stream`, does not synchronise, and returns the launch's cudaError_t
// (0 on success).
int fused_bottleneck(int dtype, const void* x, const void* w1,
                     const float* b1, const void* w2, const float* b2,
                     const void* w3, const float* b3, const void* wd,
                     const float* bd, void* out, int N, int H, int W,
                     int Cin, int Cmid, int Cout, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<decltype(&fused_bottleneck_kernel), float>(
        fused_bottleneck_kernel, sizeof(float) * smem_floats(Cmid, d),
        x, w1, b1, w2, b2, w3, b3, wd, bd, out, N, H, W, Cin, Cmid, Cout, d,
        s);
  }
  if (dtype == 1) {
    return launch<decltype(&wm::fused_bottleneck_bf16_kernel), wm::bf16>(
        wm::fused_bottleneck_bf16_kernel, wm::smem_bytes(Cmid, d), x, w1, b1,
        w2, b2, w3, b3, wd, bd, out, N, H, W, Cin, Cmid, Cout, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
