// Neighbourhood cosine-similarity map (the `knn` OOD score), for Hopper.
//
// Replaces the TPU kernel `knn_cosine_pallas` in
// open_world_semantic_segmentation_tpu/ops/pallas_knn.py (body `_knn_kernel`).
//
// Computes, for L2-normalised features fn (H, W, C) float32:
//   out[p] = sum_{dh, dw in [1, halo]} fn[p].fn[p + (dh, dw)]
//                                    + fn[p].fn[p - (dh, dw)]
// with out-of-image neighbours counting as zero vectors. halo is
// neighbor_size - 1 (8 on the eval path). The caller normalises the
// features (ops/knn.py), so each cosine is a plain dot product.
//
// Bound on an H100 SXM, at the eval path's 720 x 1280 x 13 map. The map is
// linear in the neighbours: out[p] = fn[p] . S[p], where S[p] is the sum of
// the neighbours' features, i.e. two offset 8 x 8 box sums per channel.
//   operations: separable sliding box sums (4 flops per pixel-channel), the
//               two boxes combined (1), the dot product (2), and the
//               normalisation in front (3, plus 3 per pixel) = 0.123 GFLOP,
//               1.8 us at 67 TFLOP/s of non-tensor f32;
//   bytes:      47.9 MB of features read once + 3.7 MB written = 51.6 MB,
//               15.4 us at 3.35 TB/s.
// So the function is bound by bytes, at about 15 us.
//
// Design. Each block owns a 16 x 32 tile of output pixels, one thread per
// pixel. It stages the tile plus a `halo`-pixel border of every channel in
// dynamic shared memory, zero outside the image (C x 32 x 48 floats = 78 KB
// at C = 13, halo 8), so device memory is read once per window instead of
// once per shift, as the 256 shifted passes of the plain version do. Each
// thread keeps its own C features in registers and takes the 128 dot
// products from shared memory; neighbouring threads read neighbouring
// words, so the reads are free of bank conflicts.
//
// Layout: the input stays in the caller's (H, W, C) order, so no transpose
// pass precedes the kernel; the window is read row by row in that order
// (coalesced) and stored channel-planar, [C][rows][cols], so that a warp's
// 32 pixels of one channel are 32 consecutive words.
//
// What limits this design: it takes the 128 dot products directly,
// 128 x 13 FMAs per pixel (3.07 GFLOP at the eval shape, 46 us even at the
// f32 peak, 3x the bytes bound), and every FMA reads one operand from
// shared memory, ~1.5 G shared loads. Summing the shifted features per
// channel into box sums before one dot product is the way down to the
// bytes bound (it reassociates the 128-term sum, so its error against the
// plain version must be checked again); computing each pair once for both
// pixels halves the direct form. This first version is the plain one.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kMaxC = 32;

__global__ void __launch_bounds__(kTileH * kTileW)
knn_cosine_kernel(const float* __restrict__ fn, float* __restrict__ out,
                  int H, int W, int C, int halo) {
  extern __shared__ float win[];  // [C][rows][cols]
  const int rows = kTileH + 2 * halo;
  const int cols = kTileW + 2 * halo;
  const int plane = rows * cols;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  // stage the window, reading it in the caller's (row, col, channel) order
  const int n = plane * C;
  for (int i = tid; i < n; i += kTileH * kTileW) {
    const int c = i % C;
    const int rc = i / C;
    const int col = rc % cols;
    const int row = rc / cols;
    const int gy = y0 - halo + row;
    const int gx = x0 - halo + col;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = fn[(static_cast<size_t>(gy) * W + gx) * C + c];
    }
    win[c * plane + row * cols + col] = v;
  }
  __syncthreads();

  const int center = (threadIdx.y + halo) * cols + (threadIdx.x + halo);
  float f[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    f[c] = c < C ? win[c * plane + center] : 0.f;
  }

  // same order as the plain version: shifts row-major, and for each shift
  // the forward neighbour before the backward one
  float acc = 0.f;
  for (int dh = 1; dh <= halo; ++dh) {
    for (int dw = 1; dw <= halo; ++dw) {
      const int fwd = center + dh * cols + dw;
      const int bwd = center - dh * cols - dw;
      float dot_f = 0.f;
      float dot_b = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          dot_f = fmaf(f[c], win[c * plane + fwd], dot_f);
          dot_b = fmaf(f[c], win[c * plane + bwd], dot_b);
        }
      }
      acc += dot_f;
      acc += dot_b;
    }
  }

  const int y = y0 + threadIdx.y;
  const int x = x0 + threadIdx.x;
  if (y < H && x < W) {
    out[static_cast<size_t>(y) * W + x] = acc;
  }
}

}  // namespace

extern "C" {

// Largest channel count and shared-memory window the kernel takes; the
// Python wrapper checks its inputs against them before launching.
int knn_cosine_max_channels() { return kMaxC; }

size_t knn_cosine_smem_bytes(int C, int halo) {
  return sizeof(float) * static_cast<size_t>(C) * (kTileH + 2 * halo) *
         (kTileW + 2 * halo);
}

// fn: (H, W, C) contiguous float32, L2-normalised per pixel; out: (H, W)
// contiguous float32. Launches on `stream`, does not synchronise, and
// returns the launch's cudaError_t (0 on success).
int knn_cosine_f32(const float* fn, float* out, int H, int W, int C,
                   int halo, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || C > kMaxC || halo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = knn_cosine_smem_bytes(C, halo);
  cudaError_t err = cudaFuncSetAttribute(
      knn_cosine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  knn_cosine_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      fn, out, H, W, C, halo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
