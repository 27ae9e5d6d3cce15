// Neighbourhood cosine-similarity map (the `knn` OOD score), for Hopper.
//
// Replaces the TPU kernel `knn_cosine_pallas` in
// open_world_semantic_segmentation_tpu/ops/pallas_knn.py (body `_knn_kernel`).
//
// Computes, for raw features f (H, W, C), float32 or bf16, with
// fn = f / max(||f||, eps) per pixel:
//   out[p] = sum_{dh, dw in [1, halo]} fn[p].fn[p + (dh, dw)]
//                                    + fn[p].fn[p - (dh, dw)]
// with out-of-image neighbours counting as zero vectors. halo is
// neighbor_size - 1 (8 on the eval path); the output is (H, W) float32.
//
// Bound on an H100 SXM, at the eval path's 720 x 1280 x 13 map. The map is
// linear in the neighbours: out[p] = fn[p] . (B+[p] + B-[p]), where B+ is
// the halo x halo box sum of fn at offsets (1..halo, 1..halo) and B- the
// one at (-halo..-1, -halo..-1): two separable box sums per channel.
//   operations: 10 flops per pixel-channel (normalise 3, box sums 4,
//               combine 1, dot 2) + 3 per pixel = 0.123 GFLOP, 1.8 us at
//               67 TFLOP/s of non-tensor f32;
//   bytes:      the features read once (24.0 MB in bf16, 47.9 MB in
//               float32) + 3.7 MB written: 8.3 us (bf16) or 15.4 us
//               (float32) at 3.35 TB/s.
// So the function is bound by bytes.
//
// Design. A CTA owns a TH x 32 tile of output pixels (TH = 32 for bf16,
// 16 for float32, so two CTAs fit an SM at C = 13, halo 8) and 256 threads.
//  1. Staging: the tile plus a halo-pixel border, every channel, in the
//     input's own type and the caller's (row, col, channel) order. Each
//     window row is a span of the caller's array; shared memory holds it at
//     the same address mod 16, so the span's aligned 16-byte chunks are
//     copied with one 16-byte load and store each (eight in flight per
//     thread), and only the chunks that the image's edge cuts are read
//     value by value, with zeros outside the image.
//  2. Norms: each staged pixel's ||f|| as the correctly rounded square root
//     of a compensated float32 sum of squares, clamped to eps, into a
//     float32 plane.
//  3. Per channel, one barrier each: horizontal halo-wide sums of
//     fn = f / ||f|| (a correctly rounded quotient: a product with the
//     reciprocal and one fma correction) over strips of 11 columns held in
//     registers, into a float32 plane (two planes, alternating with the
//     channel); then each thread takes the vertical halo-wide sums of two
//     columns of that plane for its TH / 8 output pixels of one column,
//     B- and B+, and adds f[p][c] * (B+ + B-) to a compensated (hi, lo)
//     pair.
//  4. out[p] = (hi + lo) / ||f[p]||.
// Every halo-wide sum is a pairwise tree (exact for a constant map at
// halo 8), never a running sum, and the dot product and the sum of squares
// are compensated: a constant map then gives the neighbour count to one
// unit in the last place, as the plain version does. halo is a template
// parameter (0..8) so the strips live in registers; the channel loops run
// exactly C times.
//
// What limits it (measured on an H100 by splitting the kernel, PERF.md):
// instruction issue in the per-channel passes, about half its time; the
// norms, which are taken for the halo too (2.25x the tile's pixels in
// bf16, 3x in float32); staging, whose halo is read again from L2.
//
// Generic path. The tiled kernel takes C <= 32 and halo <= 8, the eval's
// map. Any other map (the 4096-d PPM concat, a wider neighbourhood) takes
// three simple kernels, right rather than fast, all arithmetic in double,
// over scratch the caller allocates:
//  a. norms: one warp per pixel, max(sqrt(sum of squares), eps);
//  b. per chunk of channels, one thread per pixel and channel: the
//     horizontal halo-wide sums of fn = f / norm to the left (HM) and to
//     the right (HP) of each pixel;
//  c. per chunk, one warp per pixel: sum over the chunk's channels of
//     fn[p] * (HM summed over the halo rows above + HP over the rows
//     below), added to an accumulator; the last chunk writes out[p],
//     rounded to float32 once (a constant map gives the exact counts).
// The same box-sum identity as the tiled kernel, with a runtime halo and
// channel count. Each pixel-channel value is read 2 * halo times in (b)
// and the scratch 2 * halo times in (c), from L2 or L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <utility>

namespace {

constexpr int kMaxC = 32;
constexpr int kMaxHalo = 8;
constexpr int kMaxSmem = 232448;   // a block's shared memory on an H100
constexpr int kThreads = 256;
constexpr int kTileW = 32;
constexpr int kStrip = 11;     // columns of horizontal sums per thread

template <typename T>
struct Tile {
  static constexpr int kH = sizeof(T) == 2 ? 32 : 16;
  static constexpr int kRows = kH * kTileW / kThreads;   // per thread
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (s, c) += p exactly: s the rounded sum, the error added into c
__device__ __forceinline__ void add_compensated(float& s, float& c,
                                                float p) {
  const float t = __fadd_rn(s, p);
  const float bp = __fsub_rn(t, s);
  const float err = __fadd_rn(__fsub_rn(s, __fsub_rn(t, bp)),
                              __fsub_rn(p, bp));
  s = t;
  c = __fadd_rn(c, err);
}

// (s, c) += a * b, the product and the sum both compensated
__device__ __forceinline__ void fma_compensated(float& s, float& c, float a,
                                                float b) {
  const float p = __fmul_rn(a, b);
  const float e = __fmaf_rn(a, b, -p);
  add_compensated(s, c, p);
  c = __fadd_rn(c, e);
}

// Pairwise sum of x[K .. K + LEN): the largest power of two below LEN,
// then the rest. Shared subtrees of neighbouring windows are the same
// expressions, so the compiler computes each once.
__host__ __device__ constexpr int tree_split(int len) {
  int a = 1;
  while (a * 2 < len) a *= 2;
  return a;
}

template <int K, int LEN, int N>
__device__ __forceinline__ float tree_sum(const float (&x)[N]) {
  if constexpr (LEN == 1) {
    return x[K];
  } else {
    constexpr int A = tree_split(LEN);
    return __fadd_rn(tree_sum<K, A>(x), tree_sum<K + A, LEN - A>(x));
  }
}

// s[k] = tree_sum of x[k .. k + LEN) for every k < M
template <int LEN, int N, int M, int... K>
__device__ __forceinline__ void window_sums(const float (&x)[N],
                                            float (&s)[M],
                                            std::integer_sequence<int, K...>) {
  ((s[K] = tree_sum<K, LEN>(x)), ...);
}

template <typename T, int HALO>
struct Layout {
  static constexpr int kTH = Tile<T>::kH;
  static constexpr int kR = kTH + 2 * HALO;               // window rows
  static constexpr int kQ = kTileW + 2 * HALO;            // window cols
  static constexpr int kU = kTileW + HALO + 1;            // sums per row
  static constexpr int kStrips = (kU + kStrip - 1) / kStrip;
  static constexpr int kPN = kQ | 1;                      // norm pitch
  static constexpr int kPS = kU | 1;                      // sum pitch
  static_assert(kR * kStrips <= kThreads, "one strip per thread");
};

// Bytes of a staged window row: its kQ * C values plus the up to 15 bytes
// that keep it congruent to device memory mod 16, rounded to an odd number
// of 16-byte units, so rows start in different banks.
__host__ __device__ constexpr int row_bytes(int values, int itemsize) {
  const int units = (values * itemsize + 15) / 16 + 1;
  return 16 * (units | 1);
}

template <typename T, int HALO>
size_t smem_bytes(int C) {
  using L = Layout<T, HALO>;
  return static_cast<size_t>(L::kR) * row_bytes(L::kQ * C, sizeof(T)) +
         sizeof(float) * (L::kR * L::kPN + 2 * L::kR * L::kPS);
}

template <typename T, int HALO>
__global__ void __launch_bounds__(kThreads, 2)
knn_cosine_kernel(const T* __restrict__ ft, float* __restrict__ out, int H,
                  int W, int C, float eps) {
  using L = Layout<T, HALO>;
  constexpr int kTH = L::kTH;
  constexpr int kRows = Tile<T>::kRows;
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTileW;
  // pass 2's pixels: column tx, rows ty0 .. ty0 + kRows
  const int tx = tid % kTileW;
  const int ty0 = tid / kTileW * kRows;

  if constexpr (HALO == 0) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int y = y0 + ty0 + k;
      const int x = x0 + tx;
      if (y < H && x < W) out[static_cast<size_t>(y) * W + x] = 0.f;
    }
    return;
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    const int rb = row_bytes(L::kQ * C, sizeof(T));
    float* norm = reinterpret_cast<float*>(smem + L::kR * rb);  // [kR][kPN]
    float* sums = norm + L::kR * L::kPN;                  // [2][kR][kPS]
    // Window row r holds, in the caller's (col, channel) order, the
    // span of the caller's array that starts at `row_start(r)` (a virtual
    // address where the window leaves the image), at the same address mod
    // 16, so that 16-byte chunks of the array are 16-byte chunks of it.
    const size_t row_step = static_cast<size_t>(W) * C * sizeof(T);
    const uintptr_t row0 =
        reinterpret_cast<uintptr_t>(ft) +
        (static_cast<long long>(y0 - HALO) * W + x0 - HALO) * C *
            static_cast<long long>(sizeof(T));
    auto row_start = [&](int r) { return row0 + r * row_step; };
    auto row_values = [&](int r) {
      return reinterpret_cast<const T*>(smem + r * rb +
                                        (row_start(r) & 15));
    };

    // 1. stage the window: each row's aligned 16-byte chunks, loaded with
    //    one 16-byte load where a chunk lies wholly inside the image's
    //    part of the row, else value by value with zeros outside the
    //    image; eight chunks in flight per thread
    {
      constexpr int kPer = 16 / sizeof(T);
      constexpr int kBatch = 8;
      const int nc = (L::kQ * C * static_cast<int>(sizeof(T))) / 16 + 2;
      const int items = L::kR * nc;
      const int gx = x0 - HALO;
      for (int base = tid; base < items; base += kBatch * kThreads) {
        uint4 v[kBatch];
        int dst[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int item = base + u * kThreads;
          const int r = min(item / nc, L::kR - 1);
          const int gy = y0 - HALO + r;
          const uintptr_t a = row_start(r);
          // [g0, g1): the row's bytes inside the image
          const uintptr_t g0 = a + max(-gx, 0) * C * sizeof(T);
          const uintptr_t g1 = gy >= 0 && gy < H
                                   ? a + min(W - gx, L::kQ) * C * sizeof(T)
                                   : g0;
          const int k = item - r * nc;
          const uintptr_t cs = (a & ~uintptr_t(15)) + 16 * k;
          // chunks past the row's end hold none of its values
          dst[u] = item < items && cs < a + L::kQ * C * sizeof(T)
                       ? r * rb + 16 * k
                       : -1;
          if (cs >= g0 && cs + 16 <= g1) {
            v[u] = __ldg(reinterpret_cast<const uint4*>(cs));
          } else {
            T vals[kPer];
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              const uintptr_t g = cs + j * sizeof(T);
              vals[j] = g >= g0 && g < g1 ? *reinterpret_cast<const T*>(g)
                                          : T{};
            }
            memcpy(&v[u], vals, 16);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (dst[u] >= 0) *reinterpret_cast<uint4*>(smem + dst[u]) = v[u];
        }
      }
    }
    __syncthreads();

    // 2. per staged pixel: max(||f||, eps), the square root correctly
    //    rounded from a compensated sum of squares
    for (int i = tid; i < L::kR * L::kQ; i += kThreads) {
      const int r = i / L::kQ;
      const int col = i % L::kQ;
      const T* px = row_values(r) + col * C;
      float s = 0.f, comp = 0.f;
      for (int c = 0; c < C; ++c) {
        const float v = to_float(px[c]);
        if constexpr (sizeof(T) == 2) {
          add_compensated(s, comp, __fmul_rn(v, v));   // exact for bf16
        } else {
          fma_compensated(s, comp, v, v);
        }
      }
      float n = __fsqrt_rn(s);
      if (n > 0.f) {
        const float res = __fadd_rn(__fmaf_rn(-n, n, s), comp);
        n = __fadd_rn(n, __fdiv_rn(res, __fmul_rn(2.f, n)));
      }
      norm[r * L::kPN + col] = fmaxf(n, eps);
    }
    __syncthreads();

    // pass 1's strip: window row r1, sum columns u0 .. u0 + kStrip
    constexpr int kIn = kStrip + HALO - 1;
    const bool strip_owner = tid < L::kR * L::kStrips;
    const int r1 = tid / L::kStrips;
    const int u0 = tid % L::kStrips * kStrip;
    const T* strip = row_values(min(r1, L::kR - 1)) + u0 * C;
    float nn[kIn], rn[kIn];
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      const int col = u0 + j;
      nn[j] = strip_owner && col < L::kQ ? norm[r1 * L::kPN + col] : 1.f;
      rn[j] = __frcp_rn(nn[j]);
    }
    // pass 2's centre values
    const T* centre[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      centre[k] = row_values(ty0 + k + HALO) + (tx + HALO) * C;
    }

    float hi[kRows], lo[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) hi[k] = lo[k] = 0.f;

    for (int c = 0; c < C; ++c) {
      float* sc = sums + (c & 1) * L::kR * L::kPS;
      // 3a. horizontal sums of fn along the strip
      if (strip_owner) {
        float x[kIn];
#pragma unroll
        for (int j = 0; j < kIn; ++j) {
          const float v = u0 + j < L::kQ ? to_float(strip[j * C + c]) : 0.f;
          // v / n correctly rounded: q = v * (1/n), then one correction
          const float q = __fmul_rn(v, rn[j]);
          x[j] = __fmaf_rn(__fmaf_rn(-q, nn[j], v), rn[j], q);
        }
        float s[kStrip];
        window_sums<HALO>(x, s, std::make_integer_sequence<int, kStrip>{});
#pragma unroll
        for (int k = 0; k < kStrip; ++k) {
          if (u0 + k < L::kU) sc[r1 * L::kPS + u0 + k] = s[k];
        }
      }
      __syncthreads();
      // 3b. vertical sums: B- from column tx at rows ty .. ty + HALO, B+
      //     from column tx + HALO + 1 at rows ty + HALO + 1 ..
      constexpr int kCol = kRows + HALO - 1;
      float a[kCol], b[kCol];
#pragma unroll
      for (int i = 0; i < kCol; ++i) {
        a[i] = sc[(ty0 + i) * L::kPS + tx];
        b[i] = sc[(ty0 + HALO + 1 + i) * L::kPS + tx + HALO + 1];
      }
      float bm[kRows], bp[kRows];
      window_sums<HALO>(a, bm, std::make_integer_sequence<int, kRows>{});
      window_sums<HALO>(b, bp, std::make_integer_sequence<int, kRows>{});
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        fma_compensated(hi[k], lo[k], to_float(centre[k][c]),
                        __fadd_rn(bp[k], bm[k]));
      }
      // the next channel's sums go to the other plane; the barrier after
      // them orders this plane's reads before its next writes
    }

    // 4. divide by the pixel's own norm
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int y = y0 + ty0 + k;
      const int x = x0 + tx;
      if (y < H && x < W) {
        const float n = norm[(ty0 + k + HALO) * L::kPN + tx + HALO];
        out[static_cast<size_t>(y) * W + x] =
            __fdiv_rn(__fadd_rn(hi[k], lo[k]), n);
      }
    }
  }
}

template <typename T, int HALO>
int launch(const void* ft, float* out, int H, int W, int C, float eps,
           cudaStream_t stream) {
  using L = Layout<T, HALO>;
  size_t smem = 0;
  if constexpr (HALO > 0) {
    // once: allow up to all of a block's shared memory
    static const cudaError_t attr = cudaFuncSetAttribute(
        knn_cosine_kernel<T, HALO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    smem = smem_bytes<T, HALO>(C);
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + L::kTH - 1) / L::kTH);
  knn_cosine_kernel<T, HALO><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(ft), out, H, W, C, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int... HALO>
int dispatch(int halo, const void* ft, float* out, int H, int W, int C,
             float eps, cudaStream_t stream,
             std::integer_sequence<int, HALO...>) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  ((halo == HALO ? (err = launch<T, HALO>(ft, out, H, W, C, eps, stream))
                 : 0), ...);
  return err;
}

template <typename T, int... HALO>
size_t smem_dispatch(int halo, int C, std::integer_sequence<int, HALO...>) {
  size_t bytes = 0;
  ((halo == HALO ? (bytes = HALO == 0 ? 0 : smem_bytes<T, HALO>(C)) : 0),
   ...);
  return bytes;
}

using Halos = std::make_integer_sequence<int, kMaxHalo + 1>;

// ---- generic path: any C, any halo -----------------------------------
constexpr int kGenericThreads = 256;

template <typename T>
__device__ __forceinline__ double normalised(const T* ft, const double* norm,
                                             size_t pixel, int C, int c) {
  return static_cast<double>(to_float(ft[pixel * C + c])) / norm[pixel];
}

__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// a. norm[p] = max(||f[p]||, eps), one warp per pixel
template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
knn_norm_kernel(const T* __restrict__ ft, double* __restrict__ norm, int HW,
                int C, float eps) {
  const long long pixel =
      (static_cast<long long>(blockIdx.x) * kGenericThreads + threadIdx.x) /
      32;
  const int lane = threadIdx.x % 32;
  if (pixel >= HW) return;                 // whole warps leave together
  const T* px = ft + pixel * C;
  double s = 0.0;
  for (int c = lane; c < C; c += 32) {
    const double v = to_float(px[c]);
    s += v * v;
  }
  s = warp_sum(s);
  if (lane == 0) norm[pixel] = fmax(sqrt(s), static_cast<double>(eps));
}

// b. hm[p][cc] = sum_{d=1..halo} fn[y][x-d][c0+cc], hp the same at x+d;
//    one thread per pixel and channel of the chunk
template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
knn_hsum_kernel(const T* __restrict__ ft, const double* __restrict__ norm,
                double* __restrict__ hm, double* __restrict__ hp, int H,
                int W, int C, int c0, int CH, int halo) {
  const size_t i =
      static_cast<size_t>(blockIdx.x) * kGenericThreads + threadIdx.x;
  if (i >= static_cast<size_t>(H) * W * CH) return;
  const int c = c0 + static_cast<int>(i % CH);
  const size_t pixel = i / CH;
  const int x = static_cast<int>(pixel % W);
  double m = 0.0, q = 0.0;
  const int left = min(halo, x), right = min(halo, W - 1 - x);
  for (int d = 1; d <= left; ++d) m += normalised(ft, norm, pixel - d, C, c);
  for (int d = 1; d <= right; ++d) q += normalised(ft, norm, pixel + d, C, c);
  hm[i] = m;
  hp[i] = q;
}

// c. acc[p] (+)= sum_cc fn[p][c0+cc] * (sum_{d=1..halo} hm[y-d][x][cc]
//                                       + hp[y+d][x][cc]),
//    one warp per pixel; the last chunk writes out[p] instead
template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
knn_vdot_kernel(const T* __restrict__ ft, const double* __restrict__ norm,
                const double* __restrict__ hm, const double* __restrict__ hp,
                double* __restrict__ acc, float* __restrict__ out, int H,
                int W, int C, int c0, int CH, int halo, int first,
                int last) {
  const long long pixel =
      (static_cast<long long>(blockIdx.x) * kGenericThreads + threadIdx.x) /
      32;
  const int lane = threadIdx.x % 32;
  if (pixel >= static_cast<long long>(H) * W) return;
  const int y = static_cast<int>(pixel / W);
  const int up = min(halo, y), down = min(halo, H - 1 - y);
  double s = 0.0;
  for (int cc = lane; cc < CH; cc += 32) {
    double b = 0.0;
    for (int d = 1; d <= up; ++d) {
      b += hm[static_cast<size_t>(pixel - static_cast<long long>(d) * W) *
                  CH + cc];
    }
    for (int d = 1; d <= down; ++d) {
      b += hp[static_cast<size_t>(pixel + static_cast<long long>(d) * W) *
                  CH + cc];
    }
    s += normalised(ft, norm, pixel, C, c0 + cc) * b;
  }
  s = warp_sum(s);
  if (lane == 0) {
    const double t = first ? s : acc[pixel] + s;
    if (last) {
      out[pixel] = static_cast<float>(t);
    } else {
      acc[pixel] = t;
    }
  }
}

template <typename T>
int launch_generic(const void* ft_v, float* out, double* norm,
                   double* hsum, double* acc, int H, int W, int C, int halo,
                   int chunk, float eps, cudaStream_t stream) {
  const T* ft = static_cast<const T*>(ft_v);
  const long long hw = static_cast<long long>(H) * W;
  const unsigned warp_blocks = static_cast<unsigned>(
      (hw * 32 + kGenericThreads - 1) / kGenericThreads);
  knn_norm_kernel<T><<<warp_blocks, kGenericThreads, 0, stream>>>(
      ft, norm, static_cast<int>(hw), C, eps);
  int err = static_cast<int>(cudaGetLastError());
  for (int c0 = 0; c0 < C && err == 0; c0 += chunk) {
    const int ch = min(chunk, C - c0);
    double* hm = hsum;
    double* hp = hsum + hw * ch;
    const long long items = hw * ch;
    const unsigned blocks = static_cast<unsigned>(
        (items + kGenericThreads - 1) / kGenericThreads);
    knn_hsum_kernel<T><<<blocks, kGenericThreads, 0, stream>>>(
        ft, norm, hm, hp, H, W, C, c0, ch, halo);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) break;
    knn_vdot_kernel<T><<<warp_blocks, kGenericThreads, 0, stream>>>(
        ft, norm, hm, hp, acc, out, H, W, C, c0, ch, halo, c0 == 0,
        c0 + ch >= C);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

}  // namespace

extern "C" {

// Largest channel count and halo (neighbor_size - 1) the tiled kernel
// takes; the Python wrapper sends every other map to knn_cosine_generic.
int knn_cosine_max_channels() { return kMaxC; }
int knn_cosine_max_halo() { return kMaxHalo; }

// Dynamic shared memory of one CTA for C channels, a halo and an input
// item size (4: float32, 2: bf16); 0 for what the kernel does not take.
size_t knn_cosine_smem_bytes(int C, int halo, int itemsize) {
  if (C <= 0 || C > kMaxC || halo < 0 || halo > kMaxHalo) return 0;
  if (itemsize == 4) return smem_dispatch<float>(halo, C, Halos{});
  if (itemsize == 2) return smem_dispatch<__nv_bfloat16>(halo, C, Halos{});
  return 0;
}

// ft: (H, W, C) contiguous raw features, float32 (itemsize 4) or bf16
// (itemsize 2); out: (H, W) contiguous float32. Launches on `stream`, does
// not synchronise, and returns the launch's cudaError_t (0 on success).
int knn_cosine(const void* ft, int itemsize, float* out, int H, int W, int C,
               int halo, float eps, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || C > kMaxC || halo < 0 ||
      halo > kMaxHalo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) {
    return dispatch<float>(halo, ft, out, H, W, C, eps, s, Halos{});
  }
  if (itemsize == 2) {
    return dispatch<__nv_bfloat16>(halo, ft, out, H, W, C, eps, s, Halos{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Any C and halo. Scratch, all double and contiguous on the device: norm
// (H * W), hsum (2 * H * W * chunk), acc (H * W); chunk is the number of
// channels each pass over the scratch takes (1..C).
int knn_cosine_generic(const void* ft, int itemsize, float* out,
                       double* norm, double* hsum, double* acc, int H, int W,
                       int C, int halo, int chunk, float eps, void* stream) {
  // the grids stay below 2^31 blocks
  if (H <= 0 || W <= 0 || C <= 0 || halo < 0 || chunk <= 0 || chunk > C ||
      static_cast<long long>(H) * W * chunk > (1LL << 38)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) {
    return launch_generic<float>(ft, out, norm, hsum, acc, H, W, C, halo,
                                 chunk, eps, s);
  }
  if (itemsize == 2) {
    return launch_generic<__nv_bfloat16>(ft, out, norm, hsum, acc, H, W, C,
                                         halo, chunk, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
