// Inference ResNet bottleneck for Hopper: three implicit-GEMM phases on
// TMA-fed wgmma (bf16) or FMAs (float32).
//
// Replaces the TPU kernel `fused_bottleneck` in
// open_world_semantic_segmentation_tpu/ops/pallas_block.py:211 (body
// `_block_kernel`, :82-208). For an NHWC batch x (N, H, W, Cin) in float32
// or bfloat16 and BN-folded weights in x's type (biases float32):
//   y1  = round(relu(x . w1 + b1))              w1 (Cin, Cmid)
//   y2  = round(relu(conv3x3_d(y1, w2) + b2))   w2 (3, 3, Cmid, Cmid), taps
//                                               (dh, dw) in (-d, 0, d)^2,
//                                               y1 zero-padded
//   out = round(relu(y2 . w3 + b3 + skip))      w3 (Cmid, Cout); skip = x,
//                                               or x . wd + bd, wd (Cin, Cout)
// where round is to x's type; sums are float32 (ops/fused_block.py holds
// the plain version with the same rounding).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the eval path's
// largest pyramid level (568x1000 input), bf16, one image, the four
// products once, x, the weights and the output moved once (chip_smoke.py
// fused_bottleneck_bound_ms computes it for every geometry it times):
//   layer1.0    142x250, 128->64->256, d 1, downsample    8.2 us, bytes
//   layer1.1-2  142x250, 256->64->256, d 1               10.9 us, bytes
//   layer2.1-3  71x125, 512->128->512, d 1                5.6 us, bytes
//   layer3.0    71x125, 512->256->1024, d 1, downsample  27.1 us, ops
//   layer3.1-5  71x125, 1024->256->1024, d 2             20.0 us, ops
//   layer4.0    71x125, 1024->512->2048, d 2, downsample  108 us, ops
//   layer4.1-2  71x125, 2048->512->2048, d 4               80 us, ops
//
// Why three phases and not one. The TPU kernel fuses the block to keep y1
// and y2 out of HBM, because on a TPU the backbone is bound by bytes. On
// this card layers 3-4, which hold nearly all the work, are bound by
// operations, and a one-pass tile must carry the conv2 sum of all Cmid
// channels (133 KB of float32 at layer4), which forces small pixel tiles,
// weights re-read per 64 pixels and a recomputed y1 halo (up to 4x conv1
// at d 4). Here y1 and y2 go through memory in x's type (at most 9.1 MB
// each at layer4, well inside the 50 MB L2), and every product is a large
// GEMM tile instead: one block call is three launches of one kernel
// template on the caller's stream,
//   1. conv1:         y1 = round(relu(x . w1 + b1))
//   2. conv2, 9 taps: the K loop runs over taps x channel chunks; a tap's
//      A tile is a TMA load of y1 at (n, y0 + dh, x0 + dw, c0), and TMA
//      fills coordinates outside the image with zeros, which is exactly
//      the zero padding of y1 (after its relu). Any dilation works.
//   3. conv3 + skip:  the downsample x . wd is a second K segment into the
//      same float32 registers (bd added in the epilogue); the identity
//      skip is loaded in the epilogue.
// The extra traffic is y1 and y2 written once and read back (conv2 reads
// each y1 pixel 9 times, mostly from L2), at most 1.5x the byte bound
// (layer1).
//
// Tile: an 8 x 16 pixel patch of one image (M = 128) by BN output
// channels (128, or 64 where a phase has at most 64; a 256-wide tile would
// need 197 KB for a 4-stage ring, one CTA per SM, and then nothing
// overlaps a CTA's epilogue). The wrapper (ops/fused_block.py launch_plan) passes
// BN, the channel tiles and the grid: persistent CTAs, two per SM, each
// walking the tiles with a stride of the grid. 288 threads: two consumer
// warpgroups (rows 0-63 and 64-127 of M) and one producer warp. The
// producer keeps a ring of stages in shared memory full with TMA
// (cp.async.bulk.tensor): per stage one 4-D box of the activation (128
// pixels x 128 bytes of channels: 64 bf16 or 32 float32, 128-byte swizzle)
// and BN / 64 boxes of the weight matrix (128 bytes of K rows x 64 output
// channels, read in its (K, N) layout), signalled by mbarriers. bfloat16
// consumers issue wgmma.mma_async m64nBNk16 (A K-major, B N-major through
// the transpose-B bit, both 128-byte swizzled) with float32 accumulators
// in registers, keeping one group in flight while the previous stage is
// released. float32 consumers run FMAs from the same stages into the same
// register fragment (no tensor cores, no TF32). The epilogue works from
// registers: bias, skip, relu, rounding and stores masked to the image and
// to N, of 16 bytes in bf16 (after an exchange of values within each
// quad of threads) and of channel pairs in float32.
//
// Channel rows must be 16-byte aligned (TMA's stride rule): Cin, Cmid and
// Cout multiples of 8 in bf16 and 4 in float32. Nothing else is limited.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached
                   // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPatchH = 8;             // patch rows
constexpr int kPatchW = 16;            // patch columns
constexpr int kBM = kPatchH * kPatchW; // 128 pixels, the GEMM's M tile
constexpr int kRowBytes = 128;         // one K chunk of one row
constexpr int kATile = kBM * kRowBytes;        // 16 KB
constexpr int kBAtom = 64 * kRowBytes;         // 8 KB: K chunk x 64 outputs
constexpr int kConsumers = 256;        // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and the producer warp
constexpr int kConsumerWarps = kConsumers / 32;
// two CTAs per SM (under 113 KB of shared memory and 113 registers a
// thread each), so one CTA's epilogue overlaps the other's products
constexpr int kCtasPerSm = 2;

template <int BN>
struct Cfg {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kStageBytes = kATile + BN / 64 * kBAtom;
  // 1 KB of slack aligns the stages to the 128-byte swizzle's 1 KB period
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
};

// where a phase reads and what it computes
struct Geometry {
  int images, H, W;
  int patches_x, patches_img;  // patches per row of patches, per image
  int n_tiles;                 // output-channel tiles of BN
  int dil;                     // tap spacing (conv2)
  int taps;                    // 1 or 9 taps in segment 0
  int k0, k1;                  // K channels of segment 0 and 1 (0: none)
};

struct Epilogue {
  const float* bias0;
  const float* bias1;  // bd, or null
  const void* skip;    // x for the identity skip, or null
  void* out;
  int N;               // output channels: the row of out and of skip
};

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed; a wait that
// never ends (a broken pipeline) traps, so the launch fails instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(Pending)
               : "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B for one K step of 16: m64nNk16, bf16 in, float32 out, A
// K-major and B N-major (transpose-B) from shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[64 / 2], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[128 / 2], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_n64(d, da, db);
  } else {
    wgmma_n128(d, da, db);
  }
}

// ---------------------------------------------------------------------------
// The kernel: one phase (one GEMM of one or two K segments).
//
// Accumulator fragment, as wgmma lays it out and the float32 FMAs mirror:
// thread t of consumer warpgroup g holds, for j < BN / 8 and h, e < 2,
// d[4 j + 2 h + e] = C[row, col] with
//   row = 64 g + 16 (t / 32 % 4) + t % 32 / 4 + 8 h,
//   col = 8 j + 2 (t % 4) + e.
// Row r of M is pixel (y0 + r / 16, x0 + r % 16) of the patch.

template <typename T, int BN>
__device__ __forceinline__ void fma_stage(float (&d)[BN / 2],
                                          const uint8_t* stage) {
  // A: 128 rows x 32 float32, 128-byte swizzled (16-byte chunk c of row m
  // at chunk c ^ (m % 8)); B: BN / 64 atoms of 32 K rows x 64 float32
  const int t = threadIdx.x;
  const int r0 = 64 * (t / 128) + 16 * (t / 32 % 4) + t % 32 / 4;
  const int q = t % 4;
  const uint8_t* a0 = stage + r0 * kRowBytes;
  const uint8_t* a1 = a0 + 8 * kRowBytes;
  const uint8_t* b = stage + kATile;
  const int swz = r0 % 8;  // r0 + 8 has the same
#pragma unroll 2
  for (int k = 0; k < 32; ++k) {
    const int off = (((k >> 2) ^ swz) << 4) + (k & 3) * 4;
    const float va = *reinterpret_cast<const float*>(a0 + off);
    const float vb = *reinterpret_cast<const float*>(a1 + off);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 w = *reinterpret_cast<const float2*>(
          b + (col / 64) * kBAtom + k * 256 + (col % 64) * 4);
      d[4 * j] = fmaf(va, w.x, d[4 * j]);
      d[4 * j + 1] = fmaf(va, w.y, d[4 * j + 1]);
      d[4 * j + 2] = fmaf(vb, w.x, d[4 * j + 2]);
      d[4 * j + 3] = fmaf(vb, w.y, d[4 * j + 3]);
    }
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// two bf16 in one 32-bit word, as floats and back (rounding to nearest)
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t w) {
  __nv_bfloat162 v;
  memcpy(&v, &w, sizeof(w));
  return __bfloat1622float2(v);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  uint32_t w;
  memcpy(&w, &v, sizeof(w));
  return w;
}

// bias, skip, relu, rounding and the store of one CTA tile. All loads
// come before the first store, so they are issued together rather than
// each behind a store that might alias it.
//
// float32: each thread stores its fragment's channel pairs (8 bytes).
template <typename T, int BN>
__device__ __forceinline__ void epilogue_pairs(float (&d)[BN / 2],
                                               const Geometry& g,
                                               const Epilogue& e, int img,
                                               int y0, int x0, int n0) {
  const int t = threadIdx.x;
  const T* skip = static_cast<const T*>(e.skip);
  T* out = static_cast<T*>(e.out);
  size_t row[2];
  bool inside[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * (t / 128) + 16 * (t / 32 % 4) + t % 32 / 4 + 8 * h;
    const int y = y0 + r / kPatchW;
    const int x = x0 + r % kPatchW;
    inside[h] = y < g.H && x < g.W;
    row[h] = ((static_cast<size_t>(img) * g.H + y) * g.W + x) *
             static_cast<size_t>(e.N);
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (t % 4);
    if (c < e.N) {  // N is even: c + 1 < N too
      float2 bias = load_pair(e.bias0 + c);
      if (e.bias1 != nullptr) {
        const float2 b1 = load_pair(e.bias1 + c);
        bias.x += b1.x;
        bias.y += b1.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        d[4 * j + 2 * h] += bias.x;
        d[4 * j + 2 * h + 1] += bias.y;
        if (skip != nullptr && inside[h]) {
          const float2 s = load_pair(skip + row[h] + c);
          d[4 * j + 2 * h] += s.x;
          d[4 * j + 2 * h + 1] += s.y;
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!inside[h]) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (t % 4);
      if (c < e.N) {
        store_pair(out + row[h] + c, fmaxf(d[4 * j + 2 * h], 0.f),
                   fmaxf(d[4 * j + 2 * h + 1], 0.f));
      }
    }
  }
}

// v[k] for a k known only at run time, without indexing registers
__device__ __forceinline__ float pick4(const float (&v)[4], int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

// bfloat16: the four threads of a quad hold channel pairs 2q, 2q + 1 of
// each group of 8 channels; a 4 x 4 exchange among them (three shuffles)
// gives thread q all 8 channels of group 4m + q, which it loads and stores
// 16 bytes at a time. The exchanged values go back into d, the fragment's
// slots of group 4m + k now holding channels 2k, 2k + 1 of group 4m + q.
template <int BN>
__device__ __forceinline__ void epilogue_bf16(float (&d)[BN / 2],
                                              const Geometry& g,
                                              const Epilogue& e, int img,
                                              int y0, int x0, int n0) {
  const int t = threadIdx.x;
  const int q = t % 4;
  const bf16* skip = static_cast<const bf16*>(e.skip);
  bf16* out = static_cast<bf16*>(e.out);
  size_t row[2];
  bool inside[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * (t / 128) + 16 * (t / 32 % 4) + t % 32 / 4 + 8 * h;
    const int y = y0 + r / kPatchW;
    const int x = x0 + r % kPatchW;
    inside[h] = y < g.H && x < g.W;
    row[h] = ((static_cast<size_t>(img) * g.H + y) * g.W + x) *
             static_cast<size_t>(e.N);
  }
#pragma unroll
  for (int m = 0; m < BN / 32; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a[4], b[4], ra[4], rb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = d[4 * (4 * m + k) + 2 * h];
        b[k] = d[4 * (4 * m + k) + 2 * h + 1];
        ra[k] = k == q ? a[k] : 0.f;
        rb[k] = k == q ? b[k] : 0.f;
      }
#pragma unroll
      for (int x = 1; x < 4; ++x) {
        // send group q ^ x's pair to lane q ^ x, receive its pair of q
        const float ya = __shfl_xor_sync(0xffffffffu, pick4(a, q ^ x), x);
        const float yb = __shfl_xor_sync(0xffffffffu, pick4(b, q ^ x), x);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k == (q ^ x)) {
            ra[k] = ya;
            rb[k] = yb;
          }
        }
      }
      const int c0 = n0 + 32 * m + 8 * q;  // N % 8 == 0: all 8 or none
      float bias[8] = {};
      if (c0 < e.N) {
        const float4 lo = *reinterpret_cast<const float4*>(e.bias0 + c0);
        const float4 hi = *reinterpret_cast<const float4*>(e.bias0 + c0 + 4);
        bias[0] = lo.x, bias[1] = lo.y, bias[2] = lo.z, bias[3] = lo.w;
        bias[4] = hi.x, bias[5] = hi.y, bias[6] = hi.z, bias[7] = hi.w;
        if (e.bias1 != nullptr) {
          const float4 l1 = *reinterpret_cast<const float4*>(e.bias1 + c0);
          const float4 h1 =
              *reinterpret_cast<const float4*>(e.bias1 + c0 + 4);
          bias[0] += l1.x, bias[1] += l1.y, bias[2] += l1.z;
          bias[3] += l1.w, bias[4] += h1.x, bias[5] += h1.y;
          bias[6] += h1.z, bias[7] += h1.w;
        }
        if (skip != nullptr && inside[h]) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(skip + row[h] + c0);
          const float2 v0 = unpack_bf16x2(raw.x), v1 = unpack_bf16x2(raw.y);
          const float2 v2 = unpack_bf16x2(raw.z), v3 = unpack_bf16x2(raw.w);
          bias[0] += v0.x, bias[1] += v0.y, bias[2] += v1.x;
          bias[3] += v1.y, bias[4] += v2.x, bias[5] += v2.y;
          bias[6] += v3.x, bias[7] += v3.y;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        d[4 * (4 * m + k) + 2 * h] = ra[k] + bias[2 * k];
        d[4 * (4 * m + k) + 2 * h + 1] = rb[k] + bias[2 * k + 1];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < BN / 32; ++m) {
    const int c0 = n0 + 32 * m + 8 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (c0 < e.N && inside[h]) {
        const int i = 16 * m + 2 * h;  // slots of group 4m + k: i + 4k
        *reinterpret_cast<uint4*>(out + row[h] + c0) = make_uint4(
            pack_bf16x2(fmaxf(d[i], 0.f), fmaxf(d[i + 1], 0.f)),
            pack_bf16x2(fmaxf(d[i + 4], 0.f), fmaxf(d[i + 5], 0.f)),
            pack_bf16x2(fmaxf(d[i + 8], 0.f), fmaxf(d[i + 9], 0.f)),
            pack_bf16x2(fmaxf(d[i + 12], 0.f), fmaxf(d[i + 13], 0.f)));
      }
    }
  }
}

template <typename T, int BN>
__device__ __forceinline__ void epilogue(float (&d)[BN / 2],
                                         const Geometry& g,
                                         const Epilogue& e, int img, int y0,
                                         int x0, int n0) {
  if constexpr (sizeof(T) == 2) {
    epilogue_bf16<BN>(d, g, e, img, y0, x0, n0);
  } else {
    epilogue_pairs<T, BN>(d, g, e, img, y0, x0, n0);
  }
}

// CTA tile t: output-channel tile t % n_tiles of patch t / n_tiles,
// patches in image, row, column order
struct Tile {
  int img, y0, x0, n0;
};

template <int BN>
__device__ __forceinline__ Tile tile_at(const Geometry& g, int t) {
  const int patch = t / g.n_tiles;
  const int p = patch % g.patches_img;
  return {patch / g.patches_img, p / g.patches_x * kPatchH,
          p % g.patches_x * kPatchW, t % g.n_tiles * BN};
}

// Persistent: CTA b takes tiles b, b + gridDim.x, ... The producer's ring
// runs on across tiles, so the next tile's operands arrive while the
// consumers finish the current one.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
phase_kernel(const __grid_constant__ CUtensorMap a0,
             const __grid_constant__ CUtensorMap b0,
             const __grid_constant__ CUtensorMap a1,
             const __grid_constant__ CUtensorMap b1, const Geometry g,
             const Epilogue e) {
  using C = Cfg<BN>;
  constexpr int kKC = kRowBytes / static_cast<int>(sizeof(T));
  constexpr int kTx = C::kStageBytes;  // bytes each stage's loads bring
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t full = base + C::kStages * C::kStageBytes;  // [kStages]
  const uint32_t empty = full + 8 * C::kStages;              // [kStages]

  const int tiles = g.n_tiles * g.patches_img * g.images;
  const int chunks0 = (g.k0 + kKC - 1) / kKC;
  const int iters0 = g.taps * chunks0;
  const int iters = iters0 + (g.k1 + kKC - 1) / kKC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int s = 0, ph = 0;  // ring position and its phase parity
  if (threadIdx.x >= kConsumers) {
    // producer warp: one thread keeps the ring full
    if (threadIdx.x != kConsumers) return;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at<BN>(g, t);
      for (int i = 0; i < iters; ++i) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t dst = base + s * C::kStageBytes;
        mbar_expect_tx(bar, kTx);
        if (i < iters0) {
          const int tap = i / chunks0;
          const int c0 = i % chunks0 * kKC;
          const int dy = g.taps == 9 ? (tap / 3 - 1) * g.dil : 0;
          const int dx = g.taps == 9 ? (tap % 3 - 1) * g.dil : 0;
          tma_load_4d(dst, &a0, bar, c0, tl.x0 + dx, tl.y0 + dy, tl.img);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            tma_load_3d(dst + kATile + j * kBAtom, &b0, bar, tl.n0 + 64 * j,
                        c0, tap);
          }
        } else {
          const int c0 = (i - iters0) * kKC;
          tma_load_4d(dst, &a1, bar, c0, tl.x0, tl.y0, tl.img);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            tma_load_3d(dst + kATile + j * kBAtom, &b1, bar, tl.n0 + 64 * j,
                        c0, 0);
          }
        }
        if (++s == C::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // consumers: two warpgroups, rows 0-63 and 64-127 of the tile
  const bool lead = threadIdx.x % 32 == 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    if constexpr (sizeof(T) == 2) {
      const uint32_t a_off = (threadIdx.x / 128) * 64 * kRowBytes;
      int prev = -1;
      for (int i = 0; i < iters; ++i) {
        mbar_wait(full + 8 * s, ph);
        const uint32_t stage = base + s * C::kStageBytes;
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // A: K-major, 8-row groups 1 KB apart; B: N-major, 8-row K
          // groups 1 KB apart, 64-column atoms kBAtom apart
          wgmma_step<BN>(d, sw128_desc(stage + a_off + 32 * k, 16, 1024),
                         sw128_desc(stage + kATile + 2048 * k, kBAtom,
                                    1024));
        }
        wgmma_commit();
        fence_regs(d);
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(d);
        if (prev >= 0 && lead) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == C::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(d);
      if (lead) mbar_arrive(empty + 8 * prev);
    } else {
      for (int i = 0; i < iters; ++i) {
        mbar_wait(full + 8 * s, ph);
        fma_stage<T, BN>(d, base_ptr + s * C::kStageBytes);
        __syncwarp();
        if (lead) mbar_arrive(empty + 8 * s);
        if (++s == C::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    const Tile tl = tile_at<BN>(g, t);
    epilogue<T, BN>(d, g, e, tl.img, tl.y0, tl.x0, tl.n0);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, the launch plan's checks, the three launches.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// An NHWC activation (N, H, W, C) read in boxes of 128 bytes of channels x
// a kPatchH x kPatchW patch of one image, 128-byte swizzled; coordinates
// outside the tensor read as zero.
bool activation_map(CUtensorMap* map, int elem, const void* ptr, int N,
                    int H, int W, int C) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t row = static_cast<cuuint64_t>(C) * elem;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kRowBytes / elem),
                             kPatchW, kPatchH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode_tiled()(
             map,
             elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             4, const_cast<void*>(ptr), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `taps` weight matrices (K, Nc), row-major, read in boxes of 64 columns x
// 128 bytes of K rows (swizzled for wgmma in bf16, plain for the FMAs)
bool weight_map(CUtensorMap* map, int elem, const void* ptr, int taps, int K,
                int Nc) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Nc),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(taps)};
  const cuuint64_t row = static_cast<cuuint64_t>(Nc) * elem;
  const cuuint64_t strides[2] = {row, row * K};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(kRowBytes / elem),
                             1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode_tiled()(
             map,
             elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             3, const_cast<void*>(ptr), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             elem == 2 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap a0, b0, a1, b1;
};

template <typename T, int BN>
int launch_bn(const Maps& m, const Geometry& g, const Epilogue& e, int grid,
              cudaStream_t stream) {
  auto kernel = phase_kernel<T, BN>;
  static bool opted_in[64] = {};  // per device: the shared-memory opt-in
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<BN>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted_in[dev] = true;
  }
  kernel<<<grid, kThreads, Cfg<BN>::kSmem, stream>>>(m.a0, m.b0, m.a1, m.b1,
                                                     g, e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Maps& m, const Geometry& g, const Epilogue& e, int bn,
           int grid, cudaStream_t stream) {
  switch (bn) {
    case 64:
      return launch_bn<T, 64>(m, g, e, grid, stream);
    case 128:
      return launch_bn<T, 128>(m, g, e, grid, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (x, the weights, y1, y2 and out). x (N, H,
// W, Cin), y1 and y2 (N, H, W, Cmid) and out (N, H, W, Cout) contiguous
// NHWC; w1 (Cin, Cmid), w2 (3, 3, Cmid, Cmid), w3 (Cmid, Cout), wd (Cin,
// Cout) contiguous; biases float32; wd and bd both null for the identity
// skip (Cin == Cout). plan: (BN, output-channel tiles, grid) for each of
// the three phases, as ops/fused_block.py launch_plan computes it and
// checked here. phases: a bit mask of the phases to launch (7: the block;
// one bit: that phase alone, reading what the earlier phases left in y1
// and y2). Launches on `stream`, does not synchronise; returns 0 or the
// first failing launch's cudaError_t.
int fused_bottleneck(int dtype, const void* x, const void* w1,
                     const float* b1, const void* w2, const float* b2,
                     const void* w3, const float* b3, const void* wd,
                     const float* bd, void* y1, void* y2, void* out, int N,
                     int H, int W, int Cin, int Cmid, int Cout, int d,
                     const int* plan, int phases, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return bad;
  const int elem = dtype == 1 ? 2 : 4;
  const int align = 16 / elem;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cmid <= 0 || Cout <= 0 ||
      d < 1 || Cin % align || Cmid % align || Cout % align ||
      (wd == nullptr) != (bd == nullptr) ||
      (wd == nullptr && Cin != Cout)) {
    return bad;
  }
  const void* const tensors[] = {x,  w1, w2, w3, wd, y1, y2,
                                 out, b1, b2, b3, bd};
  for (const void* p : tensors) {
    if (!aligned16(p)) return bad;
  }
  if (encode_tiled() == nullptr) {
    return static_cast<int>(cudaErrorSymbolNotFound);
  }
  const int patches_x = (W + kPatchW - 1) / kPatchW;
  const int patches_img = (H + kPatchH - 1) / kPatchH * patches_x;
  const int outs[3] = {Cmid, Cmid, Cout};
  for (int i = 0; i < 3; ++i) {
    const int bn = plan[3 * i], tiles = plan[3 * i + 1];
    const long long all = static_cast<long long>(N) * patches_img * tiles;
    if ((bn != 64 && bn != 128) || tiles != (outs[i] + bn - 1) / bn ||
        all > INT32_MAX || plan[3 * i + 2] < 1 || plan[3 * i + 2] > all) {
      return bad;
    }
  }

  Maps m[3];
  bool ok = activation_map(&m[0].a0, elem, x, N, H, W, Cin) &&
            weight_map(&m[0].b0, elem, w1, 1, Cin, Cmid) &&
            activation_map(&m[1].a0, elem, y1, N, H, W, Cmid) &&
            weight_map(&m[1].b0, elem, w2, 9, Cmid, Cmid) &&
            activation_map(&m[2].a0, elem, y2, N, H, W, Cmid) &&
            weight_map(&m[2].b0, elem, w3, 1, Cmid, Cout);
  m[0].a1 = m[0].a0;
  m[0].b1 = m[0].b0;
  m[1].a1 = m[1].a0;
  m[1].b1 = m[1].b0;
  if (wd != nullptr) {
    ok = ok && activation_map(&m[2].a1, elem, x, N, H, W, Cin) &&
         weight_map(&m[2].b1, elem, wd, 1, Cin, Cout);
  } else {
    m[2].a1 = m[2].a0;
    m[2].b1 = m[2].b0;
  }
  if (!ok) return bad;

  const Geometry geo[3] = {
      {N, H, W, patches_x, patches_img, plan[1], d, 1, Cin, 0},
      {N, H, W, patches_x, patches_img, plan[4], d, 9, Cmid, 0},
      {N, H, W, patches_x, patches_img, plan[7], d, 1, Cmid,
       wd != nullptr ? Cin : 0}};
  const Epilogue epi[3] = {{b1, nullptr, nullptr, y1, Cmid},
                           {b2, nullptr, nullptr, y2, Cmid},
                           {b3, bd, wd == nullptr ? x : nullptr, out, Cout}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < 3; ++i) {
    if (!(phases >> i & 1)) continue;
    const int err =
        dtype == 1 ? launch<bf16>(m[i], geo[i], epi[i], plan[3 * i],
                                  plan[3 * i + 2], s)
                   : launch<float>(m[i], geo[i], epi[i], plan[3 * i],
                                   plan[3 * i + 2], s);
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
