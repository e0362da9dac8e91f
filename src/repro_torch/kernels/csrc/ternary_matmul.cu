// Ternary-weight matmul on 2-bit packed weights, on the tensor cores of
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ternary_matmul.py::_kernel
// (launched by ternary_matmul). Computes
//
//   out = (x @ (code(W) - 1)) * w_q        x (M, K) fp32, out (M, N) fp32
//
// where W is (K/4, N) uint8 and byte W[r, n] holds the codes of rows
// 4r..4r+3 of column n (2 bits each, little-endian). Sums accumulate in fp32
// and w_q, a device scalar, is applied once to the finished sum.
//
// Exact bf16 split of x. The weights -1, 0, +1 are exact in bf16; x is split
// into three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid). Both subtractions are exact in fp32 and hi + mid + lo == x for every
// normal x, so every product of a part with a weight is exact and the only
// rounding is the fp32 accumulation, as in a fp32 matmul. Each part has its
// own accumulator; the result is ((lo + mid) + hi) * w_q. One bf16 part (or
// TF32) would keep about 3 decimal digits.
//
// bf16 x has kernels of their own, designed for one bf16 part of x:
// ternary_matmul_bf16.cu. The kernels here stay templated on x's type.
//
// Bound: bytes at decode, operations at prefill. The tensor cores do
// 3 * 2 * M * K * N bf16 operations (989 TFLOP/s dense); the kernel reads
// K * N / 4 packed bytes and x, and writes out. One decode step of olmo-1b
// (M = 4, 112 launches) moves about 280 MB (84 us at 3.35 TB/s) against
// 26 us of operations; the prefill forward (M = 128) does 825 GFLOP (0.83 ms)
// against 654 MB (0.20 ms).
//
// Design. Two kernels share it: mma.sync.m16n8k16 (bf16 in, fp32
// accumulate) for M <= 16, and wgmma.m64n96k16 for M > 16.
// - A and B are swapped: the weights are the A operand, fed from registers,
//   and the output is computed transposed, out^T = (code - 1)^T [hi|mid|lo]^T.
//   Output columns fill the instruction's 16 (or 64) rows; the 3 * BM
//   (part, row of x) pairs fill its narrow dimension (12 pairs padded to 16
//   at decode, 96 for BM = 32).
// - K is permuted inside each 16-deep step so that the four k-slots a thread
//   holds for one A row (2t, 2t+1, 2t+8, 2t+9) are the four codes of one
//   packed byte (logical k 4t..4t+3). A thread's A rows are neighbouring
//   output columns, so one 32-bit (mma.sync) or 16-bit (wgmma) shared load
//   gives all its weight bytes for a step. A byte becomes two bf16x2
//   registers with one PRMT, two LOP3, one shift and two bf16x2 FMAs, with
//   no conversion: (0x4300 | c) is the bf16 128 + c, and FMA(v, 1, -129)
//   leaves c - 1. On mma.sync the B fragment is then four consecutive
//   logical k of one pair, one 8-byte load; for wgmma the split writes x in
//   the no-swizzle core-matrix layout with the same permutation, and B is
//   read from shared memory by descriptor.
// - Packed tiles and x stream through a ring of shared-memory stages with
//   cp.async (128 K values each; 4 stages, or 3 on the wgmma kernel), so the
//   HBM reads stay in flight while the MMAs run. x is split into its three
//   parts once per stage, from the staged fp32 into one of two bf16
//   buffers, by the whole block: the split of stage i + 1 runs beside the
//   MMAs of stage i, one barrier per stage.
// - A block owns 128 output columns and BM rows of x: 4 warps of 32 columns
//   and BM = 4 or 16 (mma.sync), or two warpgroups of 64 and 32 (wgmma). When
//   M and N give too few blocks to fill the card, blocks also split K (grid
//   z); each split writes its partial sums to a workspace and a second
//   kernel adds them in split order, so results are deterministic.
// - Measured on the H100 (PERF.md, chip_smoke.py): the loops are bound by
//   instruction issue and latency (the split, the unpack, the barriers), not
//   by the tensor cores or the copies; the prefill forward reaches about a
//   fifth of its bf16 bound. Moving the split to producer warps (warp
//   specialization with mbarriers) was tried and was slower at one block
//   per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kKC = 128;                 // K values per pipeline stage
constexpr int kKC4 = kKC / 4;            // packed rows per stage
constexpr int kSteps = kKC / 16;         // k16 MMA steps per stage
constexpr int kXbStride = 2 * kKC + 32;  // smem bytes per bf16 part row: conflict-free B loads

constexpr int kBN = 128;                       // output columns per block (both kernels)

// x as the kernels take it: fp32 (split into three bf16 parts) or bf16 (one
// part, held as its raw 16 bits).
using bf16_t = uint16_t;
template <typename XT>
struct XType {
  static_assert(sizeof(XT) == 4 || sizeof(XT) == 2, "x is fp32 or bf16");
  static constexpr int kParts = sizeof(XT) == 4 ? 3 : 1;
};

// The mma.sync kernel: BM rows of x, 4 warps of 32 output columns.
template <int BM, typename XT>
struct Cfg {
  static constexpr int kParts = XType<XT>::kParts;
  static constexpr int kThreads = 128;
  static constexpr int kWStride = kBN + 32;             // smem bytes per packed row: conflict-free A loads
  static constexpr int kRedStride = kBN + 4;            // floats per pair row of the epilogue
  static constexpr int kNT = (kParts * BM + 7) / 8;     // n8 tiles of (part, row) pairs
  static constexpr int kPairs = kNT * 8;
  static constexpr int kStages = 4;
  static constexpr int kWBytes = kKC4 * kWStride;
  static constexpr int kXfBytes = BM * kKC * (int)sizeof(XT);
  static constexpr int kStageBytes = kWBytes + kXfBytes;
  static constexpr int kXbBytes = kPairs * kXbStride;
  static constexpr int kMainBytes = kStages * kStageBytes + 2 * kXbBytes;
  static constexpr int kRedBytes = kPairs * kRedStride * 4;
  static constexpr int kSmem = kMainBytes > kRedBytes ? kMainBytes : kRedBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Two fp32 values rounded to nearest into one bf16x2 (lo in the low half).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float low_f(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float high_f(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The four codes of byte `sel` of `w` as two bf16x2 registers of c - 1:
// v01 = (c0 - 1, c1 - 1) and v23 = (c2 - 1, c3 - 1). The byte is copied to
// both halves; each half keeps one code at bits 0-1 (low half) or 2-3 (high
// half) of a bf16 mantissa under the exponent of 128, so the halves hold
// 128 + c and 128 + 4c, and one FMA with (1, 1/4) and (-129, -33) gives c - 1
// exactly.
template <int SEL>
__device__ __forceinline__ void unpack_byte(uint32_t w, uint32_t& v01, uint32_t& v23) {
  constexpr uint32_t kMask = 0x000C0003u;
  constexpr uint32_t kBase = 0x43004300u;      // bf16 (128, 128)
  constexpr uint32_t kMul = 0x3E803F80u;       // bf16 (1, 0.25)
  constexpr uint32_t kAdd = 0xC204C301u;       // bf16 (-129, -33)
  const uint32_t dup = __byte_perm(w, 0u, 0x4040u | (SEL << 8) | SEL);
  v01 = bf16x2_fma((dup & kMask) | kBase, kMul, kAdd);
  v23 = bf16x2_fma(((dup >> 4) & kMask) | kBase, kMul, kAdd);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage: packed rows [k4, k4 + kKC4) of the block's columns and the
// matching K range of its BM rows of x, zero-filled past the split's K
// range, past N and past M. WV is the width of a packed copy: 16 or 4 bytes
// with cp.async, or 1 (ragged N) with plain loads.
template <int BM, int kBN, int kThreads, int WV, typename XT>
__device__ __forceinline__ void load_stage(uint8_t* ws, XT* xf, const XT* x,
                                           const uint8_t* w, int M, int K4, int N,
                                           int m0, int n0, int k4, int k4_hi) {
  constexpr int kWStride = kBN + 32;
  if (WV == 16 || WV == 4) {
    constexpr int kPerRow = kBN / WV;
    for (int i = threadIdx.x; i < kKC4 * kPerRow; i += kThreads) {
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * WV;
      const bool valid = k4 + r < k4_hi && n0 + c < N;
      const uint8_t* src = valid ? w + (size_t)(k4 + r) * N + n0 + c : w;
      if (WV == 16)
        cp_async16(ws + r * kWStride + c, src, valid);
      else
        cp_async4(ws + r * kWStride + c, src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kKC4 * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i % kBN;
      ws[r * kWStride + c] =
          (k4 + r < k4_hi && n0 + c < N) ? w[(size_t)(k4 + r) * N + n0 + c] : 0;
    }
  }
  const size_t K = (size_t)K4 * 4;
  for (int i = threadIdx.x; i < BM * kKC4; i += kThreads) {
    const int m = i / kKC4;
    const int r = i % kKC4;                    // 4 values of x (16 or 8 bytes) are one packed row
    const bool valid = m0 + m < M && k4 + r < k4_hi;
    const XT* src = valid ? x + (size_t)(m0 + m) * K + (size_t)(k4 + r) * 4 : x;
    if (sizeof(XT) == 4)
      cp_async16(xf + m * kKC + 4 * r, src, valid);
    else
      cp_async8(xf + m * kKC + 4 * r, src, valid);
  }
}

// Four fp32 values of x as their three bf16 parts, each as two bf16x2
// registers (values 0, 1 and 2, 3): p[0] hi, p[1] mid, p[2] lo.
__device__ __forceinline__ void split4(const float4 v, uint2 (&p)[3]) {
  const uint32_t h0 = bf16x2(v.x, v.y), h1 = bf16x2(v.z, v.w);
  float r0 = v.x - low_f(h0), r1 = v.y - high_f(h0);
  float r2 = v.z - low_f(h1), r3 = v.w - high_f(h1);
  const uint32_t d0 = bf16x2(r0, r1), d1 = bf16x2(r2, r3);
  r0 -= low_f(d0); r1 -= high_f(d0);
  r2 -= low_f(d1); r3 -= high_f(d1);
  p[0] = make_uint2(h0, h1);
  p[1] = make_uint2(d0, d1);
  p[2] = make_uint2(bf16x2(r0, r1), bf16x2(r2, r3));
}

// Four staged values of x (one packed row's K range) as their three bf16
// parts, each as two bf16x2 registers (values 0, 1 and 2, 3).
__device__ __forceinline__ void parts4(const float* xf, uint2 (&p)[3]) {
  split4(*reinterpret_cast<const float4*>(xf), p);
}

// The staged x of one stage into its bf16 parts: pair p * BM + m holds part
// p (0 hi, 1 mid, 2 lo; bf16 x has only p = 0) of row m, in logical k order.
template <int BM, typename XT>
__device__ __forceinline__ void split_stage(const XT* xf, uint8_t* xb) {
  constexpr int kParts = XType<XT>::kParts;
  for (int i = threadIdx.x; i < BM * kKC4; i += Cfg<BM, XT>::kThreads) {
    const int m = i / kKC4;
    const int r = i % kKC4;
    uint2 p[3];
    parts4(xf + m * kKC + 4 * r, p);
#pragma unroll
    for (int part = 0; part < kParts; ++part)
      *reinterpret_cast<uint2*>(xb + (part * BM + m) * kXbStride + 8 * r) = p[part];
  }
}

// One output.
__device__ __forceinline__ void store_out(float* out, size_t i, float y) { out[i] = y; }

// The finished sum of row m, column c from the epilogue's pair rows:
// (lo + mid) + hi for fp32 x, the one part for bf16.
template <int kParts>
__device__ __forceinline__ float pair_sum(const float* red, int stride, int bm, int m, int c) {
  if (kParts == 3)
    return (red[(2 * bm + m) * stride + c] + red[(bm + m) * stride + c]) + red[m * stride + c];
  return red[m * stride + c];
}

template <int BM, int WV, typename XT>
__global__ void __launch_bounds__(128, 2)
ternary_matmul_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                      const float* __restrict__ wq, XT* __restrict__ out,
                      float* __restrict__ ws, int M, int K4, int N, int k4_per_split) {
  using C = Cfg<BM, XT>;
  constexpr int kThreads = C::kThreads;
  constexpr int kWStride = C::kWStride, kRedStride = C::kRedStride;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xb = smem + C::kStages * C::kStageBytes;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int k4_lo = blockIdx.z * k4_per_split;
  const int k4_hi = min(K4, k4_lo + k4_per_split);
  const int n_chunks = (k4_hi - k4_lo + kKC4 - 1) / kKC4;

  // pairs past kParts * BM pad the last n8 tile and stay zero (in both buffers)
  for (int i = threadIdx.x; i < (C::kPairs - C::kParts * BM) * kXbStride / 4; i += kThreads) {
    reinterpret_cast<uint32_t*>(xb + C::kParts * BM * kXbStride)[i] = 0u;
    reinterpret_cast<uint32_t*>(xb + C::kXbBytes + C::kParts * BM * kXbStride)[i] = 0u;
  }

  float acc[2][C::kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  auto stage_w = [&](int s) { return smem + s * C::kStageBytes; };
  auto stage_x = [&](int s) {
    return reinterpret_cast<XT*>(smem + s * C::kStageBytes + C::kWBytes);
  };

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_chunks)
      load_stage<BM, kBN, kThreads, WV, XT>(stage_w(s), stage_x(s), x, w, M, K4, N, m0, n0,
                                             k4_lo + s * kKC4, k4_hi);
    cp_async_commit();
  }

  // One barrier per stage: iteration i splits x of stage i + 1 into the
  // other bf16 buffer while it multiplies stage i, so the conversion of one
  // stage overlaps the MMAs of the one before.
  cp_async_wait<C::kStages - 2>();
  __syncthreads();
  if (n_chunks > 0) split_stage<BM, XT>(stage_x(0), xb);
  const int col = 32 * warp + 4 * g;           // this thread's 4 output columns
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<C::kStages - 3>();
    __syncthreads();    // stage i + 1 landed and stage i is split; iteration i - 1 is done
    {
      const int next = i + C::kStages - 1;
      if (next < n_chunks)
        load_stage<BM, kBN, kThreads, WV, XT>(stage_w(next % C::kStages),
                                               stage_x(next % C::kStages), x, w, M, K4, N, m0,
                                               n0, k4_lo + next * kKC4, k4_hi);
      cp_async_commit();
    }
    if (i + 1 < n_chunks)
      split_stage<BM, XT>(stage_x((i + 1) % C::kStages), xb + ((i + 1) & 1) * C::kXbBytes);
    const uint8_t* wsm = stage_w(i % C::kStages);
    const uint8_t* xbi = xb + (i & 1) * C::kXbBytes;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const uint32_t wb = *reinterpret_cast<const uint32_t*>(wsm + (4 * s + t) * kWStride + col);
      uint32_t a[2][4];
      unpack_byte<0>(wb, a[0][0], a[0][2]);    // column col:     m-tile 0, row g
      unpack_byte<1>(wb, a[0][1], a[0][3]);    // column col + 1: m-tile 0, row g + 8
      unpack_byte<2>(wb, a[1][0], a[1][2]);    // column col + 2: m-tile 1, row g
      unpack_byte<3>(wb, a[1][1], a[1][3]);    // column col + 3: m-tile 1, row g + 8
#pragma unroll
      for (int j = 0; j < C::kNT; ++j) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            xbi + (8 * j + g) * kXbStride + 2 * (16 * s + 4 * t));
        mma_bf16(acc[0][j], a[0], b.x, b.y);
        mma_bf16(acc[1][j], a[1], b.x, b.y);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: accumulators to shared memory as red[pair][column], then each
  // output is (lo + mid) + hi of its row (its one part for bf16 x).
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j) {
      const int p = 8 * j + 2 * t;
      const int c = col + 2 * mt;
      red[p * kRedStride + c] = acc[mt][j][0];
      red[(p + 1) * kRedStride + c] = acc[mt][j][1];
      red[p * kRedStride + c + 1] = acc[mt][j][2];
      red[(p + 1) * kRedStride + c + 1] = acc[mt][j][3];
    }
  __syncthreads();
  const float scale = ws == nullptr ? *wq : 1.f;
  for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
    const int m = i / kBN;
    const int c = i % kBN;
    const int gm = m0 + m;
    const int gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float y = pair_sum<C::kParts>(red, kRedStride, BM, m, c);
    if (ws == nullptr)
      store_out(out, (size_t)gm * N + gn, y * scale);
    else
      ws[((size_t)blockIdx.z * M + gm) * N + gn] = y;
  }
}

// ---------------------------------------------------------------------------
// The warpgroup kernel, for M > 16: wgmma.m64n96k16, A (the weights) from
// registers, B (the 96 (part, row) pairs of 32 rows of x) from shared memory. The same exact split, K
// permutation, unpack and split-K as above; each of its two warpgroups owns
// 64 output columns, and one instruction does a whole 64 x pairs x 16 step,
// so no B fragment passes through registers.

constexpr int kGBM = 32;                       // rows of x per block
constexpr int kGThreads = 256;                 // two warpgroups
constexpr int kGStages = 3;
constexpr int kGWStride = kBN + 32;
constexpr int kGRedStride = kBN + 4;

template <typename XT>
struct G {
  static constexpr int kParts = XType<XT>::kParts;
  static constexpr int kPairs = kParts * kGBM;           // 96 or 32: the instruction's N
  static constexpr int kStageBytes = kKC4 * kGWStride + kGBM * kKC * (int)sizeof(XT);
  // B of one k16 step in the no-swizzle core-matrix layout: two k-halves of
  // kPairs / 8 core matrices (8 pairs x 8 k-slots, 128 contiguous bytes
  // each); the 16 spare bytes per step spread the split's stores over all
  // 32 banks.
  static constexpr int kCoreK = (kPairs / 8) * 128;      // leading (K) byte offset
  static constexpr int kStep = 2 * kCoreK + 16;
  static constexpr int kXbBytes = kSteps * kStep;
  static constexpr int kMain = kGStages * kStageBytes + 2 * kXbBytes;
  static constexpr int kRed = kPairs * kGRedStride * 4;
  static constexpr int kSmem = kMain > kRed ? kMain : kRed;
};

template <int kCoreK>
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr >> 4) & 0x3FFF) | ((uint64_t)(kCoreK >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);       // no swizzle; N-adjacent core matrices 128 B apart
}

__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_step(float (&d)[48], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_m64n96k16(d, a, desc);
}

// The staged x of one stage into its bf16 parts in the core-matrix layout,
// with K permuted as the A fragments need: in step s, k-slots (2t, 2t+1) of
// the first half and of the second half hold logical k 16s + 4t + (0, 1)
// and + (2, 3).
template <typename XT>
__device__ __forceinline__ void split_stage_cm(const XT* xf, uint8_t* xb) {
  using C = G<XT>;
  for (int i = threadIdx.x; i < kGBM * kKC4; i += kGThreads) {
    const int m = i / kKC4;
    const int r = i % kKC4;
    uint2 p[3];
    parts4(xf + m * kKC + 4 * r, p);
    uint8_t* dst = xb + (r >> 2) * C::kStep + 4 * (r & 3);
#pragma unroll
    for (int part = 0; part < C::kParts; ++part) {
      const int pair = part * kGBM + m;
      uint8_t* row = dst + (pair >> 3) * 128 + (pair & 7) * 16;
      *reinterpret_cast<uint32_t*>(row) = p[part].x;
      *reinterpret_cast<uint32_t*>(row + C::kCoreK) = p[part].y;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
}

template <int WV, typename XT>
__global__ void __launch_bounds__(kGThreads, 2)
ternary_matmul_wgmma_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                            const float* __restrict__ wq, XT* __restrict__ out,
                            float* __restrict__ ws, int M, int K4, int N, int k4_per_split) {
  using C = G<XT>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xb = smem + kGStages * C::kStageBytes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kGBM;
  const int k4_lo = blockIdx.z * k4_per_split;
  const int k4_hi = min(K4, k4_lo + k4_per_split);
  const int n_chunks = (k4_hi - k4_lo + kKC4 - 1) / kKC4;
  // A row g of this warp's 16 is column cb + 2g, row g + 8 is column cb + 2g + 1
  const int cb = 64 * (warp >> 2) + 16 * (warp & 3);

  auto stage_w = [&](int s) { return smem + s * C::kStageBytes; };
  auto stage_x = [&](int s) {
    return reinterpret_cast<XT*>(smem + s * C::kStageBytes + kKC4 * kGWStride);
  };

  float d[C::kPairs / 2];
#pragma unroll
  for (int e = 0; e < C::kPairs / 2; ++e) d[e] = 0.f;

#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < n_chunks)
      load_stage<kGBM, kBN, kGThreads, WV, XT>(stage_w(s), stage_x(s), x, w, M, K4, N, m0, n0,
                                                k4_lo + s * kKC4, k4_hi);
    cp_async_commit();
  }
  cp_async_wait<kGStages - 2>();
  __syncthreads();
  if (n_chunks > 0) split_stage_cm<XT>(stage_x(0), xb);
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<kGStages - 3>();             // stage i + 1 landed
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");   // stage i - 1 done
    __syncthreads();
    {
      const int next = i + kGStages - 1;
      if (next < n_chunks)
        load_stage<kGBM, kBN, kGThreads, WV, XT>(stage_w(next % kGStages),
                                                  stage_x(next % kGStages), x, w, M, K4, N,
                                                  m0, n0, k4_lo + next * kKC4, k4_hi);
      cp_async_commit();
    }
    const uint8_t* wsm = stage_w(i % kGStages) + cb + 2 * g;
    uint32_t a[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const uint32_t wb = *reinterpret_cast<const uint16_t*>(wsm + (4 * s + t) * kGWStride);
      unpack_byte<0>(wb, a[s][0], a[s][2]);
      unpack_byte<1>(wb, a[s][1], a[s][3]);
    }
    const uint8_t* xbi = xb + (i & 1) * C::kXbBytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      wgmma_step(d, a[s], gmma_desc<C::kCoreK>(xbi + s * C::kStep));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (i + 1 < n_chunks)
      split_stage_cm<XT>(stage_x((i + 1) % kGStages), xb + ((i + 1) & 1) * C::kXbBytes);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  cp_async_wait<0>();
  __syncthreads();

  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int c = 0; c < C::kPairs / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(8 * c + 2 * t + (e & 1)) * kGRedStride + cb + 2 * g + (e >> 1)] = d[4 * c + e];
  __syncthreads();
  const float scale = ws == nullptr ? *wq : 1.f;
  for (int i = threadIdx.x; i < kGBM * kBN; i += kGThreads) {
    const int m = i / kBN;
    const int c = i % kBN;
    const int gm = m0 + m;
    const int gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float y = pair_sum<C::kParts>(red, kGRedStride, kGBM, m, c);
    if (ws == nullptr)
      store_out(out, (size_t)gm * N + gn, y * scale);
    else
      ws[((size_t)blockIdx.z * M + gm) * N + gn] = y;
  }
}

template <typename XT>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ wq,
                                     XT* __restrict__ out, int split,
                                     size_t mn) {
  const float scale = *wq;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < split; ++z) s += ws[(size_t)z * mn + i];
    store_out(out, i, s * scale);
  }
}

constexpr int kMaxDevices = 64;

// Raises kernel's dynamic shared-memory limit to smem on the current device,
// once per device (the attribute belongs to the device's context): ready
// holds one flag per device for this kernel. Two threads may both set it;
// the value is the same.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int smem, std::atomic<bool>* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) ready[dev].store(true, std::memory_order_release);
  return err;
}

template <int BM, int WV, typename XT>
cudaError_t launch(const XT* x, const uint8_t* w, const float* wq, XT* out,
                   float* ws, int M, int K4, int N, int split, cudaStream_t stream) {
  using C = Cfg<BM, XT>;
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = raise_smem_limit(ternary_matmul_kernel<BM, WV, XT>, C::kSmem, ready);
  if (err != cudaSuccess) return err;
  const int k4_per_split = (K4 + split - 1) / split;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, split);
  ternary_matmul_kernel<BM, WV, XT><<<grid, C::kThreads, C::kSmem, stream>>>(
      x, w, wq, out, split > 1 ? ws : nullptr, M, K4, N, k4_per_split);
  return cudaGetLastError();
}

template <int WV, typename XT>
cudaError_t launch_wgmma(const XT* x, const uint8_t* w, const float* wq, XT* out,
                         float* ws, int M, int K4, int N, int split, cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err =
      raise_smem_limit(ternary_matmul_wgmma_kernel<WV, XT>, G<XT>::kSmem, ready);
  if (err != cudaSuccess) return err;
  const int k4_per_split = (K4 + split - 1) / split;
  const dim3 grid((N + kBN - 1) / kBN, (M + kGBM - 1) / kGBM, split);
  ternary_matmul_wgmma_kernel<WV, XT><<<grid, kGThreads, G<XT>::kSmem, stream>>>(
      x, w, wq, out, split > 1 ? ws : nullptr, M, K4, N, k4_per_split);
  return cudaGetLastError();
}

template <int BM, typename XT>
cudaError_t launch_wv(const XT* x, const uint8_t* w, const float* wq, XT* out,
                      float* ws, int M, int K4, int N, int split, int wvec,
                      cudaStream_t stream) {
  if (wvec == 16) return launch<BM, 16, XT>(x, w, wq, out, ws, M, K4, N, split, stream);
  if (wvec == 4) return launch<BM, 4, XT>(x, w, wq, out, ws, M, K4, N, split, stream);
  return launch<BM, 1, XT>(x, w, wq, out, ws, M, K4, N, split, stream);
}

template <typename XT>
int run(const XT* x, const uint8_t* w, const float* wq, XT* out, float* ws, int M, int K4,
        int N, int bm, int split, int wvec, cudaStream_t s) {
  cudaError_t err;
  if (bm == 32)
    err = wvec == 16 ? launch_wgmma<16, XT>(x, w, wq, out, ws, M, K4, N, split, s)
          : wvec == 4 ? launch_wgmma<4, XT>(x, w, wq, out, ws, M, K4, N, split, s)
                      : launch_wgmma<1, XT>(x, w, wq, out, ws, M, K4, N, split, s);
  else if (bm == 16)
    err = launch_wv<16, XT>(x, w, wq, out, ws, M, K4, N, split, wvec, s);
  else
    err = launch_wv<4, XT>(x, w, wq, out, ws, M, K4, N, split, wvec, s);
  if (err != cudaSuccess || split == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_reduce_kernel<XT><<<blocks, 256, 0, s>>>(ws, wq, out, split, mn);
  return (int)cudaGetLastError();
}

}  // namespace

// bm selects the row tile of x: 4 or 16 on the mma.sync kernel, 32 on the
// warpgroup kernel; wvec the packed copy width (16 or 4 bytes, or 1 for a
// ragged N). With split > 1, ws holds split * M * N floats of partial sums.
extern "C" int ternary_matmul_f32(const float* x, const uint8_t* w,
                                  const float* wq, float* out, float* ws, int M,
                                  int K4, int N, int bm, int split, int wvec,
                                  void* stream) {
  return run<float>(x, w, wq, out, ws, M, K4, N, bm, split, wvec, (cudaStream_t)stream);
}
