// Ternary-weight matmul for bf16 x on Hopper (sm_90a): the bf16 entry of
// kernels/ternary_matmul.py.
//
// Replaces the TPU kernel src/repro/kernels/ternary_matmul.py::_kernel
// (launched by ternary_matmul) for bf16 activations. Computes
//
//   out = bf16((x @ (code(W) - 1)) * w_q)        x (M, K) bf16, out (M, N) bf16
//
// where W is (K/4, N) uint8 and byte W[r, n] holds the codes of rows
// 4r..4r+3 of column n (2 bits each, little-endian). The weights -1, 0, +1
// are exact in bf16, so every product of x with a weight is exact; the
// products are summed in fp32, the finished sum is multiplied by w_q (a
// device scalar) in fp32 and rounded to bf16 to nearest even, as the
// reference's (acc * w_q).astype(x.dtype).
//
// Bound: bytes at decode, operations at prefill. One decode step of
// olmo-1b (M = 4, 112 calls) reads 2^28 packed bytes (80 us at 3.35 TB/s);
// one prefill forward (M = 128) does 2MKN = 275 GFLOP (0.28 ms at
// 989 TFLOP/s of bf16) against 0.27 GB.
//
// Two kernels, one launch a call, no workspace:
//
// - Decode (M <= 16, and any shape whose rows of x are not 16-byte
//   multiples): mma.sync.m16n8k16 with A and B swapped, so the weights are
//   the A operand from registers and the output is computed transposed. A
//   block owns 64 output columns and 8 or 16 rows of x; its 8 warps are K
//   slots (warp q takes the 64-K stages q, q + 8, ... of the block's K
//   range). Each warp streams its own stages through a ring of its own with
//   cp.async and waits on its own copy groups (cp.async.wait_group and
//   __syncwarp): no warp waits on another until the epilogue, and at
//   olmo-1b's shapes every read is in flight from the start. K inside each
//   16-deep step is permuted so the four k-slots a thread holds for one A
//   row (2t, 2t+1, 2t+8, 2t+9) are the four codes of one packed byte; B is
//   then four consecutive k of x, one 8-byte load. The 8 warps' partial
//   sums are added in warp order through shared memory.
//
// - Prefill (M > 16, K a multiple of 8): wgmma.m64nBMk16 with the weights
//   as A from registers and BM = 64, 128 or 256 rows of x as B from shared
//   memory. A block owns 128 output columns: two consumer warpgroups of 64
//   and one producer warp. The producer loads the packed weights by
//   cp.async and x by TMA (cp.async.bulk.tensor, a 64-K by BM-row box in
//   the 128-byte swizzle that the B descriptor reads; rows past M and K past
//   the end come zero-filled from the TMA unit, so a ragged M needs no
//   padding copy), into a ring of stages guarded by full and empty
//   mbarriers. Each unpacked weight byte serves all BM rows of the tile,
//   where the fp32 design spread it over 32. x keeps its natural K order in
//   shared memory, so the K permutation moves into the unpack: a thread's
//   slots (2t, 2t+1) and (2t+8, 2t+9) of step s are the two codes at nibble
//   t & 1 of packed rows 4s + t/2 and 4s + t/2 + 2; it reads the byte pairs
//   of its two columns in both rows, shifts once and decodes four
//   registers. The warpgroups take turns at the tensor cores (named
//   barriers): one unpacks two stages while the other's wgmmas run, and no
//   A register is written while a wgmma that reads it is in flight.
//
// - Unpack: a byte becomes two bf16x2 registers of c - 1 with a PRMT, a LOP3
//   and one bf16x2 FMA each, with no conversion: (0x4300 | c) is the bf16
//   128 + c, and FMA(v, 1, -129) leaves c - 1 (the high half keeps its code
//   at bits 2-3, 128 + 4c, and takes (0.25, -33)).
//
// - K split inside the launch. When the output tiles alone are too few to
//   fill the 132 SMs, K is split across the blocks of a thread-block
//   cluster (grid z; 8 at most at decode, 4 at prefill, whose block has an
//   SM to itself). Block r of the cluster owns an r-th of the tile's
//   columns; every block stores its fp32 sums for them straight into the
//   owner's shared memory (st.shared::cluster, a slot per split: a store
//   needs no answer, where a remote read waits for one), and after one
//   cluster barrier each block adds its columns over the slots in split
//   order, scales, rounds and stores them. The order is fixed, so results
//   are the same from call to call, and nothing goes through device memory
//   but x, W and out.
//
// - Programmatic dependent launch: a kernel lets the next one on the stream
//   start at once (griddepcontrol.launch_dependents) and streams its
//   weights, which no kernel of the stream writes while they are in use,
//   before it waits for the kernels ahead (griddepcontrol.wait); it reads x
//   and writes out only after. Back-to-back matmuls overlap one's launch,
//   set-up and first weight reads with the other's tail.
//
// - Where the time goes (PERF.md; chip_smoke.py traces each call): a
//   decode call takes several times its bytes bound, in latency (the first
//   bytes from HBM, the cluster barrier and gather) and in the issue of the
//   unpack and mma.sync; a prefill call is held by feeding the SM a 16 KB
//   tile of x from L2 each stage, which every column block repeats, by the
//   unpack on the consumer warps, and by the gather of 64 KB partial tiles
//   through distributed shared memory where K is split.
//
// Weights as A from registers and a transposed output, the byte unpack and
// the decode kernel's K permutation come from the fp32 design in
// ternary_matmul.cu; the fp32 entry keeps that file's kernels.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16_t = uint16_t;

constexpr int kMaxSplit = 8;           // K splits: the portable cluster size
constexpr int kMaxPreSplit = 4;        // the prefill kernel's: one block an SM, clusters of 4 co-reside

// ---------------------------------------------------------------------------
// PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Arrives on bar once every cp.async this thread issued before has landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared address `addr` of this block, in block `rank` of the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// Programmatic dependent launch: the next kernel on the stream may start
// now (it waits in turn before it reads what this one writes) ...
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ... and this one waits here for the kernels before it to finish: only
// the packed weights and w_q, which no kernel of the stream writes while
// they are in use, are read before it.
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Named barriers over the two consumer warpgroups (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Every block of the cluster has started (with cluster_wait_all, before any
// store into another block's shared memory).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_all() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The two codes at bits 0-3 of byte `sel` of `w` as one bf16x2 register of
// c - 1 (bits 0-1 in the low half, bits 2-3 in the high half). The byte is
// copied into both halves; each half keeps one code under the exponent of
// 128 (128 + c and 128 + 4c), and one FMA with (1, 1/4) and (-129, -33)
// gives c - 1 exactly.
template <int SEL>
__device__ __forceinline__ uint32_t decode2(uint32_t w) {
  constexpr uint32_t kMask = 0x000C0003u;
  constexpr uint32_t kBase = 0x43004300u;      // bf16 (128, 128)
  constexpr uint32_t kMul = 0x3E803F80u;       // bf16 (1, 0.25)
  constexpr uint32_t kAdd = 0xC204C301u;       // bf16 (-129, -33)
  const uint32_t dup = __byte_perm(w, 0u, 0x4040u | (SEL << 8) | SEL);
  return bf16x2_fma((dup & kMask) | kBase, kMul, kAdd);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four finished sums of row gm, columns gn .. gn + 3, scaled and rounded.
__device__ __forceinline__ void store4(bf16_t* __restrict__ out, int N, int gm, int gn, float4 s,
                                       float scale) {
  const uint32_t y01 = bf16x2(s.x * scale, s.y * scale);
  const uint32_t y23 = bf16x2(s.z * scale, s.w * scale);
  bf16_t* o = out + (size_t)gm * N + gn;
  if ((N & 3) == 0 && gn + 3 < N) {
    *reinterpret_cast<uint2*>(o) = make_uint2(y01, y23);
  } else {
    const bf16_t y[4] = {(bf16_t)(y01 & 0xFFFFu), (bf16_t)(y01 >> 16), (bf16_t)(y23 & 0xFFFFu),
                         (bf16_t)(y23 >> 16)};
    for (int e = 0; e < 4 && gn + e < N; ++e) o[e] = y[e];
  }
}


// ---------------------------------------------------------------------------
// Decode: mma.sync, 8 * NT rows of x and 64 output columns (4 m-tiles of
// 16) a block, 8 warps: warp q takes stages q, q + 8, ... of the block's K
// range. Each warp has a ring of its own: it copies its stage's packed rows
// and x with cp.async and waits for its own copies (cp.async.wait_group and
// __syncwarp), so no warp waits on another until the epilogue.

constexpr int kDecBN = 64;                        // output columns per decode block

template <int NT>
struct Dec {
  static constexpr int kWarps = 8;                // = K slots
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 8 * NT;            // rows of x per block
  static constexpr int kKC = 64;                  // K per stage
  static constexpr int kKC4 = kKC / 4;            // packed rows per stage
  static constexpr int kRing = NT == 1 ? 4 : 3;   // stages in flight per warp
  static constexpr int kWStride = kDecBN + 32;    // bytes per packed row: conflict-free 8-byte loads
  static constexpr int kXStride = 2 * kKC + 32;   // bytes per row of x: conflict-free B loads
  static constexpr int kWBytes = kKC4 * kWStride;
  static constexpr int kStageBytes = kWBytes + kRows * kXStride;
  static constexpr int kRingBytes = kWarps * kRing * kStageBytes;
  static constexpr int kRedStride = kDecBN + 4;   // floats per row of a slot's partial tile
  static constexpr int kRecvOff = kRingBytes;
  // the gather's receive buffer: one slot per split, largest at ks = 8 (the
  // slots' partials of the epilogue's first step go to the rings, free by then)
  static constexpr int kRecv = kMaxSplit * kRows * (kDecBN / kMaxSplit + 4) * 4;
  static constexpr int kSmem = kRecvOff + kRecv;
  static_assert(kWarps * kRows * kRedStride * 4 <= kRingBytes, "the partials fit the rings");
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n of this thread's copy groups are pending (n < 4).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// One stage by one warp: packed rows [k4, k4 + 16) of the block's 64
// columns (16-byte copies, or bytes for a ragged N), zero past N and past K.
template <int NT, int WV>
__device__ __forceinline__ void dec_issue_w(uint8_t* stage, const uint8_t* w, int K4, int N,
                                            int n0, int k4, int lane) {
  using C = Dec<NT>;
  if (WV == 16) {
#pragma unroll
    for (int i = lane; i < C::kKC4 * (kDecBN / 16); i += 32) {
      const int r = i / (kDecBN / 16);
      const int c = (i % (kDecBN / 16)) * 16;
      const bool valid = k4 + r < K4 && n0 + c < N;
      cp_async16(stage + r * C::kWStride + c, valid ? w + (size_t)(k4 + r) * N + n0 + c : w,
                 valid);
    }
  } else {
    for (int i = lane; i < C::kKC4 * kDecBN; i += 32) {
      const int r = i / kDecBN;
      const int c = i % kDecBN;
      stage[r * C::kWStride + c] =
          (k4 + r < K4 && n0 + c < N) ? w[(size_t)(k4 + r) * N + n0 + c] : 0;
    }
  }
}

// The matching K of the block's rows of x (8-byte copies), zero past M and
// past K; then the stage's copy group closes.
template <int NT>
__device__ __forceinline__ void dec_issue_x(uint8_t* stage, const bf16_t* x, int M, int K4,
                                            int m0, int k4, int lane) {
  using C = Dec<NT>;
  uint8_t* xs = stage + C::kWBytes;
#pragma unroll
  for (int i = lane; i < C::kRows * C::kKC4; i += 32) {
    const int m = i / C::kKC4;
    const int r = i % C::kKC4;                  // 4 values of x (8 bytes) per packed row
    const bool valid = m0 + m < M && k4 + r < K4;
    cp_async8(xs + m * C::kXStride + 8 * r,
              valid ? x + (size_t)(m0 + m) * K4 * 4 + (size_t)(k4 + r) * 4 : x, valid);
  }
  cp_async_commit();
}

template <int NT, int WV>
__global__ void __launch_bounds__(256)
decode_kernel(const bf16_t* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ wq, bf16_t* __restrict__ out, int M, int K4, int N,
              int k4_per_split) {
  using C = Dec<NT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kDecBN;
  const int m0 = blockIdx.y * C::kRows;
  const int k4_lo = blockIdx.z * k4_per_split;
  const int n_chunks = (min(K4, k4_lo + k4_per_split) - k4_lo + C::kKC4 - 1) / C::kKC4;
  const int mine = n_chunks > warp ? (n_chunks - warp + C::kWarps - 1) / C::kWarps : 0;
  launch_dependents();
  const float scale = *wq;
  const int ks = gridDim.z;
  if (ks > 1) cluster_arrive_relaxed();

  uint8_t* ring = smem + warp * C::kRing * C::kStageBytes;
  auto k4_of = [&](int i) { return k4_lo + (warp + C::kWarps * i) * C::kKC4; };
  // the weights of the first stages stream before the kernels ahead finish;
  // the first copy group holds them all
  for (int i = 0; i < mine && i < C::kRing; ++i)
    dec_issue_w<NT, WV>(ring + i * C::kStageBytes, w, K4, N, n0, k4_of(i), lane);
  wait_prerequisites();
  for (int i = 0; i < mine && i < C::kRing; ++i)
    dec_issue_x<NT>(ring + i * C::kStageBytes, x, M, K4, m0, k4_of(i), lane);

  // m-tile mt: A row g is column 8g + 2mt, row g + 8 column 8g + 2mt + 1
  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait_upto(min(mine, i + C::kRing) - i - 1);
    __syncwarp();
    const uint8_t* ws = ring + (i % C::kRing) * C::kStageBytes;
    const uint8_t* xs = ws + C::kWBytes;
#pragma unroll
    for (int s = 0; s < C::kKC / 16; ++s) {
      // 8 bytes: packed row 4s + t, columns 8g .. 8g + 7
      const uint2 wv = *reinterpret_cast<const uint2*>(ws + (4 * s + t) * C::kWStride + 8 * g);
      uint2 b[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        b[j] = *reinterpret_cast<const uint2*>(xs + (8 * j + g) * C::kXStride +
                                               2 * (16 * s + 4 * t));
      const uint32_t word[2] = {wv.x, wv.y};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t wb = word[q];
        const uint32_t hi = wb >> 4;
        const uint32_t a0[4] = {decode2<0>(wb), decode2<1>(wb), decode2<0>(hi), decode2<1>(hi)};
        const uint32_t a1[4] = {decode2<2>(wb), decode2<3>(wb), decode2<2>(hi), decode2<3>(hi)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_bf16(acc[2 * q][j], a0, b[j].x, b[j].y);
          mma_bf16(acc[2 * q + 1][j], a1, b[j].x, b[j].y);
        }
      }
    }
    __syncwarp();                               // every lane is past this slot
    if (i + C::kRing < mine) {
      uint8_t* stage = ring + (i % C::kRing) * C::kStageBytes;
      dec_issue_w<NT, WV>(stage, w, K4, N, n0, k4_of(i + C::kRing), lane);
      dec_issue_x<NT>(stage, x, M, K4, m0, k4_of(i + C::kRing), lane);
    }
  }
  // Epilogue. The warps' partials go to the rings, and each thread adds
  // four columns of a row over the warps in order; with K split, the sums
  // go to the owning block of the cluster, which adds them over the splits.
  const int valid = min(C::kRows, M - m0);
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();                              // the rings are free
  {
    float* mine_red = red + warp * C::kRows * C::kRedStride;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = 8 * j + 2 * t;
        const int c = 8 * g + 2 * mt;
        if (r < valid)
          *reinterpret_cast<float2*>(mine_red + r * C::kRedStride + c) =
              make_float2(acc[mt][j][0], acc[mt][j][2]);
        if (r + 1 < valid)
          *reinterpret_cast<float2*>(mine_red + (r + 1) * C::kRedStride + c) =
              make_float2(acc[mt][j][1], acc[mt][j][3]);
      }
  }
  __syncthreads();
  const int cpo = kDecBN / ks;
  const int stride = cpo + 4;
  float* recv = reinterpret_cast<float*>(smem + C::kRecvOff);
  if (ks > 1) cluster_wait_all();
  for (int f = threadIdx.x; f < valid * (kDecBN / 4); f += C::kThreads) {
    const int r = f / (kDecBN / 4);
    const int c = (f % (kDecBN / 4)) * 4;
    const float* p = red + r * C::kRedStride + c;
    float4 s = *reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int q = 1; q < C::kWarps; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(p + q * C::kRows * C::kRedStride);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    if (ks == 1) {
      store4(out, N, m0 + r, n0 + c, s, scale);
    } else {
      const uint32_t a = smem_addr(recv + (blockIdx.z * C::kRows + r) * stride + c % cpo);
      st_cluster4(mapa(a, c / cpo), s);
    }
  }
  if (ks == 1) return;
  cluster_sync();
  // this block's columns, over the splits in order
  const int rank = cluster_rank();
  for (int f = threadIdx.x; f < valid * (cpo / 4); f += C::kThreads) {
    const int r = f / (cpo / 4);
    const int c = (f % (cpo / 4)) * 4;
    const float* p = recv + r * stride + c;
    float4 s = *reinterpret_cast<const float4*>(p);
    for (int q = 1; q < ks; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(p + q * C::kRows * stride);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    store4(out, N, m0 + r, n0 + rank * cpo + c, s, scale);
  }
}

// ---------------------------------------------------------------------------
// Prefill: wgmma.m64nBMk16, A (64 output columns of a warpgroup) from
// registers, B (BM rows of x) from the TMA's 128-byte swizzled tile.

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_step(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_n64(d, a, desc);
}
__device__ __forceinline__ void wgmma_step(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_n128(d, a, desc);
}
__device__ __forceinline__ void wgmma_step(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_n256(d, a, desc);
}

// B descriptor of a K-major tile in the 128-byte swizzle: rows of 128 bytes
// (64 K), 8-row groups 1024 bytes apart; a k16 step starts 32 bytes on.
__device__ __forceinline__ uint64_t swizzle128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

constexpr int kPreBN = 128;                       // output columns per prefill block

template <int BM>
struct Pre {
  static constexpr int kConsumers = 256;          // two warpgroups of 64 output columns
  static constexpr int kThreads = kConsumers + 32;  // and the producer warp
  static constexpr int kKC = 64;                  // K per stage: one swizzled row of x
  static constexpr int kKC4 = kKC / 4;
  static constexpr int kStages = BM == 256 ? 4 : 8;
  static constexpr int kBatch = 2;                // stages a warpgroup takes in a turn
  static constexpr int kXBytes = BM * 128;        // a multiple of 1024: swizzle atoms stay aligned
  static constexpr int kWStride = kPreBN + 16;    // conflict-free unpack loads
  static constexpr int kWBytes = kKC4 * kWStride;
  static constexpr int kWOff = kStages * kXBytes;
  static constexpr int kRing = kWOff + kStages * kWBytes;
  static constexpr int kBarOff = kRing;
  static constexpr int kRecvOff = kBarOff + 16 * kStages;
  // the gather's receive buffer, ks slots, largest at ks = 4; BM = 256 runs
  // unsplit only
  static constexpr int kRecv =
      BM == 256 ? 0 : kMaxPreSplit * BM * (kPreBN / kMaxPreSplit + 4) * 4;
  static constexpr int kSmem = kRecvOff + kRecv + 1024;   // + room to align to 1024
  static constexpr int kFullCount = 2 * 32 + 1;   // the producer's lanes twice, the TMA's arrive
};

// Pins the accumulators in their registers across the wgmma pipeline, so
// the compiler moves no read of them inside it.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// One batch of consumer warpgroup wg: NB stages from stage c on. Wait for
// them and unpack its 64 columns of their weights into registers (4 k16
// steps a stage); then, in turn with the other warpgroup (named barriers
// 1 + wg), issue the wgmmas, let the other issue its own, and wait for
// this batch. So one warpgroup unpacks while the other's wgmmas run, and no
// A register is written while a wgmma that reads one is in flight. Then
// hand the stages back to the producer. wcol points at this thread's two
// columns in packed row t / 2 of stage 0.
template <int BM, int NB>
__device__ __forceinline__ void pre_batch(int c, float (&d)[BM / 2], uint8_t* smem,
                                          const uint8_t* wcol, uint64_t* full, uint64_t* empty,
                                          int shift, int lane, int wg) {
  using C = Pre<BM>;
  uint32_t a[4 * NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int slot = (c + b) % C::kStages;
    mbar_wait(&full[slot], ((c + b) / C::kStages) & 1);
    const uint8_t* ws = wcol + slot * C::kWBytes;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // bytes (row 4s + t/2: columns 2g, 2g + 1) and (row 4s + t/2 + 2: the same)
      const uint32_t lo = *reinterpret_cast<const uint16_t*>(ws + 4 * s * C::kWStride);
      const uint32_t hi = *reinterpret_cast<const uint16_t*>(ws + (4 * s + 2) * C::kWStride);
      const uint32_t v = (lo | (hi << 16)) >> shift;
      a[4 * b + s][0] = decode2<0>(v);
      a[4 * b + s][1] = decode2<1>(v);
      a[4 * b + s][2] = decode2<2>(v);
      a[4 * b + s][3] = decode2<3>(v);
    }
  }
  named_sync(1 + wg);                           // this warpgroup's turn at the tensor cores
  fence_operand(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const uint32_t xs = smem_addr(smem + ((c + b) % C::kStages) * C::kXBytes);
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_step(d, a[4 * b + s], swizzle128_desc(xs + 32 * s));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  named_arrive(2 - wg);                         // the other's turn
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operand(d);
  if (lane == 0)
#pragma unroll
    for (int b = 0; b < NB; ++b) mbar_arrive(&empty[(c + b) % C::kStages]);
}

// A block owns 128 output columns and BM rows of x; consumer warpgroup wg
// owns columns 64 wg .. 64 wg + 63 over the block's whole K range, and warp
// w of it A rows 16w + g and 16w + g + 8: columns 64 wg + 16w + 2g and
// 64 wg + 16w + 2g + 1.
template <int BM, int WV>
__global__ void __launch_bounds__(Pre<BM>::kThreads, 1)
prefill_kernel(const __grid_constant__ CUtensorMap xmap, const uint8_t* __restrict__ w,
               const float* __restrict__ wq, bf16_t* __restrict__ out, int M, int K4, int N,
               int k4_per_split) {
  using C = Pre<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kPreBN;
  const int m0 = blockIdx.y * BM;
  const int k4_lo = blockIdx.z * k4_per_split;
  const int k4_hi = min(K4, k4_lo + k4_per_split);
  const int n_chunks = (k4_hi - k4_lo + C::kKC4 - 1) / C::kKC4;
  launch_dependents();
  const float scale = *wq;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], C::kFullCount);
      mbar_init(&empty[s], C::kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int ks = gridDim.z;
  if (ks > 1) cluster_arrive_relaxed();

  float d[BM / 2];
#pragma unroll
  for (int e = 0; e < BM / 2; ++e) d[e] = 0.f;

  const int wg = warp >> 2;
  const int cb = 64 * wg + 16 * (warp & 3);     // this consumer warp's 16 columns
  if (warp == C::kConsumers / 32) {
    // The producer: the packed weights by cp.async, x by TMA. The weights
    // of the first stages stream before the kernels ahead finish.
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
    auto load_w = [&](int c) {
      const int slot = c % C::kStages;
      const int k4 = k4_lo + c * C::kKC4;
      uint8_t* ws = smem + C::kWOff + slot * C::kWBytes;
      if (WV == 16) {
        constexpr int kPerRow = kPreBN / 16;
        for (int i = lane; i < C::kKC4 * kPerRow; i += 32) {
          const int r = i / kPerRow;
          const int cc = (i % kPerRow) * 16;
          const bool valid = k4 + r < k4_hi && n0 + cc < N;
          cp_async16(ws + r * C::kWStride + cc, valid ? w + (size_t)(k4 + r) * N + n0 + cc : w,
                     valid);
        }
      } else {
        for (int i = lane; i < C::kKC4 * kPreBN; i += 32) {
          const int r = i / kPreBN;
          const int cc = i % kPreBN;
          ws[r * C::kWStride + cc] =
              (k4 + r < k4_hi && n0 + cc < N) ? w[(size_t)(k4 + r) * N + n0 + cc] : 0;
        }
      }
      mbar_arrive(&full[slot]);
      mbar_arrive_cp_async(&full[slot]);
    };
    for (int c = 0; c < n_chunks && c < C::kStages; ++c) load_w(c);
    wait_prerequisites();
    for (int c = 0; c < n_chunks; ++c) {
      const int slot = c % C::kStages;
      if (c >= C::kStages) {
        mbar_wait(&empty[slot], (c / C::kStages - 1) & 1);
        load_w(c);
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[slot], C::kXBytes);
        tma_load_2d(smem + slot * C::kXBytes, &xmap, 4 * (k4_lo + c * C::kKC4), m0, &full[slot]);
      }
    }
  } else {
    const int shift = 4 * (t & 1);
    const uint8_t* wcol = smem + C::kWOff + (t >> 1) * C::kWStride + cb + 2 * g;
    if (wg == 1) named_arrive(1);               // warpgroup 0 goes first
    constexpr int kNB = C::kBatch;
    int c = 0;
    for (; c + kNB <= n_chunks; c += kNB)
      pre_batch<BM, kNB>(c, d, smem, wcol, full, empty, shift, lane, wg);
    if (c < n_chunks) pre_batch<BM, 1>(c, d, smem, wcol, full, empty, shift, lane, wg);
    if (wg == 0) named_sync(1);                 // the turn warpgroup 1 handed on last
  }
  wait_prerequisites();                         // (the producer has: out may be written)
  const int valid = M - m0;
  if (ks == 1) {
    // one split: each consumer thread rounds and stores its own sums
    if (warp < C::kConsumers / 32) {
      const int gn = n0 + cb + 2 * g;
#pragma unroll
      for (int i = 0; i < BM / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * i + 2 * t + e;
          if (r >= valid) continue;
          const uint32_t y = bf16x2(d[4 * i + e] * scale, d[4 * i + e + 2] * scale);
          bf16_t* o = out + (size_t)(m0 + r) * N + gn;
          if ((N & 1) == 0 && gn + 1 < N) {
            *reinterpret_cast<uint32_t*>(o) = y;
          } else if (gn < N) {
            o[0] = (bf16_t)(y & 0xFFFFu);
            if (gn + 1 < N) o[1] = (bf16_t)(y >> 16);
          }
        }
    }
    return;
  }
  // K split: the gather. Block r of the cluster owns columns [r * cpo,
  // (r + 1) * cpo); each consumer thread stores its sums into slot q (this
  // block's split) of their owner's receive buffer (distributed shared
  // memory), and after one cluster barrier each block adds its columns over
  // the slots in order, scales, rounds and stores them.
  const int cpo = kPreBN / ks;
  const int stride = cpo + 4;
  float* recv = reinterpret_cast<float*>(smem + C::kRecvOff);
  cluster_wait_all();
  if (warp < C::kConsumers / 32) {
    const uint32_t at = mapa(smem_addr(recv + cluster_rank() * BM * stride + cb % cpo), cb / cpo);
    // lanes g and g ^ 1 swap halves: the even one sends row 8i + 2t, columns
    // 2g .. 2g + 3, the odd one row 8i + 2t + 1, columns 2g - 2 .. 2g + 1
    const bool even = (g & 1) == 0;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const float o0 = __shfl_xor_sync(0xFFFFFFFFu, even ? d[4 * i + 1] : d[4 * i], 4);
      const float o2 = __shfl_xor_sync(0xFFFFFFFFu, even ? d[4 * i + 3] : d[4 * i + 2], 4);
      const int r = 8 * i + 2 * t + (even ? 0 : 1);
      if (r < valid)
        st_cluster4(at + 4u * (r * stride + (even ? 2 * g : 2 * g - 2)),
                    even ? make_float4(d[4 * i], d[4 * i + 2], o0, o2)
                         : make_float4(o0, o2, d[4 * i + 1], d[4 * i + 3]));
    }
  }
  cluster_sync();
  const int col0 = n0 + (int)cluster_rank() * cpo;
  const int c4 = cpo / 4;
  for (int f = threadIdx.x; f < min(BM, valid) * c4; f += C::kThreads) {
    const int r = f / c4;
    const int c = (f % c4) * 4;
    const float* p = recv + r * stride + c;
    float4 s = *reinterpret_cast<const float4*>(p);
    for (int q = 1; q < ks; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(p + q * BM * stride);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    store4(out, N, m0 + r, col0 + c, s, scale);
  }
}

// ---------------------------------------------------------------------------
// Host side.

constexpr int kMaxDevices = 64;

// Raises kernel's dynamic shared-memory limit to smem on the current device,
// once per device (the attribute belongs to the device's context).
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

// Launches kernel over grid with K split across the blocks of a cluster
// along z, free to start while the kernel before it on the stream finishes
// (programmatic dependent launch).
template <typename... Params, typename... Args>
cudaError_t launch_split(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// K per split: a whole number of 64-K stages, so a stage never spans two
// splits.
int k4_per_split(int K4, int split) { return ((K4 + split - 1) / split + 15) / 16 * 16; }

template <int NT, int WV>
cudaError_t launch_decode(const bf16_t* x, const uint8_t* w, const float* wq, bf16_t* out,
                          int M, int K4, int N, int split, cudaStream_t stream) {
  using C = Dec<NT>;
  static std::atomic<bool> ready[kMaxDevices];
  cudaError_t err = raise_smem_limit(decode_kernel<NT, WV>, C::kSmem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kDecBN - 1) / kDecBN, (M + C::kRows - 1) / C::kRows, split);
  return launch_split(decode_kernel<NT, WV>, grid, C::kThreads, C::kSmem, stream, x, w, wq,
                      out, M, K4, N, k4_per_split(K4, split));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no link to libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

template <int BM, int WV>
cudaError_t launch_prefill(const bf16_t* x, const uint8_t* w, const float* wq, bf16_t* out,
                           int M, int K4, int N, int split, cudaStream_t stream) {
  using C = Pre<BM>;
  static std::atomic<bool> ready[kMaxDevices];
  cudaError_t err = raise_smem_limit(prefill_kernel<BM, WV>, C::kSmem, ready);
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // x as a (M, K) bf16 tensor, boxes of 64 K by BM rows in the 128-byte swizzle
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)K4 * 4, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K4 * 8};
  const cuuint32_t box[2] = {(cuuint32_t)C::kKC, (cuuint32_t)BM};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16_t*>(x), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const dim3 grid((N + kPreBN - 1) / kPreBN, (M + BM - 1) / BM, split);
  return launch_split(prefill_kernel<BM, WV>, grid, C::kThreads, C::kSmem, stream, xmap, w, wq,
                      out, M, K4, N, k4_per_split(K4, split));
}

template <int WV>
cudaError_t run(const bf16_t* x, const uint8_t* w, const float* wq, bf16_t* out, int M, int K4,
                int N, int bm, int split, cudaStream_t s) {
  switch (bm) {
    case 8: return launch_decode<1, WV>(x, w, wq, out, M, K4, N, split, s);
    case 16: return launch_decode<2, WV>(x, w, wq, out, M, K4, N, split, s);
    case 64: return launch_prefill<64, WV>(x, w, wq, out, M, K4, N, split, s);
    case 128: return launch_prefill<128, WV>(x, w, wq, out, M, K4, N, split, s);
    case 256: return launch_prefill<256, WV>(x, w, wq, out, M, K4, N, split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bm selects the kernel and its rows of x: 8 or 16 on the mma.sync kernel,
// 64, 128 or 256 on the warpgroup kernel (which needs K a multiple of 8);
// split the K splits, the blocks of a cluster (1..8; on the warpgroup kernel
// each split but the last a multiple of 64 K); wvec the packed copy width
// (16 bytes, or 1 for a ragged N). x and out are raw bf16.
extern "C" int ternary_matmul_bf16(const uint16_t* x, const uint8_t* w, const float* wq,
                                   uint16_t* out, int M, int K4, int N, int bm, int split,
                                   int wvec, void* stream) {
  if (split < 1 || split > (bm < 64 ? kMaxSplit : kMaxPreSplit) || (bm == 256 && split > 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = wvec == 16 ? run<16>(x, w, wq, out, M, K4, N, bm, split, s)
                                     : run<1>(x, w, wq, out, M, K4, N, bm, split, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
