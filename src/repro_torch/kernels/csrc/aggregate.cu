// Packed fan-in: the server's weighted sum of C clients' 2-bit wire codes
// over every scale segment of a flush in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/aggregate.py::_fanin_kernel
// (launched by packed_weighted_sum). For a staged (C, row_bytes) uint8 buffer
// that holds each client's wire bytes of every segment at the segment's byte
// offset, a (C, S) fp32 coefficient matrix and a segment table, it computes
// for every segment s and every element e < n_out(s)
//
//   out[out_off(s) + e] = sum_{c = 0..C-1} coeff[c, s] * (code_c,s(e) - 1)
//
// in logical element order: byte m of a segment holds its elements 4m..4m+3.
// An element of a segment's last quad past n_out(s) is written as 0 (masked);
// the segments' output slots (n_out rounded up to 4) tile the output.
//
// Order: every output element sums c = 0, 1, ..., C-1 starting from +0.0f, as
// the Pallas kernel's fori_loop does. Each term coeff * u with u in
// {-1, 0, +1, +2} is exact, so a fused multiply-add rounds exactly as the
// Pallas kernel's multiply then add, and the result is bit-identical to the
// plain PyTorch version and to the Pallas kernel, subnormal coefficients and
// partial sums included (fma_ftz).
//
// Bound: bytes. Each staged client byte is read once (C * nbytes) and each
// fp32 output written once (16 * nbytes); the arithmetic is one FMA per client
// per element. What the design does about it:
//
// - One launch per flush. A segment table (byte offset in a staged row,
//   packed bytes, output offset, output elements, first block) gives each
//   block its segment by a binary search over the first-block column, as
//   quantize_pack.cu does; ResNet18*'s 52 segments of a round are one launch
//   of 148 blocks instead of 52 launches. The table depends only on the
//   model's leaf plan and stays on the device.
// - Exact staging. A segment's bytes start at a 4-byte aligned offset of the
//   row; the ragged tail of its last word is never used for an output that is
//   written, so nothing is padded to a tile.
// - Loads ahead of the arithmetic. One thread takes 4 consecutive bytes of
//   every client (one 32-bit load each; a warp reads 128 contiguous bytes per
//   client), and the client loop is unrolled 4 deep so that 4 loads are in
//   flight before the first FMA (8 and 16 deep measured slower at 16 x 2^26).
// - Decode without conversions. (word >> 2j) & 0x03030303 holds the codes of
//   elements j, 4+j, 8+j, 12+j, one per byte; a byte permute puts code c under
//   the exponent of 1.5 * 2^23, so one subtraction gives c - 1 exactly.
// - Coalesced stores. A warp's 512 outputs pass through shared memory
//   (XOR-swizzled, no bank conflicts) so that consecutive lanes write
//   consecutive 16-byte chunks.
// - The block's C coefficients of its segment sit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                  // clients loaded ahead of the FMAs

// One row of the segment table (int64 fields, as the wrapper writes them).
struct Segment {
  long long byte_off;   // offset of its bytes in a staged client row (4-byte aligned)
  long long nbytes;     // packed bytes
  long long out_off;    // offset of its first output element (a multiple of 4)
  long long n_out;      // output elements (<= 4 * nbytes)
  long long block0;     // index of its first block
};

// The segment that owns block b: the last row with block0 <= b.
__device__ __forceinline__ int find_segment(const Segment* table, int n_seg, long long b) {
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&table[mid].block0) <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// code - 1 of the code in byte k of m (bytes of m are codes 0..3), exactly.
__device__ __forceinline__ float code_minus_one(uint32_t m, int k) {
  // bytes: [0] = byte k of m, [1] = 0x00, [2] = 0x40, [3] = 0x4B -> 1.5 * 2^23 + code
  const uint32_t bits = __byte_perm(m, 0x4B400000u, 0x7640u + (uint32_t)k);
  return __int_as_float((int)bits) - 12582913.0f;
}

// acc + w * u under XLA's subnormal rule, which the Pallas kernel follows on
// the TPU and on the CPU: a subnormal coefficient or partial sum reads as a
// zero and a subnormal sum comes out as one (.ftz). With u exact in {-1, 0, 1,
// 2} the product is exact, so this is XLA's multiply then add; it is fmaf
// bit for bit wherever no operand or result is subnormal.
__device__ __forceinline__ float fma_ftz(float w, float u, float acc) {
  float d;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(w), "f"(u), "f"(acc));
  return d;
}

__device__ __forceinline__ void accumulate(uint32_t word, float w, float (&acc)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t m = (word >> (2 * j)) & 0x03030303u;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[4 * k + j] = fma_ftz(w, code_minus_one(m, k), acc[4 * k + j]);
  }
}

// Write a warp's 32 x 16 accumulators to out so that lane t stores float4s
// t, t + 32, t + 64, t + 96 of the warp's span; float4s at or past slot_end
// (elements, relative to the span) are not stored and elements at or past
// n_end are stored as 0.
__device__ __forceinline__ void store_warp(const float (&acc)[16], float4* stage, float* dst,
                                           long long n_end, long long slot_end) {
  const int lane = threadIdx.x & 31;
  const int sw = (lane >> 1) & 3;
#pragma unroll
  for (int v = 0; v < 4; ++v)
    stage[4 * lane + (v ^ sw)] =
        make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
  __syncwarp();
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int j = 32 * v + lane;           // float4 of the span
    const int owner = j >> 2;
    float4 f = stage[4 * owner + ((j & 3) ^ ((owner >> 1) & 3))];
    const long long e = 4LL * j;
    if (e >= slot_end) continue;
    if (e + 4 > n_end) {
      if (e + 0 >= n_end) f.x = 0.f;
      if (e + 1 >= n_end) f.y = 0.f;
      if (e + 2 >= n_end) f.z = 0.f;
      if (e + 3 >= n_end) f.w = 0.f;
    }
    reinterpret_cast<float4*>(dst)[j] = f;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const Segment* __restrict__ table, int n_seg,
                 const uint8_t* __restrict__ staged, long long row_bytes,
                 const float* __restrict__ coeffs, int n_clients, float* __restrict__ out) {
  __shared__ float4 s_stage[kWarps][128];
  extern __shared__ float s_coeff[];
  const int s = find_segment(table, n_seg, blockIdx.x);
  const Segment seg = table[s];
  for (int c = threadIdx.x; c < n_clients; c += kThreads)
    s_coeff[c] = coeffs[(long long)c * n_seg + s];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const long long q0 = ((long long)blockIdx.x - seg.block0) * kThreads + warp * 32;
  const long long q = q0 + (threadIdx.x & 31);   // this thread's word of the segment
  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
  if (4 * q < seg.nbytes) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(staged + seg.byte_off) + q;
    const long long stride = row_bytes / 4;
    int c = 0;
    for (; c + kUnroll <= n_clients; c += kUnroll) {
      uint32_t words[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) words[u] = __ldg(src + (long long)(c + u) * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate(words[u], s_coeff[c + u], acc);
    }
    for (; c < n_clients; ++c) accumulate(__ldg(src + (long long)c * stride), s_coeff[c], acc);
  }
  if (16 * q0 >= seg.n_out) return;                // the whole warp is past the segment
  const long long e0 = 16 * q0;                    // the warp span's first element
  store_warp(acc, s_stage[warp], out + seg.out_off + e0, seg.n_out - e0,
             ((seg.n_out + 3) & ~3LL) - e0);
}

}  // namespace

// One launch over a segment table of n_seg rows in device memory. staged:
// (n_clients, row_bytes) bytes, row_bytes a multiple of 4; coeffs: (n_clients,
// n_seg) fp32; out: 16-byte aligned, every segment's slot at its out_off.
// Returns the launch's cudaError_t.
extern "C" int aggregate_segments_f32(const void* table, int n_seg, long long n_blocks,
                                      const void* staged, long long row_bytes,
                                      const float* coeffs, int n_clients, float* out,
                                      void* stream) {
  aggregate_kernel<<<(unsigned)n_blocks, kThreads, (size_t)n_clients * sizeof(float),
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const Segment*>(table), n_seg, reinterpret_cast<const uint8_t*>(staged),
      row_bytes, coeffs, n_clients, out);
  return (int)cudaGetLastError();
}
