// Packed vote counts: the weighted -1 and +1 vote masses of C clients' 2-bit
// wire codes over every scale segment of a flush in one launch, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/vote.py::_vote_kernel (launched by
// packed_vote_counts). For a staged (C, row_bytes) uint8 buffer that holds
// each client's wire bytes of every segment at the segment's byte offset, a
// (C,) fp32 vector of client weights and a segment table, it computes for
// every segment s and element e < n_out(s), with i = out_off(s) + e,
//
//   out[0, i] = sum_{c = 0..C-1} w[c] * [code_c,s(e) == 0]     (-1 mass)
//   out[1, i] = sum_{c = 0..C-1} w[c] * [code_c,s(e) == 2]     (+1 mass)
//
// as two planes in logical element order (byte m of a segment holds its
// elements 4m..4m+3). An element of a segment's last quad past n_out(s) is
// written as 0 in both planes. Code 3 counts toward neither mass, so it falls
// in the zero mass (total - minus - plus) of the caller.
//
// Order: every element sums c = 0, 1, ..., C-1 starting from +0.0f, as the
// Pallas kernel's fori_loop does. Each term w * indicator is exact, so a fused
// multiply-add rounds exactly as the Pallas kernel's multiply and add do (a
// zero indicator adds w * 0 = +0.0 for w >= 0, and NaN for a non-finite w, in
// both), and the result is bit-identical to the plain PyTorch version and to
// the Pallas kernel.
//
// Bound: bytes. Each staged client byte is read once (C * nbytes) and each fp32
// output written once (2 planes * 16 * nbytes). The design is aggregate.cu's:
// one launch per flush over a segment table that stays on the device (binary
// search over the first-block column), exact 4-byte aligned staging, one
// 32-bit load per client per thread, the weights in shared memory, and both
// planes written through a swizzled shared-memory transpose so that
// consecutive lanes store consecutive 16-byte chunks. Two planes make it
// bound by instruction issue as much as by bytes, so the arithmetic is cut
// to two instructions per mass: bit logic on the whole word gives each
// code's [c == 0] and [c == 2] bit, and with finite weights a set bit adds w
// (a predicated add) while a clear one adds nothing. The client loop is
// unrolled 16 deep at three blocks per SM (8 deep, and 16 deep at one or two
// blocks, measured slower at 16 x 2^26).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 16;      // clients loaded ahead of the adds
constexpr int kMinBlocks = 3;    // blocks per SM the registers must allow

struct Segment {
  long long byte_off;   // offset of its bytes in a staged client row (4-byte aligned)
  long long nbytes;     // packed bytes
  long long out_off;    // offset of its first output element (a multiple of 4)
  long long n_out;      // output elements (<= 4 * nbytes)
  long long block0;     // index of its first block
};

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

// The 0/1 indicator in byte k of m as a float, exactly.
__device__ __forceinline__ float indicator(uint32_t m, int k) {
  const uint32_t bits = __byte_perm(m, 0x4B400000u, 0x7640u + (uint32_t)k);
  return __int_as_float((int)bits) - 12582912.0f;
}

// One client's word into the masses. With finite weights a zero indicator
// adds w * 0 = +-0, which leaves a sum that started at +0 unchanged, so the
// add is skipped and a set indicator adds w: one predicated add per mass.
// A non-finite weight turns w * 0 into NaN, so that case keeps the FMA.
template <bool kFinite>
__device__ __forceinline__ void accumulate(uint32_t word, float w, float (&minus)[16],
                                           float (&plus)[16]) {
  if (kFinite) {
    const uint32_t hi = word >> 1;
    const uint32_t is0 = ~(word | hi) & 0x55555555u;   // bit 2e: code of element e is 0
    const uint32_t is2 = hi & ~word & 0x55555555u;     // bit 2e: code of element e is 2
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      // byte e / 4, code e % 4: element 4 * (e / 4) + e % 4 = e
      if (is0 & (1u << (2 * e))) minus[e] += w;
      if (is2 & (1u << (2 * e))) plus[e] += w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t m = (word >> (2 * j)) & 0x03030303u;    // codes of elements j + 4k
    const uint32_t hi = m >> 1;
    const uint32_t is0 = ~(m | hi) & 0x01010101u;
    const uint32_t is2 = hi & ~m & 0x01010101u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      minus[4 * k + j] = fmaf(w, indicator(is0, k), minus[4 * k + j]);
      plus[4 * k + j] = fmaf(w, indicator(is2, k), plus[4 * k + j]);
    }
  }
}

template <bool kFinite>
__device__ __forceinline__ void fold(const uint32_t* src, long long stride, const float* s_w,
                                     int n_clients, float (&minus)[16], float (&plus)[16]) {
  int c = 0;
  for (; c + kUnroll <= n_clients; c += kUnroll) {
    uint32_t words[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) words[u] = __ldg(src + (long long)(c + u) * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate<kFinite>(words[u], s_w[c + u], minus, plus);
  }
  for (; c < n_clients; ++c)
    accumulate<kFinite>(__ldg(src + (long long)c * stride), s_w[c], minus, plus);
}

// aggregate.cu's warp store: lane t writes float4s t, t + 32, t + 64, t + 96
// of the warp's span, nothing at or past slot_end, zeros at or past n_end.
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
    const int j = 32 * v + lane;
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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
vote_kernel(const Segment* __restrict__ table, int n_seg, const uint8_t* __restrict__ staged,
            long long row_bytes, const float* __restrict__ weights, int n_clients,
            float* __restrict__ out, long long n_total) {
  __shared__ float4 s_stage[kWarps][128];
  extern __shared__ float s_w[];
  const int s = find_segment(table, n_seg, blockIdx.x);
  const Segment seg = table[s];
  int finite = 1;
  for (int c = threadIdx.x; c < n_clients; c += kThreads) {
    s_w[c] = weights[c];
    finite &= isfinite(weights[c]);
  }
  finite = __syncthreads_and(finite);

  const int warp = threadIdx.x >> 5;
  const long long q0 = ((long long)blockIdx.x - seg.block0) * kThreads + warp * 32;
  const long long q = q0 + (threadIdx.x & 31);
  float minus[16], plus[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    minus[k] = 0.0f;
    plus[k] = 0.0f;
  }
  if (4 * q < seg.nbytes) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(staged + seg.byte_off) + q;
    if (finite)
      fold<true>(src, row_bytes / 4, s_w, n_clients, minus, plus);
    else
      fold<false>(src, row_bytes / 4, s_w, n_clients, minus, plus);
  }
  if (16 * q0 >= seg.n_out) return;
  const long long e0 = 16 * q0;
  const long long n_end = seg.n_out - e0;
  const long long slot_end = ((seg.n_out + 3) & ~3LL) - e0;
  store_warp(minus, s_stage[warp], out + seg.out_off + e0, n_end, slot_end);
  store_warp(plus, s_stage[warp], out + n_total + seg.out_off + e0, n_end, slot_end);
}

}  // namespace

// One launch over a segment table of n_seg rows in device memory. staged:
// (n_clients, row_bytes) bytes, row_bytes a multiple of 4; weights: (n_clients,)
// fp32; out: two planes of n_total floats each (n_total a multiple of 4),
// 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int vote_segments_f32(const void* table, int n_seg, long long n_blocks,
                                 const void* staged, long long row_bytes, const float* weights,
                                 int n_clients, float* out, long long n_total, void* stream) {
  vote_kernel<<<(unsigned)n_blocks, kThreads, (size_t)n_clients * sizeof(float),
                (cudaStream_t)stream>>>(
      reinterpret_cast<const Segment*>(table), n_seg, reinterpret_cast<const uint8_t*>(staged),
      row_bytes, weights, n_clients, out, n_total);
  return (int)cudaGetLastError();
}
