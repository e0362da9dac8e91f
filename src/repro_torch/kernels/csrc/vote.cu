// Packed vote counts: the weighted -1 and +1 vote masses of C clients' 2-bit
// wire codes, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/vote.py::_vote_kernel (launched by
// packed_vote_counts). For a stacked (C, nbytes) uint8 tensor of wire-packed
// codes and a (C,) fp32 vector of client weights it computes, per element
// e = 4m + j (wire byte m holds flat elements 4m..4m+3),
//
//   out[0, e] = sum_{c = 0..C-1} w[c] * [code_c(e) == 0]     (-1 mass)
//   out[1, e] = sum_{c = 0..C-1} w[c] * [code_c(e) == 2]     (+1 mass)
//
// as two planes in logical element order. The TPU kernel wrote the bit-planes
// interleaved by rows and undid that with a transpose after the call; here
// each thread writes its elements in place. Code 3 counts toward neither
// mass, so it falls in the zero mass (total - minus - plus) of the caller.
//
// Order: every element sums c = 0, 1, ..., C-1 starting from +0.0f, as the
// Pallas kernel's fori_loop does. Each term w * indicator is exact, so a
// fused multiply-add rounds exactly as the Pallas kernel's multiply and add
// do (a zero indicator adds w * 0 = +0.0 for w >= 0, and NaN for a
// non-finite w, in both), and the result is bit-identical to the plain
// PyTorch version and to the Pallas kernel.
//
// Bound: bytes. Each client byte is read once (C * nbytes) and each fp32
// output written once (2 planes * 16 * nbytes). One thread takes 4
// consecutive bytes of every client (one 32-bit load each, so a warp reads 128
// contiguous bytes per client) and keeps 16 minus and 16 plus accumulators in
// registers; it writes each plane's 16 outputs as four float4 stores. The
// weights sit in shared memory, read by every thread of a block at one address.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vote_kernel(const uint32_t* __restrict__ stacked, long long n_quads,
            const float* __restrict__ coeffs, int n_clients,
            float4* __restrict__ minus_out, float4* __restrict__ plus_out) {
  extern __shared__ float s_coeff[];
  for (int c = threadIdx.x; c < n_clients; c += kThreads) s_coeff[c] = coeffs[c];
  __syncthreads();

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < n_quads;
       q += stride) {
    float minus[16], plus[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      minus[k] = 0.0f;
      plus[k] = 0.0f;
    }
    for (int c = 0; c < n_clients; ++c) {
      const uint32_t word = __ldg(stacked + (long long)c * n_quads + q);
      const float w = s_coeff[c];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        // byte k / 4 of the word, code k % 4 of that byte: element 4 * byte + code
        const uint32_t code = (word >> (2 * k)) & 3u;
        minus[k] = fmaf(w, code == 0u ? 1.0f : 0.0f, minus[k]);
        plus[k] = fmaf(w, code == 2u ? 1.0f : 0.0f, plus[k]);
      }
    }
    float4* dm = minus_out + 4 * q;
    float4* dp = plus_out + 4 * q;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      dm[v] = make_float4(minus[4 * v], minus[4 * v + 1], minus[4 * v + 2], minus[4 * v + 3]);
      dp[v] = make_float4(plus[4 * v], plus[4 * v + 1], plus[4 * v + 2], plus[4 * v + 3]);
    }
  }
}

}  // namespace

// stacked: (n_clients, 4 * n_quads) bytes, 4-byte aligned rows; out: two planes
// of 16 * n_quads floats each, 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int vote_counts_f32(const void* stacked, long long n_quads, const float* coeffs,
                               int n_clients, float* out, int n_blocks, void* stream) {
  float4* minus_out = reinterpret_cast<float4*>(out);
  vote_kernel<<<(unsigned)n_blocks, kThreads, (size_t)n_clients * sizeof(float),
                (cudaStream_t)stream>>>(
      reinterpret_cast<const uint32_t*>(stacked), n_quads, coeffs, n_clients, minus_out,
      minus_out + 4 * n_quads);
  return (int)cudaGetLastError();
}
