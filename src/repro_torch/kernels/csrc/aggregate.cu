// Packed fan-in: the server's weighted sum of C clients' 2-bit wire codes,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/aggregate.py::_fanin_kernel
// (launched by packed_weighted_sum). For a stacked (C, nbytes) uint8 tensor
// of wire-packed codes and a (C,) fp32 coefficient vector it computes
//
//   out[4m + j] = sum_{c = 0..C-1} coeff[c] * (((stacked[c, m] >> 2j) & 3) - 1)
//
// in logical element order: wire byte m holds flat elements 4m..4m+3. The TPU
// kernel wrote the four bit-planes interleaved by rows and undid that with a
// transpose after the call; here each thread writes its elements in place.
//
// Order: every output element sums c = 0, 1, ..., C-1 starting from +0.0f,
// as the Pallas kernel's fori_loop does. Each term coeff * u with
// u in {-1, 0, +1} is exact, so a fused multiply-add rounds exactly as a
// multiply then an add would, and the result is bit-identical to the plain
// PyTorch version and to the Pallas kernel.
//
// Bound: bytes. Each client byte is read once (C * nbytes) and each fp32
// output written once (16 * nbytes); the arithmetic is one FMA per client
// per element. One thread takes 4 consecutive bytes of every client (one
// 32-bit load each, so a warp reads 128 contiguous bytes per client) and
// writes its 16 outputs as four float4 stores. The coefficients sit in
// shared memory, read by every thread of the block at the same address.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const uint32_t* __restrict__ stacked, long long n_quads,
                 const float* __restrict__ coeffs, int n_clients,
                 float4* __restrict__ out) {
  extern __shared__ float s_coeff[];
  for (int c = threadIdx.x; c < n_clients; c += kThreads) s_coeff[c] = coeffs[c];
  __syncthreads();

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < n_quads;
       q += stride) {
    float acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
    for (int c = 0; c < n_clients; ++c) {
      const uint32_t word = __ldg(stacked + (long long)c * n_quads + q);
      const float w = s_coeff[c];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        // byte k / 4 of the word, code k % 4 of that byte: element 4 * byte + code
        const int code = (int)((word >> (2 * k)) & 3u);
        acc[k] = fmaf(w, (float)(code - 1), acc[k]);
      }
    }
    float4* dst = out + 4 * q;
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    dst[2] = make_float4(acc[8], acc[9], acc[10], acc[11]);
    dst[3] = make_float4(acc[12], acc[13], acc[14], acc[15]);
  }
}

}  // namespace

// stacked: (n_clients, 4 * n_quads) bytes, 4-byte aligned rows; out: 16 * n_quads
// floats, 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int aggregate_f32(const void* stacked, long long n_quads, const float* coeffs,
                             int n_clients, float* out, int n_blocks, void* stream) {
  aggregate_kernel<<<(unsigned)n_blocks, kThreads, (size_t)n_clients * sizeof(float),
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const uint32_t*>(stacked), n_quads, coeffs, n_clients,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
