// The QAT backward's elementwise step for a (L, m) fp32 or bf16 weight, for
// Hopper (sm_90a).
//
// Not a port of a TPU kernel: the reference's straight-through backward
// (src/repro/core/fttq.py::_fttq_bwd) is elementwise arithmetic that XLA
// fuses, under XLA's subnormal rule. For a cotangent g, the forward's codes
// I_t (fp32: +-1, +-0, or NaN where theta_s was NaN) and per row a flushed
// w_q and the cut c of the product g * w_q (repro_torch.dtypes.keep_cut: the
// least |g| whose product XLA keeps, at least 2^-126), one read of g and I_t
// gives
//
//   sel      = I_t != 0                         (a NaN code counts)
//   g_theta  = (g * s) * [|g| >= t]             s = sel ? w_q : 1,
//                                               t = sel ? c : 2^-126
//   g_it     = g * I_t, with |g_it| <= the largest subnormal made +0
//
// g_theta is XLA's g * scale with a subnormal g read as zero and a product
// flushed unless its exact value is at least 2^-126 - 2^-151 (the window
// below 2^-126 that IEEE rounding takes up to 2^-126 is flushed too); a
// flushed product is a zero of its sign, NaN where the product is inf or NaN.
// g_it is the flushed terms of sum g * I_t, which the caller sums per row.
// The products are IEEE fp32 products (no .ftz): bit for bit the plain
// PyTorch version's.
//
// Bound: bytes. Two reads and two writes of 4 bytes per weight. A row runs
// over blockIdx.y (a grid-stride loop above 65,535 rows); within a row each
// thread takes 4 consecutive elements with 16-byte loads and stores where the
// row's length is a multiple of 4, else one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTiny = 0x1p-126f;                            // 2^-126
constexpr float kLargestSubnormal = 0x1.fffffcp-127f;        // 2^-126 - 2^-149

__device__ __forceinline__ void one(float g, float it, float w, float c, float* gt, float* gi) {
  const bool sel = it != 0.0f;
  const float p = __fmul_rn(g, sel ? w : 1.0f);
  *gt = fabsf(g) >= (sel ? c : kTiny) ? p : __fmul_rn(p, 0.0f);
  const float q = __fmul_rn(g, it);
  *gi = fabsf(q) <= kLargestSubnormal ? 0.0f : q;
}

__global__ void __launch_bounds__(kThreads)
qat_backward_kernel(const float* __restrict__ g, const float* __restrict__ it,
                    const float* __restrict__ w, const float* __restrict__ cut, long long rows,
                    long long m, int vec, float* __restrict__ g_theta,
                    float* __restrict__ g_it) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float wr = __ldg(w + r), cr = __ldg(cut + r);
    const long long base = r * m;
    const long long m4 = vec ? m / 4 : 0;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m4; i += stride) {
      const float4 gv = reinterpret_cast<const float4*>(g + base)[i];
      const float4 iv = reinterpret_cast<const float4*>(it + base)[i];
      float4 a, b;
      one(gv.x, iv.x, wr, cr, &a.x, &b.x);
      one(gv.y, iv.y, wr, cr, &a.y, &b.y);
      one(gv.z, iv.z, wr, cr, &a.z, &b.z);
      one(gv.w, iv.w, wr, cr, &a.w, &b.w);
      reinterpret_cast<float4*>(g_theta + base)[i] = a;
      reinterpret_cast<float4*>(g_it + base)[i] = b;
    }
    for (long long e = 4 * m4 + (long long)blockIdx.x * kThreads + threadIdx.x; e < m;
         e += stride) {
      one(g[base + e], it[base + e], wr, cr, g_theta + base + e, g_it + base + e);
    }
  }
}


// The bf16 entry (a bf16 weight, its bf16 w_q and cotangent): for each
// element, in fp32 from the bf16 bits,
//
//   g_it     = g * I_t, +0 where its magnitude is below 2^-126
//   g_theta  = bf16(flush(flush(g) * flush(s)))     s = I_t != 0 ? w_q : 1
//
// where flush(x) is x * [|x| >= 2^-126] (a zero of x's sign; NaN stays NaN):
// XLA's bf16 multiply (an exact fp32 product of two 8-bit significands,
// flushed, rounded once to bf16), and the flushed terms of sum g * I_t. The
// rounding is round-to-nearest-even, as PyTorch converts fp32 to bf16: bit
// for bit the plain version's (the bf16 branch of
// repro_torch.core.fttq.FTTQQuantize.backward), but for a NaN's bits, which
// PyTorch writes as 0x7FC0, 0x7FFF or 0xFFFF by path and device, and the
// kernel as 0x7FC0.
//
// Bound: bytes. Two reads and two writes of 2 bytes per weight; a row runs
// over blockIdx.y as above, each thread taking 8 consecutive elements with
// 16-byte loads and stores where the row's length is a multiple of 8.

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) >= kTiny ? x : __fmul_rn(x, 0.0f);
}

__device__ __forceinline__ uint16_t to_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  if (x != x) return 0x7FC0u;
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ float from_bf16(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

__device__ __forceinline__ void one_bf16(uint16_t gb, uint16_t ib, float s1, uint16_t* gt,
                                         uint16_t* gi) {
  const float g = from_bf16(gb), it = from_bf16(ib);
  const float q = __fmul_rn(g, it);
  *gi = fabsf(q) < kTiny ? (uint16_t)0 : to_bf16(q);
  const float s = it != 0.0f ? s1 : 1.0f;
  *gt = to_bf16(flush(__fmul_rn(flush(g), s)));
}

__global__ void __launch_bounds__(kThreads)
qat_backward_bf16_kernel(const uint16_t* __restrict__ g, const uint16_t* __restrict__ it,
                         const uint16_t* __restrict__ w, long long rows, long long m, int vec,
                         uint16_t* __restrict__ g_theta, uint16_t* __restrict__ g_it) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float wr = flush(from_bf16(__ldg(w + r)));
    const long long base = r * m;
    const long long m8 = vec ? m / 8 : 0;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m8; i += stride) {
      const uint4 gv = reinterpret_cast<const uint4*>(g + base)[i];
      const uint4 iv = reinterpret_cast<const uint4*>(it + base)[i];
      const uint16_t* ga = reinterpret_cast<const uint16_t*>(&gv);
      const uint16_t* ia = reinterpret_cast<const uint16_t*>(&iv);
      uint4 a, b;
      uint16_t* aa = reinterpret_cast<uint16_t*>(&a);
      uint16_t* ba = reinterpret_cast<uint16_t*>(&b);
#pragma unroll
      for (int k = 0; k < 8; ++k) one_bf16(ga[k], ia[k], wr, aa + k, ba + k);
      reinterpret_cast<uint4*>(g_theta + base)[i] = a;
      reinterpret_cast<uint4*>(g_it + base)[i] = b;
    }
    for (long long e = 8 * m8 + (long long)blockIdx.x * kThreads + threadIdx.x; e < m;
         e += stride) {
      one_bf16(g[base + e], it[base + e], wr, g_theta + base + e, g_it + base + e);
    }
  }
}

}  // namespace

// g, it, g_theta, g_it: rows x m fp32, contiguous; w, cut: rows fp32. vec = 1
// when m is a multiple of 4 and the four pointers are 16-byte aligned. The
// grid is (x_blocks, y_blocks). Returns the launch's cudaError_t.
extern "C" int qat_backward_apply(const float* g, const float* it, const float* w,
                                  const float* cut, long long rows, long long m, int vec,
                                  float* g_theta, float* g_it, int x_blocks, int y_blocks,
                                  void* stream) {
  qat_backward_kernel<<<dim3((unsigned)x_blocks, (unsigned)y_blocks), kThreads, 0,
                        (cudaStream_t)stream>>>(g, it, w, cut, rows, m, vec, g_theta, g_it);
  return (int)cudaGetLastError();
}

// The bf16 entry: g, it, g_theta, g_it rows x m bf16 bits, contiguous; w:
// rows bf16. vec = 1 when m is a multiple of 8 and the four pointers are
// 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int qat_backward_bf16_apply(const uint16_t* g, const uint16_t* it, const uint16_t* w,
                                       long long rows, long long m, int vec, uint16_t* g_theta,
                                       uint16_t* g_it, int x_blocks, int y_blocks, void* stream) {
  qat_backward_bf16_kernel<<<dim3((unsigned)x_blocks, (unsigned)y_blocks), kThreads, 0,
                             (cudaStream_t)stream>>>(g, it, w, rows, m, vec, g_theta, g_it);
  return (int)cudaGetLastError();
}
