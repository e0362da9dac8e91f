// Fused FTTQ apply on one weight tensor, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ternary_quantize.py::_kernel
// (launched by ternary_quantize). For weights theta (fp32 or bf16, read flat)
// and the layer's scalars (1/max|theta|, Delta, w_q) it computes, in theta's
// dtype as the Pallas kernel does,
//
//   xs    = theta * T(inv_scale)                       rounded to T
//   I_t   = |xs| > T(Delta) ? sign(xs) : 0             int8
//   theta_t = T(w_q) * I_t                             in T
//
// with T the dtype of theta and each scalar rounded to T once. In bf16 the
// product of two bf16 values is exact in fp32, so one rounding of it to bf16
// (__float2bfloat16_rn) gives the bf16 product; the compare and the output
// product are exact. Subnormals as XLA computes on the CPU and the TPU: a
// subnormal theta or scalar (after its rounding to T) enters as a zero of its
// sign, and a subnormal product theta * inv_scale is flushed before it is
// rounded and compared. Both dtypes are bit-identical to the plain PyTorch
// version and to the Pallas kernel.
//
// Bound: bytes. One read of theta and two writes: 4 + 1 + 4 bytes per fp32
// weight, 2 + 1 + 2 per bf16 weight, and one multiply and compare each. Each
// thread takes 4 consecutive elements: one 16-byte (fp32) or 8-byte (bf16)
// load, one 4-byte store of codes and one store of theta_t of the load's
// width; a tail (n % 4) or an unaligned pointer takes the scalar path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct F32 {
  using T = float;
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

struct BF16 {
  using T = __nv_bfloat16;
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};

// A subnormal as a zero of its sign (XLA's flush of denormals).
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < 1.17549435e-38f ? copysignf(0.f, v) : v;
}

// x * s rounded to nearest, with subnormal operands and a subnormal product
// flushed to zeros of their signs: ftz(ftz(x) * ftz(s)).
__device__ __forceinline__ float mul_ftz(float x, float s) {
  float p;
  asm("mul.rn.ftz.f32 %0, %1, %2;\n" : "=f"(p) : "f"(x), "f"(s));
  return p;
}

// one element: the code and theta_t, with inv, delta and wq already in T (as
// floats) and flushed
template <class D>
__device__ __forceinline__ void apply_one(typename D::T x, float inv, float delta, float wq,
                                          int8_t* it, typename D::T* qt) {
  const float xs = D::to_f(D::from_f(mul_ftz(D::to_f(x), inv)));
  // sign(xs) where |xs| > Delta, else +0; sign keeps a signed zero (Delta < 0)
  float s = 0.0f;
  if (fabsf(xs) > delta) s = xs > 0.0f ? 1.0f : (xs < 0.0f ? -1.0f : xs);
  *it = (int8_t)s;
  *qt = D::from_f(wq * s);
}

template <class D>
__global__ void __launch_bounds__(kThreads)
ternary_quantize_kernel(const typename D::T* __restrict__ theta, long long n,
                        const float* __restrict__ scal, int vec,
                        int8_t* __restrict__ it, typename D::T* __restrict__ qt) {
  using T = typename D::T;
  // the fp32 scalars (1/max|theta|, Delta, w_q) in theta's dtype, as the
  // reference casts them, then flushed
  const float inv = ftz(D::to_f(D::from_f(__ldg(scal))));
  const float d = ftz(D::to_f(D::from_f(__ldg(scal + 1))));
  const float wq = ftz(D::to_f(D::from_f(__ldg(scal + 2))));
  const long long stride = (long long)gridDim.x * kThreads;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    alignas(16) T x[4];
    alignas(16) T q[4];
    int8_t c[4];
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(x) = reinterpret_cast<const float4*>(theta)[i];
    } else {
      *reinterpret_cast<uint2*>(x) = reinterpret_cast<const uint2*>(theta)[i];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) apply_one<D>(x[k], inv, d, wq, &c[k], &q[k]);
    reinterpret_cast<char4*>(it)[i] = make_char4(c[0], c[1], c[2], c[3]);
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(qt)[i] = *reinterpret_cast<float4*>(q);
    } else {
      reinterpret_cast<uint2*>(qt)[i] = *reinterpret_cast<uint2*>(q);
    }
  }
  for (long long e = 4 * n4 + (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += stride) {
    apply_one<D>(theta[e], inv, d, wq, it + e, qt + e);
  }
}

template <class D>
int launch(const void* theta, long long n, const float* scal, int vec, void* it, void* qt,
           int n_blocks, void* stream) {
  using T = typename D::T;
  ternary_quantize_kernel<D><<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const T*>(theta), n, scal, vec,
      reinterpret_cast<int8_t*>(it), reinterpret_cast<T*>(qt));
  return (int)cudaGetLastError();
}

}  // namespace

// theta: n elements of fp32 (bf16 = 0) or bf16 (bf16 = 1); scal: 3 fp32 on the
// device (1/max|theta|, Delta, w_q); it: n int8; qt: n of theta's dtype. vec = 1
// when theta and qt are aligned to 4 elements' width and it to 4 bytes.
// Returns the launch's cudaError_t.
extern "C" int ternary_quantize_apply(const void* theta, long long n, const float* scal,
                                      int bf16, int vec, void* it, void* qt, int n_blocks,
                                      void* stream) {
  if (bf16) return launch<BF16>(theta, n, scal, vec, it, qt, n_blocks, stream);
  return launch<F32>(theta, n, scal, vec, it, qt, n_blocks, stream);
}
