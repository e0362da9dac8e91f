// 2-bit ternary pack and unpack in the matmul layout, for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/pack2bit.py::_pack_kernel
// (launched by pack2bit) and ::_unpack_kernel (launched by unpack2bit). The
// layout packs four K-consecutive codes c = I_t + 1 of one column per byte,
//
//   packed[k4, n] = c[4 k4, n] | c[4 k4 + 1, n] << 2 | c[4 k4 + 2, n] << 4
//                   | c[4 k4 + 3, n] << 6,
//
// which is the (K/4, N) layout ternary_matmul reads. Pack computes each code
// as an int (I_t + 1) and keeps the low 8 bits of the OR, as the Pallas kernel
// does; unpack writes ((byte >> 2j) & 3) - 1 as int8 (the wrapper converts to
// another dtype; every value is exact). Both are bit-identical to the plain
// PyTorch versions and to the Pallas kernels.
//
// Bound: bytes, 1 + 0.25 bytes per code (int8 in, packed out, or the
// reverse). The TPU kernels worked on (block, 512) tiles and a sublane
// reshape; here one thread takes 4 neighbouring columns of one packed row:
// pack loads one 32-bit word from each of the 4 source rows and stores one
// word; unpack loads one word and stores 4 rows of 4 outputs. Where N % 4 != 0
// or a pointer is not aligned, one thread takes one column (the scalar path).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t pack4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  // r0..r3: the same column's int8 values of 4 consecutive rows, in byte b
  uint32_t out = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int c0 = (int)(int8_t)(r0 >> (8 * b)) + 1;
    const int c1 = (int)(int8_t)(r1 >> (8 * b)) + 1;
    const int c2 = (int)(int8_t)(r2 >> (8 * b)) + 1;
    const int c3 = (int)(int8_t)(r3 >> (8 * b)) + 1;
    out |= (uint32_t)(uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6)) << (8 * b);
  }
  return out;
}

// x: (K, N) int8; out: (K/4, N) uint8. vec: N % 4 == 0 and both 4-byte aligned.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int8_t* __restrict__ x, long long k4, long long n, int vec,
            uint8_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  if (vec) {
    const long long w = n / 4;  // words per row
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
    uint32_t* ow = reinterpret_cast<uint32_t*>(out);
    for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < k4 * w;
         t += stride) {
      const long long r = t / w, col = t - r * w;
      const uint32_t* src = xw + 4 * r * w + col;
      ow[t] = pack4(__ldg(src), __ldg(src + w), __ldg(src + 2 * w), __ldg(src + 3 * w));
    }
    return;
  }
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < k4 * n; t += stride) {
    const long long r = t / n, col = t - r * n;
    const int8_t* src = x + 4 * r * n + col;
    const int c0 = (int)src[0] + 1, c1 = (int)src[n] + 1;
    const int c2 = (int)src[2 * n] + 1, c3 = (int)src[3 * n] + 1;
    out[t] = (uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
  }
}

// packed: (K/4, N) uint8; out: (K, N) int8. vec: N % 4 == 0 and both 4-byte
// aligned.
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ packed, long long k4, long long n, int vec,
              int8_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  if (vec) {
    const long long w = n / 4;
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(packed);
    uint32_t* ow = reinterpret_cast<uint32_t*>(out);
    for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < k4 * w;
         t += stride) {
      const long long r = t / w, col = t - r * w;
      const uint32_t word = __ldg(pw + t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t o = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int v = (int)((word >> (8 * b + 2 * j)) & 3u) - 1;
          o |= (uint32_t)(uint8_t)(int8_t)v << (8 * b);
        }
        ow[(4 * r + j) * w + col] = o;
      }
    }
    return;
  }
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < k4 * n; t += stride) {
    const long long r = t / n, col = t - r * n;
    const uint32_t byte = packed[t];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[(4 * r + j) * n + col] = (int8_t)((int)((byte >> (2 * j)) & 3u) - 1);
    }
  }
}

}  // namespace

// Returns the launch's cudaError_t.
extern "C" int pack2bit_i8(const void* x, long long k4, long long n, int vec, void* out,
                           int n_blocks, void* stream) {
  pack_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int8_t*>(x), k4, n, vec, reinterpret_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// Returns the launch's cudaError_t.
extern "C" int unpack2bit_i8(const void* packed, long long k4, long long n, int vec, void* out,
                             int n_blocks, void* stream) {
  unpack_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint8_t*>(packed), k4, n, vec, reinterpret_cast<int8_t*>(out));
  return (int)cudaGetLastError();
}
