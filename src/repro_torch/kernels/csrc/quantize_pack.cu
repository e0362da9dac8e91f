// Fused ternarize + 2-bit wire pack + per-tile moments, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quantize_pack.py::_kernel
// (launched by quantize_pack_segments). For one flat fp32 leaf x of n
// elements and the leaf's (denom, delta) it computes
//
//   xs   = x / denom
//   code = 1 + [xs > delta] - [xs < -delta]              (wire code = I_t + 1)
//   out[q] = code[4q] | code[4q+1] << 2 | code[4q+2] << 4 | code[4q+3] << 6
//   moments[t] = (sum of |xs| over selected elements, selected count)
//
// where tile t covers the 32768 contiguous flat elements [32768 t, 32768 (t+1)),
// the reference's BLOCK_S * LANES tile, so codes and counts are exact and only
// the float sum's order differs. A tail that is not a multiple of 4 is padded
// with code 1 (value 0).
//
// Bound: bytes. Each element is read once (4 B) and each wire byte written
// once (0.25 B per element); the arithmetic is a division and two compares.
// The TPU kernel read a staged transpose of the leaf so that its pack was a
// sublane shuffle; here one thread reads 4 consecutive elements as one float4
// straight from the leaf and writes their byte, so a warp's loads are 512
// contiguous bytes and no staging copy exists. One 256-thread block covers
// one tile and reduces its moments through warp shuffles and shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32768;                            // elements per moment tile
constexpr int kQuadsPerThread = kTile / 4 / kThreads;   // 32

__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ x, long long n,
                     const float* __restrict__ scal, uint8_t* __restrict__ out,
                     float* __restrict__ moments, int vec) {
  const float denom = scal[0];
  const float delta = scal[1];
  const long long n_bytes = (n + 3) / 4;
  const long long q_base = (long long)blockIdx.x * (kTile / 4);
  float sum = 0.f;
  int count = 0;
#pragma unroll 4
  for (int i = 0; i < kQuadsPerThread; ++i) {
    const long long q = q_base + (long long)i * kThreads + threadIdx.x;
    if (q >= n_bytes) break;
    const long long e = 4 * q;
    float v[4];
    bool in[4];
    if (vec && e + 4 <= n) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(x) + q);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      in[0] = in[1] = in[2] = in[3] = true;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        in[j] = e + j < n;
        v[j] = in[j] ? x[e + j] : 0.f;
      }
    }
    uint32_t byte = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xs = v[j] / denom;
      const int pos = in[j] && xs > delta;
      const int neg = in[j] && xs < -delta;
      byte |= (uint32_t)(1 + pos - neg) << (2 * j);
      if (pos | neg) {
        sum += fabsf(xs);
        ++count;
      }
    }
    out[q] = (uint8_t)byte;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  __shared__ float warp_sum[kThreads / 32];
  __shared__ int warp_count[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_sum[warp] = sum;
    warp_count[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    int c = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      s += warp_sum[w];
      c += warp_count[w];
    }
    moments[2 * blockIdx.x] = s;
    moments[2 * blockIdx.x + 1] = (float)c;
  }
}

}  // namespace

extern "C" int quantize_pack_f32(const float* x, long long n, const float* scal,
                                 uint8_t* out, float* moments, long long n_tiles,
                                 int vec, void* stream) {
  quantize_pack_kernel<<<(unsigned)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      x, n, scal, out, moments, vec);
  return (int)cudaGetLastError();
}
