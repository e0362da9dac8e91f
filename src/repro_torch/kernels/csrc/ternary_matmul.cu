// Ternary-weight matmul on 2-bit packed weights, for Hopper (sm_90a).
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
// Bound: operations. One decode step of olmo-1b (M = 4) reads 2^28 packed
// bytes, 80 us at 3.35 TB/s, but does 2 * 4 * 2^30 = 8.6 GFLOP, 128 us at the
// 67 TFLOP/s of fp32 outside the tensor cores; larger M only adds FLOPs. This
// kernel runs on the CUDA cores: a later kernel that feeds the tensor cores
// (bf16 or int8 wgmma) moves the bound back to bytes.
//
// Design: a block owns BN = 128 columns (each lane reads 4 neighbouring
// columns' bytes with one 32-bit load, so a warp reads 128 contiguous bytes of
// a packed row) and BM rows of x. Its 4 warps split the block's K range
// row-interleaved, each keeping BM x 4 fp32 sums in registers, and combine
// them through shared memory at the end. x is staged in shared memory one
// chunk of 128 K values at a time and read as broadcast float4s. A code
// becomes its value c - 1 with one integer OR and one float subtract on the
// float 2^23 + c, with no int-to-float conversion. When M and N give too few
// blocks to fill the card, blocks also split K (grid z); each split writes
// its partial sums to a workspace and a second kernel adds them in split
// order, so results are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;   // columns per block: 32 lanes x 4 columns
constexpr int kKC4 = 32;   // packed rows per staged x chunk (128 K values)

__device__ __forceinline__ float code_value(uint32_t c) {
  // 2^23 + c is exact in fp32; subtracting 2^23 + 1 leaves c - 1.
  return __uint_as_float(0x4B000000u | c) - 8388609.0f;
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
ternary_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                      const float* __restrict__ wq, float* __restrict__ out,
                      float* __restrict__ ws, int M, int K4, int N,
                      int k4_per_split, int wvec) {
  __shared__ float4 xs[BM][kKC4];
  __shared__ __align__(16) float red[kWarps][BM][kBN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kBN;
  const int n0 = col0 + lane * 4;
  const int m0 = blockIdx.y * BM;
  const int k4_lo = blockIdx.z * k4_per_split;
  const int k4_hi = min(K4, k4_lo + k4_per_split);
  const size_t K = (size_t)K4 * 4;

  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int c0 = k4_lo; c0 < k4_hi; c0 += kKC4) {
    const int rows = min(kKC4, k4_hi - c0);
    __syncthreads();  // every warp is done with the previous chunk
    for (int i = threadIdx.x; i < BM * kKC4; i += kThreads) {
      const int m = i / kKC4;
      const int r = i % kKC4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + m < M && r < rows)
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(m0 + m) * K) + c0 + r);
      xs[m][r] = v;
    }
    __syncthreads();
    if (n0 >= N) continue;
#pragma unroll 2
    for (int r = warp; r < rows; r += kWarps) {
      const uint8_t* row = w + (size_t)(c0 + r) * N;
      uint32_t w4;
      if (wvec) {
        w4 = __ldg(reinterpret_cast<const uint32_t*>(row + n0));
      } else {
        w4 = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          w4 |= (uint32_t)(n0 + c < N ? row[n0 + c] : 0x55) << (8 * c);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t b = w4 >> (8 * c);
        const float v0 = code_value(b & 3u);
        const float v1 = code_value((b >> 2) & 3u);
        const float v2 = code_value((b >> 4) & 3u);
        const float v3 = code_value((b >> 6) & 3u);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float4 xv = xs[m][r];
          float a = acc[m][c];
          a = fmaf(xv.x, v0, a);
          a = fmaf(xv.y, v1, a);
          a = fmaf(xv.z, v2, a);
          a = fmaf(xv.w, v3, a);
          acc[m][c] = a;
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][lane * 4]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const float scale = ws == nullptr ? *wq : 1.f;
  for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
    const int m = i / kBN;
    const int col = i % kBN;
    const int gm = m0 + m;
    const int gn = col0 + col;
    if (gm >= M || gn >= N) continue;
    float s = red[0][m][col];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += red[k][m][col];
    if (ws == nullptr)
      out[(size_t)gm * N + gn] = s * scale;
    else
      ws[((size_t)blockIdx.z * M + gm) * N + gn] = s;
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ wq,
                                     float* __restrict__ out, int split,
                                     size_t mn) {
  const float scale = *wq;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < split; ++z) s += ws[(size_t)z * mn + i];
    out[i] = s * scale;
  }
}

template <int BM>
void launch(const float* x, const uint8_t* w, const float* wq, float* out,
            float* ws, int M, int K4, int N, int split, int wvec,
            cudaStream_t stream) {
  const int k4_per_split = (K4 + split - 1) / split;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, split);
  ternary_matmul_kernel<BM><<<grid, kThreads, 0, stream>>>(
      x, w, wq, out, split > 1 ? ws : nullptr, M, K4, N, k4_per_split, wvec);
}

}  // namespace

// bm selects the row tile (4 for decode-sized M, 16 otherwise). With
// split > 1, ws holds split * M * N floats of partial sums.
extern "C" int ternary_matmul_f32(const float* x, const uint8_t* w,
                                  const float* wq, float* out, float* ws, int M,
                                  int K4, int N, int bm, int split, int wvec,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 4)
    launch<4>(x, w, wq, out, ws, M, K4, N, split, wvec, s);
  else
    launch<16>(x, w, wq, out, ws, M, K4, N, split, wvec, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_reduce_kernel<<<blocks, 256, 0, s>>>(ws, wq, out, split, mn);
  return (int)cudaGetLastError();
}
