// Fused ternarize + 2-bit wire pack + per-tile moments over many fp32
// segments in one launch, for Hopper (sm_90a). bf16 segments have a kernel of
// their own (quantize_pack_bf16.cu), which shares the segment table.
//
// Replaces the TPU kernel src/repro/kernels/quantize_pack.py::_kernel
// (launched by quantize_pack_segments). For every segment s of a table (a
// flat fp32 source of n elements, its (denom, delta) row, the byte offset of
// its wire bytes and the index of its first moment tile) it computes
//
//   xs   = x / denom
//   code = 1 + [xs > delta] - [xs < -delta]              (wire code = I_t + 1)
//   out[q] = code[4q] | code[4q+1] << 2 | code[4q+2] << 4 | code[4q+3] << 6
//   moments[t] = (sum of |xs| over selected elements, selected count)
//
// where tile t covers 32768 contiguous flat elements of its segment, the
// reference's BLOCK_S * LANES tile, restarting at every segment, so codes
// and counts are exact and only the float sum's order differs. A segment's
// tail that is not a multiple of 4 is padded with code 1 (value 0).
// Optionally it also forms each segment's trained scale
//
//   scale[s] = (sum of its tile sums) / (sum of its tile counts + 1e-8) * denom
//
// with the count summed as an integer, as the reference's scale_from_moments
// does.
//
// Subnormals as XLA computes on the CPU and the TPU: a subnormal x, denom or
// delta enters as a zero of its sign, and a subnormal quotient (or scale) is
// flushed to zero before it is compared or summed. Normal values give the
// bits they gave without the flush.
//
// Bound: bytes. Each element is read once (4 B) and each wire byte written
// once (0.25 B per element); the arithmetic is a division and two compares.
// The TPU kernel read a staged transpose of the leaf so that its pack was a
// sublane shuffle; here one thread reads 4 consecutive elements as one float4
// straight from the segment's source and writes their byte, so a warp's loads
// are 512 contiguous bytes and no staging copy exists. One 256-thread block
// covers one tile and reduces its moments through warp shuffles and shared
// memory.
//
// One launch for a whole tree. The TPU kernel gave every grid block its own
// (denom, delta) row so that one launch encoded many segments; here the grid
// is the total number of tiles of all segments and each block finds its
// segment by a binary search over the table's first-tile column. A federated
// ResNet18* upload is 52 segments of at most one tile each: one launch of 52
// blocks instead of 52 launches of one block. The scale needs every tile of
// its segment: each block counts itself done on the segment's counter (0 in
// a freshly built table), and the last block of a segment adds the
// segment's moments (in fp64, in a fixed order, so the result does not
// depend on which block came last) and writes the scale.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32768;                            // elements per moment tile
constexpr int kQuadsPerThread = kTile / 4 / kThreads;   // 32

// One row of the segment table (int64 fields, as the wrapper writes them).
struct Segment {
  long long x;          // address of the fp32 source
  long long n;          // elements
  long long out_off;    // byte offset of its wire bytes in the output
  long long tile0;      // index of its first moment tile
  long long done;       // tiles finished in this launch; 0 when the table is built
};

__device__ __forceinline__ long long seg_tiles(long long n) {
  return n > 0 ? (n + kTile - 1) / kTile : 1;
}

// The segment that owns moment tile b: the last row with tile0 <= b.
__device__ __forceinline__ int find_segment(const Segment* table, int n_seg, long long b) {
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&table[mid].tile0) <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// A subnormal as a zero of its sign (XLA's flush of denormals).
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < 1.17549435e-38f ? copysignf(0.f, v) : v;
}

// x / d rounded to nearest, with subnormal operands and a subnormal result
// flushed to zeros of their signs: ftz(ftz(x) / ftz(d)) in one instruction
// sequence (the .ftz division, also cheaper than the one that keeps them).
__device__ __forceinline__ float div_ftz(float x, float d) {
  float q;
  asm("div.rn.ftz.f32 %0, %1, %2;\n" : "=f"(q) : "f"(x), "f"(d));
  return q;
}

__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(Segment* table, int n_seg, const float* __restrict__ scal,
                     uint8_t* __restrict__ out, float* __restrict__ moments,
                     float* __restrict__ scales) {
  const int s = find_segment(table, n_seg, blockIdx.x);
  const Segment seg = table[s];
  const float* x = reinterpret_cast<const float*>(seg.x);
  const long long n = seg.n;
  const bool vec = (seg.x & 15) == 0;
  uint8_t* dst = out + seg.out_off;
  const float denom = ftz(scal[2 * s]);
  const float delta = ftz(scal[2 * s + 1]);
  const long long n_bytes = (n + 3) / 4;
  const long long q_base = ((long long)blockIdx.x - seg.tile0) * (kTile / 4);
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
      const float xs = div_ftz(v[j], denom);
      const int pos = in[j] && xs > delta;
      const int neg = in[j] && xs < -delta;
      byte |= (uint32_t)(1 + pos - neg) << (2 * j);
      if (pos | neg) {
        sum += fabsf(xs);
        ++count;
      }
    }
    dst[q] = (uint8_t)byte;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  __shared__ float warp_sum[kThreads / 32];
  __shared__ int warp_count[kThreads / 32];
  __shared__ double red_sum[kThreads / 32];
  __shared__ long long red_count[kThreads / 32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_sum[warp] = sum;
    warp_count[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s_sum = 0.f;
    int c = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      s_sum += warp_sum[w];
      c += warp_count[w];
    }
    moments[2 * blockIdx.x] = s_sum;
    moments[2 * blockIdx.x + 1] = (float)c;
    last = false;
    if (scales != nullptr) {
      __threadfence();                       // this tile's moments before its count
      const unsigned long long prev = atomicAdd(
          reinterpret_cast<unsigned long long*>(&table[s].done), 1ull);
      last = prev + 1 == (unsigned long long)seg_tiles(n);
    }
  }
  __syncthreads();
  if (!last) return;

  // The last block of segment s: its scale from all of its tiles' moments.
  __threadfence();
  const long long nt = seg_tiles(n);
  double acc = 0.0;
  long long cnt = 0;
  for (long long t = threadIdx.x; t < nt; t += kThreads) {
    acc += (double)__ldcg(moments + 2 * (seg.tile0 + t));
    cnt += (long long)__ldcg(moments + 2 * (seg.tile0 + t) + 1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) {
    red_sum[warp] = acc;
    red_count[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    long long c = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      total += red_sum[w];
      c += red_count[w];
    }
    scales[s] = ftz(ftz((float)total / ((float)c + 1e-8f)) * denom);
  }
}

}  // namespace

// One launch over a segment table of n_seg rows in device memory. scal
// holds n_seg fp32 (denom, delta) rows; moments n_tiles (sum, count) rows;
// scales, when not null, receives each segment's scale (the table's done
// column must then be 0). Every source of a table is fp32.
extern "C" int quantize_pack_f32(void* table, int n_seg, const float* scal, uint8_t* out,
                                 float* moments, float* scales, long long n_tiles,
                                 void* stream) {
  quantize_pack_kernel<<<(unsigned)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<Segment*>(table), n_seg, scal, out, moments, scales);
  return (int)cudaGetLastError();
}
