// Fused ternarize + 2-bit wire pack + per-tile moments over many bf16
// segments in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quantize_pack.py::_kernel
// (launched by quantize_pack_segments) for bf16 weights. It reads the same
// segment table as the fp32 kernel (quantize_pack.cu) and computes, in bf16
// as the reference kernel computes in x's dtype,
//
//   xs   = bf16(x / bf16(denom))
//   code = 1 + [xs > bf16(delta)] - [xs < -bf16(delta)]   (wire code = I_t + 1)
//   out[q] = code[4q] | code[4q+1] << 2 | code[4q+2] << 4 | code[4q+3] << 6
//   moments[t] = (sum of |xs| over selected elements, selected count)
//
// over tiles of 32768 contiguous elements that restart at every segment (the
// reference's BLOCK_S * LANES tile), and optionally each segment's scale
// (sum of its tile sums) / (sum of its counts + 1e-8) * denom, formed in
// fp64 in a fixed order by whichever block finishes the segment's last tile.
//
// Bound: bytes, 2 B read and 0.25 B written per weight.
//
// No division for the codes. Let D be the bf16 denom, d the bf16 delta and
// d+ the next bf16 above d, with D and d positive normal. Then
//
//   bf16(x / D) > d   exactly when   x > T,   T = D * (d + d+) / 2,
//
// and bf16(x / D) < -d exactly when x < -T. Rounding to nearest is monotone
// and symmetric, so bf16(x / D) > d holds exactly when x / D lies above the
// midpoint M = (d + d+) / 2, or on it and rounds up. It is never on it: M
// has an odd 9-bit significand, and x = M * D would give x, whose
// significand has 8 bits, an odd factor of at least 257. M * D has at most
// 9 + 8 significant bits, so T is exact in fp32 unless it leaves the normal
// range. The fp32 quotient rounded to bf16 is the correctly rounded bf16
// quotient (24 >= 2 * 8 + 2), so this is the reference's division.
//
// A cheap |xs| for the moments: |xs| = bf16(|x| * rcp), rcp = 1 / D rounded
// to fp32. The product is within 2^-23 (relative) of |x| / D, and |x| / D is
// never within 2^-17 of a bf16 rounding boundary (a 9-bit odd significand,
// as above: the gap is a nonzero integer over D's and the boundary's
// significands, at most 255 * 511), so both round to the same bf16, for
// every selected x, whose quotient exceeds M > 2^-126. An overflowing
// quotient rounds to infinity both ways. The exhaustive check of
// chip_smoke.py and tests/test_torch_gpu.py holds this kernel, both paths,
// against the plain version's division over every bf16 bit pattern of x, a
// denom in every bf16 binade and deltas of 0, a subnormal, 0.05, 0.3, 0.7
// and 1 and their bf16 neighbours; tests/test_torch_subnormals.py models
// the threshold and the reciprocal product in PyTorch's fp32 arithmetic
// against the same division on the CPU.
//
// Subnormals as XLA computes on the CPU and the TPU: a subnormal x, denom or
// delta (after its rounding to bf16) enters as a zero of its sign, and a
// subnormal quotient is flushed before it is rounded, compared or summed.
// With T a positive normal, a subnormal x is never selected, so the
// threshold path needs no flush. A segment whose D, d or T is not a positive
// finite normal, or whose 1 / D is subnormal, takes the exact division
// (codes8<false>) in this same kernel.
//
// Memory: a thread takes 8 consecutive weights with one 16-byte load and
// writes their 2 wire bytes in one store; a warp's loads are 512 contiguous
// bytes. A tile is 16 loads a thread, held in registers; while one tile is
// computed, its loads are replaced by the next tile's, so 16 loads a thread
// stay in flight across tile boundaries and the tile's moment reduction
// overlaps them. Offsets inside a tile are 32-bit. Whole tiles of a 16-byte
// aligned source whose wire bytes start at an even address take this path
// with no bounds test; a segment's ragged last tile and an unaligned source
// take a bounds-checked path of 2-byte loads and 1-byte stores.
//
// Fixed costs: a grid of two blocks an SM, each walking a contiguous run of
// tiles, so the binary search for the segment, the table row and the
// scalars are paid once per block and per segment crossed; the tile's warp
// partials go through shared memory, one barrier a tile, and one warp (a
// different one each tile) writes the moments. A block counts the tiles it
// finished in a segment on the segment's counter once, as it leaves the
// segment, so the fence and atomic that order the moments before the count
// are paid once per block and segment, not once per tile.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32768;                    // elements per moment tile
constexpr int kTileBytes = kTile / 4;           // wire bytes per tile
constexpr int kVecs = kTile / 8 / kThreads;     // 16-byte loads a thread per tile: 16
constexpr int kQuads = kTile / 4 / kThreads;    // wire bytes a thread per tile: 32
constexpr int kBlocksPerSm = 2;
constexpr float kTiny = 1.17549435e-38f;        // least normal fp32 (and bf16)

// One row of the segment table (int64 fields, as the wrapper writes them).
struct Segment {
  long long x;          // address of the bf16 source
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
  return fabsf(v) < kTiny ? copysignf(0.f, v) : v;
}

// x / d rounded to nearest, with subnormal operands and a subnormal result
// flushed to zeros of their signs: ftz(ftz(x) / ftz(d)).
__device__ __forceinline__ float div_ftz(float x, float d) {
  float q;
  asm("div.rn.ftz.f32 %0, %1, %2;\n" : "=f"(q) : "f"(x), "f"(d));
  return q;
}

// fp32 rounded to the nearest bf16 (ties to even), returned widened.
__device__ __forceinline__ float round_bf16(float v) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(v));
  return __uint_as_float((uint32_t)h << 16);
}

// 16 bytes through the read-only path. (Hints to skip L1 or to prefetch
// into L2 made the deploy's encode slower on an H100.)
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// What a block needs of the segment it works in.
struct Seg {
  const uint16_t* x;    // bf16 source
  uint8_t* dst;         // its wire bytes
  long long n;          // elements
  long long tile0;      // first moment tile
  long long tiles;      // moment tiles
  bool vec;             // whole tiles take 16-byte loads and 2-byte stores
  bool fast;            // codes by the threshold, |xs| by the reciprocal
  float scale_denom;    // the table's fp32 denom, flushed: the scale's factor
  float denom;          // bf16 denom, flushed
  float delta;          // bf16 delta, flushed
  float t;              // code threshold on x: D * (d + d+) / 2
  float rcp;            // 1 / D rounded to fp32
};

__device__ __forceinline__ bool vec_ok(long long x, const uint8_t* dst) {
  return (x & 15) == 0 && (reinterpret_cast<uintptr_t>(dst) & 1) == 0;
}

__device__ Seg load_seg(const Segment* table, const float* scal, uint8_t* out, int s) {
  Seg g;
  const long long xa = __ldg(&table[s].x);
  g.x = reinterpret_cast<const uint16_t*>(xa);
  g.n = __ldg(&table[s].n);
  g.tile0 = __ldg(&table[s].tile0);
  g.tiles = seg_tiles(g.n);
  g.dst = out + __ldg(&table[s].out_off);
  g.vec = vec_ok(xa, g.dst);
  const float denom = __ldg(scal + 2 * s);
  g.scale_denom = ftz(denom);
  g.denom = ftz(round_bf16(denom));
  g.delta = ftz(round_bf16(__ldg(scal + 2 * s + 1)));
  // the next bf16 above delta; inf above the largest finite one, NaN above inf
  const float up = __uint_as_float(__float_as_uint(g.delta) + 0x10000u);
  g.t = __fmul_rn(__fmul_rn(__fadd_rn(g.delta, up), 0.5f), g.denom);
  g.rcp = __frcp_rn(g.denom);
  g.fast = g.denom >= kTiny && g.denom <= 0x1p126f && g.delta >= kTiny && g.t >= kTiny
           && g.t <= FLT_MAX;
  return g;
}

// One weight a (a bf16 widened) into the pos/neg bit at `bit` and the sum.
template <bool kFast>
__device__ __forceinline__ void code1(float a, const Seg& g, int bit, uint32_t& pos,
                                      uint32_t& neg, float& sum) {
  if (kFast) {
    const bool p = a > g.t, n = a < -g.t;
    pos |= (uint32_t)p << bit;
    neg |= (uint32_t)n << bit;
    if (p | n) sum += round_bf16(fabsf(a) * g.rcp);
  } else {
    const float xs = round_bf16(div_ftz(a, g.denom));
    const bool p = xs > g.delta, n = xs < -g.delta;
    pos |= (uint32_t)p << bit;
    neg |= (uint32_t)n << bit;
    if (p | n) sum += fabsf(xs);
  }
}

// Eight consecutive weights (one 16-byte load) into their 16-bit code word:
// weight j's code at bits 2j, so the word's two little-endian bytes are the
// wire bytes. Every field is 1 + p - n in [0, 2], so no field borrows.
template <bool kFast>
__device__ __forceinline__ uint32_t codes8(const uint4 v, const Seg& g, float& sum,
                                           uint32_t& count) {
  uint32_t pos = 0, neg = 0;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    code1<kFast>(__uint_as_float(w[k] << 16), g, 4 * k, pos, neg, sum);
    code1<kFast>(__uint_as_float(w[k] & 0xFFFF0000u), g, 4 * k + 2, pos, neg, sum);
  }
  count += __popc(pos) + __popc(neg);
  return 0x5555u + pos - neg;
}

// A whole tile from the registers `ring` (16 loads a thread), each load
// replaced by the next tile's at `next` as soon as it is used when
// `prefetch`.
template <bool kFast>
__device__ __forceinline__ void ring_tile(uint4 (&ring)[kVecs], const uint4* next,
                                          bool prefetch, const Seg& g, uint16_t* dst,
                                          float& sum, uint32_t& count) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const uint4 v = ring[i];
    if (prefetch) ring[i] = load_stream(next + i * kThreads);
    dst[i * kThreads] = (uint16_t)codes8<kFast>(v, g, sum, count);
  }
}

// Tile k of a segment with bounds: its ragged last tile, or an unaligned
// source. A thread takes 4 weights (one wire byte) at a time.
template <bool kFast>
__device__ void bounded_tile(const Seg& g, long long k, float& sum, uint32_t& count) {
  const long long n_bytes = (g.n + 3) / 4;
  for (int i = 0; i < kQuads; ++i) {
    const long long q = k * kTileBytes + i * kThreads + threadIdx.x;
    if (q >= n_bytes) break;
    uint32_t pos = 0, neg = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long e = 4 * q + j;
      if (e < g.n)
        code1<kFast>(__uint_as_float((uint32_t)__ldg(g.x + e) << 16), g, 2 * j, pos, neg, sum);
    }
    count += __popc(pos) + __popc(neg);
    g.dst[q] = (uint8_t)(0x55u + pos - neg);
  }
}

// The segment's scale, once every tile of it is done. A block adds the tiles
// it finished in segment s to the segment's counter as it leaves the segment
// (after a barrier, so that every warp's moment stores come first), and the
// block that completes the count adds the segment's moments in fp64 in a
// fixed order and writes the scale.
__device__ void finish_segment(Segment* table, int s, const Seg& g, long long done_here,
                               const float* moments, float* scales) {
  __shared__ bool last;
  __shared__ double red_sum[kWarps];
  __shared__ long long red_count[kWarps];
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long prev = atomicAdd(
        reinterpret_cast<unsigned long long*>(&table[s].done), (unsigned long long)done_here);
    last = prev + done_here == (unsigned long long)g.tiles;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double acc = 0.0;
  long long c = 0;
  for (long long t = threadIdx.x; t < g.tiles; t += kThreads) {
    const float2 m = __ldcg(reinterpret_cast<const float2*>(moments + 2 * (g.tile0 + t)));
    acc += (double)m.x;
    c += (long long)m.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_sum[warp] = acc;
    red_count[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    long long count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      total += red_sum[w];
      count += red_count[w];
    }
    scales[s] = ftz(ftz((float)total / ((float)count + 1e-8f)) * g.scale_denom);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
quantize_pack_bf16_kernel(Segment* table, int n_seg, const float* __restrict__ scal,
                          uint8_t* __restrict__ out, float* __restrict__ moments,
                          float* __restrict__ scales, long long n_tiles) {
  __shared__ float red_sum[2][kWarps];
  __shared__ uint32_t red_count[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long begin = n_tiles * blockIdx.x / gridDim.x;
  const long long end = n_tiles * (blockIdx.x + 1) / gridDim.x;
  if (begin >= end) return;
  int s = find_segment(table, n_seg, begin);
  Seg g = load_seg(table, scal, out, s);
  long long done_here = 0;    // tiles of segment s this block finished
  uint4 ring[kVecs];
  bool ready = false;         // ring holds this tile's loads
  int buf = 0;
  for (long long tile = begin; tile < end; ++tile) {
    if (tile >= g.tile0 + g.tiles) {
      if (scales != nullptr) finish_segment(table, s, g, done_here, moments, scales);
      g = load_seg(table, scal, out, ++s);
      done_here = 0;
    }
    const long long k = tile - g.tile0;
    float sum = 0.f;
    uint32_t count = 0;
    if (g.vec && (k + 1) * kTile <= g.n) {
      const uint4* src = reinterpret_cast<const uint4*>(g.x + k * kTile) + threadIdx.x;
      if (!ready) {
#pragma unroll
        for (int i = 0; i < kVecs; ++i) ring[i] = load_stream(src + i * kThreads);
      }
      // the next tile's loads go out while this one is computed, if it is
      // whole too (in this segment or at the start of the next)
      const uint4* next = src + kTile / 8;
      bool prefetch = false;
      if (tile + 1 < end) {
        if (k + 1 < g.tiles) {
          prefetch = (k + 2) * kTile <= g.n;
        } else {
          const long long xa = __ldg(&table[s + 1].x);
          prefetch = __ldg(&table[s + 1].n) >= kTile
                     && vec_ok(xa, out + __ldg(&table[s + 1].out_off));
          next = reinterpret_cast<const uint4*>(xa) + threadIdx.x;
        }
      }
      uint16_t* dst = reinterpret_cast<uint16_t*>(g.dst + k * kTileBytes) + threadIdx.x;
      if (g.fast)
        ring_tile<true>(ring, next, prefetch, g, dst, sum, count);
      else
        ring_tile<false>(ring, next, prefetch, g, dst, sum, count);
      ready = prefetch;
    } else {
      if (g.fast)
        bounded_tile<true>(g, k, sum, count);
      else
        bounded_tile<false>(g, k, sum, count);
      ready = false;
    }

    // the tile's moments: warp partials through shared memory (double
    // buffered, so one barrier a tile), then one warp (a different one each
    // tile) adds them in a fixed order and writes them
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_down_sync(0xffffffffu, sum, off);
      count += __shfl_down_sync(0xffffffffu, count, off);
    }
    if (lane == 0) {
      red_sum[buf][warp] = sum;
      red_count[buf][warp] = count;
    }
    __syncthreads();
    if (warp == (int)(tile % kWarps)) {
      float ts = lane < kWarps ? red_sum[buf][lane] : 0.f;
      uint32_t tc = lane < kWarps ? red_count[buf][lane] : 0u;
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1) {
        ts += __shfl_down_sync(0xffffffffu, ts, off);
        tc += __shfl_down_sync(0xffffffffu, tc, off);
      }
      if (lane == 0)
        *reinterpret_cast<float2*>(moments + 2 * tile) = make_float2(ts, (float)tc);
    }
    ++done_here;
    buf ^= 1;
  }
  if (scales != nullptr) finish_segment(table, s, g, done_here, moments, scales);
}

}  // namespace

// One launch over a segment table of n_seg rows in device memory (the fp32
// kernel's table). scal holds n_seg fp32 (denom, delta) rows; moments n_tiles
// (sum, count) rows; scales, when not null, receives each segment's scale
// (the table's done column must then be 0). Every source of a table is bf16.
// The grid is two blocks an SM, or one block a tile where there are fewer.
extern "C" int quantize_pack_bf16(void* table, int n_seg, const float* scal, uint8_t* out,
                                  float* moments, float* scales, long long n_tiles,
                                  void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(n_tiles < cap ? n_tiles : cap);
  quantize_pack_bf16_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<Segment*>(table), n_seg, scal, out, moments, scales, n_tiles);
  return (int)cudaGetLastError();
}
