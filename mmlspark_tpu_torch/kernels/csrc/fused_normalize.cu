// K1 on Hopper: per-channel normalize of a uint8 image batch,
// (float(x) - mean[c]) * inv_std[c], stored as bfloat16 or float32.
//
// Replaces the Pallas TPU kernel
// mmlspark_tpu/ops/pallas_preprocess.py::fused_normalize (body
// _normalize_kernel). On the TPU the batch was padded to a multiple of 8
// rows (the sublane tiling), the uint8 went through int32 (Mosaic has no
// direct uint8 -> float cast) and mean / inv_std were tiled on the host
// into full-row vectors, so each lane read its own constant. Here none of
// that is needed: the element's channel is its flat index modulo C.
//
// Bound. One elementwise pass: each input byte is read once and each
// output written once. At the training path's shape (B=256, 32x32x3 uint8
// -> bf16) that is 2,359,296 bytes, 0.70 us at the H100's 3.35 TB/s; two
// fp32 operations per element is far below the card's fp32 rate, so the
// kernel is bound by bytes, and at that small size by the launch itself
// (chip_smoke.py times an empty kernel of the same grid beside it).
//
// Design. The input is cut into 16-byte groups, a group a thread. The
// grid is one block per 128 groups, capped at kWaves waves of the card
// (blocks per SM times SMs); past that cap a grid-stride loop gives each
// thread up to kGroups groups a pass, kThreads * gridDim.x groups apart,
// whose 16-byte loads are all issued before any store, and the next pass's
// loads are issued before this pass's stores. (A cap of one wave, each
// thread walking ~14 groups, ran 31.5 us at B=128, 224x224x3 -> bf16
// against 22.8-23.4 us at four waves: preprocess_variants.py on an H100.) The total thread count is a multiple
// of C / gcd(C, 16), so a group's first channel, (16 * group) mod C, is the
// same for every group a thread touches: the thread fetches the 16
// (mean, inv_std) pairs of its channel phase into registers once, and the
// body has no modulo. A byte becomes fp32 by a byte permute and one
// subtract (exact), not by the quarter-rate int-to-float conversion. Index
// math is 32-bit; the entry point splits an input of 2^30 elements or more
// into launches of whole channel groups. An input that does not start on
// 16 bytes (a view) takes a one-element-per-thread variant, and the last
// partial group of 16 is finished element by element.
//
// Arithmetic. __fsub_rn then __fmul_rn in fp32, rounded to bf16 with
// __float2bfloat16_rn: the _rn intrinsics keep nvcc from contracting or
// reordering, so the kernel is bit-equal to the plain torch version
// (ops/preprocess.py::_fused_normalize_plain), which runs the same two
// roundings. The multiply is by the fp32 reciprocal of std, as in the
// reference, never a division.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 16;      // uint8 elements in a group (one 16-byte load)
constexpr int kGroups = 4;    // groups whose loads a thread has in flight
constexpr int kThreads = 128;
constexpr int kWaves = 4;     // the grid's cap, in waves of the card
// the largest launch: whole groups of 16 and of C, below 2^31 elements
constexpr long long kChunk = 1LL << 30;

__device__ __forceinline__ float normalize(uint8_t x, float mean,
                                           float inv_std) {
  return __fmul_rn(__fsub_rn(static_cast<float>(x), mean), inv_std);
}

__device__ __forceinline__ void store_one(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store_one(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// 16 results -> four 16-byte stores
__device__ __forceinline__ void store16(float* dst, const float* v) {
  float4* out = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

// 16 results -> two 16-byte stores of eight bf16 each
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint32_t packed[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // low half holds the element at the lower address
    __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    packed[j] = *reinterpret_cast<uint32_t*>(&pair);
  }
  uint4* out = reinterpret_cast<uint4*>(dst);
  out[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  out[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

// Byte `k` of `word` as an exact fp32 value without an int-to-float
// conversion (a quarter-rate instruction): one byte permute builds the
// bits of 2^23 + byte, and one subtract of 2^23 leaves the byte.
__device__ __forceinline__ float byte_to_float(uint32_t word, int k) {
  const uint32_t bits = __byte_perm(word, 0x4Bu, 0x4550u + k);
  return __fsub_rn(__uint_as_float(bits), 8388608.0f);
}

// groups g, g + stride, ... (kGroups of them, those below `groups`)
__device__ __forceinline__ void load_groups(const uint4* in, unsigned int g,
                                            unsigned int stride,
                                            unsigned int groups,
                                            uint4* raw) {
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const unsigned int gj = g + j * stride;
    if (gj < groups) raw[j] = __ldg(in + gj);
  }
}

// `total` elements from src (16-byte aligned), channel = index mod c; the
// launch's thread count is a multiple of c / gcd(c, 16)
template <typename OutT>
__global__ void __launch_bounds__(kThreads) fused_normalize_vec_kernel(
    const uint8_t* __restrict__ src, OutT* __restrict__ dst,
    const float* __restrict__ mean, const float* __restrict__ inv_std,
    int c, int total) {
  const unsigned int tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned int stride = gridDim.x * kThreads;
  const unsigned int groups = static_cast<unsigned int>(total) / kVec;

  // this thread's channel phase, and its 16 constants, once
  float mu[kVec], is[kVec];
  int ch = static_cast<int>((tid % static_cast<unsigned int>(c)) * kVec %
                            static_cast<unsigned int>(c));
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    mu[k] = __ldg(mean + ch);
    is[k] = __ldg(inv_std + ch);
    ch = (ch + 1 == c) ? 0 : ch + 1;
  }

  // each pass loads the next pass's groups before it stores its own, so
  // loads stay in flight while the stores drain
  const uint4* in = reinterpret_cast<const uint4*>(src);
  uint4 cur[kGroups];
  load_groups(in, tid, stride, groups, cur);
  for (unsigned int g = tid; g < groups; g += kGroups * stride) {
    uint4 next[kGroups];
    load_groups(in, g + kGroups * stride, stride, groups, next);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const unsigned int gj = g + j * stride;
      if (gj >= groups) break;
      const uint32_t words[4] = {cur[j].x, cur[j].y, cur[j].z, cur[j].w};
      float v[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        v[k] = __fmul_rn(__fsub_rn(byte_to_float(words[k / 4], k % 4), mu[k]),
                         is[k]);
      }
      store16(dst + gj * kVec, v);
      cur[j] = next[j];
    }
  }

  // the tail: fewer than 16 elements after the last whole group
  if (tid == 0) {
    for (unsigned int i = groups * kVec; i < static_cast<unsigned int>(total);
         ++i) {
      const unsigned int k = i % static_cast<unsigned int>(c);
      store_one(dst + i, normalize(src[i], __ldg(mean + k),
                                   __ldg(inv_std + k)));
    }
  }
}

// the misaligned variant: one element per thread and pass
template <typename OutT>
__global__ void __launch_bounds__(kThreads) fused_normalize_scalar_kernel(
    const uint8_t* __restrict__ src, OutT* __restrict__ dst,
    const float* __restrict__ mean, const float* __restrict__ inv_std,
    int c, int total) {
  const unsigned int stride = gridDim.x * kThreads;
  for (unsigned int i = blockIdx.x * kThreads + threadIdx.x;
       i < static_cast<unsigned int>(total); i += stride) {
    const unsigned int k = i % static_cast<unsigned int>(c);
    store_one(dst + i, normalize(src[i], __ldg(mean + k), __ldg(inv_std + k)));
  }
}

// the launch floor: the vector variant's grid, doing nothing
__global__ void fused_normalize_empty_kernel() {}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Blocks of the launch: one per kThreads groups (the scalar variant:
// elements), at most one wave of the card, rounded up to a multiple that
// keeps each thread's channel phase fixed. A small input thus spreads one
// group a thread over many SMs; a large one walks kGroups groups a pass.
template <typename OutT, bool kVector>
unsigned int blocks_for(long long total, int c) {
  static int wave = 0;  // per variant; every caller computes the same value
  if (wave == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (kVector) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_normalize_vec_kernel<OutT>, kThreads, 0);
    } else {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_normalize_scalar_kernel<OutT>, kThreads, 0);
    }
    wave = kWaves * sms * (per_sm > 0 ? per_sm : 1);
  }
  // one group a thread while the work fits one wave; more beyond it
  const long long units = kVector ? total / kVec : total;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  const int period = c / gcd(c, kVec);              // threads a phase cycle
  const int need = period / gcd(period, kThreads);  // blocks a phase cycle
  blocks = (blocks + need - 1) / need * need;
  return static_cast<unsigned int>(blocks);
}

template <typename OutT>
void launch(const uint8_t* src, OutT* dst, const float* mean,
            const float* inv_std, int c, long long total, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    fused_normalize_vec_kernel<OutT>
        <<<blocks_for<OutT, true>(total, c), kThreads, 0, s>>>(
            src, dst, mean, inv_std, c, static_cast<int>(total));
  } else {
    fused_normalize_scalar_kernel<OutT>
        <<<blocks_for<OutT, false>(total, c), kThreads, 0, s>>>(
            src, dst, mean, inv_std, c, static_cast<int>(total));
  }
}

// elements per launch: below 2^31, whole groups of 16 and of c
long long chunk_of(int c) {
  const long long unit = static_cast<long long>(kVec) * c;
  return kChunk / unit * unit;
}

}  // namespace

// Plain C entry point, loaded with ctypes. src is `total` contiguous uint8
// values whose channel is (index % c); mean and inv_std are c float32
// values; dst is `total` float32 values, or bfloat16 when out_bf16 != 0,
// freshly allocated (16-byte aligned). Every pointer is a device pointer.
// Launches on `stream` (once, or once per 2^30 elements) and returns
// cudaGetLastError() as an int.
extern "C" int fused_normalize(const void* src, void* dst, const void* mean,
                               const void* inv_std, long long total, int c,
                               int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  const float* mu = static_cast<const float*>(mean);
  const float* is = static_cast<const float*>(inv_std);
  const long long chunk = chunk_of(c);
  for (long long at = 0; at < total; at += chunk) {
    const long long n = total - at < chunk ? total - at : chunk;
    if (out_bf16) {
      launch(in + at, static_cast<__nv_bfloat16*>(dst) + at, mu, is, c, n, s);
    } else {
      launch(in + at, static_cast<float*>(dst) + at, mu, is, c, n, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch floor of fused_normalize: an empty kernel on the grid the
// vector variant takes for (total, c, out_bf16), for timing beside it.
extern "C" int fused_normalize_empty(long long total, int c, int out_bf16,
                                     void* stream) {
  const unsigned int blocks =
      out_bf16 ? blocks_for<__nv_bfloat16, true>(total, c)
               : blocks_for<float, true>(total, c);
  fused_normalize_empty_kernel<<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
