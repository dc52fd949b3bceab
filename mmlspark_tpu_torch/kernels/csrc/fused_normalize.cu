// K1 on Hopper: per-channel normalize of a uint8 image batch,
// (float(x) - mean[c]) * inv_std[c], stored as bfloat16 or float32.
//
// Replaces the Pallas TPU kernel
// mmlspark_tpu/ops/pallas_preprocess.py::fused_normalize (body
// _normalize_kernel). On the TPU the batch was padded to a multiple of 8
// rows (the sublane tiling), the uint8 went through int32 (Mosaic has no
// direct uint8 -> float cast) and mean / inv_std were tiled on the host
// into full-row vectors, so each lane read its own constant. Here none of
// that is needed: the element's channel is its flat index modulo C, and
// mean / inv_std are C-length fp32 arrays that stay in L1.
//
// Bound. One elementwise pass: each input byte is read once and each
// output written once. At the training path's shape (B=256, 32x32x3 uint8
// -> bf16) that is 2,359,296 bytes, 0.70 us at the H100's 3.35 TB/s; two
// fp32 operations per element is far below the card's fp32 rate, so the
// kernel is bound by bytes, and at that small size by launch latency. The
// design moves each byte once with wide accesses: a thread loads 16 input
// bytes with one 16-byte load and stores its 16 outputs with 16-byte
// stores (two for bf16, four for fp32). A misaligned input (a view that
// does not start on 16 bytes) takes a one-element-per-thread variant, and
// the last partial group of 16 is finished element by element.
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

constexpr int kVec = 16;  // uint8 elements per thread on the vector path

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

template <typename OutT>
__global__ void fused_normalize_vec_kernel(
    const uint8_t* __restrict__ src, OutT* __restrict__ dst,
    const float* __restrict__ mean, const float* __restrict__ inv_std,
    int c, long long total) {
  const long long base =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) * kVec;
  if (base >= total) return;
  int ch = static_cast<int>(base % c);
  if (base + kVec <= total) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + base));
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
    float v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      v[k] = normalize(bytes[k], __ldg(mean + ch), __ldg(inv_std + ch));
      ch = (ch + 1 == c) ? 0 : ch + 1;
    }
    store16(dst + base, v);
  } else {  // the tail: fewer than 16 elements left
    for (long long i = base; i < total; ++i) {
      store_one(dst + i, normalize(src[i], __ldg(mean + ch),
                                   __ldg(inv_std + ch)));
      ch = (ch + 1 == c) ? 0 : ch + 1;
    }
  }
}

template <typename OutT>
__global__ void fused_normalize_scalar_kernel(
    const uint8_t* __restrict__ src, OutT* __restrict__ dst,
    const float* __restrict__ mean, const float* __restrict__ inv_std,
    int c, long long total) {
  const long long i =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int ch = static_cast<int>(i % c);
  store_one(dst + i, normalize(src[i], __ldg(mean + ch), __ldg(inv_std + ch)));
}

template <typename OutT>
void launch(const uint8_t* src, OutT* dst, const float* mean,
            const float* inv_std, int c, long long total, cudaStream_t s) {
  const int threads = 256;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const long long groups = (total + kVec - 1) / kVec;
    const unsigned int blocks =
        static_cast<unsigned int>((groups + threads - 1) / threads);
    fused_normalize_vec_kernel<OutT><<<blocks, threads, 0, s>>>(
        src, dst, mean, inv_std, c, total);
  } else {
    const unsigned int blocks =
        static_cast<unsigned int>((total + threads - 1) / threads);
    fused_normalize_scalar_kernel<OutT><<<blocks, threads, 0, s>>>(
        src, dst, mean, inv_std, c, total);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. src is `total` contiguous uint8
// values whose channel is (index % c); mean and inv_std are c float32
// values; dst is `total` float32 values, or bfloat16 when out_bf16 != 0,
// freshly allocated (16-byte aligned). Every pointer is a device pointer.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int fused_normalize(const void* src, void* dst, const void* mean,
                               const void* inv_std, long long total, int c,
                               int out_bf16, void* stream) {
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  const float* mu = static_cast<const float*>(mean);
  const float* is = static_cast<const float*>(inv_std);
  if (out_bf16) {
    launch(in, static_cast<__nv_bfloat16*>(dst), mu, is, c, total, s);
  } else {
    launch(in, static_cast<float*>(dst), mu, is, c, total, s);
  }
  return static_cast<int>(cudaGetLastError());
}
