// The row moves of a routed MLP's index dispatch, and the experts' bias
// gradient, for mmlspark_tpu_torch/ops/moe.py.
//
// Replaces no TPU kernel: the JAX package moves tokens to experts by
// one-hot einsums (mmlspark_tpu/models/zoo/moe.py). Here each (token,
// choice) pair k * S + t has a slot, its row in the (E * C, D) expert
// buffer, or -1 when capacity dropped it (ops/moe.py::index_plan):
//  - moe_permute: each token's fp32 row (the routed block's LayerNorm
//    output) into its kept slots, in bf16 (the slots no pair holds are the
//    caller's zeros);
//  - moe_unpermute: each token's kept slots' rows, times their gates when
//    gates are given, summed in fp32 (the combine; without gates, the
//    gather's backward);
//  - moe_unpermute_bwd: the combine's backward: each kept slot's row
//    gradient, its gate times the token's gradient, and each gate's
//    gradient, the dot of the token's gradient with its slot's row;
//  - moe_bias_grad: an expert bias's gradient, the column sums of the
//    (E, C, N) bf16 output gradient over its C rows, in fp32.
//
// Bound. HBM bytes: a token row is read once and each of its K slot rows
// written or read once; every slot has one owner, so no atomics. One warp
// a token, 16 bytes a lane a load; D a multiple of 8. The bias gradient
// reads C x N once, each column summed by one thread over a row group and
// the groups added in shared memory, in a fixed order.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // tokens a block

struct Row8 {
  float v[8];
};

__device__ __forceinline__ Row8 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return Row8{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ Row8 load8(const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  Row8 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    r.v[2 * i] = f.x;
    r.v[2 * i + 1] = f.y;
  }
  return r;
}

__device__ __forceinline__ void store8(float* p, const Row8& r) {
  reinterpret_cast<float4*>(p)[0] = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(r.v[4], r.v[5], r.v[6], r.v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const Row8& r) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(r.v[2 * i], r.v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kWarps * 32)
moe_permute_kernel(const float* __restrict__ src, const int* __restrict__ slot,
                   __nv_bfloat16* __restrict__ dst, int S, int D, int K) {
  const int t = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= S) return;
  const float* row = src + static_cast<long long>(t) * D;
  for (int c = lane * 8; c < D; c += 256) {
    const Row8 x = load8(row + c);
    for (int k = 0; k < K; ++k) {
      const int s = slot[k * S + t];
      if (s >= 0) store8(dst + static_cast<long long>(s) * D + c, x);
    }
  }
}

template <typename Dst>
__global__ void __launch_bounds__(kWarps * 32)
moe_unpermute_kernel(const __nv_bfloat16* __restrict__ src,
                     const int* __restrict__ slot,
                     const float* __restrict__ gates,
                     Dst* __restrict__ dst, int S, int D, int K) {
  const int t = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= S) return;
  for (int c = lane * 8; c < D; c += 256) {
    Row8 acc{};
    for (int k = 0; k < K; ++k) {
      const int s = slot[k * S + t];
      if (s < 0) continue;
      const float g = gates ? gates[t * K + k] : 1.f;
      const Row8 y = load8(src + static_cast<long long>(s) * D + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc.v[i] += g * y.v[i];
    }
    store8(dst + static_cast<long long>(t) * D + c, acc);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
moe_unpermute_bwd_kernel(const __nv_bfloat16* __restrict__ dy,
                         const __nv_bfloat16* __restrict__ ye,
                         const int* __restrict__ slot,
                         const float* __restrict__ gates,
                         __nv_bfloat16* __restrict__ d_ye,
                         float* __restrict__ d_gates, int S, int D, int K) {
  const int t = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= S) return;
  const __nv_bfloat16* go = dy + static_cast<long long>(t) * D;
  for (int k = 0; k < K; ++k) {
    const int s = slot[k * S + t];
    float dot = 0.f;
    if (s >= 0) {
      const float g = gates[t * K + k];
      const long long off = static_cast<long long>(s) * D;
      for (int c = lane * 8; c < D; c += 256) {
        const Row8 d = load8(go + c);
        const Row8 y = load8(ye + off + c);
        Row8 out;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dot += d.v[i] * y.v[i];
          out.v[i] = d.v[i] * g;
        }
        store8(d_ye + off + c, out);
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, m);
    if (lane == 0) d_gates[t * K + k] = dot;
  }
}

constexpr int kBiasCols = 64;    // columns a block: 32 lanes x 2
constexpr int kBiasGroups = 8;   // row groups a block, one a warp

__global__ void __launch_bounds__(kBiasGroups * 32)
moe_bias_grad_kernel(const __nv_bfloat16* __restrict__ g,
                     float* __restrict__ out, int C, int N) {
  __shared__ float part[kBiasGroups][kBiasCols];
  const int e = blockIdx.y;
  const int col = blockIdx.x * kBiasCols + 2 * (threadIdx.x % 32);
  const int group = threadIdx.x / 32;
  const __nv_bfloat16* base =
      g + static_cast<long long>(e) * C * N + col;
  float a0 = 0.f, a1 = 0.f;
  for (int row = group; row < C; row += kBiasGroups) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<
        const __nv_bfloat162*>(base + static_cast<long long>(row) * N));
    a0 += v.x;
    a1 += v.y;
  }
  part[group][2 * (threadIdx.x % 32)] = a0;
  part[group][2 * (threadIdx.x % 32) + 1] = a1;
  __syncthreads();
  if (threadIdx.x < kBiasCols) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kBiasGroups; ++r) sum += part[r][threadIdx.x];
    out[static_cast<long long>(e) * N + blockIdx.x * kBiasCols +
        threadIdx.x] = sum;
  }
}

unsigned token_blocks(int S) { return (S + kWarps - 1) / kWarps; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Rows are contiguous; D must be
// a multiple of 8 and row pointers 16-byte aligned. slot is (K * S,) int32,
// pair k * S + t; gates (S, K) fp32 contiguous. Each launches on `stream`
// and returns the CUDA error code as an int.

// src (S, D) fp32 -> its kept slots' rows of dst (rows, D) bf16
extern "C" int moe_permute(const void* src, const void* slot, void* dst,
                           int S, int D, int K, void* stream) {
  if (S == 0) return 0;
  if (D % 8 || !aligned16(src) || !aligned16(dst)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  moe_permute_kernel<<<token_blocks(S), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(slot),
      static_cast<__nv_bfloat16*>(dst), S, D, K);
  return static_cast<int>(cudaGetLastError());
}

// src (rows, D) bf16 -> dst (S, D) fp32 (dst_f32) or bf16: each token's
// kept slots' rows, times gates[t, k] when gates is not null, summed
extern "C" int moe_unpermute(const void* src, const void* slot,
                             const void* gates, void* dst, int S, int D,
                             int K, int dst_f32, void* stream) {
  if (S == 0) return 0;
  if (D % 8 || !aligned16(src) || !aligned16(dst)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const __nv_bfloat16*>(src);
  const int* sl = static_cast<const int*>(slot);
  const float* g = static_cast<const float*>(gates);
  if (dst_f32) {
    moe_unpermute_kernel<float><<<token_blocks(S), kWarps * 32, 0, s>>>(
        in, sl, g, static_cast<float*>(dst), S, D, K);
  } else {
    moe_unpermute_kernel<__nv_bfloat16><<<token_blocks(S), kWarps * 32, 0,
                                          s>>>(
        in, sl, g, static_cast<__nv_bfloat16*>(dst), S, D, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy (S, D) bf16, ye (rows, D) bf16 -> d_ye (rows, D) bf16 at the kept
// slots (the caller zeros the rest), d_gates (S, K) fp32 (0 for a dropped
// pair)
extern "C" int moe_unpermute_bwd(const void* dy, const void* ye,
                                 const void* slot, const void* gates,
                                 void* d_ye, void* d_gates, int S, int D,
                                 int K, void* stream) {
  if (S == 0) return 0;
  if (D % 8 || !aligned16(dy) || !aligned16(ye) || !aligned16(d_ye)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  moe_unpermute_bwd_kernel<<<token_blocks(S), kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(ye), static_cast<const int*>(slot),
      static_cast<const float*>(gates), static_cast<__nv_bfloat16*>(d_ye),
      static_cast<float*>(d_gates), S, D, K);
  return static_cast<int>(cudaGetLastError());
}

// g (E, C, N) bf16 contiguous -> out (E, N) fp32, N a multiple of 64
extern "C" int moe_bias_grad(const void* g, void* out, int E, int C, int N,
                             void* stream) {
  if (E == 0) return 0;
  if (N % kBiasCols) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / kBiasCols, E);
  moe_bias_grad_kernel<<<grid, kBiasGroups * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<float*>(out), C, N);
  return static_cast<int>(cudaGetLastError());
}
