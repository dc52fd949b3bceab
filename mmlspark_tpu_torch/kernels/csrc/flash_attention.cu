// K3 on Hopper: the flash-attention forward,
// out = softmax(q k^T / sqrt(D), causal -> -1e30) v, on (B, L, H, D).
//
// Replaces the Pallas TPU kernel
// mmlspark_tpu/ops/pallas_attention.py::flash_attention (forward
// _flash_forward, body _flash_kernel :38-82, pl.pallas_call :109) for f32
// inputs and bf16 with D > 128. What it computes is the same: q cast
// to fp32 and scaled by 1/sqrt(D), the fp32 scores q.k, masked with -1e30
// under the causal mask (never -inf, so a partly masked tile gives no NaN),
// an online max m and sum l per query row in fp32 with the accumulator
// acc rescaled by exp(m_old - m_new), and acc / max(l, 1e-30) stored in q's
// dtype. What the TPU imposed is dropped:
//  - the transposes to (B, H, L, D), there only for Mosaic's (8, 128)
//    tiling: q, k and v are read in place through their (b, l, h) strides
//    (the head dim must be contiguous);
//  - the sequential grid with K/V resident in VMEM for one (batch, head):
//    here one block per (query tile, head, batch), all in parallel, each
//    streaming its keys through shared memory in tiles of 64 rows;
//  - the 256 x 256 blocks: the query tile holds BQ rows, chosen from D so
//    that the fp32 accumulators stay in registers (BQ * D <= 8192 for
//    256 threads). Key tiles wholly in the causal future are skipped, as
//    the JAX kernel cuts its loop at the query block.
//
// D may be any multiple of 8 up to 2048 (supports(): L * D <= 2^20). The
// kernel is instantiated for D padded to a power of two from 16 to 2048;
// the padding columns of q, k and v are zero in shared memory, so they add
// nothing to a score, and the output skips them.
//
// Bound. Causal attention at the LM shape (B=8, L=2048, H=8, D=64) does
// 4 B H D L(L+1)/2 = 34.4 GFLOP on 67 MB of bf16 q, k, v and out: against
// the H100's dense bf16 tensor-core rate (989 TFLOP/s) and 3.35 TB/s that
// is 0.035 ms, bound by operations. This kernel keeps the JAX kernel's
// fp32 arithmetic (the score and the weighted sum in fp32, which tensor
// cores would round) on the fp32 pipes, whose 67 TFLOP/s bound the same
// work at 0.51 ms; the design aims at that: each thread holds a register
// tile of scores (rows x columns) and of accumulators (rows x head dims),
// so every shared-memory load feeds several FMAs, and the softmax row
// reductions are warp shuffles. This kernel serves the inputs the tensor
// cores do not: f32 q, k, v (the only route that holds the plain version's
// fp32 arithmetic to 2e-5) and bf16 with D > 128. bf16 with D <= 128 goes
// to flash_attention_wgmma.cu (wgmma with TMA-fed K/V tiles, p rounded to
// bf16 before p.v); ops/attention.py::_route picks the kernel.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBK = 64;  // key rows per tile

struct Strides {
  long long b, l, h;  // in elements; the head dim has stride 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Tile shape for D padded to DPAD. Threads form an SY x SX grid; thread
// (ty, tx) owns query rows ty + SY * a (a < RA), score columns tx + SX * c
// of each key tile (c < CB) and head dims tx + SX * c of each D chunk. A
// row's SX threads are lanes of one warp (SX is 16 or 32).
template <int DPAD, int BQ, int SY, int SX>
struct Tile {
  static constexpr int kThreads = SY * SX;
  static constexpr int kDC = DPAD < 64 ? DPAD : 64;  // D chunk in shared
  static constexpr int kChunks = DPAD / kDC;
  static constexpr int kRA = BQ / SY;    // query rows per thread
  static constexpr int kCB = kBK / SX;   // score columns per thread
  static constexpr int kCC = kDC / SX;   // head dims per thread per chunk
  static constexpr int kQStride = DPAD + 1;  // padded rows: no bank
  static constexpr int kKVStride = kDC + 1;  // conflicts between rows
  static constexpr int kPStride = kBK + 1;
  static constexpr size_t kSmemBytes =
      sizeof(float) *
      (BQ * kQStride + kBK * kKVStride + BQ * kPStride);
  static_assert(BQ % SY == 0 && kBK % SX == 0 && kDC % SX == 0, "tile");
  static_assert(SX == 16 || SX == 32, "a row's threads share one warp");
};

template <typename T, int DPAD, int BQ, int SY, int SX>
__global__ void __launch_bounds__(SY * SX)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Strides sq,
                 Strides sk, Strides sv, Strides so, int L, int D,
                 float scale, int causal) {
  using C = Tile<DPAD, BQ, SY, SX>;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [BQ][kQStride]
  float* kv_s = q_s + BQ * C::kQStride;       // [kBK][kKVStride], K then V
  float* p_s = kv_s + kBK * C::kKVStride;     // [BQ][kPStride]

  const int tid = threadIdx.x;
  const int ty = tid / SX, tx = tid % SX;
  // the last query tiles do the most causal work: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // the query tile, fp32, scaled as the JAX kernel scales it (:43)
  for (int e = tid; e < BQ * DPAD; e += C::kThreads) {
    const int r = e / DPAD, d = e % DPAD;
    q_s[r * C::kQStride + d] =
        d < D ? __fmul_rn(to_f32(qb[(q0 + r) * sq.l + d]), scale) : 0.f;
  }

  float m[C::kRA], l[C::kRA], acc[C::kRA][C::kChunks * C::kCC];
#pragma unroll
  for (int a = 0; a < C::kRA; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kChunks * C::kCC; ++c) acc[a][c] = 0.f;
  }

  int n_tiles = L / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + kBK - 1) / kBK);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;

    // scores s = q . k over D, one D chunk of K in shared memory at a time
    float s[C::kRA][C::kCB];
#pragma unroll
    for (int a = 0; a < C::kRA; ++a)
#pragma unroll
      for (int c = 0; c < C::kCB; ++c) s[a][c] = 0.f;
#pragma unroll 1
    for (int ch = 0; ch < C::kChunks; ++ch) {
      __syncthreads();  // the tile before is done with kv_s (and q_s is in)
      for (int e = tid; e < kBK * C::kDC; e += C::kThreads) {
        const int r = e / C::kDC, c = e % C::kDC, d = ch * C::kDC + c;
        kv_s[r * C::kKVStride + c] =
            d < D ? to_f32(kb[(k0 + r) * sk.l + d]) : 0.f;
      }
      __syncthreads();
      const float* qc = q_s + ch * C::kDC;
#pragma unroll 4
      for (int dd = 0; dd < C::kDC; ++dd) {
        float qv[C::kRA], kv[C::kCB];
#pragma unroll
        for (int a = 0; a < C::kRA; ++a)
          qv[a] = qc[(ty + SY * a) * C::kQStride + dd];
#pragma unroll
        for (int c = 0; c < C::kCB; ++c)
          kv[c] = kv_s[(tx + SX * c) * C::kKVStride + dd];
#pragma unroll
        for (int a = 0; a < C::kRA; ++a)
#pragma unroll
          for (int c = 0; c < C::kCB; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
      }
    }

    // mask, then the online softmax of each row; the row's SX threads
    // reduce with shuffles and all end with the same m and l
#pragma unroll
    for (int a = 0; a < C::kRA; ++a) {
      const int row = ty + SY * a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < C::kCB; ++c) {
        if (causal && k0 + tx + SX * c > q0 + row) s[a][c] = kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = SX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < C::kCB; ++c) {
        const float p = expf(s[a][c] - m_new);
        rs += p;
        p_s[row * C::kPStride + tx + SX * c] = p;
      }
#pragma unroll
      for (int off = SX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[a] - m_new);
      l[a] = l[a] * corr + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < C::kChunks * C::kCC; ++c) acc[a][c] *= corr;
    }

    // acc += p . v, one D chunk of V in shared memory at a time (unrolled,
    // so acc stays in registers)
#pragma unroll
    for (int ch = 0; ch < C::kChunks; ++ch) {
      __syncthreads();  // p_s written; every thread is done reading K
      for (int e = tid; e < kBK * C::kDC; e += C::kThreads) {
        const int r = e / C::kDC, c = e % C::kDC, d = ch * C::kDC + c;
        kv_s[r * C::kKVStride + c] =
            d < D ? to_f32(vb[(k0 + r) * sv.l + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        float pv[C::kRA];
#pragma unroll
        for (int a = 0; a < C::kRA; ++a)
          pv[a] = p_s[(ty + SY * a) * C::kPStride + j];
#pragma unroll
        for (int c = 0; c < C::kCC; ++c) {
          const float vv = kv_s[j * C::kKVStride + tx + SX * c];
#pragma unroll
          for (int a = 0; a < C::kRA; ++a)
            acc[a][ch * C::kCC + c] = fmaf(pv[a], vv, acc[a][ch * C::kCC + c]);
        }
      }
    }
  }

  T* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int a = 0; a < C::kRA; ++a) {
    const int row = q0 + ty + SY * a;
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int ch = 0; ch < C::kChunks; ++ch)
#pragma unroll
      for (int c = 0; c < C::kCC; ++c) {
        const int d = ch * C::kDC + tx + SX * c;
        if (d < D)
          store(ob + row * so.l + d, __fdiv_rn(acc[a][ch * C::kCC + c], denom));
      }
  }
}

template <typename T, int DPAD, int BQ, int SY, int SX>
cudaError_t run(const T* q, const T* k, const T* v, T* out, int b, int L,
                int h, int D, Strides sq, Strides sk, Strides sv, float scale,
                int causal, cudaStream_t stream) {
  using C = Tile<DPAD, BQ, SY, SX>;
  auto kernel = flash_fwd_kernel<T, DPAD, BQ, SY, SX>;
  // above 48 KB a block's shared memory must be asked for, once per
  // instantiation (before any stream capture)
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kSmemBytes));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const Strides so{static_cast<long long>(L) * h * D,
                   static_cast<long long>(h) * D, D};
  const dim3 grid(L / BQ, h, b);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      q, k, v, out, sq, sk, sv, so, L, D, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const T* q, const T* k, const T* v, T* out, int b,
                     int L, int h, int D, Strides sq, Strides sk, Strides sv,
                     float scale, int causal, cudaStream_t s) {
  int dpad = 16;
  while (dpad < D) dpad *= 2;
  switch (dpad) {  // BQ * DPAD <= 8192: at most 32 (64 at D=2048) acc/thread
    case 16: return run<T, 16, 64, 16, 16>(q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 32: return run<T, 32, 64, 16, 16>(q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 64: return run<T, 64, 64, 16, 16>(q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 128: return run<T, 128, 64, 16, 16>(q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 256: return run<T, 256, 32, 16, 16>(q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 512: return run<T, 512, 16, 16, 16>(q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 1024: return run<T, 1024, 8, 8, 32>(q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 2048: return run<T, 2048, 4, 4, 32>(q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. q, k, v are (b, l, h, d) device
// tensors of one dtype (float32, or bfloat16 when bf16 != 0) whose head dim
// is contiguous, read through their (b, l, h) strides in elements; out is a
// fresh contiguous (b, l, h, d) tensor of the same dtype. l must be a
// multiple of 64 and d a multiple of 8 up to 2048 (the wrapper enforces
// supports()). scale is 1/sqrt(d). Launches on `stream` and returns the
// CUDA error code as an int.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int l, int h, int d,
                               long long qsb, long long qsl, long long qsh,
                               long long ksb, long long ksl, long long ksh,
                               long long vsb, long long vsl, long long vsh,
                               float scale, int causal, int bf16,
                               void* stream) {
  if (b == 0 || h == 0) return 0;
  if (l % kBK != 0 || d % 8 != 0 || d > 2048) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{qsb, qsl, qsh}, sk{ksb, ksl, ksh}, sv{vsb, vsl, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = dispatch(static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v),
                   static_cast<__nv_bfloat16*>(out), b, l, h, d, sq, sk, sv,
                   scale, causal, s);
  } else {
    err = dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(out), b,
                   l, h, d, sq, sk, sv, scale, causal, s);
  }
  return static_cast<int>(err);
}
