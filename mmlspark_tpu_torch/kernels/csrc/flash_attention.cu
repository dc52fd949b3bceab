// K3 on Hopper's fp32 CUDA cores: the flash-attention forward,
// out = softmax(q k^T / sqrt(D), causal -> -1e30) v, on (B, L, H, D).
//
// Replaces the Pallas TPU kernel
// mmlspark_tpu/ops/pallas_attention.py::flash_attention (forward
// _flash_forward, body _flash_kernel :38-82, pl.pallas_call :109) for f32
// inputs and bf16 with D > 128 (ops/attention.py::_route; bf16 with
// D <= 128 goes to flash_attention_wgmma.cu). What it computes is the
// same: q cast to fp32 and scaled by 1/sqrt(D) (__fmul_rn, one rounding),
// the fp32 scores q.k, masked with -1e30 under the causal mask (never -inf,
// so a partly masked tile gives no NaN), an online max m and sum l per
// query row in fp32 with the accumulator acc rescaled by exp(m_old - m_new)
// (expf, as the plain version's torch.exp), and acc / max(l, 1e-30)
// (__fdiv_rn) stored in q's dtype. Every product is an fp32 FMA: the tensor
// cores would round q, k or p, and the plain version's fp32 arithmetic is
// held to 2e-5. What the TPU imposed is dropped: the transposes to
// (B, H, L, D) (q, k and v are read in place through their (b, l, h)
// strides; the head dim must be contiguous) and the sequential grid with
// K/V resident in VMEM: here one block per (query tile, head, batch), all
// in parallel, the heaviest causal query tiles first, each streaming its
// keys in tiles of 64 rows; key tiles wholly in the causal future are
// skipped and only the tiles that cross the diagonal are masked.
//
// Bound. Causal attention at the LM shape (B=8, L=2048, H=8, D=64) does
// 4 B H D L(L+1)/2 = 34.4 GFLOP; on the fp32 pipes (67 TFLOP/s) that is
// 0.51 ms, against 0.040 ms for its 134 MB of f32 q, k, v and out at
// 3.35 TB/s: bound by operations, at every D this kernel takes. An FMA
// pipe that is kept busy needs its operands from registers: each SM
// issues 128 FMAs a clock but loads 32 words a clock from shared memory,
// so a kernel that loads one word per FMA or two runs at the rate of its
// shared-memory loads. The design is an SGEMM's:
//  - register micro-tiles. Each thread holds RM query rows x CN key
//    columns of the score tile and RM rows x D/TX head dims of the output,
//    and every shared load is 16 bytes (float4) where the tile allows it.
//    The layouts in shared memory: Q transposed ([D][BQ+4], already
//    scaled, fp32), so a thread's rows come in one float4 per head dim; K
//    and V row-major ([64][DC+4], the head dims of one chunk), so a
//    thread's key reads a float4 of four head dims (its CN keys are
//    TX apart, and rows DC+4 floats apart fall on distinct banks); P
//    written transposed ([64][BQ+4]), so p.v reads a float4 of rows per
//    key. Rows are padded by 4 floats, so float4 accesses of
//    neighbouring lanes stay free of bank conflicts.
//  - K/V tiles prefetched. A stage is one chunk of DC head dims of K, or
//    of V, for 64 keys; the stage after the current one is in flight
//    while the current one's FMAs run, into the other of two buffers, and
//    each stage costs one barrier. f32 stages are cp.async copies straight
//    into the buffer (no conversion, no transpose: K is kept row-major);
//    bf16 stages are register-staged (16-byte global loads issued before
//    the FMAs, converted to fp32 and stored after them; a bf16 view off
//    16-byte alignment loads its elements when the stage is needed, since
//    a stage of single bf16 values held in registers spills).
//  - one kernel, two load widths, chosen on the host from the base
//    pointers and strides of k and v: 16 bytes where they allow it, else
//    one element (4 bytes f32, 2 bytes bf16), so every view the wrapper
//    admits (strided, fused-qkv, misaligned) is read in place.
//
// Tiles by padded head dim (D padded to a power of two, 16..2048; the
// padding columns are zero in shared memory and the output skips them).
// 256 threads a block (128 at D = 64, so three blocks share an SM and
// one's barrier leaves the FMA pipes to the others: 7% faster at the LM
// shape than 128 query rows over 256 threads), as TY x TX; a row's TX
// threads are lanes of one warp, so the softmax row reductions are
// shuffles. "FMAs / word" is the FMAs per shared-memory word loaded, q.k
// then p.v (the kernel before this design: 2 and 2 at D <= 128, 0.8 and
// 0.8 at D = 512):
//
//   D      BQ   TY x TX  RM x CN  DC   acc/thread  FMAs/word     smem KB
//   16     128  16 x 16  8 x 4    16     8         2.67, 0.89      52
//   32     128  16 x 16  8 x 4    32    16         2.67, 1.6       69
//   64      64   8 x 16  8 x 4    64    32         2.67, 2.67       70
//   128    128  16 x 16  8 x 4   128    64         2.67, 2.67      169
//   256     64  16 x 16  4 x 4   128    64         2,    2.67      155
//   512     32   8 x 32  4 x 2   128    64         1.33, 2         150
//   1024    16   8 x 32  2 x 2   128    64         1,    1.33      155
//   2048     8   8 x 32  1 x 2   128    64         0.67, 0.8       169
//
// At D >= 256 the output tile bounds the query tile: BQ x D accumulators
// over 256 threads stay at 64 a thread, so BQ falls as D grows, and with
// it the FMAs per word of q.k (splitting q.k's D reduction across warp
// groups would keep a larger score tile; it is not done here). No
// instantiation may spill (chip_smoke.py checks ptxas's report of every
// one).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBK = 64;  // key rows per tile

struct Strides {
  long long b, l, h;  // in elements; the head dim has stride 1
};

// The tile shape for D padded to DPAD (the table above). MINB is the
// blocks an SM should hold (__launch_bounds__).
template <int DPAD> struct Config;
#define K3_CONFIG(DPAD_, BQ_, TY_, TX_, DC_, MINB_)                     \
  template <> struct Config<DPAD_> {                                    \
    static constexpr int kDPad = DPAD_, kBQ = BQ_, kTY = TY_, kTX = TX_, \
                         kDC = DC_, kMinBlocks = MINB_;                 \
  };
K3_CONFIG(16, 128, 16, 16, 16, 2)
K3_CONFIG(32, 128, 16, 16, 32, 2)
K3_CONFIG(64, 64, 8, 16, 64, 1)
K3_CONFIG(128, 128, 16, 16, 128, 1)
K3_CONFIG(256, 64, 16, 16, 128, 1)
K3_CONFIG(512, 32, 8, 32, 128, 1)
K3_CONFIG(1024, 16, 8, 32, 128, 1)
K3_CONFIG(2048, 8, 8, 32, 128, 1)
#undef K3_CONFIG

// What follows from a Config. Thread (ty, tx) owns query rows
// g * TY * RW + ty * RW + r (g < RM / RW, r < RW), score columns
// tx + TX * i (i < CN) of each key tile, and head dims
// g * TX * DW + tx * DW + i (g < DN / DW, i < DW) of each chunk of DC.
template <typename C>
struct Tile {
  static constexpr int kDPad = C::kDPad, kBQ = C::kBQ, kTY = C::kTY,
                       kTX = C::kTX, kDC = C::kDC;
  static constexpr int kThreads = kTY * kTX;
  static constexpr int kRM = kBQ / kTY;          // query rows per thread
  static constexpr int kRW = kRM < 4 ? kRM : 4;  // rows per shared load
  static constexpr int kCN = kBK / kTX;          // score columns per thread
  static constexpr int kChunks = kDPad / kDC;
  static constexpr int kDN = kDC / kTX;          // head dims per thread per chunk
  static constexpr int kDW = kDN < 4 ? kDN : 4;  // head dims per shared load
  static constexpr int kQS = kBQ + 4;            // Q^T [DPAD][kQS]
  static constexpr int kPS = kBQ + 4;            // P^T [kBK][kPS]
  static constexpr int kKS = kDC + 4;            // K or V chunk [kBK][kKS]
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kDPad * kQS + kBK * kPS + 2 * kBK * kKS);
  static_assert(kTX == 16 || kTX == 32, "a row's threads share one warp");
  static_assert(kBQ % kTY == 0 && kRM % kRW == 0 && kBK % kTX == 0 &&
                    kDC % kTX == 0 && kDN % kDW == 0 && kDC % 4 == 0,
                "tile");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");

  __device__ static int row(int ty, int a) {
    return (a / kRW) * kTY * kRW + ty * kRW + a % kRW;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// W consecutive floats of shared memory (aligned to 4 W bytes) in, or out
template <int W>
__device__ __forceinline__ void lds(float* v, const float* p) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int W>
__device__ __forceinline__ void sts(float* p, const float* v) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// One stage: keys k0..k0+63 of K or V, head dims d0..d0+DC, into an fp32
// [kBK][DC + 4] buffer, head dims >= D as zeros. start() issues the loads;
// commit() completes them into the buffer (the one start() was given).
// WIDE loads 16 bytes at a time, else one element.
template <typename T, bool WIDE, int DC, int NT>
struct Stage;

// f32: cp.async into the buffer; a head dim past D copies 0 source bytes,
// which fills zeros
template <bool WIDE, int DC, int NT>
struct Stage<float, WIDE, DC, NT> {
  static constexpr int kVec = WIDE ? 4 : 1;
  static constexpr int kUnits = kBK * DC / kVec;
  static constexpr int kPer = (kUnits + NT - 1) / NT;

  __device__ __forceinline__ void start(float* buf, const float* src,
                                        long long sl, int k0, int d0, int D,
                                        int tid) {
    // not unrolled: unrolled, the compiler keeps every unit's address of
    // every chunk in registers across the whole key loop
#pragma unroll 1
    for (int i = 0; i < kPer; ++i) {
      const int u = tid + NT * i;
      if (kUnits % NT != 0 && u >= kUnits) break;
      const int r = u / (DC / kVec), c = u % (DC / kVec) * kVec;
      const bool in = d0 + c < D;
      const float* g = in ? src + (k0 + r) * sl + d0 + c : src;
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(buf + r * (DC + 4) + c));
      if constexpr (WIDE) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         dst),
                     "l"(g), "r"(in ? 16 : 0));
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         dst),
                     "l"(g), "r"(in ? 4 : 0));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  __device__ __forceinline__ void commit(float*) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
};

// bf16, 16 bytes: loads into registers before the FMAs, converted to fp32
// (exactly: a bf16 is the top half of an fp32) and stored after them
template <int DC, int NT>
struct Stage<__nv_bfloat16, true, DC, NT> {
  static constexpr int kUnits = kBK * DC / 8;
  static constexpr int kPer = (kUnits + NT - 1) / NT;
  uint4 raw[kPer];
  int tid;

  __device__ __forceinline__ void start(float*, const __nv_bfloat16* src,
                                        long long sl, int k0, int d0, int D,
                                        int tid_) {
    tid = tid_;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = tid + NT * i;
      if (kUnits % NT != 0 && u >= kUnits) break;
      const int r = u / (DC / 8), c = u % (DC / 8) * 8;
      raw[i] = d0 + c < D ? *reinterpret_cast<const uint4*>(
                                src + (k0 + r) * sl + d0 + c)
                          : uint4{};
    }
  }
  __device__ __forceinline__ void commit(float* buf) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = tid + NT * i;
      if (kUnits % NT != 0 && u >= kUnits) break;
      const int r = u / (DC / 8), c = u % (DC / 8) * 8;
      const unsigned w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
      float f[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[2 * j] = __uint_as_float(w[j] << 16);
        f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
      float* dst = buf + r * (DC + 4) + c;
      sts<4>(dst, f);
      sts<4>(dst + 4, f + 4);
    }
  }
};

// bf16, one element at a time (a view off 16-byte alignment): the loads
// wait for commit(), which loads, converts and stores, since holding a
// stage of single bf16 values in registers across the FMAs spills
template <int DC, int NT>
struct Stage<__nv_bfloat16, false, DC, NT> {
  const __nv_bfloat16* src;
  long long sl;
  int k0, d0, D, tid;

  __device__ __forceinline__ void start(float*, const __nv_bfloat16* src_,
                                        long long sl_, int k0_, int d0_,
                                        int D_, int tid_) {
    src = src_, sl = sl_, k0 = k0_, d0 = d0_, D = D_, tid = tid_;
  }
  __device__ __forceinline__ void commit(float* buf) {
#pragma unroll 4
    for (int u = tid; u < kBK * DC; u += NT) {
      const int r = u / DC, c = u % DC;
      buf[r * (DC + 4) + c] =
          d0 + c < D ? __bfloat162float(src[(k0 + r) * sl + d0 + c]) : 0.f;
    }
  }
};

// s += Q^T(rows, this chunk's head dims) . K chunk(columns)
template <typename TL>
__device__ __forceinline__ void scores(float (&s)[TL::kRM][TL::kCN],
                                       const float* q_c, const float* k_c,
                                       int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < TL::kDC; d += 4) {
    float kv[TL::kCN][4];
#pragma unroll
    for (int i = 0; i < TL::kCN; ++i)
      lds<4>(kv[i], k_c + (tx + TL::kTX * i) * TL::kKS + d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float qv[TL::kRM];
#pragma unroll
      for (int g = 0; g < TL::kRM / TL::kRW; ++g)
        lds<TL::kRW>(qv + g * TL::kRW, q_c + (d + e) * TL::kQS +
                                           g * TL::kTY * TL::kRW +
                                           ty * TL::kRW);
#pragma unroll
      for (int a = 0; a < TL::kRM; ++a)
#pragma unroll
        for (int i = 0; i < TL::kCN; ++i)
          s[a][i] = fmaf(qv[a], kv[i][e], s[a][i]);
    }
  }
}

// acc(rows, chunk CH's head dims) += P^T(keys, rows)^T . V chunk
template <typename TL, int CH, int NACC>
__device__ __forceinline__ void weigh(float (&acc)[TL::kRM][NACC],
                                      const float* p_s, const float* v_c,
                                      int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    float pv[TL::kRM], vv[TL::kDN];
#pragma unroll
    for (int g = 0; g < TL::kRM / TL::kRW; ++g)
      lds<TL::kRW>(pv + g * TL::kRW,
                   p_s + j * TL::kPS + g * TL::kTY * TL::kRW + ty * TL::kRW);
#pragma unroll
    for (int g = 0; g < TL::kDN / TL::kDW; ++g)
      lds<TL::kDW>(vv + g * TL::kDW,
                   v_c + j * TL::kKS + g * TL::kTX * TL::kDW + tx * TL::kDW);
#pragma unroll
    for (int a = 0; a < TL::kRM; ++a)
#pragma unroll
      for (int n = 0; n < TL::kDN; ++n)
        acc[a][CH * TL::kDN + n] =
            fmaf(pv[a], vv[n], acc[a][CH * TL::kDN + n]);
  }
}

// the V stages of one key tile, chunk CH onwards (unrolled at compile
// time, so the accumulators stay in registers); the last one starts the
// next tile's first K stage
template <typename TL, int CH, typename S, typename T, int NACC>
__device__ __forceinline__ void weigh_chunks(
    S& stage, float*& cur, float*& nxt, float (&acc)[TL::kRM][NACC],
    const float* p_s, const T* kb, const T* vb, long long skl, long long svl,
    int k0, bool more, int D, int tid, int ty, int tx) {
  if constexpr (CH < TL::kChunks) {
    stage.commit(cur);
    __syncthreads();
    if constexpr (CH + 1 < TL::kChunks) {
      stage.start(nxt, vb, svl, k0, (CH + 1) * TL::kDC, D, tid);
    } else if (more) {
      stage.start(nxt, kb, skl, k0 + kBK, 0, D, tid);
    }
    weigh<TL, CH>(acc, p_s, cur, ty, tx);
    float* t = cur;
    cur = nxt;
    nxt = t;
    weigh_chunks<TL, CH + 1>(stage, cur, nxt, acc, p_s, kb, vb, skl, svl, k0,
                             more, D, tid, ty, tx);
  }
}

template <typename T, bool WIDE, typename C>
__global__ void __launch_bounds__(C::kTY * C::kTX, C::kMinBlocks)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Strides sq,
                 Strides sk, Strides sv, Strides so, int L, int D,
                 float scale, int causal) {
  using TL = Tile<C>;
  constexpr int RM = TL::kRM, RW = TL::kRW, CN = TL::kCN, TX = TL::kTX;
  constexpr int NACC = TL::kChunks * TL::kDN;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);    // Q^T [DPAD][kQS]
  float* p_s = q_s + TL::kDPad * TL::kQS;          // P^T [kBK][kPS]
  float* cur = p_s + kBK * TL::kPS;                // K / V stages [kBK][kKS]
  float* nxt = cur + kBK * TL::kKS;

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  // the last query tiles do the most causal work: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TL::kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  int n_tiles = L / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + TL::kBQ + kBK - 1) / kBK);
  Stage<T, WIDE, TL::kDC, TL::kThreads> stage;
  stage.start(cur, kb, sk.l, 0, 0, D, tid);

  // the query tile, transposed, fp32, scaled as the JAX kernel scales it
  // (:43)
  for (int e = tid; e < TL::kBQ * TL::kDPad; e += TL::kThreads) {
    const int r = e / TL::kDPad, d = e % TL::kDPad;
    q_s[d * TL::kQS + r] =
        d < D ? __fmul_rn(to_f32(qb[(q0 + r) * sq.l + d]), scale) : 0.f;
  }

  float m[RM], l[RM], acc[RM][NACC];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NACC; ++c) acc[a][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;

    // s = q . k, one chunk of head dims a stage; the last K stage starts
    // the tile's first V stage
    float s[RM][CN];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int i = 0; i < CN; ++i) s[a][i] = 0.f;
#pragma unroll 1
    for (int ch = 0; ch < TL::kChunks; ++ch) {
      stage.commit(cur);
      __syncthreads();  // the stage is in; every thread is done with nxt
      if (ch + 1 < TL::kChunks) {
        stage.start(nxt, kb, sk.l, k0, (ch + 1) * TL::kDC, D, tid);
      } else {
        stage.start(nxt, vb, sv.l, k0, 0, D, tid);
      }
      scores<TL>(s, q_s + ch * TL::kDC * TL::kQS, cur, ty, tx);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }

    // mask (only a tile that crosses the diagonal), then the online
    // softmax of each row; the row's TX threads reduce with shuffles and
    // all end with the same m and l. p goes to P^T, which every thread
    // finished reading before this tile's first barrier.
    const bool diag = causal && k0 + kBK - 1 > q0;
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int row = q0 + TL::row(ty, a);
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < CN; ++i) {
        if (diag && k0 + tx + TX * i > row) s[a][i] = kNegInf;
        mx = fmaxf(mx, s[a][i]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < CN; ++i) {
        s[a][i] = expf(s[a][i] - m_new);
        rs += s[a][i];
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[a] - m_new);
      l[a] = l[a] * corr + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NACC; ++c) acc[a][c] *= corr;
    }
#pragma unroll
    for (int i = 0; i < CN; ++i)
#pragma unroll
      for (int g = 0; g < RM / RW; ++g) {
        float pv[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) pv[r] = s[g * RW + r][i];
        sts<RW>(p_s + (tx + TX * i) * TL::kPS + g * TL::kTY * RW + ty * RW,
                pv);
      }

    // acc += p . v, one chunk of head dims a stage (its first barrier
    // also publishes P^T)
    weigh_chunks<TL, 0>(stage, cur, nxt, acc, p_s, kb, vb, sk.l, sv.l, k0,
                        t + 1 < n_tiles, D, tid, ty, tx);
  }

  T* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int row = q0 + TL::row(ty, a);
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int ch = 0; ch < TL::kChunks; ++ch)
#pragma unroll
      for (int g = 0; g < TL::kDN / TL::kDW; ++g)
#pragma unroll
        for (int i = 0; i < TL::kDW; ++i) {
          const int d = ch * TL::kDC + g * TX * TL::kDW + tx * TL::kDW + i;
          if (d < D)
            store(ob + row * so.l + d,
                  __fdiv_rn(acc[a][ch * TL::kDN + g * TL::kDW + i], denom));
        }
  }
}

template <typename T, bool WIDE, typename C>
cudaError_t run(const T* q, const T* k, const T* v, T* out, int b, int L,
                int h, int D, Strides sq, Strides sk, Strides sv, float scale,
                int causal, cudaStream_t stream) {
  using TL = Tile<C>;
  if (L % TL::kBQ != 0) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<T, WIDE, C>;
  // above 48 KB a block's shared memory must be asked for, once per
  // instantiation (before any stream capture)
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(TL::kSmemBytes));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const Strides so{static_cast<long long>(L) * h * D,
                   static_cast<long long>(h) * D, D};
  const dim3 grid(L / TL::kBQ, h, b);
  kernel<<<grid, TL::kThreads, TL::kSmemBytes, stream>>>(
      q, k, v, out, sq, sk, sv, so, L, D, scale, causal);
  return cudaGetLastError();
}

// 16-byte loads of K and V where both base addresses are 16-byte aligned
// and their (b, l, h) strides are multiples of 16 bytes (D, a multiple of
// 8, keeps every 16-byte unit inside the head dim)
template <typename T>
bool wide_ok(const T* p, Strides s) {
  constexpr long long vec = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % vec == 0 &&
         s.l % vec == 0 && s.h % vec == 0;
}

template <typename T, int DPAD>
cudaError_t launch(bool wide, const T* q, const T* k, const T* v, T* out,
                   int b, int L, int h, int D, Strides sq, Strides sk,
                   Strides sv, float scale, int causal, cudaStream_t s) {
  using C = Config<DPAD>;
  return wide ? run<T, true, C>(q, k, v, out, b, L, h, D, sq, sk, sv, scale,
                                causal, s)
              : run<T, false, C>(q, k, v, out, b, L, h, D, sq, sk, sv, scale,
                                 causal, s);
}

template <typename T>
cudaError_t dispatch(const T* q, const T* k, const T* v, T* out, int b,
                     int L, int h, int D, Strides sq, Strides sk, Strides sv,
                     float scale, int causal, cudaStream_t s) {
  const bool wide = wide_ok(k, sk) && wide_ok(v, sv);
  int dpad = 16;
  while (dpad < D) dpad *= 2;
  switch (dpad) {
    case 16: return launch<T, 16>(wide, q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 32: return launch<T, 32>(wide, q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 64: return launch<T, 64>(wide, q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 128: return launch<T, 128>(wide, q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 256: return launch<T, 256>(wide, q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 512: return launch<T, 512>(wide, q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 1024: return launch<T, 1024>(wide, q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    case 2048: return launch<T, 2048>(wide, q, k, v, out, b, L, h, D, sq, sk, sv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. q, k, v are (b, l, h, d) device
// tensors of one dtype (float32, or bfloat16 when bf16 != 0) whose head dim
// is contiguous, read through their (b, l, h) strides in elements; out is a
// fresh contiguous (b, l, h, d) tensor of the same dtype. l must be a
// multiple of the query tile (128 at most; supports() gives multiples of
// 256) and d a multiple of 8 up to 2048. scale is 1/sqrt(d). Launches on
// `stream` and returns the CUDA error code as an int.
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
