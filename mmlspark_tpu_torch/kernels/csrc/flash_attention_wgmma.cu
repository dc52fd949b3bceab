// K3 on Hopper's tensor cores: the flash-attention forward for bf16 q, k
// and v, out = softmax(q k^T / sqrt(D), causal -> -1e30) v, on (B, L, H, D)
// with D a multiple of 8 up to 128.
//
// Replaces the Pallas TPU kernel
// mmlspark_tpu/ops/pallas_attention.py::flash_attention (body _flash_kernel
// :38-82, pl.pallas_call :109) for those inputs; flash_attention.cu, the
// fp32 CUDA-core design, keeps f32 inputs and D > 128. It computes
// _flash_kernel's function: fp32 scores masked with -1e30 under the causal
// mask (never -inf), an fp32 online max m and sum l per query row with the
// accumulator rescaled at every key tile, key tiles wholly in the causal
// future skipped, and acc / max(l, 1e-30) stored in bf16. Its arithmetic
// differs in three places, each within the gate stated in chip_smoke.py:
//  - q.k is a bf16 product summed in fp32 by the tensor cores;
//  - 1/sqrt(D) and log2(e) are folded into one fp32 multiply of the score,
//    and the exponentials are exp2;
//  - the probabilities p are rounded to bf16 before p.v, as the reference
//    path (full_attention(use_flash="never")) rounds them; l sums the fp32 p.
//
// Bound. At the LM shape (B=8, L=2048, H=8, D=64, causal) the two products
// do 4 B H D L(L+1)/2 = 34.4 GFLOP on 67 MB of q, k, v and out: 0.0348 ms at
// the H100's dense bf16 tensor-core rate (989 TFLOP/s) against 0.020 ms at
// 3.35 TB/s, so operations bound it. The design keeps the tensor cores fed:
//  - one block per 128 query rows of one (batch, head): two consumer
//    warpgroups of 64 rows each and one producer warp; blocks of the last
//    (heaviest causal) query tiles are scheduled first;
//  - the producer warp keeps TMA loads of K and V tiles in flight through a
//    ring of four shared-memory stages guarded by full/empty mbarriers. Each
//    tensor map covers (D, L, H, B) with the view's own strides, so strided
//    q, k, v (a fused qkv unbind) are read in place; boxes are 64 head dims
//    wide (128 bytes, the 128-byte swizzle's limit; D = 128 takes two), and
//    TMA's out-of-bounds fill pads D to 64 or 128 with zeros;
//  - S = Q K^T by wgmma m64nBKk16 with both operands in shared memory
//    (K-major); the online softmax in registers, the row max and sum across
//    each row's quad by shuffles, masking only on diagonal tiles, one FMA
//    and one ex2 a probability;
//  - P converted to bf16 in the accumulator's register layout is the
//    register A operand of O += P V (wgmma m64n64k16, V the MN-major B
//    operand); O stays in fp32 registers, 32 a thread per 64 head dims;
//  - each warpgroup issues Q K_t^T and P_{t-1} V_{t-1} together and runs the
//    softmax of tile t while P_{t-1} V_{t-1} is on the tensor cores (two
//    sets of P registers), so the exponentials, which cost about as much as
//    the products at D = 64, overlap them.
// Key tiles are 128 rows at D <= 64 and 64 at D = 128, so scores, P and O
// fit the registers of one block a multiprocessor without spilling.
//
// The tensor maps are encoded on the host at every call (through
// cudaGetDriverEntryPoint, so nothing links libcuda) and passed by value as
// __grid_constant__ parameters, which CUDA-graph capture records.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 128;                        // query rows a block
constexpr int kConsumers = 256;                 // two warpgroups
constexpr int kThreads = kConsumers + 32;       // and the producer warp
constexpr int kRowBytes = 128;                  // a swizzled row: 64 bf16
// returned, plus libcuda's CUresult, when a tensor map cannot be encoded
constexpr int kEncodeFailed = 100000;

// Shared memory of one block: Q (kBQ x DP), then STAGES tiles of K and of V
// (BK x DP each), each as DP / 64 boxes of 64 columns, then the barriers.
template <int DP, int BK, int STAGES>
struct Cfg {
  static constexpr int kBoxes = DP / 64;
  static constexpr int kQBox = kBQ * kRowBytes;
  static constexpr int kKVBox = BK * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;     // one K or V tile
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + STAGES * kKVBytes;
  static constexpr int kBarOff = kVOff + STAGES * kKVBytes;
  // + slack to align the base to the swizzle's 1024 bytes
  static constexpr int kSmemBytes = kBarOff + 8 * (1 + 2 * STAGES) + 1024;
  static constexpr int kSRegs = BK / 2;                // scores a thread
  static_assert(DP == 64 || DP == 128, "head dim padded to 64 or 128");
  static_assert(BK == 64 || BK == 128, "key tile of 64 or 128 rows");
  static_assert(kBarOff % 1024 == 0, "tiles 1024-byte aligned");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive once and expect `bytes` of TMA transactions in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that never
// ends (a lost TMA transaction) traps, so the launch fails instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (tries == (1u << 26)) __trap();
  }
}

// one box of a (D, L, H, B) tensor map into shared memory at `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0),
         "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile whose
// rows are 128 bytes: start address, leading byte offset, stride byte
// offset 1024 (eight rows), swizzle mode 1 (128 bytes). Tiles start on
// 1024-byte boundaries, so the base offset is 0.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this thread are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence or the wait.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// 2^x by the multifunction unit, subnormal results flushed to zero (a p
// under 2^-126 of its row's max adds nothing a bf16 p could hold)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 128, fp32) = A . B^T over one k16 step, A and B K-major bf16 in
// shared memory (128-byte swizzle); scale_d == 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) = A . B^T over one k16 step, A and B K-major bf16 in
// shared memory (128-byte swizzle); scale_d == 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A . B over one k16 step: A (64 x 16 bf16) from
// registers, B MN-major bf16 in shared memory (128-byte swizzle, trans-b)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for one key tile: DP / 16 steps of 16 head dims, each 32 bytes
// into the 128-byte rows of a 64-column box
template <int DP, int BK, int STAGES>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
  using C = Cfg<DP, BK, STAGES>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = desc_sw128(q_rows + (kk / 4) * C::kQBox + col, 16);
    const uint64_t db = desc_sw128(k_tile + (kk / 4) * C::kKVBox + col, 16);
    if constexpr (BK == 128) {
      wgmma_ss_n128(s, da, db, kk > 0);
    } else {
      wgmma_ss_n64(s, da, db, kk > 0);
    }
  }
}

// O += P V for one key tile: BK / 16 steps of 16 keys (two 1024-byte
// swizzle atoms of V each), one n64 product per 64-column box
template <int DP, int BK, int STAGES>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 64][32],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint32_t v_tile) {
  using C = Cfg<DP, BK, STAGES>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x)
      wgmma_rs_n64_tb(o[x], p[kk],
                      desc_sw128(v_tile + x * C::kKVBox + kk * 2048, 1024));
}

// The online softmax of one key tile in the log2 domain. s holds the raw
// scores q.k: s[4j + 2i + e] is row `row` + 8i, key k0 + 8j + c + e. Masks
// (on a diagonal tile) with -1e30, updates the row max m and the partial
// row sum l of this thread's columns, and returns in p the tile's
// probabilities in bf16 as wgmma A fragments (register e of key step kk
// holds scores 8kk + 2e and 8kk + 2e + 1, of row half e % 2) and in corr
// the factor that rescales O.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             uint32_t (&p)[BK / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool diag,
                                             int k0, int row, int c,
                                             float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        if (diag && k0 + 8 * j + c + e > row + 8 * i) x = kNegInf;
        mx[i] = fmaxf(mx[i], x);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // the scale is positive, so the max of the scaled scores is the scaled
    // max
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);
    corr[i] = exp2_ftz(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e % 2;
      const float p0 = exp2_ftz(fmaf(s[8 * kk + 2 * e], scale_log2, -m[i]));
      const float p1 =
          exp2_ftz(fmaf(s[8 * kk + 2 * e + 1], scale_log2, -m[i]));
      l[i] += p0 + p1;
      p[kk][e] = pack_bf16(p0, p1);
    }
}

// One block: query rows q0 .. q0 + 127 of (batch b, head h). Warps 0-7 are
// two consumer warpgroups (64 rows each), warp 8 the producer.
template <int DP, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int L, int H, int D,
                float scale_log2, int causal) {
  using C = Cfg<DP, BK, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_k = base + C::kKOff, s_v = base + C::kVOff;
  const uint32_t bar_q = base + C::kBarOff;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  // the last query tiles do the most causal work: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int n_tiles = causal ? (q0 + kBQ) / BK : L / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kConsumers / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer: Q once, then K and V tile by tile through the ring
    if (lane == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load(s_q + x * C::kQBox, &tq, bar_q, 64 * x, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, use = t / STAGES;
        if (use > 0) mbar_wait(bar_empty(s), (use - 1) & 1);
        mbar_expect_tx(bar_full(s), 2 * C::kKVBytes);
        const uint32_t k_dst = s_k + s * C::kKVBytes;
        const uint32_t v_dst = s_v + s * C::kKVBytes;
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(k_dst + x * C::kKVBox, &tk, bar_full(s), 64 * x, t * BK, h,
                   b);
          tma_load(v_dst + x * C::kKVBox, &tv, bar_full(s), 64 * x, t * BK, h,
                   b);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows row0 .. row0 + 63; this thread holds
  // rows row0 + r and row0 + r + 8, columns c and c + 1 of every 8
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;
  const int c = (lane % 4) * 2;
  const int row0 = q0 + wg * 64;
  const uint32_t q_rows = s_q + wg * 64 * kRowBytes;

  float o[C::kBoxes][32];
  float s[C::kSRegs];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int x = 0; x < C::kBoxes; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[x][e] = 0.f;
#pragma unroll
  for (int e = 0; e < C::kSRegs; ++e) s[e] = 0.f;
  // P of the tile whose P V is in flight, and of the tile just scored
  uint32_t p[BK / 16][4], p_next[BK / 16][4];

  // tile 0: its scores and softmax (O is still zero, so corr is moot)
  mbar_wait(bar_q, 0);
  mbar_wait(bar_full(0), 0);
  wgmma_fence();
  issue_qk<DP, BK, STAGES>(s, q_rows, s_k);
  wgmma_commit();
  wgmma_wait<0>();
  hold(s);
  softmax_tile<BK>(s, p, m, l, corr, causal && BK - 1 > row0, 0, row0 + r,
                   c, scale_log2);

  // tile t: Q K_t^T and P_{t-1} V_{t-1} go to the tensor cores together;
  // the softmax of tile t runs while P_{t-1} V_{t-1} is in flight
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % STAGES, prev = (t - 1) % STAGES;
    mbar_wait(bar_full(st), (t / STAGES) & 1);
    wgmma_fence();
    issue_qk<DP, BK, STAGES>(s, q_rows, s_k + st * C::kKVBytes);
    wgmma_commit();
    issue_pv<DP, BK, STAGES>(o, p, s_v + prev * C::kKVBytes);
    wgmma_commit();
    wgmma_wait<1>();                 // the scores are in; P V may run on
    hold(s);
    const int k0 = t * BK;
    softmax_tile<BK>(s, p_next, m, l, corr, causal && k0 + BK - 1 > row0, k0,
                     row0 + r, c, scale_log2);
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) hold(o[x]);
    hold(p);
    if (lane == 0) mbar_arrive(bar_empty(prev));   // K and V of tile t - 1
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[x][e] *= corr[(e / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[kk][e] = p_next[kk][e];
  }
  const int last = (n_tiles - 1) % STAGES;
  wgmma_fence();
  issue_pv<DP, BK, STAGES>(o, p, s_v + last * C::kKVBytes);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int x = 0; x < C::kBoxes; ++x) hold(o[x]);
  hold(p);
  if (lane == 0) mbar_arrive(bar_empty(last));

  // acc / max(l, 1e-30) in bf16 into the contiguous (B, L, H, D) output
  __nv_bfloat16* ob = out + (static_cast<long long>(b) * L * H + h) * D;
  const long long row_stride = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = ob + (row0 + r + 8 * i) * row_stride;
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (64 * x + 8 * j < D) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * x + 8 * j + c) =
              __floats2bfloat162_rn(__fdiv_rn(o[x][4 * j + 2 * i], denom),
                                    __fdiv_rn(o[x][4 * j + 2 * i + 1], denom));
        }
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(sym);
    }
  }
  return fn;
}

// The (D, L, H, B) tensor map of one of q, k, v (strides in elements): boxes
// of 64 head dims by `rows` rows of one (head, batch), 128-byte swizzle,
// head dims past d read as zeros.
CUresult encode(CUtensorMap* map, const void* ptr, int b, int L, int h, int d,
                long long sb, long long sl, long long sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct View {
  const void* ptr;
  long long sb, sl, sh;
};

template <int DP, int BK, int STAGES>
int run(View q, View k, View v, void* out, int b, int L, int h, int d,
        float scale_log2, int causal, cudaStream_t stream) {
  using C = Cfg<DP, BK, STAGES>;
  auto kernel = flash_tc_kernel<DP, BK, STAGES>;
  // above 48 KB a block's shared memory must be asked for, once per
  // instantiation (before any stream capture)
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  CUtensorMap tq, tk, tv;
  CUresult res = encode(&tq, q.ptr, b, L, h, d, q.sb, q.sl, q.sh, kBQ);
  if (res == CUDA_SUCCESS) {
    res = encode(&tk, k.ptr, b, L, h, d, k.sb, k.sl, k.sh, BK);
  }
  if (res == CUDA_SUCCESS) {
    res = encode(&tv, v.ptr, b, L, h, d, v.sb, v.sl, v.sh, BK);
  }
  if (res != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(res);
  const dim3 grid(b * h, L / kBQ);
  kernel<<<grid, kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), L, h, d, scale_log2,
      causal);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, long long sb, long long sl, long long sh,
             int b, int L, int h) {
  // TMA reads from 16-byte-aligned addresses with 16-byte-multiple strides
  // (bf16 strides in elements: multiples of 8); a dim of size 1 has no
  // stride to speak of
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (b == 1 || sb % 8 == 0) && (L == 1 || sl % 8 == 0) &&
         (h == 1 || sh % 8 == 0);
}

}  // namespace

// Plain C entry point, loaded with ctypes; the signature of
// flash_attention.cu's. q, k, v are (b, l, h, d) bfloat16 device tensors
// (bf16 must be nonzero) whose head dim is contiguous, read through their
// (b, l, h) strides in elements; their base addresses must be 16-byte
// aligned and their strides multiples of 8 elements (16 bytes). out is a
// fresh contiguous (b, l, h, d) bfloat16 tensor. l must be a multiple of 128
// and d a multiple of 8 up to 128. scale is 1/sqrt(d). Launches on `stream`
// and returns the CUDA error code as an int, or 100000 plus libcuda's
// CUresult when a tensor map cannot be encoded.
extern "C" int flash_attention_tc(const void* q, const void* k, const void* v,
                                  void* out, int b, int l, int h, int d,
                                  long long qsb, long long qsl, long long qsh,
                                  long long ksb, long long ksl, long long ksh,
                                  long long vsb, long long vsl, long long vsh,
                                  float scale, int causal, int bf16,
                                  void* stream) {
  if (b == 0 || h == 0) return 0;
  if (!bf16 || l % kBQ != 0 || d % 8 != 0 || d < 8 || d > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned(q, qsb, qsl, qsh, b, l, h) ||
      !aligned(k, ksb, ksl, ksh, b, l, h) ||
      !aligned(v, vsb, vsl, vsh, b, l, h) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const View vq{q, qsb, qsl, qsh}, vk{k, ksb, ksl, ksh}, vv{v, vsb, vsl, vsh};
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) {
    return run<64, 128, 4>(vq, vk, vv, out, b, l, h, d, scale_log2, causal, s);
  }
  return run<128, 64, 4>(vq, vk, vv, out, b, l, h, d, scale_log2, causal, s);
}
