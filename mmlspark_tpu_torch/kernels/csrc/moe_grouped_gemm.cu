// The experts of a routed MLP as one batched GEMM over E experts on
// Hopper's tensor cores: c[e] = epilogue(a[e] . b[e]), a[e] (M x K) and
// b[e] (K x N) bf16, sums in fp32, for every expert e of the launch.
//
// Replaces no TPU kernel: the JAX package routes experts by one-hot
// einsums that XLA lowers (mmlspark_tpu/models/zoo/moe.py). The port's
// index dispatch (mmlspark_tpu_torch/ops/moe.py) gathers each expert's
// C = capacity rows into an (E, C, D) buffer and runs the experts here:
//  - up:     pre = xe . w_up + b_up, h = gelu(pre)        (epilogue 1)
//  - down:   ye = h . w_down + b_down                       (epilogue 0)
//  - d_pre = (d_ye . w_down^T) * gelu'(pre)                 (epilogue 2)
//  - d_xe  = d_pre . w_up^T                                 (epilogue 3)
//  - d_w_up = xe^T . d_pre, d_w_down = h^T . d_ye, fp32     (epilogue 4)
// Every operand is read where it lies: a K-major operand (K contiguous)
// and an MN-major one (M or N contiguous) are both taken by wgmma, so no
// weight or activation is transposed in device memory.
//
// Bound. At V-MoE-B/16's training shapes (E = 32, C = 1,655, D = 768,
// H = 3,072) each of the six products is 2 E C D H = 250 GFLOP, 0.253 ms
// at the H100's dense bf16 rate (989 TFLOP/s); the up product also writes
// pre and h (650 MB, 0.194 ms at 3.35 TB/s) and d_pre reads pre back. So
// the tensor cores bound every product, and the epilogues' bytes come
// close. The design keeps the tensor cores fed and the bytes off their
// path:
//  - one block a 128 x 256 tile of one expert (one block a
//    multiprocessor); one producer warp keeps TMA loads of 64-deep k
//    slices in flight through a ring of four stages (three for d_pre)
//    in shared memory (128-byte swizzle, full and empty mbarriers); two
//    consumer warpgroups (64 rows each) run m64n256k16 on them;
//  - a bf16 epilogue stages the fp32 tile over the freed ring, then each
//    consumer thread takes 8 columns of a row: the bias, GELU or GELU' on
//    them, 16-byte loads and stores, a warp a contiguous 512-byte row; the
//    up product stores pre and h from one pass; d_pre's pre is a TMA load
//    into its own buffer, issued after the tile's last k slice, so it
//    lands while the tile's products run;
//  - the weight gradients (fp32) are stored from the fragments, a warp's
//    store filling whole 32-byte sectors;
//  - TMA's zero fill pads the last expert's rows past M (and the k loop
//    past K in the weight gradients, whose k is the C rows).
// Rows past an expert's kept pairs are zero rows that the dispatch
// wrote: the products over them are the paper's fixed-capacity work.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                 // rows of a tile
constexpr int BK = 64;                  // k of a stage: one 128-byte row
constexpr int kHalfBytes = 64 * 128;    // 64 rows of 128 bytes
// returned, plus libcuda's CUresult, when a tensor map cannot be encoded
constexpr int kEncodeFailed = 100000;

enum Epi { kBias = 0, kBiasGelu = 1, kDGelu = 2, kPlain = 3, kF32 = 4 };

constexpr int BN = 256;                 // columns of a tile
constexpr int kConsumers = 256;         // two warpgroups, 64 rows each
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kABytes = BM * BK * 2;
constexpr int kBBytes = BN * BK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBoxBytes = BM * 128;     // 128 rows of a 64-column box
constexpr int kAuxBytes = (BN / 64) * kBoxBytes;
constexpr int kRow = BN + 8;            // floats a staged row of the tile

// Shared memory: a ring of k slices, then (epilogue 2) the tile's pre,
// then the barriers. The epilogue stages the fp32 tile over the ring.
template <int EPI>
struct Smem {
  static constexpr int kStages = EPI == 2 ? 3 : 4;
  static constexpr int kAuxOff = kStages * kStageBytes;
  static constexpr int kBarOff = kAuxOff + (EPI == 2 ? kAuxBytes : 0);
  // + slack to align the base to the swizzle's 1024 bytes
  static constexpr int kBytes = kBarOff + 8 * (2 * kStages + 1) + 1024;
  static_assert(BM * kRow * 4 <= kAuxOff, "the staged tile fits the ring");
};

struct Params {
  void* c;                   // (E, M, N) at ldc, sce
  void* c2;                  // epilogue 1: gelu(pre), like c
  const __nv_bfloat16* bias; // epilogues 0, 1: (E, N)
  const __nv_bfloat16* aux;  // epilogue 2: pre, like c
  long long ldc, sce;
  int M, N, k_tiles, m_tiles, n_tiles;
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

// one box of an (inner, rows, expert) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int inner, int row,
                                         int expert) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(inner), "r"(row), "r"(expert)
      : "memory");
}

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile whose
// rows are 128 bytes: start address, leading byte offset (the stride
// between 64-wide blocks of the M or N dim of an MN-major operand; unused
// for a K-major one), stride byte offset 1024 (eight rows), swizzle mode 1
// (128 bytes). Tiles start on 1024-byte boundaries: base offset 0.
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

// the consumer warpgroups' own barrier (0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// Byte offset of element (row, col) of a tile that TMA loaded as BN / 64
// boxes of 128 rows x 64 columns with the 128-byte swizzle: a row's
// 16-byte chunk j sits at chunk j ^ (row % 8).
__device__ __forceinline__ uint32_t out_offset(int row, int col) {
  return (col / 64) * kBoxBytes + row * 128 +
         ((((col % 64) / 8) ^ (row & 7)) << 4) + (col % 8) * 2;
}

// D (64 x 256, fp32) += A . B over one k16 step, A and B bf16 in shared
// memory (128-byte swizzle); TA / TB: A / B MN-major; scale_d == 0
// overwrites D
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// tanh by the multifunction unit (absolute error under 2^-10.9)
__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh-approximated GELU and its derivative, of a bf16-rounded x
__device__ __forceinline__ float gelu(float x) {
  const float u = 0.7978845608028654f * fmaf(0.044715f * x, x * x, x);
  return 0.5f * x * (1.f + tanh_fast(u));
}
__device__ __forceinline__ float gelu_grad(float x) {
  const float x2 = x * x;
  const float th = tanh_fast(0.7978845608028654f * fmaf(0.044715f * x, x2, x));
  const float du = 0.7978845608028654f * fmaf(0.134145f, x2, 1.f);
  return 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * du;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One block: tile (mt, nt) of expert e, blockIdx.x = (e m_tiles + mt)
// n_tiles + nt. Warps 0-7 are the two consumer warpgroups, warp 8 the
// producer.
template <int A_MN, int B_MN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
moe_grouped_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap t_aux,
                        const Params p) {
  using S = Smem<EPI>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar0 = base + S::kBarOff;
  auto bar_full = [&](int s) { return bar0 + 8u * s; };
  auto bar_empty = [&](int s) { return bar0 + 8u * (kStages + s); };
  const uint32_t bar_aux = bar0 + 8u * (2 * kStages);  // epilogue 2's pre
  auto a_tile = [&](int s) { return base + s * kStageBytes; };
  auto b_tile = [&](int s) { return base + s * kStageBytes + kABytes; };

  const int tiles_e = p.m_tiles * p.n_tiles;
  const int e = blockIdx.x / tiles_e;
  const int m0 = (blockIdx.x % tiles_e) / p.n_tiles * BM;
  const int n0 = blockIdx.x % p.n_tiles * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kConsumers / 32);   // one arrival a warp
    }
    mbar_init(bar_aux, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer: a's 128 rows and b's 256 columns, k slice by k slice
    // through the ring, then (epilogue 2) the tile's pre, which lands
    // while the last slices' products run
    if (lane == 0) {
      for (int kt = 0; kt < p.k_tiles; ++kt) {
        const int s = kt % kStages, use = kt / kStages;
        if (use > 0) mbar_wait(bar_empty(s), (use - 1) & 1);
        mbar_expect_tx(bar_full(s), kStageBytes);
        const int k0 = kt * BK;
        if (A_MN) {
          tma_load(a_tile(s), &ta, bar_full(s), m0, k0, e);
          tma_load(a_tile(s) + kHalfBytes, &ta, bar_full(s), m0 + 64, k0, e);
        } else {
          tma_load(a_tile(s), &ta, bar_full(s), k0, m0, e);
        }
        if (B_MN) {
#pragma unroll
          for (int x = 0; x < BN / 64; ++x)
            tma_load(b_tile(s) + x * kHalfBytes, &tb, bar_full(s),
                     n0 + 64 * x, k0, e);
        } else {
          tma_load(b_tile(s), &tb, bar_full(s), k0, n0, e);
        }
      }
      if (EPI == kDGelu) {
        mbar_expect_tx(bar_aux, kAuxBytes);
#pragma unroll
        for (int x = 0; x < BN / 64; ++x)
          tma_load(base + S::kAuxOff + x * kBoxBytes, &t_aux, bar_aux,
                   n0 + 64 * x, m0, e);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile;
  // this thread holds rows r and r + 8 of them, columns c, c + 1 of every 8
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;
  const int c = (lane % 4) * 2;
  const int row0 = wg * 64 + r;             // its rows row0 and row0 + 8
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < p.k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(bar_full(s), (kt / kStages) & 1);
    hold(acc);
    wgmma_fence();
    const uint32_t a_rows = a_tile(s) + wg * kHalfBytes;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = A_MN ? desc_sw128(a_rows + kk * 2048, kHalfBytes)
                               : desc_sw128(a_rows + kk * 32, 16);
      const uint64_t db = B_MN ? desc_sw128(b_tile(s) + kk * 2048, kHalfBytes)
                               : desc_sw128(b_tile(s) + kk * 32, 16);
      wgmma_n256<A_MN, B_MN>(acc, da, db, kt > 0 || kk > 0);
    }
    wgmma_commit();
    hold(acc);
    if (kt > 0) {
      wgmma_wait<1>();               // slice kt - 1 is read: give it back
      if (lane == 0) mbar_arrive(bar_empty((kt - 1) % kStages));
    }
  }
  wgmma_wait<0>();
  hold(acc);

  const long long eoff = static_cast<long long>(e) * p.sce;
  if (EPI == kF32) {
    // fp32 straight from the fragments: a warp's store fills 8 whole
    // 32-byte sectors
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + row0 + 8 * i;
      if (row >= p.M) continue;
      float* dst = static_cast<float*>(p.c) + eoff +
                   static_cast<long long>(row) * p.ldc + n0 + c;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
    return;
  }

  // bf16 out. Every consumer warp is past its last product, so the ring
  // is free: the fp32 tile goes there (rows padded by 32 bytes, so a half
  // warp's fragment stores hit 32 distinct banks), then every consumer
  // thread takes 8 columns of a row at a time: bias, GELU or GELU' on
  // them, 16-byte loads of the bias and stores, a warp a contiguous row.
  consumers_sync();
  float* tile = reinterpret_cast<float*>(base_ptr);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* row = tile + (row0 + 8 * i) * kRow + c;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
  consumers_sync();
  if (EPI == kDGelu) mbar_wait(bar_aux, 0);
  const uint8_t* aux = base_ptr + S::kAuxOff;

  for (int q = threadIdx.x; q < BM * BN / 8; q += kConsumers) {
    const int rt = q / (BN / 8), ct = q % (BN / 8) * 8;
    if (m0 + rt >= p.M) break;          // rows only grow along q
    const float4 lo = *reinterpret_cast<const float4*>(tile + rt * kRow + ct);
    const float4 hi =
        *reinterpret_cast<const float4*>(tile + rt * kRow + ct + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const long long off =
        eoff + static_cast<long long>(m0 + rt) * p.ldc + n0 + ct;
    if (EPI == kBias || EPI == kBiasGelu) {
      const uint4 b = *reinterpret_cast<const uint4*>(
          p.bias + static_cast<long long>(e) * p.N + n0 + ct);
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(as_bf162(bw[k]));
        v[2 * k] += f.x;
        v[2 * k + 1] += f.y;
      }
    }
    if (EPI == kDGelu) {
      const uint4 a = *reinterpret_cast<const uint4*>(aux + out_offset(rt, ct));
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x = __bfloat1622float2(as_bf162(aw[k]));
        v[2 * k] *= gelu_grad(x.x);
        v[2 * k + 1] *= gelu_grad(x.y);
      }
    }
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = pack_bf16(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.c) + off) =
        make_uint4(w[0], w[1], w[2], w[3]);
    if (EPI == kBiasGelu) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x = __bfloat1622float2(as_bf162(w[k]));
        w[k] = pack_bf16(gelu(x.x), gelu(x.y));
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.c2) + off) =
          make_uint4(w[0], w[1], w[2], w[3]);
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

// The (inner, rows, E) tensor map of a bf16 operand whose rows lie `ld`
// elements apart and whose experts `se`: boxes of 64 inner elements (128
// bytes, the swizzle's width) by `box_rows` rows; reads past a dim are
// zeros.
CUresult encode(CUtensorMap* map, const void* ptr, long long inner,
                long long rows, int E, long long ld, long long se,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(se) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int A_MN, int B_MN, int EPI>
int run(const void* a, const void* b, const Params& p0, int E, int K,
        long long lda, long long sae, long long ldb, long long sbe,
        cudaStream_t stream) {
  using S = Smem<EPI>;
  auto kernel = moe_grouped_gemm_kernel<A_MN, B_MN, EPI>;
  // above 48 KB a block's shared memory must be asked for, once per
  // instantiation (before any stream capture)
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  Params p = p0;
  p.k_tiles = (K + BK - 1) / BK;
  p.m_tiles = (p.M + BM - 1) / BM;
  p.n_tiles = p.N / BN;
  // a K-major a is (E, M, K), an MN-major one (E, K, M); b likewise; aux
  // (epilogue 2) (E, M, N) like c
  CUtensorMap map_a, map_b, map_aux;
  CUresult res = A_MN ? encode(&map_a, a, p.M, K, E, lda, sae, 64)
                      : encode(&map_a, a, K, p.M, E, lda, sae, BM);
  if (res == CUDA_SUCCESS) {
    res = B_MN ? encode(&map_b, b, p.N, K, E, ldb, sbe, 64)
               : encode(&map_b, b, K, p.N, E, ldb, sbe, BN);
  }
  map_aux = map_b;
  if (res == CUDA_SUCCESS && EPI == kDGelu) {
    res = encode(&map_aux, p.aux, p.N, p.M, E, p.ldc, p.sce, BM);
  }
  if (res != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(res);
  const long long blocks = static_cast<long long>(E) * p.m_tiles * p.n_tiles;
  kernel<<<static_cast<unsigned>(blocks), kThreads, S::kBytes, stream>>>(
      map_a, map_b, map_aux, p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. c[e] = epilogue(a[e] . b[e])
// for e < E, a[e] (M x K), b[e] (K x N), bf16 operands read through their
// row strides (lda, ldb) and expert strides (sae, sbe) in elements:
//  - a_mn == 0: a is (E, M, K), K contiguous; 1: (E, K, M), M contiguous;
//  - b_mn == 0: b is (E, N, K), K contiguous; 1: (E, K, N), N contiguous;
//  - c (and c2, aux) is (E, M, N) at ldc, sce: bf16, fp32 for epi 4;
//  - epi 0: + bias (E, N) bf16; 1: pre = . + bias into c, gelu(pre) into
//    c2; 2: . * gelu'(aux); 3: as it is; 4: as it is, fp32.
// Taken: (a_mn, b_mn, epi) in (0, 1, 0 or 1), (0, 0, 2 or 3), (1, 1, 4).
// N must be a multiple of 256, M of 128 when a_mn, K of 64 unless it is
// a's and b's row dim (a_mn and b_mn); strides multiples of 8 elements,
// every pointer 16-byte aligned.
// Launches on `stream` and returns the CUDA error code as an int, or
// 100000 plus libcuda's CUresult when a tensor map cannot be encoded.
extern "C" int moe_grouped_gemm(const void* a, const void* b, void* c,
                                void* c2, const void* bias, const void* aux,
                                int E, int M, int N, int K, int a_mn,
                                int b_mn, long long lda, long long sae,
                                long long ldb, long long sbe, long long ldc,
                                long long sce, int epi, void* stream) {
  if (E == 0 || M == 0) return 0;
  if (N % BN != 0 || K <= 0 || (a_mn && M % BM != 0) ||
      (!(a_mn && b_mn) && K % BK != 0) || lda % 8 || sae % 8 || ldb % 8 ||
      sbe % 8 || ldc % 8 || sce % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(a) || !aligned16(b) || !aligned16(c) || !aligned16(c2) ||
      !aligned16(bias) || !aligned16(aux)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Params p{};
  p.c = c;
  p.c2 = c2;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.aux = static_cast<const __nv_bfloat16*>(aux);
  p.ldc = ldc;
  p.sce = sce;
  p.M = M;
  p.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a_mn && b_mn && epi == kBiasGelu)
    return run<0, 1, kBiasGelu>(a, b, p, E, K, lda, sae, ldb, sbe, s);
  if (!a_mn && b_mn && epi == kBias)
    return run<0, 1, kBias>(a, b, p, E, K, lda, sae, ldb, sbe, s);
  if (!a_mn && !b_mn && epi == kDGelu)
    return run<0, 0, kDGelu>(a, b, p, E, K, lda, sae, ldb, sbe, s);
  if (!a_mn && !b_mn && epi == kPlain)
    return run<0, 0, kPlain>(a, b, p, E, K, lda, sae, ldb, sbe, s);
  if (a_mn && b_mn && epi == kF32)
    return run<1, 1, kF32>(a, b, p, E, K, lda, sae, ldb, sbe, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
