// K2 on Hopper: center-crop + bilinear resize + requantize + per-channel
// normalize of a uint8 NHWC image batch, in one pass.
//
// Replaces the Pallas TPU kernel
// mmlspark_tpu/ops/pallas_preprocess.py::_fused_crop_resize_normalize
// (body _crop_resize_norm_kernel). On the TPU each image went through two
// mostly-zero matmuls, Ry (Hd x Hs) @ x @ kron(Rx^T, I_C), because the MXU
// was the cheap unit there. Every row of Ry and Rx has at most two
// nonzeros, so here each output element is a direct 2-tap-per-axis lerp:
// the taps (i0, i1, frac) per axis come from the wrapper
// (mmlspark_tpu_torch/ops/preprocess.py::CropResizePlan), computed once per
// shape by the same formula as the reference's _sampling_matrix. They fold
// in the center-crop offset and clamp at the SOURCE border, not the crop
// border, so the rows a band reads come from the taps, never from the crop
// window.
//
// Bound. At the main path's shape (B=128, 256x256x3 uint8 in, 224x224x3
// out) the kernel must read 25.2 MB and write 38.5 MB in bf16 (77.1 MB in
// fp32): 0.019 ms (0.0305 ms) at the H100's 3.35 TB/s. It does ~14 fp32
// operations per output element (0.27 GFLOP, ~4 us at 67 TFLOP/s), so it is
// bound by bytes.
//
// Design. One block per (image, band of output rows); the plan picks the
// band height from the largest set of source rows a band reads and a
// shared-memory budget. The staged variant copies the band's distinct
// source rows (every row a y-tap of the band names, sorted; taps are
// monotone) into shared memory with 16-byte cp.async, and the x-taps
// (x0 * C, x1 * C, fx) and mean / 1/std into shared memory beside them,
// once a block; each source byte then leaves device memory once a band
// instead of once a tap. Each thread then produces whole 16-byte output
// vectors, each written with one 16-byte store: for C = 1, 3 or 4 (compiled
// apart) a unit of whole pixels whose outputs fill whole vectors (3 x 4
// fp32 pixels or 3 x 8 bf16 pixels, in three vectors, at C = 3), with the
// x-taps read once a pixel and mean / 1/std in registers; for any other C
// one vector of the flat (x, c) row, which may cross pixels (the channel
// is the flat index mod C). A row whose length in bytes is not a multiple
// of 16, or its last partial unit, takes element stores in the same
// kernel. A source byte becomes fp32 by an OR into the bits of 2^23 and
// one subtract (exact), not by the quarter-rate int-to-float conversion.
// The direct-load variant (chosen by the plan when two source rows or
// their alignment do not allow staging, and by the wrapper for a source
// off 16 bytes) reads the taps and the source bytes from device memory
// through the cache instead, with the same output units. Index math is
// 32-bit inside an image; the wrapper checks that an image's offsets fit.
// At the main shape the kernel is bound by its instructions, ~30 a bf16
// output (four byte loads, their conversions and the 2 x 2 lerps), not by
// its bytes: the direct-load variant runs within 2% of the staged one
// (PERF.md).
//
// Arithmetic. Row lerp, then column lerp, in fp32, with the same operation
// order as the plain torch version (_crop_resize_normalize_plain). The
// _rn intrinsics keep nvcc from contracting a*b+c into an fma, so the
// kernel and the plain version agree bit for bit on the card in practice
// (the gate allows one uint8 quantum on 1% of elements). rintf rounds half
// to even like jnp.round / torch.round; the normalize keeps the multiply
// by the fp32 reciprocal of std; the bf16 store is __float2bfloat16_rn of
// the same fp32 value, what a cast of the fp32 output gives.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void store_one(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store_one(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// elements in one 16-byte output vector
template <typename OutT>
struct Vec {
  static constexpr int kN = 16 / sizeof(OutT);
};

__device__ __forceinline__ void store_vec(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* dst,
                                          const float* v) {
  uint32_t packed[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // low half holds the element at the lower address
    __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    packed[j] = *reinterpret_cast<uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int to =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
               "l"(gmem));
}

// The geometry of one launch; every count fits in 32 bits.
struct Shape {
  int hs, ws, hd, wd, c;
  int band_rows;  // output rows per block
  int stage_max;  // source rows staged per block (staged variant)
  int aligned;    // output rows start on 16 bytes: vector stores
};

__host__ __device__ constexpr int gcd_of(int a, int b) {
  return b ? gcd_of(b, a % b) : a;
}

// a uint8 as an exact fp32 value without the quarter-rate int-to-float
// conversion: the bits of 2^23 + b, less 2^23
__device__ __forceinline__ float u8f(uint8_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}

// One output element: row lerp at both tap columns, column lerp,
// requantize, normalize; the plain version's operation order.
__device__ __forceinline__ float resample(const uint8_t* r0,
                                          const uint8_t* r1, int c0, int c1,
                                          float wy0, float wy1, float wx1,
                                          float mu, float is) {
  const float wx0 = __fsub_rn(1.0f, wx1);
  const float left =
      __fadd_rn(__fmul_rn(u8f(r0[c0]), wy0), __fmul_rn(u8f(r1[c0]), wy1));
  const float right =
      __fadd_rn(__fmul_rn(u8f(r0[c1]), wy0), __fmul_rn(u8f(r1[c1]), wy1));
  float z = __fadd_rn(__fmul_rn(left, wx0), __fmul_rn(right, wx1));
  z = fminf(fmaxf(rintf(z), 0.0f), 255.0f);
  return __fmul_rn(__fsub_rn(z, mu), is);
}

// kC > 0: C known at compile time (1, 3, 4). A thread's unit is kP whole
// pixels whose kP * kC outputs fill whole 16-byte vectors; the x-taps are
// read once a pixel and mean / 1/std sit in registers. kC == 0: any C, a
// unit is one 16-byte vector of the flat (x, c) row, which may cross
// pixels (the channel is the flat index mod C).
template <typename OutT, bool kStaged, int kC>
__global__ void __launch_bounds__(kThreads) crop_resize_normalize_kernel(
    const uint8_t* __restrict__ src, OutT* __restrict__ dst,
    const int* __restrict__ y0, const int* __restrict__ y1,
    const float* __restrict__ fy, const int* __restrict__ x0,
    const int* __restrict__ x1, const float* __restrict__ fx,
    const float* __restrict__ mean, const float* __restrict__ istd,
    const int* __restrict__ slots, const int* __restrict__ stage_rows,
    const int* __restrict__ stage_n, Shape g) {
  constexpr int V = Vec<OutT>::kN;
  const int c = kC > 0 ? kC : g.c;
  const int bands = (g.hd + g.band_rows - 1) / g.band_rows;
  const int band = static_cast<int>(blockIdx.x % bands);
  const int img = static_cast<int>(blockIdx.x / bands);
  const int row_bytes = g.ws * c;
  const int wdc = g.wd * c;
  const uint8_t* image =
      src + static_cast<size_t>(img) * (g.hs * row_bytes);
  OutT* out = dst + static_cast<size_t>(img) * (g.hd * wdc);
  const int ya = band * g.band_rows;
  const int rows = min(g.band_rows, g.hd - ya);

  extern __shared__ __align__(16) unsigned char smem[];
  // the staged variant's tables, after the rows (a multiple of 16 bytes)
  int* s_c0 = reinterpret_cast<int*>(smem + g.stage_max * row_bytes);
  int* s_c1 = s_c0 + g.wd;
  float* s_fx = reinterpret_cast<float*>(s_c1 + g.wd);
  float* s_mean = s_fx + g.wd;
  float* s_istd = s_mean + c;
  if constexpr (kStaged) {
    const int n = __ldg(stage_n + band);
    const int* rows_of = stage_rows + band * g.stage_max;
    const int chunks = row_bytes / 16;
    for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
      const int s = i / chunks;
      const int q = i - s * chunks;
      cp_async16(smem + s * row_bytes + q * 16,
                 image + __ldg(rows_of + s) * row_bytes + q * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int x = threadIdx.x; x < g.wd; x += kThreads) {
      s_c0[x] = __ldg(x0 + x) * c;
      s_c1[x] = __ldg(x1 + x) * c;
      s_fx[x] = __ldg(fx + x);
    }
    for (int k = threadIdx.x; k < c; k += kThreads) {
      s_mean[k] = __ldg(mean + k);
      s_istd[k] = __ldg(istd + k);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  }
  // the taps of output column x, its two source columns times C
  auto taps = [&](int x, int& c0, int& c1, float& wx1) {
    if constexpr (kStaged) {
      c0 = s_c0[x];
      c1 = s_c1[x];
      wx1 = s_fx[x];
    } else {
      c0 = __ldg(x0 + x) * c;
      c1 = __ldg(x1 + x) * c;
      wx1 = __ldg(fx + x);
    }
  };

  constexpr int kP = kC > 0 ? 16 / gcd_of(16, kC * (int)sizeof(OutT)) : 1;
  constexpr int kN = kC > 0 ? kP * kC : V;   // outputs of one unit
  float mu[kC > 0 ? kC : 1], is[kC > 0 ? kC : 1];
  if constexpr (kC > 0) {
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      mu[k] = __ldg(mean + k);
      is[k] = __ldg(istd + k);
    }
  }
  // units per row: kP pixels, or one vector of the flat row
  const int units = kC > 0 ? (g.wd + kP - 1) / kP : (wdc + V - 1) / V;
  for (int i = threadIdx.x; i < rows * units; i += kThreads) {
    const int r = i / units;
    const int j0 = (i - r * units) * kN;   // first output of the unit
    const int y = ya + r;
    const float wy1 = __ldg(fy + y);
    const float wy0 = __fsub_rn(1.0f, wy1);
    const uint8_t* r0;
    const uint8_t* r1;
    if constexpr (kStaged) {
      r0 = smem + __ldg(slots + 2 * y) * row_bytes;
      r1 = smem + __ldg(slots + 2 * y + 1) * row_bytes;
    } else {
      r0 = image + __ldg(y0 + y) * row_bytes;
      r1 = image + __ldg(y1 + y) * row_bytes;
    }
    float v[kN];
    if constexpr (kC > 0) {
      const int xa = j0 / kC;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (xa + p < g.wd) {
          int c0, c1;
          float wx1;
          taps(xa + p, c0, c1, wx1);
#pragma unroll
          for (int k = 0; k < kC; ++k) {
            v[p * kC + k] = resample(r0, r1, c0 + k, c1 + k, wy0, wy1, wx1,
                                     mu[k], is[k]);
          }
        }
      }
    } else {
      int x = j0 / c;
      int k = j0 - x * c;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (j0 + e < wdc) {
          int c0, c1;
          float wx1;
          taps(x, c0, c1, wx1);
          const float m = kStaged ? s_mean[k] : __ldg(mean + k);
          const float s = kStaged ? s_istd[k] : __ldg(istd + k);
          v[e] = resample(r0, r1, c0 + k, c1 + k, wy0, wy1, wx1, m, s);
        }
        if (++k == c) {
          k = 0;
          ++x;
        }
      }
    }
    OutT* o = out + y * wdc + j0;
    if (g.aligned && j0 + kN <= wdc) {
#pragma unroll
      for (int m = 0; m < kN / V; ++m) store_vec(o + m * V, v + m * V);
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        if (j0 + e < wdc) store_one(o + e, v[e]);
      }
    }
  }
}

template <typename OutT, int kC>
void launch_c(const uint8_t* src, OutT* out, const int* const* tabs,
              const float* const* wts, unsigned int blocks, const Shape& g,
              int staged, cudaStream_t s) {
  if (staged) {
    const size_t smem = static_cast<size_t>(g.stage_max) * g.ws * g.c +
                        static_cast<size_t>(g.wd) * 12 + g.c * 8;
    crop_resize_normalize_kernel<OutT, true, kC>
        <<<blocks, kThreads, smem, s>>>(
            src, out, tabs[0], tabs[1], wts[0], tabs[2], tabs[3], wts[1],
            wts[2], wts[3], tabs[4], tabs[5], tabs[6], g);
  } else {
    crop_resize_normalize_kernel<OutT, false, kC>
        <<<blocks, kThreads, 0, s>>>(
            src, out, tabs[0], tabs[1], wts[0], tabs[2], tabs[3], wts[1],
            wts[2], wts[3], tabs[4], tabs[5], tabs[6], g);
  }
}

template <typename OutT>
void launch(const uint8_t* src, void* dst, const int* const* tabs,
            const float* const* wts, int b, Shape g, int staged,
            cudaStream_t s) {
  OutT* out = static_cast<OutT*>(dst);
  g.aligned = reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
              (static_cast<long long>(g.wd) * g.c * sizeof(OutT)) % 16 == 0;
  const int bands = (g.hd + g.band_rows - 1) / g.band_rows;
  const unsigned int blocks = static_cast<unsigned int>(b) * bands;
  switch (g.c) {
    case 1:
      launch_c<OutT, 1>(src, out, tabs, wts, blocks, g, staged, s);
      break;
    case 3:
      launch_c<OutT, 3>(src, out, tabs, wts, blocks, g, staged, s);
      break;
    case 4:
      launch_c<OutT, 4>(src, out, tabs, wts, blocks, g, staged, s);
      break;
    default:
      launch_c<OutT, 0>(src, out, tabs, wts, blocks, g, staged, s);
  }
}

__global__ void crop_resize_normalize_empty_kernel() {}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device
// pointer; src is (b, hs, ws, c) uint8, dst (b, hd, wd, c) float32, or
// bfloat16 when out_bf16 != 0. y0, y1, x0, x1 are int32 taps, fy, fx their
// float32 weights, mean and istd c float32 values. slots is (hd, 2) int32:
// the staged row of y0[y] and y1[y] within y's band; stage_rows is
// (bands, stage_max) int32, the source rows each band stages, stage_n their
// count. staged != 0 takes the staged variant (the source 16-byte aligned,
// ws * c a multiple of 16, stage_max * ws * c + 12 * wd + 8 * c bytes of
// shared memory within 48 KB); 0 the direct-load variant, which reads no
// stage table. Launches once on `stream` and returns cudaGetLastError().
extern "C" int crop_resize_normalize(
    const void* src, void* dst, const void* y0, const void* y1,
    const void* fy, const void* x0, const void* x1, const void* fx,
    const void* mean, const void* istd, const void* slots,
    const void* stage_rows, const void* stage_n, int b, int hs, int ws,
    int hd, int wd, int c, int band_rows, int stage_max, int staged,
    int out_bf16, void* stream) {
  if (b == 0 || hd == 0 || wd == 0) return 0;
  const int* tabs[] = {static_cast<const int*>(y0),
                       static_cast<const int*>(y1),
                       static_cast<const int*>(x0),
                       static_cast<const int*>(x1),
                       static_cast<const int*>(slots),
                       static_cast<const int*>(stage_rows),
                       static_cast<const int*>(stage_n)};
  const float* wts[] = {static_cast<const float*>(fy),
                        static_cast<const float*>(fx),
                        static_cast<const float*>(mean),
                        static_cast<const float*>(istd)};
  const Shape g{hs, ws, hd, wd, c, band_rows, stage_max, 0};
  const uint8_t* in = static_cast<const uint8_t*>(src);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    launch<__nv_bfloat16>(in, dst, tabs, wts, b, g, staged, s);
  } else {
    launch<float>(in, dst, tabs, wts, b, g, staged, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch floor of crop_resize_normalize: an empty kernel on the grid
// of a (b, hd, band_rows) launch, for timing beside it.
extern "C" int crop_resize_normalize_empty(int b, int hd, int band_rows,
                                           void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>(b) * ((hd + band_rows - 1) / band_rows);
  crop_resize_normalize_empty_kernel<<<blocks, kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
