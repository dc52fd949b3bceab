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
// (mmlspark_tpu_torch/ops/preprocess.py), computed once per shape by the
// same formula as the reference's _sampling_matrix. They fold in the
// center-crop offset and clamp at the SOURCE border, not the crop border.
//
// Bound. At the main path's shape (B=128, 256x256x3 uint8 in, 224x224x3
// fp32 out) the kernel must read 25.2 MB and write 77.1 MB: 102.2 MB, or
// about 30.5 us at the H100's 3.35 TB/s. It does ~12 fp32 operations per
// output element (0.23 GFLOP, ~3.4 us at 67 TFLOP/s), so it is bound by
// bytes. The design moves each byte once: the uint8 source is read
// straight from device memory (the four taps of neighbouring threads hit
// the same cache lines) and no fp32 copy of the source image is ever
// materialised; the normalized value is stored once, in the output dtype.
//
// Arithmetic. Row lerp, then column lerp, in fp32, with the same operation
// order as the plain torch version (_crop_resize_normalize_plain). The
// _rn intrinsics keep nvcc from contracting a*b+c into an fma, so the
// kernel and the plain version agree bit for bit on the card. rintf
// rounds half to even like jnp.round / torch.round; the normalize keeps
// the multiply by the fp32 reciprocal of std.
//
// One thread per output pixel (b, y, x); the C channels are a short loop.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);

template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void crop_resize_normalize_kernel(
    const uint8_t* __restrict__ src, OutT* __restrict__ dst,
    const int* __restrict__ y0, const int* __restrict__ y1,
    const float* __restrict__ fy, const int* __restrict__ x0,
    const int* __restrict__ x1, const float* __restrict__ fx,
    const float* __restrict__ mean, const float* __restrict__ istd,
    int hs, int ws, int hd, int wd, int c, long long total) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (p >= total) return;
  const int x = static_cast<int>(p % wd);
  const long long t = p / wd;
  const int y = static_cast<int>(t % hd);
  const long long b = t / hd;

  const float wy1 = __ldg(fy + y);
  const float wy0 = __fsub_rn(1.0f, wy1);
  const float wx1 = __ldg(fx + x);
  const float wx0 = __fsub_rn(1.0f, wx1);
  const long long row = static_cast<long long>(ws) * c;
  const uint8_t* img = src + b * hs * row;
  const uint8_t* r0 = img + __ldg(y0 + y) * row;
  const uint8_t* r1 = img + __ldg(y1 + y) * row;
  const int c0 = __ldg(x0 + x) * c;
  const int c1 = __ldg(x1 + x) * c;
  OutT* out = dst + p * c;

  for (int k = 0; k < c; ++k) {
    const float v00 = r0[c0 + k], v10 = r1[c0 + k];
    const float v01 = r0[c1 + k], v11 = r1[c1 + k];
    const float left = __fadd_rn(__fmul_rn(v00, wy0), __fmul_rn(v10, wy1));
    const float right = __fadd_rn(__fmul_rn(v01, wy0), __fmul_rn(v11, wy1));
    float z = __fadd_rn(__fmul_rn(left, wx0), __fmul_rn(right, wx1));
    z = fminf(fmaxf(rintf(z), 0.0f), 255.0f);
    out[k] = to_out<OutT>(
        __fmul_rn(__fsub_rn(z, __ldg(mean + k)), __ldg(istd + k)));
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device
// pointer; dst is (b, hd, wd, c) float32, or bfloat16 when out_bf16 != 0.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int crop_resize_normalize(
    const void* src, void* dst, const void* y0, const void* y1,
    const void* fy, const void* x0, const void* x1, const void* fx,
    const void* mean, const void* istd, int b, int hs, int ws, int hd,
    int wd, int c, int out_bf16, void* stream) {
  const long long total = static_cast<long long>(b) * hd * wd;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks =
      static_cast<unsigned int>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  const int* iy0 = static_cast<const int*>(y0);
  const int* iy1 = static_cast<const int*>(y1);
  const float* wy = static_cast<const float*>(fy);
  const int* ix0 = static_cast<const int*>(x0);
  const int* ix1 = static_cast<const int*>(x1);
  const float* wx = static_cast<const float*>(fx);
  const float* mu = static_cast<const float*>(mean);
  const float* is = static_cast<const float*>(istd);
  if (out_bf16) {
    crop_resize_normalize_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        in, static_cast<__nv_bfloat16*>(dst), iy0, iy1, wy, ix0, ix1, wx, mu,
        is, hs, ws, hd, wd, c, total);
  } else {
    crop_resize_normalize_kernel<float><<<blocks, threads, 0, s>>>(
        in, static_cast<float*>(dst), iy0, iy1, wy, ix0, ix1, wx, mu, is, hs,
        ws, hd, wd, c, total);
  }
  return static_cast<int>(cudaGetLastError());
}
