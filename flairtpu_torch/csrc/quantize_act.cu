// Activation requantize: float32 or bfloat16 NHWC -> int8, one per-tensor
// scale.
//
// Replaces the XLA requantize of flairtpu/models/quantize.py:223,
//   q = clip(round(x / sx), -127, 127).astype(int8),
// where the int8 walk's input is not already the int8 output of the site
// before it (ops/int8_conv.py): the stem's input, the normalized tile; the
// max-pooled stem output; and the decoder's int8 blocks, whose input is
// cat(upsample2x(x), skip) under one scale. In flairtpu's jitted zone
// program sx is a constant, and XLA computes x / sx as x * float32(1 / sx):
//   q = clamp(rint(x * inv_sx), -127, 127)     (rint: half to even, as jnp.round)
// The output may have more channels than the input (cp >= c, the stem's 5
// padded to 8 for the int8 conv's 8-byte gathers); those are 0.
//
// Bound: bytes (one multiply, a rounding and a clamp per element against 5
// or 3 bytes moved). A thread writes 8 output channels of one pixel as one
// 8-byte store; where c == cp and the input is 16-byte aligned it reads
// them with 16-byte loads (two for float32), else one element at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t quantize4(const float (&v)[8], int base, float inv) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = fminf(fmaxf(rintf(__fmul_rn(v[base + i], inv)), -127.f), 127.f);
    out |= (static_cast<uint32_t>(static_cast<int>(t)) & 0xffu) << (8 * i);
  }
  return out;
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    quantize_act_kernel(const T* __restrict__ x, uint2* __restrict__ out, long long n_groups,
                        int c, int cp, float inv) {
  const int groups_per_pix = cp / 8;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < n_groups; g += step) {
    float v[8];
    if constexpr (kVec) {  // c == cp: the group is 8 consecutive inputs
      if constexpr (sizeof(T) == 4) {
        const float4* p = reinterpret_cast<const float4*>(x) + 2 * g;
        const float4 a = __ldg(p), b = __ldg(p + 1);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      } else {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(x) + g);
        const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[2 * i] = __uint_as_float(u[i] << 16);
          v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
      }
    } else {
      const long long pix = g / groups_per_pix;
      const int c0 = (int)(g - pix * groups_per_pix) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = c0 + i < c ? to_float<T>(x[pix * c + c0 + i]) : 0.f;
    }
    out[g] = make_uint2(quantize4(v, 0, inv), quantize4(v, 4, inv));
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool kVec>
cudaError_t launch(const void* x, void* out, long long n_groups, int c, int cp, float inv,
                   cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, quantize_act_kernel<T, kVec>, kThreads, 0)) != cudaSuccess)
    return err;
  const long long need = (n_groups + kThreads - 1) / kThreads;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(need < full ? need : full);
  quantize_act_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<uint2*>(out), n_groups, c, cp, inv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* out, long long n_groups, int c, int cp, float inv,
                     cudaStream_t stream) {
  if (c == cp && aligned16(x)) return launch<T, true>(x, out, n_groups, c, cp, inv, stream);
  return launch<T, false>(x, out, n_groups, c, cp, inv, stream);
}

}  // namespace

// x: (n_pix, c) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1); out:
// (n_pix, cp) int8, 8-byte aligned, cp >= c and a multiple of 8. Returns
// cudaGetLastError() after the launch.
extern "C" int quantize_act(const void* x, int x_bf16, void* out, long long n_pix, int c, int cp,
                            float inv_sx, void* stream) {
  if (c < 1 || cp < c || cp % 8 || n_pix < 0 || (reinterpret_cast<uintptr_t>(out) & 7))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return (int)cudaSuccess;
  const long long n_groups = n_pix * (cp / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return (int)dispatch<__nv_bfloat16>(x, out, n_groups, c, cp, inv_sx, s);
  return (int)dispatch<float>(x, out, n_groups, c, cp, inv_sx, s);
}
