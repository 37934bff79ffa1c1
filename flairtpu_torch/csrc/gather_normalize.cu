// Tile gather fused with channel normalization.
//
// Replaces flairtpu/zone/device_engine.py:124-129 (DeviceZoneRunner._gather,
// a vmapped dynamic_slice) together with flairtpu/data/normalize.py:52-63
// (normalize_device), which XLA fused into one pass on the TPU.
//
// From the margin-padded uint8 zone (Hp, Wp, C) and the (B, 2) int32 tile
// origins (row, col), writes the (B, S, S, C) normalized tiles in float32 or
// bfloat16: NHWC bytes, which the encoder takes as an NCHW channels_last view
// without a copy.
//
// Bound: bytes. Each output element is one uint8 read and one 2- or 4-byte
// write, with no reuse to exploit. One block per output tile row: in the
// (Hp, Wp, C) zone that row is one contiguous run of S*C bytes, so both the
// reads and the writes of neighbouring threads are neighbouring addresses.

// Arithmetic matches normalize_device bit for bit in float32 as the jitted
// zone program computes it (XLA turns the division by a constant into a
// multiply by its float32 reciprocal): `scaling` is x * inv_scale, `custom`
// is (x - mean) * inv_std, with inv_scale = 1/255 and inv_std = 1/std taken
// in float32 by the caller. A lone multiply is never contracted into an FMA.
// bfloat16 output is the round-to-nearest-even cast of that.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 16;

struct NormParams {
  float mean[kMaxChannels];
  float inv_std[kMaxChannels];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// mode 0: scaling (x * inv_scale), 1: custom ((x - mean) * inv_std), 2: without
template <typename T, int kMode>
__global__ void gather_normalize_kernel(const uint8_t* __restrict__ zone, int wp, int c_count,
                                        const int* __restrict__ origins, int size,
                                        NormParams norm, float inv_scale, T* __restrict__ out) {
  const int row = blockIdx.x;  // b * size + y
  const int b = row / size, y = row % size;
  const int r0 = origins[2 * b], c0 = origins[2 * b + 1];
  const uint8_t* src = zone + ((long long)(r0 + y) * wp + c0) * c_count;
  T* dst = out + (long long)row * size * c_count;
  const int run = size * c_count;
  for (int e = threadIdx.x; e < run; e += blockDim.x) {
    float v = (float)src[e];
    if (kMode == 0) {
      v = v * inv_scale;
    } else if (kMode == 1) {
      const int c = e % c_count;
      v = (v - norm.mean[c]) * norm.inv_std[c];
    }
    store(dst + e, v);
  }
}

template <typename T, int kMode>
void launch(const uint8_t* zone, int wp, int c_count, const int* origins, int batch, int size,
            const NormParams& norm, float inv_scale, void* out, cudaStream_t stream) {
  gather_normalize_kernel<T, kMode><<<batch * size, 256, 0, stream>>>(
      zone, wp, c_count, origins, size, norm, inv_scale, static_cast<T*>(out));
}

}  // namespace

// zone: (Hp, wp, c_count) uint8; origins: (batch, 2) int32 inside the padded
// zone; out: (batch, size, size, c_count) float32 (out_bf16 = 0) or bfloat16.
// mean / inv_std: host arrays of c_count floats (read for mode 1 only).
// Returns cudaGetLastError() after the launch.
extern "C" int gather_normalize(const void* zone, int wp, int c_count,
                                const void* origins, int batch, int size, int mode,
                                const float* mean, const float* inv_std, float inv_scale,
                                void* out, int out_bf16, void* stream) {
  if (c_count < 1 || c_count > kMaxChannels || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  NormParams norm{};
  for (int c = 0; c < c_count && mode == 1; ++c) {
    norm.mean[c] = mean[c];
    norm.inv_std[c] = inv_std[c];
  }
  const uint8_t* z = static_cast<const uint8_t*>(zone);
  const int* o = static_cast<const int*>(origins);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    if (mode == 0) launch<__nv_bfloat16, 0>(z, wp, c_count, o, batch, size, norm, inv_scale, out, s);
    else if (mode == 1) launch<__nv_bfloat16, 1>(z, wp, c_count, o, batch, size, norm, inv_scale, out, s);
    else launch<__nv_bfloat16, 2>(z, wp, c_count, o, batch, size, norm, inv_scale, out, s);
  } else {
    if (mode == 0) launch<float, 0>(z, wp, c_count, o, batch, size, norm, inv_scale, out, s);
    else if (mode == 1) launch<float, 1>(z, wp, c_count, o, batch, size, norm, inv_scale, out, s);
    else launch<float, 2>(z, wp, c_count, o, batch, size, norm, inv_scale, out, s);
  }
  return (int)cudaGetLastError();
}
