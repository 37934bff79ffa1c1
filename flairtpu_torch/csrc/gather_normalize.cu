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
// Bound: bytes, and mostly the output's: at 512/128, batch 128, C = 5 the
// bf16 tiles are 335 MB against 50 MB of distinct zone bytes (neighbouring
// tiles share half their rows, and those re-reads hit L2). So every store is
// 16 bytes: a thread makes 8 consecutive outputs of one tile row at a time
// (one 16-byte bf16 store, or two for float32). Output row y of tile b is
// the run of S*C zone bytes from ((r0 + y) * Wp + c0) * C, which starts at
// any byte; its 8 input bytes come from the one or two aligned 8-byte words
// that hold them, funnel-shifted together. Neighbouring threads take
// neighbouring groups of a row, so a warp stores 512 contiguous bytes and
// loads about 256. A grid of as many blocks as fit on the SMs walks all
// (row, group) pairs, each thread loading 4 groups before it stores any, and
// the stores stream past L2. In `custom` mode the 8 channels of a group start
// at phase e % C; the per-channel constants sit in shared memory repeated
// past C, so the 8 are read in a row with no modulo in the inner loop.
//
// When S*C is not a multiple of 8, a row does not start on a 16-byte output
// boundary; that case takes a second instance whose groups are aligned to
// the output tensor, with the row's partial first and last groups written
// one element at a time. The aligned instance has no such branch.
//
// Arithmetic matches normalize_device bit for bit in float32 as the jitted
// zone program computes it (XLA turns the division by a constant into a
// multiply by its float32 reciprocal): `scaling` is x * inv_scale, `custom`
// is (x - mean) * inv_std, with inv_scale = 1/255 and inv_std = 1/std taken
// in float32 by the caller. bfloat16 output is the round-to-nearest-even
// cast of that.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 16;
constexpr int kThreads = 256;
constexpr int kDepth = 4;  // units a thread loads before it stores

struct NormParams {
  float mean[kMaxChannels];
  float inv_std[kMaxChannels];
};

// 8 consecutive bytes from any address: the aligned 8-byte word that holds
// the first, and when they straddle, the next one, shifted together. Every
// word read holds at least one of the 8 bytes, so no read leaves the zone's
// allocation.
__device__ __forceinline__ unsigned long long load8(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned sh = (unsigned)(a & 7) * 8;
  const unsigned long long* q = reinterpret_cast<const unsigned long long*>(a & ~(uintptr_t)7);
  unsigned long long v = __ldg(q);
  if (sh) v = (v >> sh) | (__ldg(q + 1) << (64 - sh));
  return v;
}

// mode 0: scaling (x * inv_scale), 1: custom ((x - mean) * inv_std), 2: without
template <int kMode>
__device__ __forceinline__ float normalize(unsigned x, float mean, float inv_std,
                                           float inv_scale) {
  const float v = (float)x;
  if constexpr (kMode == 0) return __fmul_rn(v, inv_scale);
  if constexpr (kMode == 1) return __fmul_rn(__fsub_rn(v, mean), inv_std);
  return v;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// Streaming stores (evict first): the tiles are read back only by the next
// kernel, long after L2 has turned over, and they should not evict the zone
// rows that the next tile reads again.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  __stcs(reinterpret_cast<uint4*>(p),
         make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7])));
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  __stcs(q, make_float4(v[0], v[1], v[2], v[3]));
  __stcs(q + 1, make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Unit u is group g of output row `row` (= b * size + y); `groups` units a row.
// kRagged: groups start at multiples of 8 of the whole output, not of the row.
// A thread takes kDepth units a trip (u, u + step, ...) and loads all their
// zone bytes before it stores any, so that enough loads are in flight to
// cover the latency of L2 under the stream of stores.
template <typename T, int kMode, bool kRagged>
__global__ void __launch_bounds__(kThreads)
    gather_normalize_kernel(const uint8_t* __restrict__ zone, long long pitch, int c_count,
                            const int* __restrict__ origins, int size, int run, unsigned groups,
                            unsigned n_units, const NormParams norm, float inv_scale,
                            T* __restrict__ out) {
  __shared__ float s_mean[kMaxChannels + 8], s_inv[kMaxChannels + 8];
  if constexpr (kMode == 1) {
    for (int i = threadIdx.x; i < c_count + 8; i += kThreads) {
      s_mean[i] = norm.mean[i % c_count];
      s_inv[i] = norm.inv_std[i % c_count];
    }
    __syncthreads();
  }
  const unsigned step = gridDim.x * kThreads;
  for (unsigned u = blockIdx.x * kThreads + threadIdx.x; u < n_units; u += kDepth * step) {
    const uint8_t* src[kDepth];
    T* dst[kDepth];
    int e0[kDepth];
    unsigned long long bytes[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const unsigned uk = u + k * step;
      if (uk >= n_units) break;
      const unsigned row = uk / groups, g = uk - row * groups;
      const unsigned b = row / size, y = row - b * size;
      const int r0 = __ldg(origins + 2 * b), c0 = __ldg(origins + 2 * b + 1);
      src[k] = zone + (long long)(r0 + (int)y) * pitch + (long long)c0 * c_count;
      const long long o0 = (long long)row * run;
      dst[k] = out + o0;
      e0[k] = 8 * (int)g;  // the group's first element in the row
      if constexpr (kRagged) e0[k] -= (int)(o0 & 7);
      if (!kRagged || (e0[k] >= 0 && e0[k] + 8 <= run)) bytes[k] = load8(src[k] + e0[k]);
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (u + k * step >= n_units) break;
      const int e = e0[k];
      if (!kRagged || (e >= 0 && e + 8 <= run)) {
        const int ph = kMode == 1 ? e % c_count : 0;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned x = (unsigned)(bytes[k] >> (8 * j)) & 0xffu;
          if constexpr (kMode == 1) v[j] = normalize<kMode>(x, s_mean[ph + j], s_inv[ph + j], 0.f);
          else v[j] = normalize<kMode>(x, 0.f, 0.f, inv_scale);
        }
        store8(dst[k] + e, v);
      } else {
        for (int i = e < 0 ? 0 : e; i < e + 8 && i < run; ++i) {
          const int c = i % c_count;
          if constexpr (kMode == 1) {
            store1(dst[k] + i, normalize<kMode>(src[k][i], s_mean[c], s_inv[c], 0.f));
          } else {
            store1(dst[k] + i, normalize<kMode>(src[k][i], 0.f, 0.f, inv_scale));
          }
        }
      }
    }
  }
}

template <typename T, int kMode, bool kRagged>
cudaError_t launch(const uint8_t* zone, int wp, int c_count, const int* origins, int batch,
                   int size, const NormParams& norm, float inv_scale, void* out,
                   cudaStream_t stream) {
  const auto kernel = gather_normalize_kernel<T, kMode, kRagged>;
  const int run = size * c_count;
  const unsigned long long groups = kRagged ? (run + 7) / 8 + 1 : run / 8;
  const unsigned long long n_units = groups * batch * size;
  if (n_units == 0) return cudaSuccess;
  // unit indices are 32-bit: u + kDepth * step must not wrap
  if (n_units > 0xffffffffull - (1ull << 28)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const unsigned long long need = (n_units + kThreads - 1) / kThreads;
  const unsigned long long full = (unsigned long long)sms * per_sm;
  kernel<<<(int)(need < full ? need : full), kThreads, 0, stream>>>(
      zone, (long long)wp * c_count, c_count, origins, size, run, (unsigned)groups,
      (unsigned)n_units, norm, inv_scale, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t dispatch(const uint8_t* zone, int wp, int c_count, const int* origins, int batch,
                     int size, const NormParams& norm, float inv_scale, void* out,
                     cudaStream_t stream) {
  if ((size * c_count) % 8 == 0)
    return launch<T, kMode, false>(zone, wp, c_count, origins, batch, size, norm, inv_scale, out,
                                   stream);
  return launch<T, kMode, true>(zone, wp, c_count, origins, batch, size, norm, inv_scale, out,
                                stream);
}

template <typename T>
cudaError_t dispatch(int mode, const uint8_t* zone, int wp, int c_count, const int* origins,
                     int batch, int size, const NormParams& norm, float inv_scale, void* out,
                     cudaStream_t stream) {
  if (mode == 0) return dispatch<T, 0>(zone, wp, c_count, origins, batch, size, norm, inv_scale, out, stream);
  if (mode == 1) return dispatch<T, 1>(zone, wp, c_count, origins, batch, size, norm, inv_scale, out, stream);
  return dispatch<T, 2>(zone, wp, c_count, origins, batch, size, norm, inv_scale, out, stream);
}

}  // namespace

// zone: (Hp, wp, c_count) uint8; origins: (batch, 2) int32 inside the padded
// zone; out: (batch, size, size, c_count) float32 (out_bf16 = 0) or bfloat16,
// 16-byte aligned. mean / inv_std: host arrays of c_count floats (read for
// mode 1 only). Returns cudaGetLastError() after the launch.
extern "C" int gather_normalize(const void* zone, int wp, int c_count,
                                const void* origins, int batch, int size, int mode,
                                const float* mean, const float* inv_std, float inv_scale,
                                void* out, int out_bf16, void* stream) {
  if (c_count < 1 || c_count > kMaxChannels || mode < 0 || mode > 2 || batch < 0 || size < 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  NormParams norm{};
  for (int c = 0; c < c_count && mode == 1; ++c) {
    norm.mean[c] = mean[c];
    norm.inv_std[c] = inv_std[c];
  }
  const uint8_t* z = static_cast<const uint8_t*>(zone);
  const int* o = static_cast<const int*>(origins);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return (int)dispatch<__nv_bfloat16>(mode, z, wp, c_count, o, batch, size, norm, inv_scale, out, s);
  return (int)dispatch<float>(mode, z, wp, c_count, o, batch, size, norm, inv_scale, out, s);
}
