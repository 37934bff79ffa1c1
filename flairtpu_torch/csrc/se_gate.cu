// Squeeze-excite at an EfficientNet block's depthwise site, in two launches
// around the gate's two small convs.
//
// Replaces what XLA fused on the TPU at flairtpu/models/efficientnet.py:
// 191-201: the depthwise conv's BatchNorm and SiLU (:191), the squeeze-excite
// mean in float32 (:193), and the sigmoid gate's multiply on the float32 SiLU
// value (:199), cast to the compute dtype at the project conv (:200-201).
// No Pallas kernel computed it; PyTorch would write the float32 SiLU map
// (4 bytes an element) and read it back twice.
//
//   squeeze: mean[b, c] = sum_p silu(y[b, p, c] * scale[c] + shift[c]) / HW
//   excite:  out[b, p, c] = bf16(silu(y[b, p, c] * scale[c] + shift[c]) * gate[b, c])
//
// with silu(v) = v * (1 / (1 + exp(-v))), every multiply, add and divide
// rounded on its own (no FMA contraction) and expf the accurate one, as the
// plain PyTorch version (ops/se_gate.py: v * torch.sigmoid(v)) computes it.
// y, out: (B, HW, C) bfloat16, NHWC (an NCHW channels_last tensor), C a
// multiple of 8, 16-byte aligned; scale, shift: C float32 (the inference
// BatchNorm); gate: (B, C) float32, the sigmoid of the small convs' output.
//
// Bound: bytes. The squeeze reads the bf16 map once and writes B x C
// floats; the excite reads it once more and writes it once: 6 bytes an
// element over the pair, against about 8 float32 operations and one exp
// an element. Both read in 16-byte accesses, 8 channels a thread,
// neighbouring threads on neighbouring channel groups of a pixel and then of
// the next pixel, each thread issuing kUnroll loads before it computes any
// of them, so that enough bytes are in flight. The accurate expf and the
// rounded divide (which keep the bits of torch.sigmoid) cost some 20-40
// instructions an element, so on an H100 the squeeze, with half the bytes
// of the excite an element, is held by instruction issue rather than by
// its bytes (PERF.md).
//
// Squeeze: block (channel tile, split, b) reduces a tile of `group_tile`
// 8-channel groups (a divisor of C / 8, at most 32) over its split of the
// pixels: each thread a fixed group and every `rows`-th pixel, then the
// block's rows summed in a fixed order in shared memory into partial[b,
// split, tile]. The splits fill the card (ops/se_gate.py:squeeze_plan).
// The last block of (b, tile) to finish, by an atomic ticket, sums the
// partials in split order and divides by HW: the result does not depend on
// which block finished when. The tickets are zeroed by the entry point
// before the launch.
//
// Excite: block (x, b) walks b's map with a grid-stride step that is a
// multiple of C / 8, so each thread keeps one channel group, with its
// scale, shift and gate in registers, for the whole walk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroupTile = 32;
// pixels (squeeze) or channel groups (excite) a thread loads before it
// computes any of them: 16-byte loads in flight a thread
constexpr int kUnroll = 2;

__device__ __forceinline__ float silu_bn(float y, float s, float t) {
  const float v = __fadd_rn(__fmul_rn(y, s), t);
  return __fmul_rn(v, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))));
}

// 8 bf16 -> float32, exactly (a bf16 is the top half of a float32)
__device__ __forceinline__ void unpack8(const uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

struct SqueezeArgs {
  const uint4* y;
  const float* scale;
  const float* shift;
  float* partial;           // (B, n_split, C)
  unsigned int* tickets;    // (B, tiles), zero before the launch
  float* mean;              // (B, C)
  long long hw;
  int channels;
  int group_tile;
  int n_split;
};

__global__ void __launch_bounds__(kThreads) se_squeeze_kernel(const SqueezeArgs a) {
  __shared__ float sums[kThreads * 8];
  __shared__ bool last;
  const int tile = blockIdx.x, split = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int gt = a.group_tile, rows = kThreads / gt, width = gt * 8;
  const int c8 = a.channels / 8;
  const int g = t % gt, r = t / gt;
  const int c0 = (tile * gt + g) * 8;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  if (r < rows) {
    float s[8], sh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = __ldg(a.scale + c0 + j);
      sh[j] = __ldg(a.shift + c0 + j);
    }
    const long long p0 = a.hw * split / a.n_split, p1 = a.hw * (split + 1) / a.n_split;
    const uint4* y = a.y + (long long)b * a.hw * c8 + c0 / 8;
    for (long long p = p0 + r; p < p1; p += kUnroll * rows) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + u * rows < p1) w[u] = __ldg(y + (p + u * rows) * c8);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * rows >= p1) break;
        float v[8];
        unpack8(w[u], v);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], silu_bn(v[j], s[j], sh[j]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) sums[t * 8 + j] = acc[j];  // row r, column g * 8 + j
  __syncthreads();
  const long long col0 = (long long)tile * width;
  if (t < width) {
    float total = 0.f;
    for (int rr = 0; rr < rows; ++rr) total = __fadd_rn(total, sums[rr * width + t]);
    a.partial[((long long)b * a.n_split + split) * a.channels + col0 + t] = total;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) {
    const unsigned int ticket = atomicAdd(a.tickets + (long long)b * gridDim.x + tile, 1u);
    last = ticket == (unsigned int)(a.n_split - 1);
  }
  __syncthreads();
  if (!last || t >= width) return;
  const float* col = a.partial + (long long)b * a.n_split * a.channels + col0 + t;
  float total = 0.f;
  for (int sp = 0; sp < a.n_split; ++sp)
    total = __fadd_rn(total, __ldcg(col + (long long)sp * a.channels));
  a.mean[(long long)b * a.channels + col0 + t] = __fdiv_rn(total, (float)a.hw);
}

struct ExciteArgs {
  const uint4* y;
  const float* scale;
  const float* shift;
  const float* gate;  // (B, C)
  uint4* out;
  long long hw;
  int channels;
  int lanes;          // threads a b walks with: a multiple of C / 8
};

__global__ void __launch_bounds__(kThreads) se_excite_kernel(const ExciteArgs a) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.lanes) return;
  const int b = blockIdx.y, c8 = a.channels / 8;
  const int g = lane % c8, c0 = g * 8;
  float s[8], sh[8], gate[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = __ldg(a.scale + c0 + j);
    sh[j] = __ldg(a.shift + c0 + j);
    gate[j] = __ldg(a.gate + (long long)b * a.channels + c0 + j);
  }
  const long long n = a.hw * c8, base = (long long)b * n;
  for (long long e = lane; e < n; e += kUnroll * (long long)a.lanes) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (e + u * (long long)a.lanes < n) w[u] = __ldg(a.y + base + e + u * (long long)a.lanes);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = e + u * (long long)a.lanes;
      if (at >= n) break;
      float v[8];
      unpack8(w[u], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(silu_bn(v[j], s[j], sh[j]), gate[j]);
      a.out[base + at] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                                    pack2(v[6], v[7]));
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// y: (batch, hw, channels) bf16; scale, shift: channels float32; partial:
// (batch, n_split, channels) float32 scratch; tickets: batch x
// (channels / 8 / group_tile) uint32 scratch; mean: (batch, channels)
// float32. group_tile divides channels / 8 and is at most 32 (ops/se_gate.py:
// squeeze_plan). Returns cudaGetLastError() after the launch.
extern "C" int se_squeeze(const void* y, const void* scale, const void* shift, void* partial,
                          void* tickets, void* mean, int batch, long long hw, int channels,
                          int group_tile, int n_split, void* stream) {
  if (batch < 1 || hw < 1 || channels < 8 || channels % 8 || group_tile < 1 ||
      group_tile > kMaxGroupTile || (channels / 8) % group_tile || n_split < 1 ||
      n_split > hw || n_split > 65535 || batch > 65535 || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  const int tiles = channels / 8 / group_tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(tickets, 0, sizeof(unsigned int) * batch * tiles, s);
  if (err != cudaSuccess) return (int)err;
  const SqueezeArgs a{static_cast<const uint4*>(y), static_cast<const float*>(scale),
                      static_cast<const float*>(shift), static_cast<float*>(partial),
                      static_cast<unsigned int*>(tickets), static_cast<float*>(mean), hw,
                      channels, group_tile, n_split};
  se_squeeze_kernel<<<dim3(tiles, n_split, batch), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// y, out: (batch, hw, channels) bf16; scale, shift: channels float32; gate:
// (batch, channels) float32. Returns cudaGetLastError() after the launch.
extern "C" int se_excite(const void* y, const void* scale, const void* shift, const void* gate,
                         void* out, int batch, long long hw, int channels, void* stream) {
  if (batch < 1 || hw < 1 || channels < 8 || channels % 8 || !aligned16(y) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, se_excite_kernel, kThreads,
                                                           0)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // as many blocks as fit on the card at once, shared out over the batch,
  // each b walked by a whole number of channel-group rows
  const int c8 = channels / 8;
  const long long n = hw * c8;
  long long per_b = ((long long)sms * per_sm + batch - 1) / batch;
  const long long need = (n + kThreads - 1) / kThreads;
  if (per_b > need) per_b = need;
  long long lanes = per_b * kThreads / c8 * c8;
  if (lanes < c8) {
    lanes = c8;
    per_b = (c8 + kThreads - 1) / kThreads;
  }
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const ExciteArgs a{static_cast<const uint4*>(y), static_cast<const float*>(scale),
                     static_cast<const float*>(shift), static_cast<const float*>(gate),
                     static_cast<uint4*>(out), hw, channels, (int)lanes};
  se_excite_kernel<<<dim3((unsigned)per_b, batch), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
