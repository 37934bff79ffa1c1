// GroupNorm + ReLU (+ 2x nearest upsample) of FPN's Conv3x3GNReLU sites, in
// two passes over the bfloat16 conv output.
//
// Replaces what XLA fused on the TPU at flairtpu/models/smp_extra.py:52-68
// (seven sites a forward, :95-100): nn.GroupNorm(32, epsilon=1e-5,
// dtype=float32) with Flax's statistics (per sample and group, float32, the
// fast variance max(0, E[x^2] - E[x]^2)), nn.relu and upsample2x_nearest:
//
//   out = max(0, (x - mean_g) * (rsqrt(var_g + eps) * gamma_c) + beta_c)
//
// x: (batch, h * w, C) bfloat16 (an NCHW channels_last tensor); out: (batch,
// (u h) * (u w), C) float32, u = 2 where the site upsamples (each pixel
// written to its 2 x 2 copies), else 1. Every multiply and add is rounded on
// its own (__fmul_rn / __fadd_rn), as the plain PyTorch version's separate
// ops are.
//
// Bound: bytes (a few float32 operations per element; the output, float32
// and 4x larger where the site upsamples, is most of them). Both passes walk
// the map in 16-byte accesses, a thread keeping 8 channels of a pixel, and
// a block 512 pixels of one sample:
//   group_norm_stats: each thread sums x and x^2 of its 8 channels over its
//     pixels, the block adds the threads of each channel in a fixed order,
//     then the channels of each group, into (batch, chunks, G) partials;
//   group_norm_apply: each block adds its sample's partials of each group in
//     chunk order (the same sums in every block), takes mean, variance and
//     rsqrt, and writes its 512 pixels, two 16-byte float32 stores each.
// No atomics: two calls give the same bits. The input is read twice (once a
// pass); it is a quarter of the output's bytes or less.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 512;       // pixels a block covers (ops/group_norm.py:PIXELS_PER_BLOCK)
constexpr int kMaxC = 2048;     // 8 channels a thread, at least one pixel a block pass

// 8 bf16 -> float32, exactly (a bf16 is the top half of a float32)
__device__ __forceinline__ void unpack8(const uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__global__ void __launch_bounds__(kThreads)
    stats_kernel(const uint4* __restrict__ x, float2* __restrict__ partials, long long hw,
                 int C, int G, int chunks) {
  __shared__ float red_s[kThreads * 8], red_q[kThreads * 8];
  __shared__ float ch_s[kMaxC], ch_q[kMaxC];
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int noct = C / 8, lanes = kThreads / noct;
  const int oct = threadIdx.x % noct, lane = threadIdx.x / noct;
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.f;
  const long long p0 = (long long)chunk * kPix;
  const long long p1 = min(hw, p0 + kPix);
  const uint4* src = x + (long long)b * hw * noct + oct;
  for (long long p = p0 + lane; p < p1; p += lanes) {
    float f[8];
    unpack8(__ldg(src + p * noct), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] = __fadd_rn(s[i], f[i]);
      q[i] = __fadd_rn(q[i], __fmul_rn(f[i], f[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red_s[lane * C + oct * 8 + i] = s[i];
    red_q[lane * C + oct * 8 + i] = q[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {  // each channel, lanes in order
    float cs = 0.f, cq = 0.f;
    for (int l = 0; l < lanes; ++l) {
      cs = __fadd_rn(cs, red_s[l * C + c]);
      cq = __fadd_rn(cq, red_q[l * C + c]);
    }
    ch_s[c] = cs;
    ch_q[c] = cq;
  }
  __syncthreads();
  const int gs = C / G;
  for (int g = threadIdx.x; g < G; g += kThreads) {  // each group, channels in order
    float gsum = 0.f, gsq = 0.f;
    for (int c = g * gs; c < (g + 1) * gs; ++c) {
      gsum = __fadd_rn(gsum, ch_s[c]);
      gsq = __fadd_rn(gsq, ch_q[c]);
    }
    partials[((long long)b * chunks + chunk) * G + g] = make_float2(gsum, gsq);
  }
}

template <bool kUp>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const uint4* __restrict__ x, const float2* __restrict__ partials,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 float* __restrict__ out, int h, int w, int C, int G, int chunks, float eps) {
  __shared__ float g_mean[kMaxC], g_inv[kMaxC];
  const int b = blockIdx.y, chunk = blockIdx.x;
  const long long hw = (long long)h * w;
  const int gs = C / G;
  const float n = (float)(hw * gs);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float sum = 0.f, sq = 0.f;
    const float2* pp = partials + (long long)b * chunks * G + g;
    for (int c = 0; c < chunks; ++c) {
      const float2 v = pp[(long long)c * G];
      sum = __fadd_rn(sum, v.x);
      sq = __fadd_rn(sq, v.y);
    }
    const float mean = __fdiv_rn(sum, n);
    const float var = fmaxf(0.f, __fsub_rn(__fdiv_rn(sq, n), __fmul_rn(mean, mean)));
    g_mean[g] = mean;
    g_inv[g] = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  const int noct = C / 8, lanes = kThreads / noct;
  const int oct = threadIdx.x % noct, lane = threadIdx.x / noct;
  float mean[8], mul[8], add[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = oct * 8 + i;
    mean[i] = g_mean[c / gs];
    mul[i] = __fmul_rn(g_inv[c / gs], gamma[c]);
    add[i] = beta[c];
  }
  const long long p0 = (long long)chunk * kPix;
  const long long p1 = min(hw, p0 + kPix);
  const uint4* src = x + (long long)b * hw * noct + oct;
  float* dst = out + (long long)b * hw * (kUp ? 4 : 1) * C + oct * 8;
  for (long long p = p0 + lane; p < p1; p += lanes) {
    float f[8];
    unpack8(__ldg(src + p * noct), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = __fadd_rn(__fmul_rn(__fsub_rn(f[i], mean[i]), mul[i]), add[i]);
      f[i] = v < 0.f ? 0.f : v;  // NaN passes, as torch.relu
    }
    const float4 lo = make_float4(f[0], f[1], f[2], f[3]);
    const float4 hi = make_float4(f[4], f[5], f[6], f[7]);
    if (kUp) {
      const long long r = p / w, c = p - r * w;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float4* o = reinterpret_cast<float4*>(
            dst + ((2 * r + (d >> 1)) * (2LL * w) + 2 * c + (d & 1)) * C);
        o[0] = lo;
        o[1] = hi;
      }
    } else {
      float4* o = reinterpret_cast<float4*>(dst + p * C);
      o[0] = lo;
      o[1] = hi;
    }
  }
}

bool channels_ok(int C, int G) {
  return C >= 8 && C <= kMaxC && C % 8 == 0 && kThreads % (C / 8) == 0 && G >= 1 && C % G == 0;
}

}  // namespace

// Pass 1. x: (batch, hw, C) bfloat16, 16-byte aligned; partials: (batch,
// chunks, G) float2 (sum, sum of squares); chunks = ceil(hw / 512).
extern "C" int group_norm_stats(const void* x, void* partials, int batch, long long hw, int C,
                                int G, int chunks, void* stream) {
  if (batch < 1 || hw < 1 || !channels_ok(C, G) || chunks != (int)((hw + kPix - 1) / kPix))
    return (int)cudaErrorInvalidValue;
  stats_kernel<<<dim3(chunks, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<float2*>(partials), hw, C, G, chunks);
  return (int)cudaGetLastError();
}

// Pass 2. gamma, beta: C float32; out: (batch, (u h) * (u w), C) float32,
// u = 2 if upsample, else 1.
extern "C" int group_norm_apply(const void* x, const void* partials, const void* gamma,
                                const void* beta, void* out, int batch, int h, int w, int C,
                                int G, int chunks, float eps, int upsample, void* stream) {
  const long long hw = (long long)h * w;
  if (batch < 1 || hw < 1 || !channels_ok(C, G) || chunks != (int)((hw + kPix - 1) / kPix))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(chunks, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  const float2* pp = static_cast<const float2*>(partials);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* o = static_cast<float*>(out);
  if (upsample)
    apply_kernel<true><<<grid, kThreads, 0, s>>>(xv, pp, gm, bt, o, h, w, C, G, chunks, eps);
  else
    apply_kernel<false><<<grid, kThreads, 0, s>>>(xv, pp, gm, bt, o, h, w, C, G, chunks, eps);
  return (int)cudaGetLastError();
}
