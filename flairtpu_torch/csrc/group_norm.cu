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
// pass); it is a quarter of the output's bytes or less. In train mode the
// apply pass's first block of each sample also writes that sample's
// (mean_g, rstd_g), float32, for the backward.
//
// The backward (group_norm_backward: three launches) is the VJP of the
// same function, which replaces what XLA's autodiff fused on the TPU for
// flairtpu's train step through those sites (jax.value_and_grad at
// flairtpu/train/loop.py:286-311). With g the float32 gradient of the
// output, u x u copies a pixel:
//
//   dz = [z > 0] * sum of g over the pixel's u x u copies,   z recomputed
//        from x and the saved statistics exactly as the forward computed it
//   xh = (x - mean_g) * rstd_g
//   dbeta_c = sum dz;  dgamma_c = sum dz * xh             (over samples, pixels)
//   dy = rstd_g * (dz * gamma_c - mean_g(dz * gamma) - xh * mean_g(dz * gamma * xh))
//
// rounded to bfloat16 (the gradient of the bf16 conv output):
//   back_reduce: per (sample, chunk of 512 pixels) the per-channel sums of
//     dz and dz * xh in a fixed order, and their gamma-weighted sums over
//     each group;
//   back_apply: each block adds its sample's group sums in chunk order,
//     reads x and g again (the second read of a chunk the first pass left
//     in L2, where it fits) and writes dy;
//   back_params: a block a channel adds the per-channel sums over samples
//     and chunks in a fixed order (a strided walk, then a shared-memory
//     tree) into dgamma and dbeta.
// Bound: bytes (x and g read once, dy written once; g, float32 and u^2
// times the map, is most of them). The design reads x and g twice.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 512;       // pixels a block covers (ops/group_norm.py:PIXELS_PER_BLOCK)
constexpr int kMaxC = 2048;     // 8 channels a thread, at least one pixel a block pass

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
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
                 float* __restrict__ out, float* __restrict__ stats, int h, int w, int C,
                 int G, int chunks, float eps) {
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
    if (stats != nullptr && chunk == 0) {  // train mode: (mean, rstd) for the backward
      stats[(long long)b * G + g] = mean;
      stats[((long long)gridDim.y + b) * G + g] = g_inv[g];
    }
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

// The channel constants of a thread's 8 channels (oct), as the forward's
// apply computes them, and the u x u sum of g at pixel p of a sample.
struct GnThread {
  float mean[8], rstd[8], mul[8], add[8];
  __device__ GnThread(const float* __restrict__ gmean, const float* __restrict__ grstd,
                      const float* __restrict__ gamma, const float* __restrict__ beta, int oct,
                      int gs) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = oct * 8 + i;
      mean[i] = gmean[c / gs];
      rstd[i] = grstd[c / gs];
      mul[i] = __fmul_rn(rstd[i], gamma[c]);
      add[i] = beta[c];
    }
  }
  // dz and xh of the 8 channels of pixel value f with output gradient gs8
  __device__ void grads(const float (&f)[8], const float (&gsum)[8], float (&dz)[8],
                        float (&xh)[8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __fsub_rn(f[i], mean[i]);
      const float v = __fadd_rn(__fmul_rn(d, mul[i]), add[i]);
      dz[i] = v > 0.f ? gsum[i] : 0.f;
      xh[i] = __fmul_rn(d, rstd[i]);
    }
  }
};

template <bool kUp>
__device__ __forceinline__ void grad_sum(const float* __restrict__ gs, long long p, int w, int C,
                                         float (&out)[8]) {
  if (kUp) {
    const long long r = p / w, c = p - r * w;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float4* q = reinterpret_cast<const float4*>(
          gs + ((2 * r + (d >> 1)) * (2LL * w) + 2 * c + (d & 1)) * C);
      const float4 lo = __ldg(q), hi = __ldg(q + 1);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = d == 0 ? v[i] : __fadd_rn(out[i], v[i]);
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(gs + p * C);
    const float4 lo = __ldg(q), hi = __ldg(q + 1);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = v[i];
  }
}

template <bool kUp>
__global__ void __launch_bounds__(kThreads)
    back_reduce_kernel(const uint4* __restrict__ x, const float* __restrict__ g,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       float2* __restrict__ chan_partials,
                       float2* __restrict__ group_partials, int h, int w, int C, int G,
                       int chunks) {
  __shared__ float red_s[kThreads * 8], red_q[kThreads * 8];
  __shared__ float ch_s[kMaxC], ch_q[kMaxC];
  const int b = blockIdx.y, chunk = blockIdx.x;
  const long long hw = (long long)h * w;
  const int noct = C / 8, lanes = kThreads / noct, gs = C / G;
  const int oct = threadIdx.x % noct, lane = threadIdx.x / noct;
  const GnThread t(mean + (long long)b * G, rstd + (long long)b * G, gamma, beta, oct, gs);
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.f;
  const long long p0 = (long long)chunk * kPix;
  const long long p1 = min(hw, p0 + kPix);
  const uint4* src = x + (long long)b * hw * noct + oct;
  const float* gb = g + (long long)b * hw * (kUp ? 4 : 1) * C + oct * 8;
  for (long long p = p0 + lane; p < p1; p += lanes) {
    float f[8], gsum[8], dz[8], xh[8];
    unpack8(__ldg(src + p * noct), f);
    grad_sum<kUp>(gb, p, w, C, gsum);
    t.grads(f, gsum, dz, xh);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] = __fadd_rn(s[i], dz[i]);
      q[i] = __fadd_rn(q[i], __fmul_rn(dz[i], xh[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red_s[lane * C + oct * 8 + i] = s[i];
    red_q[lane * C + oct * 8 + i] = q[i];
  }
  __syncthreads();
  float2* cp = chan_partials + ((long long)b * chunks + chunk) * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {  // each channel, lanes in order
    float cs = 0.f, cq = 0.f;
    for (int l = 0; l < lanes; ++l) {
      cs = __fadd_rn(cs, red_s[l * C + c]);
      cq = __fadd_rn(cq, red_q[l * C + c]);
    }
    ch_s[c] = cs;
    ch_q[c] = cq;
    cp[c] = make_float2(cs, cq);
  }
  __syncthreads();
  for (int gi = threadIdx.x; gi < G; gi += kThreads) {  // gamma-weighted, channels in order
    float a = 0.f, bq = 0.f;
    for (int c = gi * gs; c < (gi + 1) * gs; ++c) {
      a = __fadd_rn(a, __fmul_rn(gamma[c], ch_s[c]));
      bq = __fadd_rn(bq, __fmul_rn(gamma[c], ch_q[c]));
    }
    group_partials[((long long)b * chunks + chunk) * G + gi] = make_float2(a, bq);
  }
}

template <bool kUp>
__global__ void __launch_bounds__(kThreads)
    back_apply_kernel(const uint4* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float2* __restrict__ group_partials,
                      uint4* __restrict__ dy, int h, int w, int C, int G, int chunks) {
  __shared__ float g_a[kMaxC], g_b[kMaxC];
  const int b = blockIdx.y, chunk = blockIdx.x;
  const long long hw = (long long)h * w;
  const int gs = C / G;
  const float n = (float)(hw * gs);
  for (int gi = threadIdx.x; gi < G; gi += kThreads) {
    float a = 0.f, bq = 0.f;
    const float2* pp = group_partials + (long long)b * chunks * G + gi;
    for (int c = 0; c < chunks; ++c) {
      const float2 v = pp[(long long)c * G];
      a = __fadd_rn(a, v.x);
      bq = __fadd_rn(bq, v.y);
    }
    g_a[gi] = __fdiv_rn(a, n);
    g_b[gi] = __fdiv_rn(bq, n);
  }
  __syncthreads();
  const int noct = C / 8, lanes = kThreads / noct;
  const int oct = threadIdx.x % noct, lane = threadIdx.x / noct;
  const GnThread t(mean + (long long)b * G, rstd + (long long)b * G, gamma, beta, oct, gs);
  float gam[8], ma[8], mb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = oct * 8 + i;
    gam[i] = gamma[c];
    ma[i] = g_a[c / gs];
    mb[i] = g_b[c / gs];
  }
  const long long p0 = (long long)chunk * kPix;
  const long long p1 = min(hw, p0 + kPix);
  const uint4* src = x + (long long)b * hw * noct + oct;
  uint4* dst = dy + (long long)b * hw * noct + oct;
  const float* gb = g + (long long)b * hw * (kUp ? 4 : 1) * C + oct * 8;
  for (long long p = p0 + lane; p < p1; p += lanes) {
    float f[8], gsum[8], dz[8], xh[8], o[8];
    unpack8(__ldg(src + p * noct), f);
    grad_sum<kUp>(gb, p, w, C, gsum);
    t.grads(f, gsum, dz, xh);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dxh = __fmul_rn(dz[i], gam[i]);
      o[i] = __fmul_rn(t.rstd[i], __fsub_rn(__fsub_rn(dxh, ma[i]), __fmul_rn(xh[i], mb[i])));
    }
    dst[p * noct] = pack8(o);
  }
}

// a block a channel: thread t adds partials t, t + 256, ... (sample-major,
// chunks in order), then a fixed tree over the threads
__global__ void __launch_bounds__(kThreads)
    back_params_kernel(const float2* __restrict__ chan_partials, float* __restrict__ dgamma,
                       float* __restrict__ dbeta, int n, int C) {
  __shared__ float rs[kThreads], rq[kThreads];
  const int c = blockIdx.x;
  float s = 0.f, q = 0.f;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float2 v = chan_partials[(long long)k * C + c];
    s = __fadd_rn(s, v.x);
    q = __fadd_rn(q, v.y);
  }
  rs[threadIdx.x] = s;
  rq[threadIdx.x] = q;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      rs[threadIdx.x] = __fadd_rn(rs[threadIdx.x], rs[threadIdx.x + off]);
      rq[threadIdx.x] = __fadd_rn(rq[threadIdx.x], rq[threadIdx.x + off]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    dbeta[c] = rs[0];
    dgamma[c] = rq[0];
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
// u = 2 if upsample, else 1; stats: null, or (2, batch, G) float32 (mean,
// then rstd) written for the backward.
extern "C" int group_norm_apply(const void* x, const void* partials, const void* gamma,
                                const void* beta, void* out, void* stats, int batch, int h,
                                int w, int C, int G, int chunks, float eps, int upsample,
                                void* stream) {
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
  float* st = static_cast<float*>(stats);
  if (upsample)
    apply_kernel<true><<<grid, kThreads, 0, s>>>(xv, pp, gm, bt, o, st, h, w, C, G, chunks,
                                                 eps);
  else
    apply_kernel<false><<<grid, kThreads, 0, s>>>(xv, pp, gm, bt, o, st, h, w, C, G, chunks,
                                                  eps);
  return (int)cudaGetLastError();
}

// The backward, three launches. x: (batch, h * w, C) bfloat16; g: (batch,
// (u h) * (u w), C) float32; mean, rstd: (batch, G) float32 from the forward;
// gamma, beta: C float32; scratch: chan_partials (batch, chunks, C) and
// group_partials (batch, chunks, G) float2; out: dy (batch, h * w, C)
// bfloat16, dgamma and dbeta C float32. Every map 16-byte aligned.
extern "C" int group_norm_backward(const void* x, const void* g, const void* mean,
                                   const void* rstd, const void* gamma, const void* beta,
                                   void* chan_partials,
                                   void* group_partials, void* dy, void* dgamma, void* dbeta,
                                   int batch, int h, int w, int C, int G, int chunks,
                                   int upsample, void* stream) {
  const long long hw = (long long)h * w;
  if (batch < 1 || hw < 1 || !channels_ok(C, G) || chunks != (int)((hw + kPix - 1) / kPix))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(chunks, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  const float* gv = static_cast<const float*>(g);
  const float* mn = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float2* cp = static_cast<float2*>(chan_partials);
  float2* gp = static_cast<float2*>(group_partials);
  uint4* d = static_cast<uint4*>(dy);
  if (upsample)
    back_reduce_kernel<true><<<grid, kThreads, 0, s>>>(xv, gv, mn, rs, gm, bt, cp, gp, h, w, C, G,
                                                       chunks);
  else
    back_reduce_kernel<false><<<grid, kThreads, 0, s>>>(xv, gv, mn, rs, gm, bt, cp, gp, h, w, C, G,
                                                        chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (upsample)
    back_apply_kernel<true><<<grid, kThreads, 0, s>>>(xv, gv, mn, rs, gm, bt, gp, d, h, w, C, G,
                                                      chunks);
  else
    back_apply_kernel<false><<<grid, kThreads, 0, s>>>(xv, gv, mn, rs, gm, bt, gp, d, h, w, C, G,
                                                       chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  back_params_kernel<<<C, kThreads, 0, s>>>(cp, static_cast<float*>(dgamma),
                                            static_cast<float*>(dbeta), batch * chunks, C);
  return (int)cudaGetLastError();
}
