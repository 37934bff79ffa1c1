// Train-mode BatchNorm: the batch statistics of a convolution's output with
// the running-statistics update, and the backward of BatchNorm + residual
// (or a second BatchNorm'd branch) + ReLU.
//
// Replaces what XLA fused into the train step on the TPU: Flax's train-mode
// BatchNorm (flairtpu/models/resnet.py:40-70; flax.linen.BatchNorm with
// use_fast_variance, momentum 0.9, epsilon 1e-5, statistics in float32) at
// every site of the resnet encoders' blocks and stem (resnet.py:177-189,
// :208-222, :269-273) and of the U-Net decoder (flairtpu/models/unet.py:
// 71-76), and its VJP with the residual add and the ReLU after it. The
// forward's apply (y * scale + shift, residual or branch, ReLU, casts) is
// the conv_epilogue kernel, fed the batch (scale, shift) written here.
//
// bn_train_stats, over x (M, C) bfloat16 (NHWC: M = B H W pixels):
//   mean = sum(x) / M;  var = max(sum(x^2) / M - mean^2, 0)      (biased)
//   invstd = rsqrt(var + eps);  scale = gamma * invstd;  shift = beta - mean * scale
//   running_mean = m * running_mean + (1 - m) * mean;  running_var likewise with var
// bn_train_backward, with gz = (g + g32) * [out > 0] (the ReLU's mask read
// from the saved bf16 output) and xh = (y - mean) * invstd:
//   dbeta = sum(gz);  dgamma = sum(gz * xh)
//   dy = gamma * invstd * (gz - (dbeta + xh * dgamma) / M)        (bf16)
//   dres = gz (float32), or for a branch d the same dy formula with its own
//   statistics into dd (bf16).
//
// Bound: bytes. Statistics read x once (2 M C bytes); the backward reads g,
// out, y (and g32, d) twice, once to reduce and once to apply, and writes dy
// (and dres or dd). A thread takes 8 channels of a pixel (one 16-byte bf16
// load), C / 8 neighbouring threads cover a pixel and a block's 256 threads
// walk 256 / (C / 8) pixels at a time down a grid-stride loop, keeping
// float32 partial sums in registers: at the stem (16 x 256 x 256 pixels, 64
// channels) each thread sums about 32 pixels. A block adds its rows of
// partials in shared memory and writes one row of C sums; a small kernel adds
// the blocks' rows in double, in a fixed order, and derives the per-channel
// constants. So every sum is a tree of short float32 runs, and a run gives
// the same bits every time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void unpack8(const uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, long long off, float (&f)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p + off), f);
}

__device__ __forceinline__ void load8(const float* p, long long off, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p + off);
  const float4 b = *reinterpret_cast<const float4*>(p + off + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The block's thread layout: lanes = C / 8 threads a pixel, rows = 256 /
// lanes pixels at a time; threads past rows * lanes only join the barriers.
struct Layout {
  int lanes, rows, lane, row;
  bool active;
  __device__ Layout(int channels) {
    lanes = channels / 8;
    rows = kThreads / lanes;
    lane = threadIdx.x % lanes;
    row = threadIdx.x / lanes;
    active = row < rows;
  }
};

// Adds the block's per-thread partials (n_sums of 8 channels each) over its
// rows in shared memory, and writes the block's row of n_sums * C sums.
template <int kSums>
__device__ void block_sums(const Layout& t, const float (&acc)[kSums][8], float* smem,
                           float* partials, int channels) {
  // smem: rows x (kSums * C)
  const int width = kSums * channels;
  if (t.active)
#pragma unroll
    for (int s = 0; s < kSums; ++s)
#pragma unroll
      for (int i = 0; i < 8; ++i) smem[t.row * width + s * channels + t.lane * 8 + i] = acc[s][i];
  __syncthreads();
  for (int e = threadIdx.x; e < width; e += kThreads) {
    float v = 0.f;
    for (int r = 0; r < t.rows; ++r) v += smem[r * width + e];
    partials[(long long)blockIdx.x * width + e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    stats_partial(const __nv_bfloat16* __restrict__ x, float* __restrict__ partials,
                  long long m, int channels) {
  extern __shared__ float smem[];
  const Layout t(channels);
  float acc[2][8] = {};
  if (t.active)
    for (long long p = (long long)blockIdx.x * t.rows + t.row; p < m;
         p += (long long)gridDim.x * t.rows) {
      float f[8];
      load8(x, p * channels + t.lane * 8, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[0][i] += f[i];
        acc[1][i] += f[i] * f[i];
      }
    }
  block_sums<2>(t, acc, smem, partials, channels);
}

__global__ void stats_finalize(const float* __restrict__ partials, int blocks, long long m,
                               int channels, const float* __restrict__ gamma,
                               const float* __restrict__ beta, float* __restrict__ running_mean,
                               float* __restrict__ running_var, float* __restrict__ mean_out,
                               float* __restrict__ invstd_out, float* __restrict__ scale_out,
                               float* __restrict__ shift_out, float eps, float momentum) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  double s = 0.0, q = 0.0;
  for (int b = 0; b < blocks; ++b) {
    s += partials[(long long)b * 2 * channels + c];
    q += partials[(long long)b * 2 * channels + channels + c];
  }
  const float mean = (float)(s / (double)m);
  const float ex2 = (float)(q / (double)m);
  const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
  const float invstd = rsqrtf(__fadd_rn(var, eps));
  const float scale = __fmul_rn(gamma[c], invstd);
  mean_out[c] = mean;
  invstd_out[c] = invstd;
  scale_out[c] = scale;
  shift_out[c] = __fsub_rn(beta[c], __fmul_rn(mean, scale));
  const float keep = 1.f - momentum;
  running_mean[c] = __fadd_rn(__fmul_rn(momentum, running_mean[c]), __fmul_rn(keep, mean));
  running_var[c] = __fadd_rn(__fmul_rn(momentum, running_var[c]), __fmul_rn(keep, var));
}

struct BackArgs {
  const __nv_bfloat16* g;    // null: no bf16 gradient
  const float* g32;          // null: no float32 gradient
  const __nv_bfloat16* out;  // null: no ReLU
  const __nv_bfloat16* y;
  const float* mean;
  const float* invstd;
  const float* gamma;
  const __nv_bfloat16* d;    // null: no branch
  const float* mean_d;
  const float* invstd_d;
  const float* gamma_d;
  const float* sums;         // (3, C): dbeta, dgamma, dgamma_d (the apply pass)
  __nv_bfloat16* dy;
  float* dres;               // null: no residual
  __nv_bfloat16* dd;         // branch
  long long m;
  int channels;
};

// gz of 8 channels of pixel p
__device__ __forceinline__ void masked_grad(const BackArgs& a, long long off, float (&gz)[8]) {
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) gz[i] = 0.f;
  if (a.g) {
    load8(a.g, off, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) gz[i] += f[i];
  }
  if (a.g32) {
    load8(a.g32, off, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) gz[i] += f[i];
  }
  if (a.out) {
    load8(a.out, off, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) gz[i] = f[i] > 0.f ? gz[i] : 0.f;
  }
}

__device__ __forceinline__ void normalized(const __nv_bfloat16* x, const float* mean,
                                           const float* invstd, long long off, int c0,
                                           float (&xh)[8]) {
  load8(x, off, xh);
#pragma unroll
  for (int i = 0; i < 8; ++i) xh[i] = (xh[i] - mean[c0 + i]) * invstd[c0 + i];
}

__global__ void __launch_bounds__(kThreads) backward_partial(BackArgs a, float* partials) {
  extern __shared__ float smem[];
  const Layout t(a.channels);
  float acc[3][8] = {};
  const int c0 = t.lane * 8;
  if (t.active)
    for (long long p = (long long)blockIdx.x * t.rows + t.row; p < a.m;
         p += (long long)gridDim.x * t.rows) {
      const long long off = p * a.channels + c0;
      float gz[8], xh[8];
      masked_grad(a, off, gz);
      normalized(a.y, a.mean, a.invstd, off, c0, xh);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[0][i] += gz[i];
        acc[1][i] += gz[i] * xh[i];
      }
      if (a.d) {
        normalized(a.d, a.mean_d, a.invstd_d, off, c0, xh);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[2][i] += gz[i] * xh[i];
      }
    }
  block_sums<3>(t, acc, smem, partials, a.channels);
}

__global__ void backward_finalize(const float* __restrict__ partials, int blocks, int channels,
                                  float* __restrict__ sums) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * channels) return;
  double v = 0.0;
  for (int b = 0; b < blocks; ++b) v += partials[(long long)b * 3 * channels + e];
  sums[e] = (float)v;
}

__global__ void __launch_bounds__(kThreads) backward_apply(BackArgs a) {
  const int lanes = a.channels / 8;
  const long long n_groups = a.m * lanes;
  const float inv_m = 1.f / (float)a.m;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < n_groups;
       e += (long long)gridDim.x * kThreads) {
    const int c0 = (int)(e % lanes) * 8;
    const long long off = e * 8;
    float gz[8], xh[8], o[8];
    masked_grad(a, off, gz);
    normalized(a.y, a.mean, a.invstd, off, c0, xh);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + i;
      o[i] = a.gamma[c] * a.invstd[c] *
             (gz[i] - (a.sums[c] + xh[i] * a.sums[a.channels + c]) * inv_m);
    }
    *reinterpret_cast<uint4*>(a.dy + off) = pack8(o);
    if (a.dres) {
      *reinterpret_cast<float4*>(a.dres + off) = make_float4(gz[0], gz[1], gz[2], gz[3]);
      *reinterpret_cast<float4*>(a.dres + off + 4) = make_float4(gz[4], gz[5], gz[6], gz[7]);
    }
    if (a.d) {
      normalized(a.d, a.mean_d, a.invstd_d, off, c0, xh);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + i;
        o[i] = a.gamma_d[c] * a.invstd_d[c] *
               (gz[i] - (a.sums[c] + xh[i] * a.sums[2 * a.channels + c]) * inv_m);
      }
      *reinterpret_cast<uint4*>(a.dd + off) = pack8(o);
    }
  }
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

bool layout_ok(int channels) {
  return channels >= 8 && channels % 8 == 0 && channels / 8 <= kThreads;
}

size_t smem_bytes(int channels, int sums) {
  return (size_t)(kThreads / (channels / 8)) * sums * channels * sizeof(float);
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// x: (m, channels) bfloat16, 16-byte aligned, channels a multiple of 8 up to
// 2048; gamma, beta: channels float32; running_mean, running_var: channels
// float32, updated in place; partials: blocks * 2 * channels float32
// scratch; mean, invstd, scale, shift: channels float32 outputs. Returns
// cudaGetLastError() after the launches.
extern "C" int bn_train_stats(const void* x, const void* gamma, const void* beta,
                              void* running_mean, void* running_var, void* partials, int blocks,
                              void* mean, void* invstd, void* scale, void* shift, long long m,
                              int channels, float eps, float momentum, void* stream) {
  if (m < 1 || blocks < 1 || !layout_ok(channels) || !aligned16(x))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(channels, 2);
  cudaError_t err = allow_smem((const void*)stats_partial, smem);
  if (err != cudaSuccess) return (int)err;
  stats_partial<<<blocks, kThreads, smem, s>>>(static_cast<const __nv_bfloat16*>(x),
                                               static_cast<float*>(partials), m, channels);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  stats_finalize<<<(channels + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(partials), blocks, m, channels,
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(running_mean), static_cast<float*>(running_var),
      static_cast<float*>(mean), static_cast<float*>(invstd), static_cast<float*>(scale),
      static_cast<float*>(shift), eps, momentum);
  return (int)cudaGetLastError();
}

// g: (m, channels) bfloat16 or null; g32: (m, channels) float32 or null;
// out: the forward's bf16 output (the ReLU's mask) or null (no ReLU); y:
// the conv output; mean, invstd, gamma: its statistics and scale; d,
// mean_d, invstd_d, gamma_d: the branch (or null); partials: blocks * 3 *
// channels float32 scratch; sums: 3 * channels float32 outputs (dbeta,
// dgamma, dgamma_d; the branch's dbeta is dbeta); dy: (m, channels) bf16;
// dres: (m, channels) float32 or null; dd: (m, channels) bf16 where d is
// given. Returns cudaGetLastError() after the launches.
extern "C" int bn_train_backward(const void* g, const void* g32, const void* out, const void* y,
                                 const void* mean, const void* invstd, const void* gamma,
                                 const void* d, const void* mean_d, const void* invstd_d,
                                 const void* gamma_d, void* partials, int blocks, void* sums,
                                 void* dy, void* dres, void* dd, long long m, int channels,
                                 void* stream) {
  if (m < 1 || blocks < 1 || !layout_ok(channels) || (d && !dd) || (d && dres) ||
      !(aligned16(g) && aligned16(g32) && aligned16(out) && aligned16(y) && aligned16(d) &&
        aligned16(dy) && aligned16(dres) && aligned16(dd)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BackArgs a{static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(g32),
             static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(y),
             static_cast<const float*>(mean), static_cast<const float*>(invstd),
             static_cast<const float*>(gamma), static_cast<const __nv_bfloat16*>(d),
             static_cast<const float*>(mean_d), static_cast<const float*>(invstd_d),
             static_cast<const float*>(gamma_d), static_cast<const float*>(sums),
             static_cast<__nv_bfloat16*>(dy), static_cast<float*>(dres),
             static_cast<__nv_bfloat16*>(dd), m, channels};
  const size_t smem = smem_bytes(channels, 3);
  cudaError_t err = allow_smem((const void*)backward_partial, smem);
  if (err != cudaSuccess) return (int)err;
  backward_partial<<<blocks, kThreads, smem, s>>>(a, static_cast<float*>(partials));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  backward_finalize<<<(3 * channels + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(partials), blocks, channels, static_cast<float*>(sums));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = m * (channels / 8);
  long long grid = (groups + kThreads - 1) / kThreads;
  if (grid > 8LL * sms) grid = 8LL * sms;
  backward_apply<<<(int)grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
