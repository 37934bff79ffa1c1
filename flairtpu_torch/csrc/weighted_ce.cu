// Weighted cross-entropy over per-pixel logits, its gradient, and the
// confusion matrix of the first-maximum argmax.
//
// Replaces what XLA fused around the loss of the train and eval steps on
// the TPU: flairtpu/train/loop.py:255-269 (_loss, torch's
// CrossEntropyLoss(weight=w) as a weighted mean of the NLL, the weights of
// weight-0 classes included), its VJP, and :307-310 / :399-400 with
// flairtpu/ops/confmat.py:19-41 (confusion_matrix of argmax(logits), rows =
// target).
//
// Forward, one pass over the float32 logits (N, K), K innermost:
//   logp_t = (l_t - max) - log(sum_c exp(l_c - max))
//   sum += -logp_t * w[t];  wsum += w[t];  cm[t][argmax_c l_c] += 1
//   loss = sum / max(wsum, 1e-8)                 (out[0]; out[1] = wsum)
// Backward:
//   dl_c = (softmax_c - [c == t]) * w[t] * (g / max(wsum, 1e-8))
// with g and wsum read from the card, so that no step waits on the host.
//
// Bound: bytes. The forward reads 4 N K + 4 N bytes (319 MB for a batch of
// 16 512 x 512 patches at K = 19) and does about 3 K operations a pixel; the
// backward reads as much and writes 4 N K. A thread takes one pixel: its
// K logits are one contiguous 4K-byte run, so a warp reads and writes 32
// neighbouring runs. Each thread keeps float32 partial sums over its pixels;
// a block combines them in a tree of warp shuffles and writes one pair; a
// one-block kernel sums the pairs in double in a fixed order (the result
// does not depend on the run). The confusion matrix counts in shared memory
// with integer atomics (exact in any order) and adds the block's counts to
// the card's K x K int32 matrix, which accumulates over a whole epoch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    weighted_ce_partial(const float* __restrict__ logits, const int* __restrict__ target,
                        const float* __restrict__ weight, int* __restrict__ cm,
                        float* __restrict__ partials, long long n, int k) {
  __shared__ int s_cm[kMaxClasses * kMaxClasses];
  __shared__ float s_sum[kThreads / 32][2];
  for (int e = threadIdx.x; e < k * k; e += kThreads) s_cm[e] = 0;
  __syncthreads();
  float sum = 0.f, wsum = 0.f;
  for (long long p = blockIdx.x * (long long)kThreads + threadIdx.x; p < n;
       p += (long long)gridDim.x * kThreads) {
    const float* l = logits + p * k;
    float m = l[0];
    int arg = 0;
    for (int c = 1; c < k; ++c) {
      const float x = l[c];
      if (x > m) {  // strict: the first maximum wins
        m = x;
        arg = c;
      }
    }
    float s = 0.f;
    for (int c = 0; c < k; ++c) s += expf(l[c] - m);
    const int t = target[p];
    const float w = weight[t];
    const float logp = (l[t] - m) - logf(s);
    sum += -logp * w;
    wsum += w;
    if (cm) atomicAdd(&s_cm[t * k + arg], 1);
  }
  sum = warp_sum(sum);
  wsum = warp_sum(wsum);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_sum[warp][0] = sum;
    s_sum[warp][1] = wsum;
  }
  __syncthreads();
  if (warp == 0) {
    sum = lane < kThreads / 32 ? s_sum[lane][0] : 0.f;
    wsum = lane < kThreads / 32 ? s_sum[lane][1] : 0.f;
    sum = warp_sum(sum);
    wsum = warp_sum(wsum);
    if (lane == 0) {
      partials[2 * blockIdx.x] = sum;
      partials[2 * blockIdx.x + 1] = wsum;
    }
  }
  if (cm)
    for (int e = threadIdx.x; e < k * k; e += kThreads)
      if (s_cm[e]) atomicAdd(&cm[e], s_cm[e]);
}

__global__ void __launch_bounds__(kThreads)
    weighted_ce_finalize(const float* __restrict__ partials, int blocks, float* __restrict__ out) {
  __shared__ double s[2][kThreads];
  double sum = 0.0, wsum = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    sum += partials[2 * b];
    wsum += partials[2 * b + 1];
  }
  s[0][threadIdx.x] = sum;
  s[1][threadIdx.x] = wsum;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s[0][threadIdx.x] += s[0][threadIdx.x + stride];
      s[1][threadIdx.x] += s[1][threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float ws = (float)s[1][0];
    out[0] = (float)s[0][0] / fmaxf(ws, 1e-8f);
    out[1] = ws;
  }
}

__global__ void __launch_bounds__(kThreads)
    weighted_ce_grad(const float* __restrict__ logits, const int* __restrict__ target,
                     const float* __restrict__ weight, const float* __restrict__ wsum,
                     const float* __restrict__ grad, float* __restrict__ dlogits, long long n,
                     int k) {
  const float g = grad[0] / fmaxf(wsum[0], 1e-8f);
  for (long long p = blockIdx.x * (long long)kThreads + threadIdx.x; p < n;
       p += (long long)gridDim.x * kThreads) {
    const float* l = logits + p * k;
    float* d = dlogits + p * k;
    float m = l[0];
    for (int c = 1; c < k; ++c) m = fmaxf(m, l[c]);
    float s = 0.f;
    for (int c = 0; c < k; ++c) s += expf(l[c] - m);
    const int t = target[p];
    const float scale = weight[t] * g;
    for (int c = 0; c < k; ++c) {
      const float prob = expf(l[c] - m) / s;
      d[c] = (c == t ? prob - 1.f : prob) * scale;
    }
  }
}

}  // namespace

// logits: (n, k) float32; target: n int32 in [0, k); weight: k float32; cm:
// (k, k) int32 added to (null: not counted); partials: 2 * blocks float32
// scratch; out: 2 float32 (loss, weight sum). Returns cudaGetLastError().
extern "C" int weighted_ce_forward(const void* logits, const void* target, const void* weight,
                                   void* cm, void* partials, int blocks, void* out,
                                   long long n, int k, void* stream) {
  if (n < 1 || k < 1 || k > kMaxClasses || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  weighted_ce_partial<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(logits), static_cast<const int*>(target),
      static_cast<const float*>(weight), static_cast<int*>(cm), static_cast<float*>(partials),
      n, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  weighted_ce_finalize<<<1, kThreads, 0, s>>>(static_cast<const float*>(partials), blocks,
                                               static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// wsum: 1 float32, the forward's weight sum; grad: 1 float32, the loss's
// incoming gradient; dlogits: (n, k) float32. Returns cudaGetLastError().
extern "C" int weighted_ce_backward(const void* logits, const void* target, const void* weight,
                                    const void* wsum, const void* grad, void* dlogits,
                                    int blocks, long long n, int k, void* stream) {
  if (n < 1 || k < 1 || k > kMaxClasses || blocks < 1) return (int)cudaErrorInvalidValue;
  weighted_ce_grad<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(target),
      static_cast<const float*>(weight), static_cast<const float*>(wsum),
      static_cast<const float*>(grad), static_cast<float*>(dlogits), n, k);
  return (int)cudaGetLastError();
}
