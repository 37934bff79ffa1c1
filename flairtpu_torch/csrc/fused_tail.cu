// Fused U-Net decoder tail: last decoder block + segmentation head +
// softmax max/argmax epilogue, one kernel.
//
// Replaces the Pallas kernel benchmarks/pallas_fused_tail.py:make_kernel
// (pallas_call at :229), which fuses the same stretch of the resnet34-unet
// inner decode, and the XLA path the zone program runs for it
// (flairtpu/models/unet.py:145-154, flairtpu/models/factory.py:270-274,
// flairtpu/zone/device_engine.py:143-146):
//
//   x3 (B, E3, E3, 32) -> 2x nearest upsample, crop [uc, uc+E4)
//     -> conv3x3 32->16, *scale1 + shift1, relu     (BatchNorm as an epilogue)
//     -> conv3x3 16->16, *scale2 + shift2, relu
//     -> head conv3x3 16->K, + bias, crop [hc, hc+s)
//     -> argmax over K (first max wins), round(255 * 1/sum exp(x - max))
//   out: class (B, s, s) uint8, prob (B, s, s) uint8
//
// The geometry (E3, uc, E4, hc, s) comes from plan_inner_crops(S, m) and K
// is at most 32, so the kernel serves every resnet*_unet at any tile size
// and margin (their last two decoder widths are always 32 and 16). Each conv
// zero-pads the edges of its own E4 extent, as F.conv2d(padding=1) on the
// cropped extent does.
//
// Bound: operations. At 512/128 with K = 19 the tail needs about 1.29 GFLOP
// per tile against 1.3 MB of input and output, far above the card's
// operations-per-byte balance point. This first version is simple rather
// than fast: one block per (tile, 16 x 32 output patch); the x3 window, the
// conv1 and conv2 results (with the 3-pixel halo the three convs need) and
// all weights live in shared memory; each thread computes every output
// channel of one position with float32 FMAs on the CUDA cores. Nothing but
// the two uint8 planes goes back to device memory. Tensor cores (wgmma) and
// TMA are later work.
//
// Numerics follow the plain PyTorch version (ops/fused_tail.py): with
// bfloat16 activations the two block convs accumulate in float32 and round
// their result to bfloat16 (as a bfloat16 cuDNN conv does) before the
// float32 BatchNorm epilogue; the head's float32 sum is the logit, unrounded;
// __fmul_rn/__fadd_rn keep the epilogues from being contracted into an FMA;
// the probability is rintf((1.0f / s) * 255.0f), round half to even, as
// jnp.round and torch.round do. No fast math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC3 = 32;  // channels into the last decoder block
constexpr int kC4 = 16;  // channels of the last decoder block
constexpr int kTH = 16, kTW = 32;  // output rows x cols per block
constexpr int kThreads = 256;
constexpr int kUH = kTH + 6, kUW = kTW + 6;          // upsampled window (3-px halo)
constexpr int kXH = kUH / 2 + 1, kXW = kUW / 2 + 1;  // x3 rows/cols that window spans
constexpr int kXP = kXH * kXW + 1;                   // x3 plane + one zero slot
constexpr int kZero = kXH * kXW;
constexpr int kH1 = kTH + 4, kW1 = kTW + 4, kP1 = kH1 * kW1;  // conv1 window
constexpr int kH2 = kTH + 2, kW2 = kTW + 2, kP2 = kH2 * kW2;  // conv2 window

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a conv result rounded to the activation type, back in float32
template <typename T> __device__ __forceinline__ float round_t(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ int floor_div2(int v) { return v >= 0 ? v / 2 : -((1 - v) / 2); }

struct Geometry {
  int e3, uc, e4, hc, s, k;
};

template <int KP>
__host__ __device__ constexpr size_t weight_floats() {
  return 9 * kC3 * kC4 + 9 * kC4 * kC4 + 9 * kC4 * KP + 4 * kC4 + KP;
}

template <typename T, int KP>
__host__ __device__ constexpr size_t smem_bytes() {
  return weight_floats<KP>() * sizeof(float) + (size_t)(kC3 * kXP + kC4 * kP1 + kC4 * kP2) * sizeof(T);
}

template <typename T, int KP>
__global__ void __launch_bounds__(kThreads)
fused_tail_kernel(const T* __restrict__ x3, const float* __restrict__ w1,
                  const float* __restrict__ sc1, const float* __restrict__ sh1,
                  const float* __restrict__ w2, const float* __restrict__ sc2,
                  const float* __restrict__ sh2, const float* __restrict__ wh,
                  const float* __restrict__ bh, uint8_t* __restrict__ cls,
                  uint8_t* __restrict__ prob, Geometry g) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                  // [tap][ci][co], 9 x 32 x 16
  float* w2s = w1s + 9 * kC3 * kC4;   // [tap][ci][co], 9 x 16 x 16
  float* whs = w2s + 9 * kC4 * kC4;   // [tap][ci][co], 9 x 16 x KP (zero past K)
  float* s1 = whs + 9 * kC4 * KP;
  float* t1 = s1 + kC4;
  float* s2 = t1 + kC4;
  float* t2 = s2 + kC4;
  float* bs = t2 + kC4;                                          // KP
  T* xs = reinterpret_cast<T*>(smem + weight_floats<KP>());      // [ci][kXP]
  T* c1 = xs + kC3 * kXP;                                        // [co][kP1]
  T* c2 = c1 + kC4 * kP1;                                        // [co][kP2]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;  // output coords
  const int h0 = g.hc + r0, w0 = g.hc + c0;                // same, in E4 coords

  // weights: torch (O, I, 3, 3) -> [tap][ci][co]
  for (int i = tid; i < 9 * kC3 * kC4; i += kThreads) {
    const int co = i / (kC3 * 9), ci = (i / 9) % kC3, tap = i % 9;
    w1s[(tap * kC3 + ci) * kC4 + co] = w1[i];
  }
  for (int i = tid; i < 9 * kC4 * kC4; i += kThreads) {
    const int co = i / (kC4 * 9), ci = (i / 9) % kC4, tap = i % 9;
    w2s[(tap * kC4 + ci) * kC4 + co] = w2[i];
  }
  for (int i = tid; i < 9 * kC4 * KP; i += kThreads) {
    const int co = i / (kC4 * 9), ci = (i / 9) % kC4, tap = i % 9;
    whs[(tap * kC4 + ci) * KP + co] = co < g.k ? wh[i] : 0.f;
  }
  if (tid < kC4) {
    s1[tid] = sc1[tid];
    t1[tid] = sh1[tid];
    s2[tid] = sc2[tid];
    t2[tid] = sh2[tid];
  }
  if (tid < KP) bs[tid] = tid < g.k ? bh[tid] : 0.f;

  // x3 window: rows/cols whose 2x upsample covers the upsampled window
  // [h0-3, h0+kTH+3) x [w0-3, w0+kTW+3); x3 is NHWC (channels_last)
  const int xr0 = floor_div2(g.uc + h0 - 3), xc0 = floor_div2(g.uc + w0 - 3);
  const T* xb = x3 + (size_t)b * g.e3 * g.e3 * kC3;
  for (int i = tid; i < kXH * kXW * kC3; i += kThreads) {
    const int ci = i % kC3, pos = i / kC3;
    const int gr = xr0 + pos / kXW, gc = xc0 + pos % kXW;
    T v = from_f<T>(0.f);
    if (gr >= 0 && gr < g.e3 && gc >= 0 && gc < g.e3) v = xb[((size_t)gr * g.e3 + gc) * kC3 + ci];
    xs[ci * kXP + pos] = v;
  }
  if (tid < kC3) xs[tid * kXP + kZero] = from_f<T>(0.f);
  __syncthreads();

  // conv1 on the upsampled, cropped x3: window rows/cols [h0-2, h0+kTH+2)
  for (int p = tid; p < kP1; p += kThreads) {
    const int i = p / kW1, j = p % kW1;
    const int qr = h0 - 2 + i, qc = w0 - 2 + j;
    if (qr < 0 || qr >= g.e4 || qc < 0 || qc >= g.e4) {  // outside E4: conv2's zero pad
#pragma unroll
      for (int co = 0; co < kC4; ++co) c1[co * kP1 + p] = from_f<T>(0.f);
      continue;
    }
    int off[9];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int ur = qr + dy - 1;
      const int lr = floor_div2(g.uc + ur) - xr0;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ucol = qc + dx - 1;
        const int lc = floor_div2(g.uc + ucol) - xc0;
        const bool ok = ur >= 0 && ur < g.e4 && ucol >= 0 && ucol < g.e4;
        off[dy * 3 + dx] = ok ? lr * kXW + lc : kZero;
      }
    }
    float acc[kC4];
#pragma unroll
    for (int co = 0; co < kC4; ++co) acc[co] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const T* src = xs + off[tap];
      const float* w = w1s + tap * kC3 * kC4;
#pragma unroll 4
      for (int ci = 0; ci < kC3; ++ci) {
        const float v = to_f(src[ci * kXP]);
        const float4* w4 = reinterpret_cast<const float4*>(w + ci * kC4);
#pragma unroll
        for (int q = 0; q < kC4 / 4; ++q) {
          const float4 ww = w4[q];
          acc[4 * q + 0] = fmaf(v, ww.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, ww.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, ww.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, ww.w, acc[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int co = 0; co < kC4; ++co) {
      const float y = __fadd_rn(__fmul_rn(round_t<T>(acc[co]), s1[co]), t1[co]);
      c1[co * kP1 + p] = from_f<T>(fmaxf(y, 0.f));
    }
  }
  __syncthreads();

  // conv2: window rows/cols [h0-1, h0+kTH+1); neighbours lie in the conv1 window
  for (int p = tid; p < kP2; p += kThreads) {
    const int i = p / kW2, j = p % kW2;
    const int qr = h0 - 1 + i, qc = w0 - 1 + j;
    if (qr < 0 || qr >= g.e4 || qc < 0 || qc >= g.e4) {  // the head's zero pad
#pragma unroll
      for (int co = 0; co < kC4; ++co) c2[co * kP2 + p] = from_f<T>(0.f);
      continue;
    }
    float acc[kC4];
#pragma unroll
    for (int co = 0; co < kC4; ++co) acc[co] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const T* src = c1 + (i + tap / 3) * kW1 + j + tap % 3;
      const float* w = w2s + tap * kC4 * kC4;
#pragma unroll 4
      for (int ci = 0; ci < kC4; ++ci) {
        const float v = to_f(src[ci * kP1]);
        const float4* w4 = reinterpret_cast<const float4*>(w + ci * kC4);
#pragma unroll
        for (int q = 0; q < kC4 / 4; ++q) {
          const float4 ww = w4[q];
          acc[4 * q + 0] = fmaf(v, ww.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, ww.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, ww.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, ww.w, acc[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int co = 0; co < kC4; ++co) {
      const float y = __fadd_rn(__fmul_rn(round_t<T>(acc[co]), s2[co]), t2[co]);
      c2[co * kP2 + p] = from_f<T>(fmaxf(y, 0.f));
    }
  }
  __syncthreads();

  // head + epilogue on the output patch
  for (int p = tid; p < kTH * kTW; p += kThreads) {
    const int i = p / kTW, j = p % kTW;
    const int r = r0 + i, c = c0 + j;
    if (r >= g.s || c >= g.s) continue;
    float acc[KP];
#pragma unroll
    for (int co = 0; co < KP; ++co) acc[co] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const T* src = c2 + (i + tap / 3) * kW2 + j + tap % 3;
      const float* w = whs + tap * kC4 * KP;
#pragma unroll 2
      for (int ci = 0; ci < kC4; ++ci) {
        const float v = to_f(src[ci * kP2]);
        const float4* w4 = reinterpret_cast<const float4*>(w + ci * KP);
#pragma unroll
        for (int q = 0; q < KP / 4; ++q) {
          const float4 ww = w4[q];
          acc[4 * q + 0] = fmaf(v, ww.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, ww.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, ww.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, ww.w, acc[4 * q + 3]);
        }
      }
    }
    // float32 logits: the head's sum is not rounded to the activation type
    float mx = __fadd_rn(acc[0], bs[0]);
    int am = 0;
#pragma unroll
    for (int co = 0; co < KP; ++co) {
      acc[co] = __fadd_rn(acc[co], bs[co]);
      if (co > 0 && co < g.k && acc[co] > mx) {
        mx = acc[co];
        am = co;
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int co = 0; co < KP; ++co) {
      if (co < g.k) sum += expf(acc[co] - mx);
    }
    const size_t o = ((size_t)b * g.s + r) * g.s + c;
    cls[o] = (uint8_t)am;
    prob[o] = (uint8_t)rintf(__fmul_rn(1.0f / sum, 255.0f));
  }
}

template <typename T, int KP>
cudaError_t launch(const void* x3, const float* w1, const float* sc1, const float* sh1,
                   const float* w2, const float* sc2, const float* sh2, const float* wh,
                   const float* bh, uint8_t* cls, uint8_t* prob, int batch, const Geometry& g,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, KP>();
  cudaError_t err = cudaFuncSetAttribute(fused_tail_kernel<T, KP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.s + kTW - 1) / kTW, (g.s + kTH - 1) / kTH, batch);
  fused_tail_kernel<T, KP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x3), w1, sc1, sh1, w2, sc2, sh2, wh, bh, cls, prob, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k(const void* x3, const float* w1, const float* sc1, const float* sh1,
                       const float* w2, const float* sc2, const float* sh2, const float* wh,
                       const float* bh, uint8_t* cls, uint8_t* prob, int batch,
                       const Geometry& g, cudaStream_t s) {
  if (g.k <= 8) return launch<T, 8>(x3, w1, sc1, sh1, w2, sc2, sh2, wh, bh, cls, prob, batch, g, s);
  if (g.k <= 16) return launch<T, 16>(x3, w1, sc1, sh1, w2, sc2, sh2, wh, bh, cls, prob, batch, g, s);
  if (g.k <= 24) return launch<T, 24>(x3, w1, sc1, sh1, w2, sc2, sh2, wh, bh, cls, prob, batch, g, s);
  return launch<T, 32>(x3, w1, sc1, sh1, w2, sc2, sh2, wh, bh, cls, prob, batch, g, s);
}

}  // namespace

// x3: (batch, e3, e3, 32) NHWC, bfloat16 (x3_bf16 = 1) or float32.
// w1 (16, 32, 3, 3), w2 (16, 16, 3, 3), wh (k, 16, 3, 3): float32 holding
// values already rounded to the activation type; sc/sh (16), bh (k): float32.
// cls, prob: (batch, s, s) uint8. Geometry from plan_inner_crops; needs
// uc >= 0, hc >= 0, hc + s <= e4, (uc + e4 - 1) / 2 < e3, 1 <= k <= 32.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_tail(const void* x3, int x3_bf16, const float* w1, const float* sc1,
                          const float* sh1, const float* w2, const float* sc2, const float* sh2,
                          const float* wh, const float* bh, void* cls, void* prob, int batch,
                          int e3, int uc, int e4, int hc, int s, int k, void* stream) {
  if (k < 1 || k > 32 || uc < 0 || hc < 0 || hc + s > e4 || (uc + e4 - 1) / 2 >= e3)
    return (int)cudaErrorInvalidValue;
  const Geometry g{e3, uc, e4, hc, s, k};
  uint8_t* c = static_cast<uint8_t*>(cls);
  uint8_t* p = static_cast<uint8_t*>(prob);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x3_bf16 ? dispatch_k<__nv_bfloat16>(x3, w1, sc1, sh1, w2, sc2, sh2, wh, bh, c, p, batch, g, st)
              : dispatch_k<float>(x3, w1, sc1, sh1, w2, sc2, sh2, wh, bh, c, p, batch, g, st);
  return (int)err;
}
