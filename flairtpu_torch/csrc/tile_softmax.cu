// Full-tile softmax payloads of the streaming zone route, one launch per
// batch of tiles.
//
// Replaces what XLA fused on the TPU in ZoneEngine.device_fn
// (flairtpu/zone/engine.py:138-145) after the whole-tile forward. Input: the
// fused tail's float32 logits (batch, size, size, k), k innermost. Per pixel,
// with the sum over classes taken in ascending order:
//
//   mode 0 (full_probs):  probs[b, c, y, x] = exp(v_c - max v) / sum_k exp(v_k - max v)
//                         -> (batch, k, size, size) float32
//   mode 1 (full_argmax): cls = argmax_k v_k (first maximum) -> uint8,
//                         prob = 1 / sum_k exp(v_k - max v) -> float32,
//                         both (batch, size, size)
//
// The arithmetic is that of csrc/accumulate_probs.cu (mode 0) and
// csrc/merge_max.cu (mode 1): expf, __fadd_rn in class order, IEEE
// division, no fast math. So the host stitchers' acc += p * w and p > best
// reproduce the device route's stitches bit for bit.
//
// Bound: bytes (k floats read a pixel; k floats, or 5 bytes, written). One
// thread a pixel, a block 256 consecutive pixels. The block first copies its
// 256 k logits, one contiguous run, into shared memory with consecutive
// threads on consecutive floats, at a pixel stride of k | 1 (odd, so the
// per-pixel reads that follow are free of bank conflicts; an even k is
// padded by one). Stores are coalesced: in mode 0 one class plane after
// another, neighbouring threads on neighbouring pixels of a plane.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* logits;  // (batch, size, size, k)
  void* out0;           // mode 0: probs (batch, k, size, size); mode 1: cls (batch, size, size)
  float* prob;          // mode 1: (batch, size, size)
  long long pixels;     // batch * size * size
  long long plane;      // size * size
  int k;
};

template <int KP, int MODE>
__global__ void __launch_bounds__(kThreads) tile_softmax_kernel(Args a) {
  __shared__ float sh[kThreads * (KP + 1)];
  const int k = a.k, ks = k | 1;
  const long long base = (long long)blockIdx.x * kThreads;
  const int n = (int)min((long long)kThreads, a.pixels - base);

  // coalesced copy of the block's n * k logits; float i is (pixel p, class c),
  // walked by increments with no division in the loop
  const float* src = a.logits + base * k;
  const int total = n * k, dp = kThreads / k, dc = kThreads - dp * k;
  int p = threadIdx.x / k, c = threadIdx.x - p * k;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    sh[p * ks + c] = src[i];
    p += dp;
    c += dc;
    if (c >= k) {
      c -= k;
      ++p;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x >= n) return;

  const float* v = sh + threadIdx.x * ks;
  float e[KP];
  float mx = -INFINITY;
  int am = 0;
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    e[j] = j < k ? v[j] : -INFINITY;
    if (e[j] > mx) {  // strict: the first maximum wins
      mx = e[j];
      am = j;
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    if (j < k) {
      e[j] = expf(e[j] - mx);
      sum = __fadd_rn(sum, e[j]);
    }
  }
  const long long pix = base + threadIdx.x;
  if (MODE == 0) {
    const long long b = pix / a.plane, q = pix - b * a.plane;
    float* out = static_cast<float*>(a.out0) + b * k * a.plane + q;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      if (j < k) out[j * a.plane] = __fdiv_rn(e[j], sum);
    }
  } else {
    static_cast<uint8_t*>(a.out0)[pix] = (uint8_t)am;
    a.prob[pix] = __fdiv_rn(1.0f, sum);
  }
}

template <int KP>
cudaError_t launch(int mode, const Args& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.pixels + kThreads - 1) / kThreads);
  if (mode == 0)
    tile_softmax_kernel<KP, 0><<<blocks, kThreads, 0, stream>>>(a);
  else
    tile_softmax_kernel<KP, 1><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// mode 0: out0 = probs (batch, k, size, size) float32, out1 unused;
// mode 1: out0 = cls (batch, size, size) uint8, out1 = prob (batch, size, size)
// float32. logits: (batch, size, size, k) float32. 1 <= k <= 32. Returns
// cudaGetLastError().
extern "C" int tile_softmax(int mode, const void* logits, void* out0, void* out1, int batch,
                            int size, int k, void* stream) {
  if (mode < 0 || mode > 1 || k < 1 || k > 32 || batch < 1 || size < 1 ||
      (mode == 1 && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)size * size;
  const Args a{static_cast<const float*>(logits), out0, static_cast<float*>(out1),
               plane * batch, plane, k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((k + 7) / 8) {
    case 1: return (int)launch<8>(mode, a, st);
    case 2: return (int)launch<16>(mode, a, st);
    case 3: return (int)launch<24>(mode, a, st);
    default: return (int)launch<32>(mode, a, st);
  }
}
