// Augment + normalize: the D4 transform of each sample, the label cleaning
// and the channel normalization of a batch, in one pass.
//
// Replaces what XLA fused at the head of the train step on the TPU:
// flairtpu/data/augment.py:35-54 (augment_batch: a vertical flip, then a
// horizontal flip, then rot90 by k, chosen per sample),
// flairtpu/train/loop.py:271-274 (_clean_targets: labels outside [0, K)
// become 0) and :339-342 (normalize_device), and the mask's "- 1" of the
// reference's loader (flairtpu/data/patches.py:49), which the host no longer
// does: the mask crosses the bus as the uint8 read from disk.
//
//   src = the source pixel of output (i, j) under (v, h, k)
//   out[b, i, j, c] = (float(img[b, src, c]) - mean[c]) * mul[c]   (bf16 RNE or float32)
//   t = int(mask[b, src]) - 1;  target[b, i, j] = (0 <= t < K) ? t : 0
//
// mean and mul carry the three norm types (custom: mean, 1/std; scaling:
// 0, 1/max; without: 0, 1); __fsub_rn/__fmul_rn keep each operation rounded
// on its own, as the plain PyTorch version (ops/augment.py) does.
//
// Bound: bytes. A batch of 16 512 x 512 x 5 patches reads 21 MB of image
// and 4 MB of mask and writes 42 MB of bf16 and 17 MB of int32 targets;
// there is no arithmetic to speak of. A rotation by 90 degrees reads a
// column of the source for a row of the output, so each block stages a
// 32 x 32 source tile (all channels, and the mask) in shared memory with
// coalesced byte loads and writes its 32 x 32 output tile from there:
// neighbouring threads write neighbouring pixels. A D4 transform maps a
// square tile onto a square tile, so the source tile is the one whose
// corner is the lesser of the images of the output tile's two corners.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxChannels = 32;

struct Args {
  const uint8_t* img;     // (B, H, W, C)
  const uint8_t* mask;    // (B, H, W) or null
  const int* choices;     // (B, 3): v, h, k; null: identity
  const float* mean;      // C
  const float* mul;       // C
  void* out;              // (B, H, W, C) bf16 or float32
  int* target;            // (B, H, W) or null
  int height, width, channels, n_classes;
};

// the source pixel of output (i, j): rot90 by k (np.rot90 on axes 0, 1) of
// the horizontally and then vertically flipped image
__device__ __forceinline__ void source(int i, int j, int v, int h, int k, int H, int W,
                                       int& r, int& c) {
  int p, q;
  switch (k & 3) {
    case 0: p = i; q = j; break;
    case 1: p = j; q = W - 1 - i; break;
    case 2: p = H - 1 - i; q = W - 1 - j; break;
    default: p = H - 1 - j; q = i; break;
  }
  r = v ? H - 1 - p : p;
  c = h ? W - 1 - q : q;
}

template <bool kF32>
__global__ void __launch_bounds__(kThreads) augment_normalize_kernel(Args a) {
  extern __shared__ uint8_t smem[];
  uint8_t* s_img = smem;                               // kTile * kTile * C
  uint8_t* s_msk = smem + kTile * kTile * a.channels;  // kTile * kTile
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int H = a.height, W = a.width, C = a.channels;
  const int i1 = min(i0 + kTile, H), j1 = min(j0 + kTile, W);
  int v = 0, h = 0, k = 0;
  if (a.choices) {
    v = a.choices[3 * b];
    h = a.choices[3 * b + 1];
    k = a.choices[3 * b + 2];
  }
  // the source tile: corner at the lesser of the two corners' images
  int ra, ca, rb, cb;
  source(i0, j0, v, h, k, H, W, ra, ca);
  source(i1 - 1, j1 - 1, v, h, k, H, W, rb, cb);
  const int r0 = min(ra, rb), c0 = min(ca, cb);
  const int rows = min(kTile, H - r0), cols = min(kTile, W - c0);

  const uint8_t* img = a.img + ((long long)b * H * W) * C;
  const int row_bytes = cols * C;
  for (int e = threadIdx.x; e < rows * row_bytes; e += kThreads) {
    const int rr = e / row_bytes, cc = e - rr * row_bytes;
    s_img[rr * kTile * C + cc] = img[((long long)(r0 + rr) * W + c0) * C + cc];
  }
  if (a.mask) {
    const uint8_t* msk = a.mask + (long long)b * H * W;
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int rr = e / cols, cc = e - rr * cols;
      s_msk[rr * kTile + cc] = msk[(long long)(r0 + rr) * W + c0 + cc];
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int i = i0 + e / kTile, j = j0 + e % kTile;
    if (i >= i1 || j >= j1) continue;
    int r, c;
    source(i, j, v, h, k, H, W, r, c);
    const int s = (r - r0) * kTile + (c - c0);
    const long long o = ((long long)b * H + i) * W + j;
    for (int ch = 0; ch < C; ++ch) {
      const float x = __fmul_rn(__fsub_rn((float)s_img[s * C + ch], a.mean[ch]), a.mul[ch]);
      if constexpr (kF32)
        static_cast<float*>(a.out)[o * C + ch] = x;
      else
        static_cast<__nv_bfloat16*>(a.out)[o * C + ch] = __float2bfloat16_rn(x);
    }
    if (a.mask) {
      const int t = (int)s_msk[s] - 1;
      a.target[o] = (t >= 0 && t < a.n_classes) ? t : 0;
    }
  }
}

}  // namespace

// img: (batch, height, width, channels) uint8; mask: (batch, height, width)
// uint8 as read from disk (labels from 1), or null (no targets); choices:
// (batch, 3) int32 (v, h, k), or null for the identity (k odd needs height
// == width); mean, mul: channels float32; out: (batch, height, width,
// channels) bfloat16, or float32 where out_f32 is nonzero; target: (batch,
// height, width) int32, written where mask is given. Returns
// cudaGetLastError() after the launch.
extern "C" int augment_normalize(const void* img, const void* mask, const void* choices,
                                 const void* mean, const void* mul, void* out, void* target,
                                 int batch, int height, int width, int channels, int n_classes,
                                 int out_f32, void* stream) {
  if (batch < 0 || height < 1 || width < 1 || channels < 1 || channels > kMaxChannels ||
      (mask && !target))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const Args a{static_cast<const uint8_t*>(img), static_cast<const uint8_t*>(mask),
               static_cast<const int*>(choices), static_cast<const float*>(mean),
               static_cast<const float*>(mul), out, static_cast<int*>(target),
               height, width, channels, n_classes};
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile, batch);
  const size_t smem = (size_t)kTile * kTile * (channels + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    augment_normalize_kernel<true><<<grid, kThreads, smem, s>>>(a);
  else
    augment_normalize_kernel<false><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}
