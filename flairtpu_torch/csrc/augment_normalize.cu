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
// and 4 MB of mask and writes 42 MB of bf16 and 17 MB of int32 targets
// (0.025 ms at 3.35 TB/s); there is no arithmetic to speak of. A rotation
// by 90 degrees reads a column of the source for a row of the output, so a
// block stages a square source tile in shared memory and writes its output
// tile from there. A D4 transform maps a square tile onto a square tile:
// the source tile's corner is the lesser of the images of the output tile's
// corners, and over a tile the map is affine.
//
// Two instances, chosen by the host (ops/augment.py:launch_plan) and passed
// as the entry point's last argument:
//
// - tiled (square patches whose side is a multiple of kBigTile, at most
//   kBigMaxChannels channels, every pointer 16-byte aligned: FLAIR's
//   train, eval and predict batches). A block owns a 64 x 64 output tile:
//   1. it works out the tile's source map once, as a staged offset base +
//      ii * si + jj * sj (+ the channel) of output pixel (ii, jj), and each
//      thread its constants once: a thread always builds the same chunk
//      column q of the tile's rows, so the staged offsets of its chunk's
//      values relative to the row and their channels' mean and mul stay in
//      registers;
//   2. it issues every copy of its source tile (64 rows of 64 C bytes, 20
//      KB at C = 5) and of its mask tile (4 KB) with cp.async before its
//      one wait, so an SM keeps its blocks' tiles, tens of KB, in flight;
//   3. a staged row is padded by one word (kPadBytes) to an odd number of
//      words, so the column walk of k = 1 and k = 3, which reads a byte of a
//      different source row on each lane, spreads over the banks (without
//      the pad, 64 C bytes a row put every row on the same few banks). The
//      copies are kCopyBytes wide to land on that pitch; consecutive lanes
//      copy consecutive words of a row, so a warp reads whole 128-byte
//      lines;
//   4. each thread builds whole 16-byte chunks of an output row (8 bf16 or
//      4 float32 values, in the row's (pixel, channel) order; 4 int32
//      targets) and stores each with one 16-byte store, neighbouring
//      threads on neighbouring chunks. Where the output row runs forward
//      along a staged row (the identity, and 3 more of the 16 choices), a
//      chunk's bytes are read as whole words; else byte by byte.
//   A byte becomes a float exactly as 0x4B0000bb - 2^23.
// - general (any batch, height, width, channels <= kMaxChannels, any
//   alignment): a block stages a 32 x 32 source tile with byte loads and
//   writes one output pixel a thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGeneral = 0, kTiled = 1;  // the entry point's instance argument
constexpr int kMaxChannels = 32;
// the general instance
constexpr int kTile = 32;
constexpr int kThreads = 256;
// the tiled instance
constexpr int kBigTile = 64;
constexpr int kBigThreads = 256;  // at most: a block is a whole number of a tile row's chunks
constexpr int kBigMaxChannels = 8;
constexpr int kCopyBytes = 4;
constexpr int kPadBytes = 4;
constexpr int kAlign = 16;

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

__device__ __forceinline__ int clean(int t, int n_classes) {
  return (t >= 0 && t < n_classes) ? t : 0;
}

template <bool kF32>
__global__ void __launch_bounds__(kThreads) general_kernel(Args a) {
  extern __shared__ uint8_t smem_general[];
  uint8_t* s_img = smem_general;                               // kTile * kTile * C
  uint8_t* s_msk = smem_general + kTile * kTile * a.channels;  // kTile * kTile
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
    if (a.mask) a.target[o] = clean((int)s_msk[s] - 1, a.n_classes);
  }
}

__device__ __forceinline__ void copy_async(uint32_t dst, const uint8_t* src) {
  if constexpr (kCopyBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src),
                 "n"(kCopyBytes) : "memory");
}

// byte e of w, as the float 2^23 + byte (exact)
__device__ __forceinline__ float magic_byte(uint32_t w, int e) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | e));
}

// (x - mean) * mul of the byte carried by magic (2^23 + byte)
__device__ __forceinline__ float normalize(float magic, float mean, float mul) {
  return __fmul_rn(__fsub_rn(__fsub_rn(magic, 8388608.0f), mean), mul);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <bool kF32>
__global__ void __launch_bounds__(kBigThreads) tiled_kernel(Args a) {
  constexpr int kVals = kF32 ? 4 : 8;  // values a 16-byte chunk
  extern __shared__ __align__(16) uint8_t smem_tiled[];
  const int C = a.channels, n = a.height;  // square
  const int row_bytes = kBigTile * C;
  const int pitch = row_bytes + kPadBytes;
  constexpr int kMaskPitch = kBigTile + kPadBytes;
  uint8_t* s_img = smem_tiled;                     // kBigTile rows of pitch bytes
  uint8_t* s_msk = smem_tiled + kBigTile * pitch;  // kBigTile rows of kMaskPitch bytes
  const int b = blockIdx.z, i0 = blockIdx.y * kBigTile, j0 = blockIdx.x * kBigTile;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  int v = 0, h = 0, k = 0;
  if (a.choices) {
    v = a.choices[3 * b];
    h = a.choices[3 * b + 1];
    k = a.choices[3 * b + 2];
  }
  // the tile's source map: (r, c) = (ra + ii * dri + jj * drj, ca + ii * dci + jj * dcj)
  int ra, ca, rb, cb, rc, cc;
  source(i0, j0, v, h, k, n, n, ra, ca);
  source(i0 + 1, j0, v, h, k, n, n, rb, cb);
  source(i0, j0 + 1, v, h, k, n, n, rc, cc);
  const int dri = rb - ra, dci = cb - ca, drj = rc - ra, dcj = cc - ca;
  const int r0 = ra + (kBigTile - 1) * (min(dri, 0) + min(drj, 0));
  const int c0 = ca + (kBigTile - 1) * (min(dci, 0) + min(dcj, 0));
  const int sr0 = ra - r0, sc0 = ca - c0;

  // every copy of the source tile, then one wait
  {
    const uint8_t* img = a.img + (((long long)b * n + r0) * n + c0) * C;
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(s_img));
    const int units = row_bytes / kCopyBytes;
    const uint32_t magic = 0xFFFFFFFFu / units + 1;  // e / units = umulhi(e, magic) here
    for (int e = tid; e < kBigTile * units; e += nthreads) {
      const int r = __umulhi(e, magic), u = e - r * units;
      copy_async(dst + r * pitch + u * kCopyBytes, img + (long long)r * n * C + u * kCopyBytes);
    }
    if (a.mask) {
      constexpr int kUnits = kBigTile / kCopyBytes;
      const uint8_t* msk = a.mask + ((long long)b * n + r0) * n + c0;
      const uint32_t mdst = static_cast<uint32_t>(__cvta_generic_to_shared(s_msk));
      for (int e = tid; e < kBigTile * kUnits; e += nthreads) {
        const int r = e / kUnits, u = e % kUnits;
        copy_async(mdst + r * kMaskPitch + u * kCopyBytes, msk + (long long)r * n + u * kCopyBytes);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  }

  // this thread's chunk column q: its values' staged offsets from the row's
  // base, and their channels' constants
  const int cpr = row_bytes / kVals;  // chunks a row; nthreads is a multiple of it
  const int q = tid % cpr;
  const int si = dri * pitch + dci * C, sj = drj * pitch + dcj * C;
  const bool forward = sj == C;  // a chunk's bytes lie in order, from a word boundary
  int rel[kVals];
  float mean[kVals], mul[kVals];
  {
    int jj = kVals * q / C, ch = kVals * q - jj * C;
#pragma unroll
    for (int e = 0; e < kVals; ++e) {
      rel[e] = jj * sj + ch;
      mean[e] = a.mean[ch];
      mul[e] = a.mul[ch];
      if (++ch == C) {
        ch = 0;
        ++jj;
      }
    }
  }
  __syncthreads();

  using Out = typename std::conditional<kF32, float, __nv_bfloat16>::type;
  Out* out = static_cast<Out*>(a.out) + (((long long)b * n + i0) * n + j0) * C + kVals * q;
  const uint8_t* s_row = s_img + sr0 * pitch + sc0 * C;
  for (int ii = tid / cpr; ii < kBigTile; ii += nthreads / cpr) {
    const uint8_t* src = s_row + ii * si;
    float x[kVals];
    if (forward) {
#pragma unroll
      for (int w = 0; w < kVals / 4; ++w) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(src + kVals * q + 4 * w);
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * w + e] = magic_byte(word, e);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVals; ++e) x[e] = __uint_as_float(0x4B000000u | src[rel[e]]);
    }
#pragma unroll
    for (int e = 0; e < kVals; ++e) x[e] = normalize(x[e], mean[e], mul[e]);
    uint4 chunk;
    if constexpr (kF32) {
      chunk = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                         __float_as_uint(x[3]));
    } else {
      chunk = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                         pack_bf16(x[6], x[7]));
    }
    *reinterpret_cast<uint4*>(out + (long long)ii * n * C) = chunk;
  }

  if (a.mask) {
    constexpr int kChunks = kBigTile / 4;  // 4 int32 targets a chunk
    const int mi = dri * kMaskPitch + dci, mj = drj * kMaskPitch + dcj;
    const uint8_t* m_row = s_msk + sr0 * kMaskPitch + sc0;
    int* target = a.target + ((long long)b * n + i0) * n + j0;
    for (int g = tid; g < kBigTile * kChunks; g += nthreads) {
      const int ii = g / kChunks, tq = g % kChunks;
      const uint8_t* src = m_row + ii * mi + 4 * tq * mj;
      int t[4];
      if (mj == 1) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
        for (int e = 0; e < 4; ++e) t[e] = (int)((word >> (8 * e)) & 0xFFu) - 1;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) t[e] = (int)src[e * mj] - 1;
      }
      *reinterpret_cast<int4*>(target + (long long)ii * n + 4 * tq) =
          make_int4(clean(t[0], a.n_classes), clean(t[1], a.n_classes),
                    clean(t[2], a.n_classes), clean(t[3], a.n_classes));
    }
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % kAlign == 0; }

}  // namespace

// img: (batch, height, width, channels) uint8; mask: (batch, height, width)
// uint8 as read from disk (labels from 1), or null (no targets); choices:
// (batch, 3) int32 (v, h, k), or null for the identity (k odd needs height
// == width); mean, mul: channels float32; out: (batch, height, width,
// channels) bfloat16, or float32 where out_f32 is nonzero; target: (batch,
// height, width) int32, written where mask is given; instance: 0 general,
// 1 tiled (cudaErrorInvalidValue where the shapes or pointers do not suit
// it). Returns cudaGetLastError() after the launch.
extern "C" int augment_normalize(const void* img, const void* mask, const void* choices,
                                 const void* mean, const void* mul, void* out, void* target,
                                 int batch, int height, int width, int channels, int n_classes,
                                 int out_f32, void* stream, int instance) {
  if (batch < 0 || height < 1 || width < 1 || channels < 1 || channels > kMaxChannels ||
      (mask && !target))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const Args a{static_cast<const uint8_t*>(img), static_cast<const uint8_t*>(mask),
               static_cast<const int*>(choices), static_cast<const float*>(mean),
               static_cast<const float*>(mul), out, static_cast<int*>(target),
               height, width, channels, n_classes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == kTiled) {
    if (height != width || height % kBigTile || channels > kBigMaxChannels || !aligned(img) ||
        !aligned(out) || (mask && (!aligned(mask) || !aligned(target))))
      return (int)cudaErrorInvalidValue;
    const int cpr = kBigTile * channels / (out_f32 ? 4 : 8);
    const int threads = cpr * max(1, kBigThreads / cpr);
    const dim3 grid(width / kBigTile, height / kBigTile, batch);
    const size_t smem = (size_t)kBigTile * (kBigTile * channels + kPadBytes) +
                        (mask ? (size_t)kBigTile * (kBigTile + kPadBytes) : 0);
    if (out_f32)
      tiled_kernel<true><<<grid, threads, smem, s>>>(a);
    else
      tiled_kernel<false><<<grid, threads, smem, s>>>(a);
  } else if (instance == kGeneral) {
    const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile, batch);
    const size_t smem = (size_t)kTile * kTile * (channels + 1);
    if (out_f32)
      general_kernel<true><<<grid, kThreads, smem, s>>>(a);
    else
      general_kernel<false><<<grid, kThreads, smem, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
