// Train-mode BatchNorm: the batch statistics of a convolution's output with
// the running-statistics update, and the backward of BatchNorm + residual
// (or a second BatchNorm'd branch) + ReLU.
//
// Replaces what XLA fused into the train step on the TPU: Flax's train-mode
// BatchNorm (flairtpu/models/resnet.py:40-70; flax.linen.BatchNorm with
// use_fast_variance, momentum 0.9, epsilon 1e-5, statistics in float32) at
// every site of the resnet encoders' blocks and stem (resnet.py:177-189,
// :208-222, :269-273) and of the U-Net decoder (flairtpu/models/unet.py:
// 71-76), and its VJP with the residual add and the ReLU after it. At the
// wide sites the forward's apply (y * scale + shift, residual or branch,
// ReLU, casts) is the conv_epilogue kernel, fed the batch (scale, shift)
// written here; the narrow sites' forward applies them itself (below).
//
// bn_train_stats, over x (M, C) bfloat16 (NHWC: M = B H W pixels):
//   mean = sum(x) / M;  var = max(sum(x^2) / M - mean^2, 0)      (biased)
//   invstd = rsqrt(var + eps);  scale = gamma * invstd;  shift = beta - mean * scale
//   running_mean = m * running_mean + (1 - m) * mean;  running_var likewise with var
// bn_train_backward, with gr = (g + g32) * [out > 0] (the ReLU's mask read
// from the saved bf16 output), then at EfficientNet's sites (flairtpu/models/
// efficientnet.py:170-212, :234-262) the per-(b, c) gradient affine and the
// SiLU's derivative, and xh = (y - mean) * invstd:
//   ga = gr * gmul[b, c] + gadd[b, c]      (each optional; b the pixel's sample)
//   gz = ga * s (1 + z (1 - s)),  z = y * scale + shift,  s = 1 / (1 + exp(-z))
//                                          (SiLU sites; else gz = ga)
//   gz = gr * r6(z),  r6 = 1 on (0, 6), 1/2 at z == 0 or z == 6, else 0
//                                          (ReLU6 sites, MobileNetV2's)
//   dbeta = sum(gz);  dgamma = sum(gz * xh)
//   dy = gamma * invstd * (gz - (dbeta + xh * dgamma) / M)        (bf16)
//   dres = gr (float32), or for a branch d the same dy formula with its own
//   statistics into dd (bf16).
// z is recomputed from the saved bf16 y with the forward's float32 scale
// (gamma * invstd, as the statistics round it) and shift, in the order
// conv_epilogue computes it, so it has the forward's bits. The affine is the
// depthwise site's two gradients summed before the SiLU (gmul the squeeze-
// excite gate, gadd the squeeze's mean gradient over HW), and the project
// site's drop-connect (gmul = mask[b] / keep): one backward, not two.
// The ReLU6's mask cannot come from the saved bf16 output, as the ReLU's
// does: bf16 rounds every float32 in [5.984375, 6) to 6.0, where the
// gradient is 1. So it is read from z, recomputed as the SiLU's is. At the
// ties z == 0 and z == 6 the derivative is 1/2, as JAX differentiates
// jnp.clip (flairtpu/models/tv_encoders.py:103-104: clip is max then min,
// and each splits a tie's gradient in two); NaN gives 0.
//
// Bound: bytes, both entry points. The statistics read x once (2 M C
// bytes). The backward reads g, out, y (and g32, d) and writes dy (and dres
// or dd); its sums must be complete before any dy, so it reads its inputs
// twice, and only the second read can come from L2.
//
// Design. A thread takes 8 channels of a pixel (one 16-byte bf16 load) and
// keeps them: C / 8 neighbouring threads cover a pixel, a block's 256
// threads `rows` = 256 / (C / 8) pixels. A block walks tiles of rows x U
// pixels (contiguous in memory), tile b, b + grid, ... of the site, so the
// card's read front moves through the site as one; the U loads of a tile
// are issued before any is used (U = 4 in the statistics, 16 KB a tile; in
// the backward U = 4 where a pixel loads only g and y, 32 bytes, and U = 2
// where it also loads the ReLU's output, a branch or g32, 48-64 bytes: about
// 128 bytes a thread in flight either way). Float32 partial
// sums stay in registers; a block folds its rows (a warp shuffle tree where
// a warp holds whole pixels, then its warps in shared memory, in a fixed
// order) into one column of per-channel sums, written transposed so each
// (sum, channel)'s blocks lie side by side. Each block then takes a ticket
// (__threadfence before the atomicAdd on an int32 counter). The last blocks
// to arrive, as many as give each team of 1-8 warps one channel (the whole
// grid where it is small), wait for the rest and share the combine in one
// round of loads: a team's lanes stride over the blocks in double, 8 loads
// a sum in flight, and fixed shuffle trees add them, so the result does not
// depend on which blocks finished last, and no float atomic is used; two
// runs give the same bits. (ops/bn_train_phases.py's one_combiner variant
// times one combining block instead.) The last combiner to finish resets
// the counters to 0 for the next call on the stream. Blocks that leave
// free their places for those not yet started, and the wrapper's grid never
// exceeds the blocks the card holds at once, so the waiting ends even where
// every block combines.
//
// The statistics are one launch: the combiners write mean, invstd, scale,
// shift and the running statistics. The backward is two: the reduce (a
// forward walk) with the same combine into (dbeta, dgamma, dgamma_d), and
// the apply, which walks the same tiles in the reverse order, so it starts
// on the tiles the reduce read last, still in the 50 MB L2. The statistics
// walk in reverse too, so the conv_epilogue that applies them (a forward
// grid-stride walk) starts on the tiles they read last.
//
// Above 2048 channels (EfficientNet-b2..b7's expanded maps, up to 3840) a
// pixel's C / 8 threads would not fit a block, so the channels are cut into
// `channel_tiles` equal tiles of `width` channels (ops/bn_train.py:
// channel_tiles: the fewest, of at least 512 channels, that keep the most of
// a block's threads busy): block i takes tile i % channel_tiles and walks
// the pixels as block i / channel_tiles of the tile's grid / channel_tiles,
// and each channel's partials are that grid's. The ticket still counts the
// whole grid, and the combiners take every channel, so each channel is
// reduced once, in the same fixed order. At 2048 channels or fewer there is
// one tile and nothing changes.
//
// The backward's modes are template instances (Kind: the ReLU sites, the
// branch, and the lean ones that load no ReLU output and no branch: plain,
// SiLU, affine, SiLU + affine, each with g32 or not), so the per-element
// path tests none of their pointers (the ReLU6 instance, the eleventh, is
// a lean one too: g and y a pixel). The ReLU instances keep their
// arithmetic bit for bit; the lean ones fold the apply's constants and take
// invstd once a sum. At a SiLU site the sigmoid runs on the special-function
// units (ex2.approx, rcp.approx: about 10 instructions an element, the IEEE
// expf and division about 30) from z with the forward's bits. The affine's
// sample b = p / hw is a multiply-high by a constant that the host computes
// (ops/bn_train.py:sample_divisor; the entry point checks it), and a thread
// keeps its sample's gmul and gadd in registers, loading them with a tile's
// loads where the tile starts another sample: no 64-bit division and no
// dependent load a pixel. A lean site above L2 still reads g and y twice
// from HBM, which caps it near (4 + 2) / (8 + 2) of its byte bound.
//
// The wrapper (ops/bn_train.py:launch_plan) sizes the grid by the work: at
// least 64 KB of x (bf16) a block, at most the blocks the card holds at
// once (132 SMs x the kernel's occupancy, bn_train_occupancy). At batch 16
// the stem, layer1 and decoder blocks 2-4 take the co-resident grid (528
// statistics blocks, 264 backward), layer2-4 and decoder blocks 0-1 64-256
// blocks and as few partials. The sites whose backward inputs fit in L2
// (layer3, layer4 and decoder block 0: 13-42 MB) can read them from HBM
// about once; the others read them twice, which caps their backward at
// about 8/14 of its byte bound. A lean backward takes at least 16 KB a
// block (its small maps, 16² and 32² at b4's deep blocks, are bound by each
// block's fixed work and the launches), and a one-tile grid above the SMs
// a multiple of them, so no SM runs a block more than another.
//
// Narrow sites (bn_train_narrow_forward, bn_train_narrow_backward): a
// channel count that is not a multiple of 8 (PAN's FPA pyramid, flairtpu/
// models/pan.py:83-95: six 1-channel sites on maps of at most B x 16 x 16
// pixels at 512 tiles), with no residual or branch. At these sizes (256 to
// 4096 values a channel) the bytes take nanoseconds and the card's floor for
// one launch bounds a call, so each direction is one launch of a block a
// channel that reads its values once: a thread keeps up to 16 of them (and
// in the backward its gz and xh) in registers from the sums to the apply,
// sums in double, and the block adds its threads by warp shuffles, then its
// warps in order (the same bits in every thread; no scratch, no counters).
// The forward writes the statistics as the combiners do and, at a train
// site, applies them from the registers: the site's output with
// conv_epilogue's arithmetic, so no conv_epilogue launch follows. The
// backward writes dgamma, dbeta and dy. bn_train_launch_floor times the
// floor they are held to: an empty kernel and one block's reduction.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStatsUnroll = 4;  // pixels a thread loads at once: statistics
constexpr int kBackUnroll = 2;   // backward, where a pixel loads out, d or g32 too
constexpr int kLeanUnroll = 4;   // backward, where it loads only g and y (32 bytes)
constexpr int kLeanMinBlocks = 2;  // a lean backward's blocks an SM at least (registers capped)
constexpr long long kMaxBackPixels = 1LL << 31;  // a backward's m: a pixel index fits 31 bits
constexpr float kNegLog2e = -1.4426950408889634f;
constexpr int kCombineLoads = 8; // loads a lane keeps in flight for each sum
constexpr int kCounters = 2;     // int32: arrived, combined
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p, long long off) {
  return *reinterpret_cast<const uint4*>(p + off);
}

// The block's thread layout over its channel tile of `width` channels:
// lanes = width / 8 threads a pixel, rows = 256 / lanes pixels at a time;
// threads past rows * lanes only join the barriers. Where lanes divides 32,
// a warp holds 32 / lanes whole pixels. The block is block `bi` of the
// tile's `nb` (block i: tile i % tiles, bi = i / tiles); c0 is the thread's
// first channel.
struct Layout {
  int lanes, rows, lane, row, ctile, width, bi, nb, c0;
  bool active, warp_rows;
  __device__ Layout(int channels, int tiles) {
    width = channels / tiles;
    ctile = blockIdx.x % tiles;
    bi = blockIdx.x / tiles;
    nb = gridDim.x / tiles;
    lanes = width / 8;
    rows = kThreads / lanes;
    lane = threadIdx.x % lanes;
    row = threadIdx.x / lanes;
    active = row < rows;
    warp_rows = 32 % lanes == 0;
    c0 = ctile * width + lane * 8;
  }
};

// The block's tiles of rows * U pixels, bi, bi + nb, ...: k = 0 ... last
// in walk order, the k-th starting at pixel first(k, reverse).
template <int U>
struct Tiles {
  long long pixels, last, bi, nb;
  __device__ Tiles(const Layout& t, long long m) {
    pixels = (long long)t.rows * U;
    bi = t.bi;
    nb = t.nb;
    const long long tiles = (m + pixels - 1) / pixels;
    last = bi < tiles ? (tiles - 1 - bi) / nb : -1;
  }
  __device__ long long first(long long k, bool reverse) const {
    return (bi + (reverse ? last - k : k) * nb) * pixels;
  }
};

// Folds the block's per-thread partials (kSums of 8 channels each) over its
// rows in a fixed order and writes the block's column of kSums * width sums
// of its channel tile: partials[e * nb + bi], e = s * C + c.
template <int kSums>
__device__ void block_sums(const Layout& t, float (&acc)[kSums][8], float* smem,
                           float* __restrict__ partials, int channels) {
  const int width = kSums * t.width;
  int prow = t.row, nrows = t.rows;
  bool write = t.active;
  if (t.warp_rows) {
    for (int off = t.lanes; off < 32; off <<= 1)
#pragma unroll
      for (int s = 0; s < kSums; ++s)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[s][i] += __shfl_xor_sync(kFull, acc[s][i], off);
    prow = threadIdx.x / 32;
    nrows = kWarps;
    write = threadIdx.x % 32 < t.lanes;
  }
  if (write)
#pragma unroll
    for (int s = 0; s < kSums; ++s)
#pragma unroll
      for (int i = 0; i < 8; ++i) smem[prow * width + s * t.width + t.lane * 8 + i] = acc[s][i];
  __syncthreads();
  for (int e = threadIdx.x; e < width; e += kThreads) {
    float v = 0.f;
    for (int r = 0; r < nrows; ++r) v += smem[r * width + e];
    const int s = e / t.width, c = t.ctile * t.width + e % t.width;
    partials[((long long)s * channels + c) * t.nb + t.bi] = v;
  }
}

// Publishes the block's partials and takes a ticket. The last `combiners`
// blocks to arrive wait until every block has, and get their rank among
// the combiners; the others get -1 and leave.
__device__ int arrive(int* counters, int combiners) {
  __shared__ int rank;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int r = atomicAdd(&counters[0], 1) - ((int)gridDim.x - combiners);
    if (r >= 0) {
      const volatile int* arrived = counters;
      while (*arrived < (int)gridDim.x) __nanosleep(64);
      __threadfence();
    }
    rank = r;
  }
  __syncthreads();
  return rank;
}

// A combiner is done; the last one resets the counters for the next call.
__device__ void release(int* counters, int combiners) {
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(&counters[1], 1) == combiners - 1) {
    counters[0] = 0;
    counters[1] = 0;
  }
}

// Warps a combining block puts on one channel: enough that a lane loads at
// most kCombineLoads of a sum's partials.
__host__ __device__ int combine_warps(int grid) {
  int seg = 1;
  while (seg < kWarps && seg * 32 * kCombineLoads < grid) seg <<= 1;
  return seg;
}

// The combiners of a grid: enough that each takes one channel a team, so
// the combine is one round of loads.
int combiners_for(int blocks, int channels) {
  const int want = (channels * combine_warps(blocks) + kWarps - 1) / kWarps;
  return blocks < want ? blocks : want;
}

// The combine: the totals over a channel tile's `grid` blocks of each sum
// s < kSums of the channels this combiner takes (channel c in rounds of `teams`, the
// combiners' teams interleaved), handed to done(c, totals, prefetch(c)) on
// one thread, which called prefetch(c) before the round's loads.
// A team of `seg` warps takes a channel: warp j of the team adds blocks
// [j * per, (j + 1) * per) of each sum's row, lane l blocks l, l + 32, ...
// in double with 8 loads a row in flight, then a fixed shuffle tree; the
// team's leader adds its warps' totals in order. Every total has the same
// bits whichever block computes it.
template <int kSums, typename Prefetch, typename Done>
__device__ void combine(const float* partials, int channels, int grid, int rank, int combiners,
                        Prefetch prefetch, Done done) {
  __shared__ double part[kWarps][kSums];
  const int seg = combine_warps(grid);
  const int teams = kWarps / seg, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int team = warp / seg, per = (grid + seg - 1) / seg;
  const int begin = (warp % seg) * per, end = min(grid, begin + per);
  for (int c0 = rank * teams; c0 < channels; c0 += combiners * teams) {
    const int c = c0 + team;
    const bool leader = c < channels && warp % seg == 0 && lane == 0;
    decltype(prefetch(0)) pre{};
    if (leader) pre = prefetch(c);
    if (c < channels) {
      double v[kSums];
#pragma unroll
      for (int s = 0; s < kSums; ++s) v[s] = 0.0;
      for (int b = begin + lane; b < end; b += 32 * kCombineLoads) {
        float x[kSums][kCombineLoads];
#pragma unroll
        for (int s = 0; s < kSums; ++s)
#pragma unroll
          for (int u = 0; u < kCombineLoads; ++u) {
            const int bb = b + 32 * u;
            x[s][u] = bb < end ? __ldcg(partials + (long long)(s * channels + c) * grid + bb)
                               : 0.f;
          }
#pragma unroll
        for (int s = 0; s < kSums; ++s)
#pragma unroll
          for (int u = 0; u < kCombineLoads; ++u) v[s] += (double)x[s][u];
      }
#pragma unroll
      for (int s = 0; s < kSums; ++s) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v[s] += __shfl_xor_sync(kFull, v[s], off);
        if (lane == 0) part[warp][s] = v[s];
      }
    }
    __syncthreads();
    if (leader) {
      double total[kSums];
#pragma unroll
      for (int s = 0; s < kSums; ++s) {
        total[s] = 0.0;
        for (int k = 0; k < seg; ++k) total[s] += part[warp + k][s];
      }
      done(c, total, pre);
    }
    __syncthreads();
  }
}

struct StatsArgs {
  const __nv_bfloat16* x;
  const float* gamma;
  const float* beta;
  float* running_mean;
  float* running_var;
  float* partials;  // (2, C, grid)
  int* counters;
  float* mean;
  float* invstd;
  float* scale;
  float* shift;
  long long m;
  int channels, combiners, tiles;
  float eps, momentum;
};

__global__ void __launch_bounds__(kThreads) stats_kernel(StatsArgs a) {
  extern __shared__ float smem[];
  const Layout t(a.channels, a.tiles);
  const Tiles<kStatsUnroll> tiles(t, a.m);
  const int c0 = t.c0;
  float acc[2][8] = {};
  if (t.active)
    for (long long k = 0; k <= tiles.last; ++k) {
      const long long p0 = tiles.first(k, true) + t.row;
      uint4 w[kStatsUnroll];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        const long long p = p0 + (long long)u * t.rows;
        w[u] = p < a.m ? load16(a.x, p * a.channels + c0) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        float f[8];
        unpack8(w[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[0][i] += f[i];
          acc[1][i] += f[i] * f[i];
        }
      }
    }
  block_sums<2>(t, acc, smem, a.partials, a.channels);
  const int rank = arrive(a.counters, a.combiners);
  if (rank < 0) return;
  const auto vectors = [&](int c) {
    return make_float4(a.gamma[c], a.beta[c], a.running_mean[c], a.running_var[c]);
  };
  combine<2>(a.partials, a.channels, t.nb, rank, a.combiners, vectors,
             [&](int c, const double (&sum)[2], float4 v) {
    const float mean = (float)(sum[0] / (double)a.m);
    const float ex2 = (float)(sum[1] / (double)a.m);
    const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
    const float invstd = rsqrtf(__fadd_rn(var, a.eps));
    const float scale = __fmul_rn(v.x, invstd);
    a.mean[c] = mean;
    a.invstd[c] = invstd;
    a.scale[c] = scale;
    a.shift[c] = __fsub_rn(v.y, __fmul_rn(mean, scale));
    const float keep = 1.f - a.momentum;
    a.running_mean[c] = __fadd_rn(__fmul_rn(a.momentum, v.z), __fmul_rn(keep, mean));
    a.running_var[c] = __fadd_rn(__fmul_rn(a.momentum, v.w), __fmul_rn(keep, var));
  });
  release(a.counters, a.combiners);
}

struct BackArgs {
  const __nv_bfloat16* g;    // null: no bf16 gradient
  const float* g32;          // null: no float32 gradient
  const __nv_bfloat16* out;  // null: no ReLU
  const __nv_bfloat16* y;
  const float* mean;
  const float* invstd;
  const float* gamma;
  const __nv_bfloat16* d;    // the branch (kBranch)
  const float* mean_d;
  const float* invstd_d;
  const float* gamma_d;
  float* partials;           // (2 + kBranch, C, grid)
  int* counters;
  float* sums;               // (3, C): dbeta, dgamma, dgamma_d
  __nv_bfloat16* dy;
  float* dres;               // null: no residual
  __nv_bfloat16* dd;         // the branch's
  long long m;
  int channels, combiners, tiles;
  const float* shift;        // the forward's shift at a SiLU or ReLU6 site, else null
  const float* gmul;         // (B, C) or null: the gradient affine's factor
  const float* gadd;         // (B, C) or null: its term
  long long hw;              // pixels a sample
  unsigned sample_magic;     // b = (p * sample_magic) >> sample_shift = p / hw
  int sample_shift;
};

// The backward's instances, by what a site's pixel loads and computes: the
// C entry point picks one from its pointers, bn_train_occupancy takes it as
// `kind`. Lean instances load no ReLU output and no branch, and g32 or not
// by the instance (kinds 6-9 are 2-5 with it); the ReLU instances test g32
// at run time and take no register cap, so they keep their occupancy, grid
// and bits.
enum Kind : int {
  kReluKind = 0,    // the ReLU: its output loaded (with a residual or not)
  kBranchKind = 1,  // a second BatchNorm'd branch
  kLeanKind = 2,    // no ReLU, no branch
  kSiluKind = 3,    // the SiLU's derivative
  kAffineKind = 4,  // the gradient affine
  kSiluAffineKind = 5,
  kLeanG32Kind = 6,
  kSiluG32Kind = 7,
  kAffineG32Kind = 8,
  kSiluAffineG32Kind = 9,
  kRelu6Kind = 10,  // lean: the ReLU6's derivative from z (no g32 twin: no site needs one)
};
constexpr int kKinds = 11;

// A site's activation as bn_train_backward takes it (conv_epilogue.cu's
// Activation codes)
enum Act : int { kActNone = 0, kActRelu = 1, kActSilu = 2, kActRelu6 = 3 };

template <int K>
struct Mode {
  static constexpr bool relu6 = K == kRelu6Kind;
  // lean: float32 gradient loaded
  static constexpr bool g32 = K >= kLeanG32Kind && K <= kSiluAffineG32Kind;
  static constexpr int base = relu6 ? kLeanKind : g32 ? K - (kLeanG32Kind - kLeanKind) : K;
  static constexpr bool branch = base == kBranchKind;
  static constexpr bool lean = base >= kLeanKind;
  static constexpr bool silu = base == kSiluKind || base == kSiluAffineKind;
  static constexpr bool affine = base >= kAffineKind;
  static constexpr int unroll = lean && !g32 ? kLeanUnroll : kBackUnroll;
  static constexpr int min_blocks = lean ? kLeanMinBlocks : 1;
  static constexpr int sums = branch ? 3 : 2;
};

// One pixel's raw operands: 8 channels of each map.
struct Pixel {
  uint4 g, out, y, d;
  float4 g32[2];
};

template <class M>
__device__ __forceinline__ void load_pixel(const BackArgs& a, long long off, bool in,
                                           Pixel& px) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  px.g = in && a.g ? load16(a.g, off) : zero;
  px.out = !M::lean && in && a.out ? load16(a.out, off) : zero;
  px.y = in ? load16(a.y, off) : zero;
  if (M::branch) px.d = in ? load16(a.d, off) : zero;
  if (in && (M::lean ? M::g32 : a.g32 != nullptr)) {
    px.g32[0] = *reinterpret_cast<const float4*>(a.g32 + off);
    px.g32[1] = *reinterpret_cast<const float4*>(a.g32 + off + 4);
  } else {
    px.g32[0] = px.g32[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// gr of the pixel's 8 channels: (g + g32) masked by the ReLU (a lean
// pixel's g is zeros where the call has none: no add from 0)
template <class M>
__device__ __forceinline__ void masked_grad(const BackArgs& a, const Pixel& px, float (&gz)[8]) {
  float f[8];
  unpack8(px.g, f);
  const float h[8] = {px.g32[0].x, px.g32[0].y, px.g32[0].z, px.g32[0].w,
                      px.g32[1].x, px.g32[1].y, px.g32[1].z, px.g32[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (M::lean) {
      gz[i] = M::g32 ? f[i] + h[i] : f[i];
      continue;
    }
    gz[i] = 0.f;
    if (a.g) gz[i] += f[i];
    if (a.g32) gz[i] += h[i];
  }
  if (!M::lean && a.out) {
    unpack8(px.out, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) gz[i] = f[i] > 0.f ? gz[i] : 0.f;
  }
}

// 8 floats of a (B, C) float32 operand
__device__ __forceinline__ void load8(const float* p, long long off, float (&f)[8]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p + off));
  const float4 v = __ldg(reinterpret_cast<const float4*>(p + off + 4));
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The SiLU's derivative s (1 + z (1 - s)) at z = y * scale + shift, z
// rounded as conv_epilogue's SiLU and the plain version compute it, the
// sigmoid s on the special-function units: 2^(-z log2 e) (inf below z of
// about -88, so s = 0), 1 + that, its reciprocal; 1 + z (1 - s) by one fma
__device__ __forceinline__ float silu_grad(float y, float scale, float shift) {
  const float z = __fadd_rn(__fmul_rn(y, scale), shift);
  const float s = rcp_approx(__fadd_rn(1.f, ex2_approx(__fmul_rn(z, kNegLog2e))));
  return __fmul_rn(s, fmaf(z, __fsub_rn(1.f, s), 1.f));
}

// The ReLU6's derivative at z = y * scale + shift (the forward's bits): 1
// inside (0, 6), 1/2 at either tie, 0 outside and at NaN
__device__ __forceinline__ float relu6_grad(float y, float scale, float shift) {
  const float z = __fadd_rn(__fmul_rn(y, scale), shift);
  return z > 0.f && z < 6.f ? 1.f : (z == 0.f || z == 6.f ? 0.5f : 0.f);
}

// 8 channels of a (C,) float32 vector
__device__ __forceinline__ void vec8(const float* v, int c0, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = v[c0 + i];
}

// The forward's scale (gamma invstd, each rounded) of 8 channels
__device__ __forceinline__ void scale8(const float* gamma, const float* invstd, int c0,
                                       float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __fmul_rn(gamma[c0 + i], invstd[c0 + i]);
}

// The gradient affine of a thread's 8 channels at its current sample b:
// gmul's and gadd's (b, c) values (1 and 0 where the call has none), loaded
// again only when a pixel's sample differs from the last one's.
struct SampleAffine {
  int b = -1;
  float mul[8], add[8];
  // p / hw by the host's multiply-high constant
  __device__ __forceinline__ int sample(const BackArgs& a, long long p) const {
    return (int)(((unsigned long long)(unsigned)p * a.sample_magic) >> a.sample_shift);
  }
  // At a tile's first pixel p0 (below m): its sample's values; whether the
  // tile's last pixel p1 lies in that sample too (then no pixel checks)
  __device__ __forceinline__ bool tile(const BackArgs& a, long long p0, long long p1, int c0) {
    at(a, p0, c0);
    return sample(a, p1) == b;
  }
  __device__ __forceinline__ void at(const BackArgs& a, long long p, int c0) {
    const int s = sample(a, p);
    if (s == b) return;
    b = s;
    const long long off = (long long)s * a.channels + c0;
    if (a.gmul) {
      load8(a.gmul, off, mul);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) mul[i] = 1.f;
    }
    if (a.gadd) {
      load8(a.gadd, off, add);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) add[i] = 0.f;
    }
  }
};

// gz from gr at pixel p, channels c0..c0 + 7: the affine (gr * gmul + gadd
// by one fma), then the SiLU's or the ReLU6's derivative, as the instance
// has them; 0 past the last pixel
template <class M>
__device__ __forceinline__ void site_grad(const BackArgs& a, const float (&scale)[8],
                                          const float (&shift)[8], SampleAffine& af, bool whole,
                                          const uint4 y, long long p, int c0,
                                          const float (&gr)[8], float (&gz)[8]) {
  if (p >= a.m) {
#pragma unroll
    for (int i = 0; i < 8; ++i) gz[i] = 0.f;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) gz[i] = gr[i];
  if (M::affine) {
    if (!whole) af.at(a, p, c0);
#pragma unroll
    for (int i = 0; i < 8; ++i) gz[i] = fmaf(gz[i], af.mul[i], af.add[i]);
  }
  if (M::silu) {
    float f[8];
    unpack8(y, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) gz[i] = __fmul_rn(gz[i], silu_grad(f[i], scale[i], shift[i]));
  }
  if (M::relu6) {
    float f[8];
    unpack8(y, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) gz[i] = __fmul_rn(gz[i], relu6_grad(f[i], scale[i], shift[i]));
  }
}

// A map's per-channel constants, 8 channels of a thread
struct Consts {
  float mean[8], invstd[8];
  __device__ void load(const float* m, const float* s, int c0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mean[i] = m[c0 + i];
      invstd[i] = s[c0 + i];
    }
  }
  __device__ void normalized(const uint4 w, float (&xh)[8]) const {
    unpack8(w, xh);
#pragma unroll
    for (int i = 0; i < 8; ++i) xh[i] = (xh[i] - mean[i]) * invstd[i];
  }
  __device__ void centered(const uint4 w, float (&xc)[8]) const {
    unpack8(w, xc);
#pragma unroll
    for (int i = 0; i < 8; ++i) xc[i] = xc[i] - mean[i];
  }
};

template <int K>
__global__ void __launch_bounds__(kThreads, Mode<K>::min_blocks) backward_reduce(BackArgs a) {
  using M = Mode<K>;
  constexpr int kSums = M::sums;
  extern __shared__ float smem[];
  const Layout t(a.channels, a.tiles);
  const Tiles<M::unroll> tiles(t, a.m);
  const int c0 = t.c0;
  float acc[kSums][8] = {};
  if (t.active) {
    Consts cy, cd;
    float scale[8], shift[8];
    SampleAffine af;
    cy.load(a.mean, a.invstd, c0);
    if (M::branch) cd.load(a.mean_d, a.invstd_d, c0);
    if (M::silu || M::relu6) {
      scale8(a.gamma, a.invstd, c0, scale);
      vec8(a.shift, c0, shift);
    }
    for (long long k = 0; k <= tiles.last; ++k) {
      const long long p0 = tiles.first(k, false) + t.row;
      Pixel px[M::unroll];
#pragma unroll
      for (int u = 0; u < M::unroll; ++u) {
        const long long p = p0 + (long long)u * t.rows;
        load_pixel<M>(a, p * a.channels + c0, p < a.m, px[u]);
      }
      // the tile's sample's gmul and gadd, in flight with its loads
      const bool whole = M::affine && p0 < a.m &&
                         af.tile(a, p0, p0 + (M::unroll - 1) * (long long)t.rows, c0);
#pragma unroll
      for (int u = 0; u < M::unroll; ++u) {
        float gr[8], gz[8], xh[8];
        masked_grad<M>(a, px[u], gr);
        site_grad<M>(a, scale, shift, af, whole, px[u].y, p0 + (long long)u * t.rows, c0, gr,
                     gz);
        if (M::lean)
          cy.centered(px[u].y, xh);  // y - mean: the sum takes invstd once, below
        else
          cy.normalized(px[u].y, xh);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[0][i] += gz[i];
          acc[1][i] += gz[i] * xh[i];
        }
        if (M::branch) {
          cd.normalized(px[u].d, xh);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[kSums - 1][i] += gz[i] * xh[i];
        }
      }
    }
    if (M::lean)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[1][i] *= cy.invstd[i];
  }
  block_sums<kSums>(t, acc, smem, a.partials, a.channels);
  const int rank = arrive(a.counters, a.combiners);
  if (rank < 0) return;
  combine<kSums>(a.partials, a.channels, t.nb, rank, a.combiners, [](int) { return 0; },
                 [&](int c, const double (&sum)[kSums], int) {
#pragma unroll
                   for (int s = 0; s < kSums; ++s) a.sums[s * a.channels + c] = (float)sum[s];
                 });
  release(a.counters, a.combiners);
}

// dy (or dd) of 8 channels: gamma invstd (gz - (dbeta + xh dgamma) / M)
struct Apply {
  Consts c;
  float k[8], dbeta[8], dgamma[8];
  __device__ void load(const float* mean, const float* invstd, const float* gamma,
                       const float* dbeta_, const float* dgamma_, int c0, float) {
    c.load(mean, invstd, c0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      k[i] = gamma[c0 + i] * invstd[c0 + i];
      dbeta[i] = dbeta_[c0 + i];
      dgamma[i] = dgamma_[c0 + i];
    }
  }
  __device__ uint4 operator()(const uint4 w, const float (&gz)[8], float inv_m) const {
    float xh[8], o[8];
    c.normalized(w, xh);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = k[i] * (gz[i] - (dbeta[i] + xh[i] * dgamma[i]) * inv_m);
    return pack8(o);
  }
};

// The same at the lean sites, its per-channel constants folded: k gz + ky y
// + k0, ky = -k dgamma invstd / M, k0 = -k (dbeta - dgamma invstd mean) / M
// (three operations an element for six, 24 registers for 40; k is Apply's)
struct FoldedApply {
  float k[8], ky[8], k0[8];
  __device__ void load(const float* mean, const float* invstd, const float* gamma,
                       const float* dbeta, const float* dgamma, int c0, float inv_m) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      k[i] = gamma[c0 + i] * invstd[c0 + i];
      const float gi = dgamma[c0 + i] * invstd[c0 + i];
      ky[i] = -k[i] * gi * inv_m;
      k0[i] = -k[i] * (dbeta[c0 + i] - gi * mean[c0 + i]) * inv_m;
    }
  }
  __device__ uint4 operator()(const uint4 w, const float (&gz)[8], float) const {
    float y[8], o[8];
    unpack8(w, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = fmaf(k[i], gz[i], fmaf(ky[i], y[i], k0[i]));
    return pack8(o);
  }
};

template <int K>
__global__ void __launch_bounds__(kThreads, Mode<K>::min_blocks) backward_apply(BackArgs a) {
  using M = Mode<K>;
  const Layout t(a.channels, a.tiles);
  if (!t.active) return;
  const Tiles<M::unroll> tiles(t, a.m);
  const int c0 = t.c0;
  const int C = a.channels;
  const float inv_m = 1.f / (float)a.m;
  std::conditional_t<M::lean, FoldedApply, Apply> fy;
  Apply fd;
  float shift[8];  // the SiLU's or ReLU6's; its scale is fy.k (gamma invstd, the same bits)
  SampleAffine af;
  fy.load(a.mean, a.invstd, a.gamma, a.sums, a.sums + C, c0, inv_m);
  if (M::branch) fd.load(a.mean_d, a.invstd_d, a.gamma_d, a.sums, a.sums + 2 * C, c0, inv_m);
  if (M::silu || M::relu6) vec8(a.shift, c0, shift);
  for (long long k = 0; k <= tiles.last; ++k) {
    const long long p0 = tiles.first(k, true) + t.row;
    Pixel px[M::unroll];
#pragma unroll
    for (int u = 0; u < M::unroll; ++u) {
      const long long p = p0 + (long long)u * t.rows;
      load_pixel<M>(a, p * C + c0, p < a.m, px[u]);
    }
    const bool whole = M::affine && p0 < a.m &&
                       af.tile(a, p0, p0 + (M::unroll - 1) * (long long)t.rows, c0);
#pragma unroll
    for (int u = 0; u < M::unroll; ++u) {
      const long long p = p0 + (long long)u * t.rows;
      if (p >= a.m) continue;
      const long long off = p * C + c0;
      float gr[8], gz[8];
      masked_grad<M>(a, px[u], gr);
      site_grad<M>(a, fy.k, shift, af, whole, px[u].y, p, c0, gr, gz);
      *reinterpret_cast<uint4*>(a.dy + off) = fy(px[u].y, gz, inv_m);
      if (a.dres) {
        *reinterpret_cast<float4*>(a.dres + off) = make_float4(gr[0], gr[1], gr[2], gr[3]);
        *reinterpret_cast<float4*>(a.dres + off + 4) = make_float4(gr[4], gr[5], gr[6], gr[7]);
      }
      if (M::branch) *reinterpret_cast<uint4*>(a.dd + off) = fd(px[u].d, gz, inv_m);
    }
  }
}

// The narrow sites: a block a channel; a thread keeps its values in
// registers (kNarrowHeld, p = threadIdx.x + 256 i) from the sums to the
// apply where the channel has at most 256 x kNarrowHeld values, else reads
// them again by chunks of that size.
constexpr int kNarrowHeld = 16;
constexpr long long kNarrowChunk = (long long)kThreads * kNarrowHeld;

// The block's totals of two doubles a thread, the same bits in every
// thread: a shuffle butterfly in each warp (commutative steps: every lane
// ends with the same sums), then the warps' sums in warp order. Once a
// launch (part is not reused).
__device__ double2 block_totals(double a, double b, double2* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = make_double2(a, b);
  __syncthreads();
  double2 t = make_double2(0.0, 0.0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    t.x += part[w].x;
    t.y += part[w].y;
  }
  return t;
}

// bf16 bits -> float32, exactly
__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float((uint32_t)u << 16);
}

struct NarrowArgs {
  const __nv_bfloat16* x;
  const float* gamma;
  const float* beta;
  float* running_mean;
  float* running_var;
  float* mean;
  float* invstd;
  float* scale;
  float* shift;
  __nv_bfloat16* out;  // null: the statistics alone
  float* out32;        // null: no float32 output
  long long m;
  int channels, relu;
  float eps, momentum;
};

// The statistics of a channel (the combiners' formulas), then, where `out`
// is given, the apply from the values the block holds: y * scale + shift,
// ReLU, bf16 (and float32) with conv_epilogue's arithmetic, so the same
// bits as bn_stats then conv_epilogue. The channel's scalars are loaded
// first, so their latency overlaps the values'.
__global__ void __launch_bounds__(kThreads) narrow_forward_kernel(NarrowArgs a) {
  __shared__ double2 part[kWarps];
  const int c = blockIdx.x, C = a.channels;
  const float gamma = a.gamma[c], beta = a.beta[c];
  float rm = 0.f, rv = 0.f;
  if (threadIdx.x == 0) {
    rm = a.running_mean[c];
    rv = a.running_var[c];
  }
  const unsigned short* x = reinterpret_cast<const unsigned short*>(a.x);
  unsigned short raw[kNarrowHeld];
  double s = 0.0, q = 0.0;
  const auto load = [&](long long base) {
#pragma unroll
    for (int i = 0; i < kNarrowHeld; ++i) {
      const long long p = base + threadIdx.x + (long long)i * kThreads;
      raw[i] = p < a.m ? x[p * C + c] : (unsigned short)0;
    }
  };
  for (long long base = 0; base < a.m; base += kNarrowChunk) {
    load(base);
#pragma unroll
    for (int i = 0; i < kNarrowHeld; ++i)
      if (base + threadIdx.x + (long long)i * kThreads < a.m) {
        const float f = bf16_bits(raw[i]);
        s += (double)f;
        q += (double)(f * f);
      }
  }
  const double2 t = block_totals(s, q, part);
  const float mean = (float)(t.x / (double)a.m);
  const float ex2 = (float)(t.y / (double)a.m);
  const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
  const float invstd = rsqrtf(__fadd_rn(var, a.eps));
  const float scale = __fmul_rn(gamma, invstd);
  const float shift = __fsub_rn(beta, __fmul_rn(mean, scale));
  if (threadIdx.x == 0) {
    a.mean[c] = mean;
    a.invstd[c] = invstd;
    a.scale[c] = scale;
    a.shift[c] = shift;
    const float keep = 1.f - a.momentum;
    a.running_mean[c] = __fadd_rn(__fmul_rn(a.momentum, rm), __fmul_rn(keep, mean));
    a.running_var[c] = __fadd_rn(__fmul_rn(a.momentum, rv), __fmul_rn(keep, var));
  }
  if (!a.out) return;
  for (long long base = 0; base < a.m; base += kNarrowChunk) {
    if (a.m > kNarrowChunk) load(base);
#pragma unroll
    for (int i = 0; i < kNarrowHeld; ++i) {
      const long long p = base + threadIdx.x + (long long)i * kThreads;
      if (p >= a.m) continue;
      float o = __fadd_rn(__fmul_rn(bf16_bits(raw[i]), scale), shift);
      if (a.relu) o = o < 0.f ? 0.f : o;  // NaN passes, as torch.relu
      a.out[p * C + c] = __float2bfloat16_rn(o);
      if (a.out32) a.out32[p * C + c] = o;
    }
  }
}

// The backward of a channel: every operand of the thread's values loaded
// before any is used, gz and xh kept in registers from the sums to the
// apply (read again by chunks past kNarrowChunk values); the channel's
// scalars loaded first.
__global__ void __launch_bounds__(kThreads) narrow_backward_kernel(BackArgs a) {
  __shared__ double2 part[kWarps];
  const int c = blockIdx.x, C = a.channels;
  const float mean = a.mean[c], invstd = a.invstd[c], gamma = a.gamma[c];
  const unsigned short* g = reinterpret_cast<const unsigned short*>(a.g);
  const unsigned short* out = reinterpret_cast<const unsigned short*>(a.out);
  const unsigned short* y = reinterpret_cast<const unsigned short*>(a.y);
  float gz[kNarrowHeld], xh[kNarrowHeld];
  double s = 0.0, q = 0.0;
  const auto load = [&](long long base) {
    unsigned short rg[kNarrowHeld], ro[kNarrowHeld], ry[kNarrowHeld];
    float r32[kNarrowHeld];
#pragma unroll
    for (int i = 0; i < kNarrowHeld; ++i) {
      const long long p = base + threadIdx.x + (long long)i * kThreads;
      const long long off = p * C + c;
      const bool in = p < a.m;
      rg[i] = in && g ? g[off] : (unsigned short)0;
      r32[i] = in && a.g32 ? a.g32[off] : 0.f;
      ro[i] = in && out ? out[off] : (unsigned short)0;
      ry[i] = in ? y[off] : (unsigned short)0;
    }
#pragma unroll
    for (int i = 0; i < kNarrowHeld; ++i) {  // gz = (g + g32) masked by the ReLU
      float v = 0.f;
      if (g) v += bf16_bits(rg[i]);
      if (a.g32) v += r32[i];
      if (out && !(bf16_bits(ro[i]) > 0.f)) v = 0.f;
      gz[i] = v;
      xh[i] = (bf16_bits(ry[i]) - mean) * invstd;
    }
  };
  for (long long base = 0; base < a.m; base += kNarrowChunk) {
    load(base);
#pragma unroll
    for (int i = 0; i < kNarrowHeld; ++i)
      if (base + threadIdx.x + (long long)i * kThreads < a.m) {
        s += (double)gz[i];
        q += (double)(gz[i] * xh[i]);
      }
  }
  const double2 t = block_totals(s, q, part);
  const float dbeta = (float)t.x, dgamma = (float)t.y;
  if (threadIdx.x == 0) {
    a.sums[c] = dbeta;
    a.sums[C + c] = dgamma;
  }
  const float k = gamma * invstd, inv_m = 1.f / (float)a.m;
  for (long long base = 0; base < a.m; base += kNarrowChunk) {
    if (a.m > kNarrowChunk) load(base);
#pragma unroll
    for (int i = 0; i < kNarrowHeld; ++i) {
      const long long p = base + threadIdx.x + (long long)i * kThreads;
      if (p < a.m)
        a.dy[p * C + c] = __float2bfloat16_rn(k * (gz[i] - (dbeta + xh[i] * dgamma) * inv_m));
    }
  }
}

// The card's floor for one launch (chip_smoke phase 2): a kernel that does
// nothing, and one block's reduction of 256 values as the narrow kernels do.
__global__ void floor_empty_kernel() {}

__global__ void __launch_bounds__(kThreads) floor_reduce_kernel(const float* in, float* out) {
  __shared__ double2 part[kWarps];
  const double v = in[threadIdx.x];
  const double2 t = block_totals(v, v * v, part);
  if (threadIdx.x == 0) out[0] = (float)t.x;
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

// A tile `width` channels wide: a multiple of 8, at most 8 a thread.
bool layout_ok(int width) { return width >= 8 && width % 8 == 0 && width / 8 <= kThreads; }

// `channels` cut into `tiles` equal tiles that a block takes, and a grid
// of whole tiles' blocks
bool tiles_ok(int channels, int tiles, int blocks) {
  return tiles >= 1 && channels % (8 * tiles) == 0 && layout_ok(channels / tiles) &&
         blocks % tiles == 0;
}

// block_sums' shared memory: its rows of sums * width floats
size_t smem_bytes(int width, int sums) {
  const int lanes = width / 8;
  const int rows = 32 % lanes == 0 ? kWarps : kThreads / lanes;
  return (size_t)rows * sums * width * sizeof(float);
}

bool scratch_ok(long long partial_floats, int n_counters, int blocks, int sums, int channels) {
  return blocks >= 1 && partial_floats >= (long long)sums * channels * blocks &&
         n_counters >= kCounters;
}

int occupancy(const void* kernel, size_t smem, int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                            smem);
}

// The lesser of an instance's two kernels' blocks an SM
template <int K>
int backward_occupancy(int width, int* blocks_per_sm) {
  int reduce = 0, apply = 0;
  int err = occupancy((const void*)backward_reduce<K>, smem_bytes(width, Mode<K>::sums), &reduce);
  if (err) return err;
  err = occupancy((const void*)backward_apply<K>, 0, &apply);
  *blocks_per_sm = reduce < apply ? reduce : apply;
  return err;
}

// The instance of a call's activation (Act) and operands (Kind)
int backward_kind(bool branch, int act, bool affine, bool g32) {
  if (branch) return kBranchKind;
  if (act == kActRelu) return kReluKind;
  if (act == kActRelu6) return kRelu6Kind;
  const bool silu = act == kActSilu;
  const int kind = silu && affine ? kSiluAffineKind
                   : affine       ? kAffineKind
                   : silu         ? kSiluKind
                                  : kLeanKind;
  return g32 ? kind + (kLeanG32Kind - kLeanKind) : kind;
}

int unroll_of(int kind) {
  return (kind >= kLeanKind && kind < kLeanG32Kind) || kind == kRelu6Kind ? kLeanUnroll
                                                                          : kBackUnroll;
}

// b = p / hw for p < 2^31 as (p * magic) >> shift: shift = 31 + ceil(log2
// hw), magic = ceil(2^shift / hw), which is below 2^32, and its error times
// hw stays under 2^(shift - 31), so the quotient is exact for every 31-bit p
bool sample_divisor_ok(long long hw, unsigned magic, int shift) {
  if (hw < 1 || hw > kMaxBackPixels) return false;
  int l = 0;
  while ((1LL << l) < hw) ++l;
  const unsigned long long want = ((1ULL << (31 + l)) + (unsigned long long)hw - 1) /
                                  (unsigned long long)hw;
  return shift == 31 + l && (unsigned long long)magic == want;
}

template <int K>
int launch_backward(const BackArgs& a, int blocks, int width, cudaStream_t s) {
  backward_reduce<K><<<blocks, kThreads, smem_bytes(width, Mode<K>::sums), s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  backward_apply<K><<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Each Kind's occupancy and launch, by its index
template <int... K>
struct Instances {
  static constexpr int (*occupancies[])(int, int*) = {backward_occupancy<K>...};
  static constexpr int (*launches[])(const BackArgs&, int, int, cudaStream_t) = {
      launch_backward<K>...};
};
using Backward = Instances<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10>;
static_assert(sizeof(Backward::launches) / sizeof(Backward::launches[0]) == kKinds,
              "an instance of every Kind");

}  // namespace

// The blocks of `mode` (0: statistics; 1: the backward's instance `kind`,
// a Kind, the lesser of its two kernels') that one SM holds at once at this
// channel tile width, into *blocks_per_sm. Returns a cudaError_t.
extern "C" int bn_train_occupancy(int mode, int channels, int kind, int* blocks_per_sm) {
  if (!layout_ok(channels) || !blocks_per_sm) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return occupancy((const void*)stats_kernel, smem_bytes(channels, 2), blocks_per_sm);
  if (kind < 0 || kind >= kKinds) return (int)cudaErrorInvalidValue;
  return Backward::occupancies[kind](channels, blocks_per_sm);
}

// x: (m, channels) bfloat16, 16-byte aligned, channels a multiple of 8 *
// tiles, at most 2048 a tile; gamma, beta: channels float32; running_mean,
// running_var: channels float32, updated in place; partials: partial_floats
// >= 2 * channels * blocks / tiles float32 scratch; counters: n_counters >=
// 2 int32, zero, and left zero; mean, invstd, scale, shift: channels float32
// outputs. One launch of `blocks` blocks (a multiple of tiles), at most as
// many as the card holds at once (its SMs x bn_train_occupancy at the tile
// width). Returns cudaGetLastError() after it.
extern "C" int bn_train_stats(const void* x, const void* gamma, const void* beta,
                              void* running_mean, void* running_var, void* partials,
                              long long partial_floats, void* counters, int n_counters,
                              int blocks, void* mean, void* invstd, void* scale, void* shift,
                              long long m, int channels, float eps, float momentum, int tiles,
                              void* stream) {
  if (m < 1 || !tiles_ok(channels, tiles, blocks) || !aligned16(x) ||
      !scratch_ok(partial_floats, n_counters, blocks / tiles, 2, channels))
    return (int)cudaErrorInvalidValue;
  StatsArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
              static_cast<const float*>(beta), static_cast<float*>(running_mean),
              static_cast<float*>(running_var), static_cast<float*>(partials),
              static_cast<int*>(counters), static_cast<float*>(mean),
              static_cast<float*>(invstd), static_cast<float*>(scale),
              static_cast<float*>(shift), m, channels,
              combiners_for(blocks / tiles, channels), tiles, eps, momentum};
  stats_kernel<<<blocks, kThreads, smem_bytes(channels / tiles, 2),
                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// g: (m, channels) bfloat16 or null; g32: (m, channels) float32 or null;
// out: the forward's bf16 output (the ReLU's mask) or null (no ReLU); y:
// the conv output; mean, invstd, gamma: its statistics and scale; d,
// mean_d, invstd_d, gamma_d: the branch (or null); partials:
// partial_floats >= (2 + branch) * channels * blocks float32 scratch;
// counters: n_counters >= 2 int32, zero, and left zero; sums: 3 * channels
// float32 outputs (dbeta, dgamma, dgamma_d; the branch's dbeta is dbeta);
// dy: (m, channels) bf16; dres: (m, channels) float32 or null; dd: (m,
// channels) bf16 where d is given. act: the site's activation (Act): the
// ReLU's with `out` given (and only then), the SiLU's or the ReLU6's with
// `shift` given (and only then): the forward's shift (channels float32; the
// derivative at z = y * scale + shift, scale = gamma * invstd), no branch,
// and for the ReLU6 no affine and no g32. gmul, gadd: null or (m / hw,
// channels) float32, 16-byte aligned, the gradient affine, hw the pixels of
// a sample; neither with a branch or a ReLU. m below 2^31. unroll: the
// instance's pixels a thread loads at once
// (kBackUnroll where out, d or g32 is given, else kLeanUnroll), as the wrapper's
// plan sized the grid by; sample_magic, sample_shift: hw's divisor constant
// (sample_divisor_ok). Two launches of `blocks` blocks (the reduce, then
// the apply; a multiple of tiles, as bn_train_stats takes them), at most as
// many as the card holds at once (its SMs x bn_train_occupancy of the
// instance at the tile width). Returns cudaGetLastError() after them.
extern "C" int bn_train_backward(const void* g, const void* g32, const void* out, const void* y,
                                 const void* mean, const void* invstd, const void* gamma,
                                 const void* d, const void* mean_d, const void* invstd_d,
                                 const void* gamma_d, void* partials, long long partial_floats,
                                 void* counters, int n_counters, int blocks, void* sums,
                                 void* dy, void* dres, void* dd, long long m, int channels,
                                 int tiles, const void* shift, const void* gmul,
                                 const void* gadd, long long hw, int unroll,
                                 unsigned sample_magic, int sample_shift, int act,
                                 void* stream) {
  const int n_sums = d ? 3 : 2;
  const bool affine = gmul || gadd;
  const bool z_act = act == kActSilu || act == kActRelu6;
  if (act < kActNone || act > kActRelu6 || (act == kActRelu) != (out != nullptr) ||
      z_act != (shift != nullptr) || (act == kActRelu6 && (affine || g32)))
    return (int)cudaErrorInvalidValue;
  const int kind = backward_kind(d, act, affine, g32);
  if (m < 1 || m >= kMaxBackPixels || !tiles_ok(channels, tiles, blocks) || (d && !dd) ||
      (d && dres) || ((d || out) && (shift || affine)) ||
      !sample_divisor_ok(hw, sample_magic, sample_shift) || (affine && m % hw) ||
      unroll != unroll_of(kind) ||
      !scratch_ok(partial_floats, n_counters, blocks / tiles, n_sums, channels) ||
      !(aligned16(g) && aligned16(g32) && aligned16(out) && aligned16(y) && aligned16(d) &&
        aligned16(dy) && aligned16(dres) && aligned16(dd) && aligned16(gmul) &&
        aligned16(gadd)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BackArgs a{static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(g32),
             static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(y),
             static_cast<const float*>(mean), static_cast<const float*>(invstd),
             static_cast<const float*>(gamma), static_cast<const __nv_bfloat16*>(d),
             static_cast<const float*>(mean_d), static_cast<const float*>(invstd_d),
             static_cast<const float*>(gamma_d), static_cast<float*>(partials),
             static_cast<int*>(counters), static_cast<float*>(sums),
             static_cast<__nv_bfloat16*>(dy), static_cast<float*>(dres),
             static_cast<__nv_bfloat16*>(dd), m, channels,
             combiners_for(blocks / tiles, channels), tiles, static_cast<const float*>(shift),
             static_cast<const float*>(gmul), static_cast<const float*>(gadd), hw, sample_magic,
             sample_shift};
  return Backward::launches[kind](a, blocks, channels / tiles, s);
}

// Narrow sites: x (m, channels) bfloat16, any channel count up to 2048 (the
// wrapper sends those that are not a multiple of 8); gamma ... shift as
// bn_train_stats'. out: null (the statistics alone), or (m, channels) bf16,
// the site's output: y * scale + shift, ReLU where `relu`, with out32 null or
// its float32 copy. One launch of `channels` blocks.
extern "C" int bn_train_narrow_forward(const void* x, const void* gamma, const void* beta,
                                       void* running_mean, void* running_var, void* mean,
                                       void* invstd, void* scale, void* shift, void* out,
                                       void* out32, long long m, int channels, int relu,
                                       float eps, float momentum, void* stream) {
  if (m < 1 || channels < 1 || channels > 8 * kThreads || (out32 && !out))
    return (int)cudaErrorInvalidValue;
  NarrowArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
               static_cast<const float*>(beta), static_cast<float*>(running_mean),
               static_cast<float*>(running_var), static_cast<float*>(mean),
               static_cast<float*>(invstd), static_cast<float*>(scale),
               static_cast<float*>(shift), static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(out32), m, channels, relu, eps, momentum};
  narrow_forward_kernel<<<channels, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Narrow sites' backward with no residual or branch: g, g32, out, y, mean,
// invstd, gamma as bn_train_backward's; sums: 2 * channels float32 outputs
// (dbeta, dgamma); dy: (m, channels) bf16. One launch of `channels` blocks.
extern "C" int bn_train_narrow_backward(const void* g, const void* g32, const void* out,
                                        const void* y, const void* mean, const void* invstd,
                                        const void* gamma, void* sums, void* dy, long long m,
                                        int channels, void* stream) {
  if (m < 1 || channels < 1 || channels > 8 * kThreads || !(g || g32))
    return (int)cudaErrorInvalidValue;
  BackArgs a{static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(g32),
             static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(y),
             static_cast<const float*>(mean), static_cast<const float*>(invstd),
             static_cast<const float*>(gamma), nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, static_cast<float*>(sums), static_cast<__nv_bfloat16*>(dy), nullptr,
             nullptr, m, channels, 0};
  narrow_backward_kernel<<<channels, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// One launch of a floor kernel: mode 0 the empty one (in, out unused), 1 the
// reduction of in[0..255] into out[0] (float32).
extern "C" int bn_train_launch_floor(int mode, const void* in, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    floor_empty_kernel<<<1, 1, 0, s>>>();
  else if (mode == 1 && in && out)
    floor_reduce_kernel<<<1, kThreads, 0, s>>>(static_cast<const float*>(in),
                                               static_cast<float*>(out));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
