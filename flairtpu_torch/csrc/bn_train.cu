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
// bn_train_backward, with gz = (g + g32) * [out > 0] (the ReLU's mask read
// from the saved bf16 output) and xh = (y - mean) * invstd:
//   dbeta = sum(gz);  dgamma = sum(gz * xh)
//   dy = gamma * invstd * (gz - (dbeta + xh * dgamma) / M)        (bf16)
//   dres = gz (float32), or for a branch d the same dy formula with its own
//   statistics into dd (bf16).
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
// are issued before any is used (U = 4 in the statistics, 16 KB a tile; U =
// 2 in the backward, whose pixel already takes 3-5 loads). Float32 partial
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
// The wrapper (ops/bn_train.py:launch_plan) sizes the grid by the work: at
// least 64 KB of x (bf16) a block, at most the blocks the card holds at
// once (132 SMs x the kernel's occupancy, bn_train_occupancy). At batch 16
// the stem, layer1 and decoder blocks 2-4 take the co-resident grid (528
// statistics blocks, 264 backward), layer2-4 and decoder blocks 0-1 64-256
// blocks and as few partials. The sites whose backward inputs fit in L2
// (layer3, layer4 and decoder block 0: 13-42 MB) can read them from HBM
// about once; the others read them twice, which caps their backward at
// about 8/14 of its byte bound.
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStatsUnroll = 4;  // pixels a thread loads at once: statistics
constexpr int kBackUnroll = 2;   // backward (reduce and apply)
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

// The block's thread layout: lanes = C / 8 threads a pixel, rows = 256 /
// lanes pixels at a time; threads past rows * lanes only join the barriers.
// Where lanes divides 32, a warp holds 32 / lanes whole pixels.
struct Layout {
  int lanes, rows, lane, row;
  bool active, warp_rows;
  __device__ Layout(int channels) {
    lanes = channels / 8;
    rows = kThreads / lanes;
    lane = threadIdx.x % lanes;
    row = threadIdx.x / lanes;
    active = row < rows;
    warp_rows = 32 % lanes == 0;
  }
};

// The block's tiles of rows * U pixels, b, b + grid, ...: k = 0 ... last
// in walk order, the k-th starting at pixel first(k, reverse).
template <int U>
struct Tiles {
  long long pixels, last;
  __device__ Tiles(const Layout& t, long long m) {
    pixels = (long long)t.rows * U;
    const long long tiles = (m + pixels - 1) / pixels;
    last = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x : -1;
  }
  __device__ long long first(long long k, bool reverse) const {
    return (blockIdx.x + (reverse ? last - k : k) * (long long)gridDim.x) * pixels;
  }
};

// Folds the block's per-thread partials (kSums of 8 channels each) over its
// rows in a fixed order and writes the block's column of kSums * C sums:
// partials[e * grid + block], e = s * C + c.
template <int kSums>
__device__ void block_sums(const Layout& t, float (&acc)[kSums][8], float* smem,
                           float* __restrict__ partials, int channels) {
  const int width = kSums * channels;
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
      for (int i = 0; i < 8; ++i) smem[prow * width + s * channels + t.lane * 8 + i] = acc[s][i];
  __syncthreads();
  for (int e = threadIdx.x; e < width; e += kThreads) {
    float v = 0.f;
    for (int r = 0; r < nrows; ++r) v += smem[r * width + e];
    partials[(long long)e * gridDim.x + blockIdx.x] = v;
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

// The combine: the totals over the grid's blocks of each sum s < kSums of
// the channels this combiner takes (channel c in rounds of `teams`, the
// combiners' teams interleaved), handed to done(c, totals, prefetch(c)) on
// one thread, which called prefetch(c) before the round's loads.
// A team of `seg` warps takes a channel: warp j of the team adds blocks
// [j * per, (j + 1) * per) of each sum's row, lane l blocks l, l + 32, ...
// in double with 8 loads a row in flight, then a fixed shuffle tree; the
// team's leader adds its warps' totals in order. Every total has the same
// bits whichever block computes it.
template <int kSums, typename Prefetch, typename Done>
__device__ void combine(const float* partials, int channels, int rank, int combiners,
                        Prefetch prefetch, Done done) {
  __shared__ double part[kWarps][kSums];
  const int grid = gridDim.x;
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
  int channels, combiners;
  float eps, momentum;
};

__global__ void __launch_bounds__(kThreads) stats_kernel(StatsArgs a) {
  extern __shared__ float smem[];
  const Layout t(a.channels);
  const Tiles<kStatsUnroll> tiles(t, a.m);
  const int c0 = t.lane * 8;
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
  combine<2>(a.partials, a.channels, rank, a.combiners, vectors,
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
  int channels, combiners;
};

// One pixel's raw operands: 8 channels of each map.
struct Pixel {
  uint4 g, out, y, d;
  float4 g32[2];
};

template <bool kBranch>
__device__ __forceinline__ void load_pixel(const BackArgs& a, long long off, bool in,
                                           Pixel& px) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  px.g = in && a.g ? load16(a.g, off) : zero;
  px.out = in && a.out ? load16(a.out, off) : zero;
  px.y = in ? load16(a.y, off) : zero;
  if (kBranch) px.d = in ? load16(a.d, off) : zero;
  if (in && a.g32) {
    px.g32[0] = *reinterpret_cast<const float4*>(a.g32 + off);
    px.g32[1] = *reinterpret_cast<const float4*>(a.g32 + off + 4);
  } else {
    px.g32[0] = px.g32[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// gz of the pixel's 8 channels: (g + g32) masked by the ReLU
__device__ __forceinline__ void masked_grad(const BackArgs& a, const Pixel& px, float (&gz)[8]) {
  float f[8];
  unpack8(px.g, f);
  const float h[8] = {px.g32[0].x, px.g32[0].y, px.g32[0].z, px.g32[0].w,
                      px.g32[1].x, px.g32[1].y, px.g32[1].z, px.g32[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    gz[i] = 0.f;
    if (a.g) gz[i] += f[i];
    if (a.g32) gz[i] += h[i];
  }
  if (a.out) {
    unpack8(px.out, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) gz[i] = f[i] > 0.f ? gz[i] : 0.f;
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
};

template <bool kBranch>
__global__ void __launch_bounds__(kThreads) backward_reduce(BackArgs a) {
  constexpr int kSums = kBranch ? 3 : 2;
  extern __shared__ float smem[];
  const Layout t(a.channels);
  const Tiles<kBackUnroll> tiles(t, a.m);
  const int c0 = t.lane * 8;
  float acc[kSums][8] = {};
  if (t.active) {
    Consts cy, cd;
    cy.load(a.mean, a.invstd, c0);
    if (kBranch) cd.load(a.mean_d, a.invstd_d, c0);
    for (long long k = 0; k <= tiles.last; ++k) {
      const long long p0 = tiles.first(k, false) + t.row;
      Pixel px[kBackUnroll];
#pragma unroll
      for (int u = 0; u < kBackUnroll; ++u) {
        const long long p = p0 + (long long)u * t.rows;
        load_pixel<kBranch>(a, p * a.channels + c0, p < a.m, px[u]);
      }
#pragma unroll
      for (int u = 0; u < kBackUnroll; ++u) {
        float gz[8], xh[8];
        masked_grad(a, px[u], gz);
        cy.normalized(px[u].y, xh);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[0][i] += gz[i];
          acc[1][i] += gz[i] * xh[i];
        }
        if (kBranch) {
          cd.normalized(px[u].d, xh);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[kSums - 1][i] += gz[i] * xh[i];
        }
      }
    }
  }
  block_sums<kSums>(t, acc, smem, a.partials, a.channels);
  const int rank = arrive(a.counters, a.combiners);
  if (rank < 0) return;
  combine<kSums>(a.partials, a.channels, rank, a.combiners, [](int) { return 0; },
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
                       const float* dbeta_, const float* dgamma_, int c0) {
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

template <bool kBranch>
__global__ void __launch_bounds__(kThreads) backward_apply(BackArgs a) {
  const Layout t(a.channels);
  if (!t.active) return;
  const Tiles<kBackUnroll> tiles(t, a.m);
  const int c0 = t.lane * 8;
  const int C = a.channels;
  const float inv_m = 1.f / (float)a.m;
  Apply fy, fd;
  fy.load(a.mean, a.invstd, a.gamma, a.sums, a.sums + C, c0);
  if (kBranch) fd.load(a.mean_d, a.invstd_d, a.gamma_d, a.sums, a.sums + 2 * C, c0);
  for (long long k = 0; k <= tiles.last; ++k) {
    const long long p0 = tiles.first(k, true) + t.row;
    Pixel px[kBackUnroll];
#pragma unroll
    for (int u = 0; u < kBackUnroll; ++u) {
      const long long p = p0 + (long long)u * t.rows;
      load_pixel<kBranch>(a, p * C + c0, p < a.m, px[u]);
    }
#pragma unroll
    for (int u = 0; u < kBackUnroll; ++u) {
      const long long p = p0 + (long long)u * t.rows;
      if (p >= a.m) continue;
      const long long off = p * C + c0;
      float gz[8];
      masked_grad(a, px[u], gz);
      *reinterpret_cast<uint4*>(a.dy + off) = fy(px[u].y, gz, inv_m);
      if (a.dres) {
        *reinterpret_cast<float4*>(a.dres + off) = make_float4(gz[0], gz[1], gz[2], gz[3]);
        *reinterpret_cast<float4*>(a.dres + off + 4) = make_float4(gz[4], gz[5], gz[6], gz[7]);
      }
      if (kBranch) *reinterpret_cast<uint4*>(a.dd + off) = fd(px[u].d, gz, inv_m);
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

bool layout_ok(int channels) {
  return channels >= 8 && channels % 8 == 0 && channels / 8 <= kThreads;
}

// block_sums' shared memory: its rows of sums * C floats
size_t smem_bytes(int channels, int sums) {
  const int lanes = channels / 8;
  const int rows = 32 % lanes == 0 ? kWarps : kThreads / lanes;
  return (size_t)rows * sums * channels * sizeof(float);
}

bool scratch_ok(long long partial_floats, int n_counters, int blocks, int sums, int channels) {
  return blocks >= 1 && partial_floats >= (long long)sums * channels * blocks &&
         n_counters >= kCounters;
}

int occupancy(const void* kernel, size_t smem, int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                            smem);
}

}  // namespace

// The blocks of `mode` (0: statistics; 1: the backward, the lesser of its
// two kernels') that one SM holds at once at this channel count, into
// *blocks_per_sm. Returns a cudaError_t.
extern "C" int bn_train_occupancy(int mode, int channels, int branch, int* blocks_per_sm) {
  if (!layout_ok(channels) || !blocks_per_sm) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return occupancy((const void*)stats_kernel, smem_bytes(channels, 2), blocks_per_sm);
  int reduce = 0, apply = 0;
  const int sums = branch ? 3 : 2;
  int err = branch ? occupancy((const void*)backward_reduce<true>, smem_bytes(channels, sums),
                               &reduce)
                   : occupancy((const void*)backward_reduce<false>,
                               smem_bytes(channels, sums), &reduce);
  if (err) return err;
  err = branch ? occupancy((const void*)backward_apply<true>, 0, &apply)
               : occupancy((const void*)backward_apply<false>, 0, &apply);
  *blocks_per_sm = reduce < apply ? reduce : apply;
  return err;
}

// x: (m, channels) bfloat16, 16-byte aligned, channels a multiple of 8 up to
// 2048; gamma, beta: channels float32; running_mean, running_var: channels
// float32, updated in place; partials: partial_floats >= 2 * channels *
// blocks float32 scratch; counters: n_counters >= 2 int32, zero, and left
// zero; mean, invstd, scale, shift: channels float32 outputs. One launch of
// `blocks` blocks, at most as many as the card holds at once (its SMs x
// bn_train_occupancy). Returns cudaGetLastError() after it.
extern "C" int bn_train_stats(const void* x, const void* gamma, const void* beta,
                              void* running_mean, void* running_var, void* partials,
                              long long partial_floats, void* counters, int n_counters,
                              int blocks, void* mean, void* invstd, void* scale, void* shift,
                              long long m, int channels, float eps, float momentum,
                              void* stream) {
  if (m < 1 || !layout_ok(channels) || !aligned16(x) ||
      !scratch_ok(partial_floats, n_counters, blocks, 2, channels))
    return (int)cudaErrorInvalidValue;
  StatsArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
              static_cast<const float*>(beta), static_cast<float*>(running_mean),
              static_cast<float*>(running_var), static_cast<float*>(partials),
              static_cast<int*>(counters), static_cast<float*>(mean),
              static_cast<float*>(invstd), static_cast<float*>(scale),
              static_cast<float*>(shift), m, channels,
              combiners_for(blocks, channels), eps, momentum};
  stats_kernel<<<blocks, kThreads, smem_bytes(channels, 2), static_cast<cudaStream_t>(stream)>>>(a);
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
// channels) bf16 where d is given. Two launches of `blocks` blocks (the
// reduce, then the apply), at most as many as the card holds at once (its
// SMs x bn_train_occupancy). Returns cudaGetLastError() after them.
extern "C" int bn_train_backward(const void* g, const void* g32, const void* out, const void* y,
                                 const void* mean, const void* invstd, const void* gamma,
                                 const void* d, const void* mean_d, const void* invstd_d,
                                 const void* gamma_d, void* partials, long long partial_floats,
                                 void* counters, int n_counters, int blocks, void* sums,
                                 void* dy, void* dres, void* dd, long long m, int channels,
                                 void* stream) {
  const int n_sums = d ? 3 : 2;
  if (m < 1 || !layout_ok(channels) || (d && !dd) || (d && dres) ||
      !scratch_ok(partial_floats, n_counters, blocks, n_sums, channels) ||
      !(aligned16(g) && aligned16(g32) && aligned16(out) && aligned16(y) && aligned16(d) &&
        aligned16(dy) && aligned16(dres) && aligned16(dd)))
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
             combiners_for(blocks, channels)};
  const size_t smem = smem_bytes(channels, n_sums);
  if (d)
    backward_reduce<true><<<blocks, kThreads, smem, s>>>(a);
  else
    backward_reduce<false><<<blocks, kThreads, smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (d)
    backward_apply<true><<<blocks, kThreads, 0, s>>>(a);
  else
    backward_apply<false><<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
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
