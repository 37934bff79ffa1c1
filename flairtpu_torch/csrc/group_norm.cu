// GroupNorm + ReLU (+ 2x nearest upsample) of FPN's Conv3x3GNReLU sites, in
// two passes over the bfloat16 conv output, and its backward in one launch.
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
// The backward (group_norm_backward) is the VJP of the same function, which
// replaces what XLA's autodiff fused on the TPU for flairtpu's train step
// through those sites (jax.value_and_grad at flairtpu/train/loop.py:286-311).
// With g the float32 gradient of the output, u x u copies a pixel:
//
//   dz = [z > 0] * sum of g over the pixel's u x u copies,   z recomputed
//        from x and the saved statistics exactly as the forward computed it
//   xh = (x - mean_g) * rstd_g
//   dbeta_c = sum dz;  dgamma_c = sum dz * xh             (over samples, pixels)
//   dy = rstd_g * (dz * gamma_c - mean_g(dz * gamma) - xh * mean_g(dz * gamma * xh))
//
// rounded to bfloat16 (the gradient of the bf16 conv output). Bound: bytes
// (x and g read once, dy written once; g, float32 and u^2 times the map, is
// most of them). The group means must be complete before any dy, so the
// whole sample sits between the reduce and the apply.
//
// Design: one launch of a grid that the card holds at once (the C entry
// point checks it against the occupancy query, so its waits always end; a
// wait past a second traps). A sample is cut into `parts` items of `part`
// pixels; block b takes part b % parts of samples b / parts, b / parts +
// slots, ... (slots = grid / parts samples in flight), so the blocks of a
// sample are all resident together. A thread keeps 8 channels of a pixel,
// the 4 at 4 oct and the 4 at C / 2 + 4 oct, so each warp-wide 16-byte
// float32 load of g (and 8-byte load of x, store of dy) reads or writes
// whole sectors. For each item a block:
//   1. reduces: each thread reads x and the u x u copies of g of its pixels,
//      recomputes the ReLU mask, sums dz and dz xh in registers; the block
//      folds its rows in a fixed order (a warp shuffle butterfly, then the
//      warps) into per-channel sums, adds them to its running dgamma /
//      dbeta sums, and writes the item's gamma-weighted group sums;
//   2. arrives at its sample's barrier (an int32 ticket). The last item to
//      arrive adds the sample's group sums over its parts in part order and
//      raises the ticket once more; the others wait for it. Every block then
//      reads the same sums: no float atomics, two calls give the same bits;
//   3. applies: writes dy of its pixels (streaming stores: not read again).
// Two routes (ops/group_norm.py:launch_plan):
//   on chip (kOnChip, the upsampling sites): step 1 keeps dz (float32) and x
//     (bf16) of the item in shared memory, 6 C bytes a pixel, and step 3 reads
//     them there: g and x are read from HBM once, as streaming loads;
//   re-read: steps 1 and 3 stage each pixel's x and g into a ring of
//     shared memory by cp.async, ring_slots - 1 pixels ahead of the one in
//     use, so several pixels' loads are in flight without registers, and
//     step 3 reads x and g again. The plan bounds the samples in flight so
//     that their x and g fit in half the L2, where the second read finds
//     them, unless one sample alone does not fit.
// dgamma and dbeta: a block publishes its running channel sums at its last
// item's barrier; the last block of each kFoldFanIn to publish adds theirs
// in block order before its own apply (while the sample's other items
// arrive), and the last of those adds the folds in order (a ticket each;
// every counter is left at 0 for the next call on the stream).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>
#include <vector>

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

// ---- the backward ----

constexpr int kWarps = kThreads / 32;
constexpr int kFoldFanIn = 16;  // blocks whose dgamma / dbeta sums one fold adds (ops/group_norm.py)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kWaitLimitNs = 1000000000ull;  // a barrier wait past 1 s traps

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t = 0;
#ifdef __CUDA_ARCH__
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
#endif
  return t;
}

struct BackArgs {
  const uint2* x;       // (batch, hw, C) bf16, as 4-channel words
  const float* g;       // (batch, u^2 hw, C)
  const float* mean;    // (batch, G), from the forward
  const float* rstd;
  const float* gamma;
  const float* beta;
  float* gpart;         // (batch, parts, 2, G): each item's gamma-weighted group sums
  float* gsum;          // (batch, 2, G): the sample's, added by its last item
  float* rows;          // (grid, 2, C): each block's channel sums of dz and dz xh
  float* frows;         // (folds, 2, C)
  int* arrive;          // (batch) tickets, zero and left zero
  int* leave;           // (batch)
  int* fold;            // (folds)
  int* final_ticket;    // 1
  uint2* dy;            // (batch, hw, C) bf16
  float* dparams;       // (2, C): dgamma, dbeta
  int batch, h, w, C, G, part, parts;
};

// A thread's 8 channels: i < 4 the 4 at 4 oct, the others the 4 at C / 2 +
// 4 oct, so each of its 16-byte float32 loads (and 8-byte bf16 ones) sits
// beside its neighbours' and a warp's load reads whole sectors.
__host__ __device__ inline int channel(int oct, int i, int C) {
  return (i < 4 ? 0 : C / 2) + 4 * oct + (i & 3);
}

// The re-read route stages each pixel's x and g into a ring of
// ring_slots pixels a thread by cp.async, pixel_words 16-byte words each.
__host__ __device__ constexpr int ring_slots(bool up) { return up ? 2 : 4; }
__host__ __device__ constexpr int pixel_words(bool up) { return up ? 9 : 3; }

// The dynamic shared memory of a block (ops/group_norm.py:backward_smem):
// the staged pixels (on chip, dz and x of each of the item's passes; else
// the ring), then in floats the rows of the channel fold, the item's
// channel sums, the block's running ones, the sample's group means, the
// combine's partials, four ints.
__host__ __device__ inline int fold_rows(int C) {
  const int lanes = C / 8;
  return lanes <= 32 ? kWarps : kThreads / lanes;
}
__host__ __device__ inline long long stage_bytes(int C, int part, bool on_chip, bool up) {
  const int ppass = kThreads / (C / 8);
  return on_chip ? (long long)((part + ppass - 1) / ppass) * 3 * kThreads * 16
                 : (long long)ring_slots(up) * pixel_words(up) * kThreads * 16;
}
__host__ __device__ inline long long backward_smem(int C, int G, int part, bool on_chip,
                                                   bool up) {
  const long long floats = (long long)fold_rows(C) * 2 * C + 4LL * C + ((2LL * G + 3) / 4) * 4 +
                           kThreads + 4;
  return stage_bytes(C, part, on_chip, up) + 4 * floats;
}

// A pixel's raw operands: x, and g at its u x u copies (8 channels each).
template <bool kUp>
struct Raw {
  uint4 x;
  float4 g[kUp ? 8 : 2];
};

template <bool kStream, typename T>
__device__ __forceinline__ T load(const T* p) {
  return kStream ? __ldcs(p) : __ldg(p);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
#endif
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
#endif
}
__device__ __forceinline__ void cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
template <int N>
__device__ __forceinline__ void cp_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// g's float32 index of copy d of pixel p (its u x u copies in row order)
template <bool kUp>
__device__ __forceinline__ long long copy_of(long long p, int d, int w) {
  if (!kUp) return p;
  const long long row = p / w, col = p - row * w;
  return (2 * row + (d >> 1)) * (2LL * w) + 2 * col + (d & 1);
}

// xs, gs: the sample's x and g
template <bool kUp, bool kStream>
__device__ __forceinline__ void load_raw(const uint2* xs, const float* gs, long long p, int w,
                                         int C, int oct, Raw<kUp>& r) {
  const int lanes = C / 8;
  const uint2* xp = xs + p * 2 * lanes + oct;
  const uint2 xa = load<kStream>(xp), xb = load<kStream>(xp + lanes);
  r.x = make_uint4(xa.x, xa.y, xb.x, xb.y);
#pragma unroll
  for (int d = 0; d < (kUp ? 4 : 1); ++d) {
    const float4* v = reinterpret_cast<const float4*>(gs + copy_of<kUp>(p, d, w) * C) + oct;
    r.g[2 * d] = load<kStream>(v);
    r.g[2 * d + 1] = load<kStream>(v + lanes);
  }
}

// The re-read route's walk over a thread's pixels first, first + ppass, ...
// < p1: each pixel's x and g staged into the thread's ring by cp.async
// ring_slots - 1 pixels ahead (its loads in flight without registers), then
// f(p, raw) on it.
template <bool kUp, typename F>
__device__ __forceinline__ void ring_walk(uint4* ring, const uint2* xs, const float* gs,
                                          long long first, long long p1, int ppass, int w, int C,
                                          int oct, F f) {
  constexpr int kR = ring_slots(kUp), kW = pixel_words(kUp);
  const int lanes = C / 8;
  const auto stage = [&](long long p, int slot) {
    uint4* dst = ring + (long long)slot * kW * kThreads + threadIdx.x;
    if (p < p1) {
      const uint2* xp = xs + p * 2 * lanes + oct;
      cp_async8(dst, xp);
      cp_async8(reinterpret_cast<char*>(dst) + 8, xp + lanes);
#pragma unroll
      for (int d = 0; d < (kUp ? 4 : 1); ++d) {
        const float4* v = reinterpret_cast<const float4*>(gs + copy_of<kUp>(p, d, w) * C) + oct;
        cp_async16(dst + (1 + 2 * d) * kThreads, v);
        cp_async16(dst + (2 + 2 * d) * kThreads, v + lanes);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < kR - 1; ++j) stage(first + j * ppass, j);
  int k = 0;
  for (long long p = first; p < p1; p += ppass, ++k) {
    stage(p + (kR - 1) * ppass, (k + kR - 1) % kR);
    cp_wait<kR - 1>();
    const uint4* src = ring + (long long)(k % kR) * kW * kThreads + threadIdx.x;
    Raw<kUp> r;
    r.x = src[0];
#pragma unroll
    for (int i = 0; i < (kUp ? 8 : 2); ++i) {
      const uint4 u = src[(1 + i) * kThreads];
      r.g[i] = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                           __uint_as_float(u.w));
    }
    f(p, r);
  }
  cp_wait<0>();
}

// The channel constants of a thread's 8 channels, as the forward's apply
// computes them.
struct Consts {
  float mean[8], rstd[8], mul[8], add[8];
  __device__ void load(const BackArgs& a, int s, int oct) {
    const int gs = a.C / a.G;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = channel(oct, i, a.C);
      mean[i] = a.mean[(long long)s * a.G + c / gs];
      rstd[i] = a.rstd[(long long)s * a.G + c / gs];
      mul[i] = __fmul_rn(rstd[i], a.gamma[c]);
      add[i] = a.beta[c];
    }
  }
  // xh of the 8 channels of x
  __device__ void normalized(const uint4 xw, float (&xh)[8]) const {
    unpack8(xw, xh);
#pragma unroll
    for (int i = 0; i < 8; ++i) xh[i] = __fmul_rn(__fsub_rn(xh[i], mean[i]), rstd[i]);
  }
  // dz and xh of a pixel: the u x u copies of g added in order, masked by
  // the ReLU recomputed as the forward rounded it
  template <bool kUp>
  __device__ void grads(const Raw<kUp>& r, float (&dz)[8], float (&xh)[8]) const {
    float f[8];
    unpack8(r.x, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float gs = 0.f;
#pragma unroll
      for (int d = 0; d < (kUp ? 4 : 1); ++d) {
        const float4 v = r.g[2 * d + i / 4];
        const float e = (i % 4 == 0) ? v.x : (i % 4 == 1) ? v.y : (i % 4 == 2) ? v.z : v.w;
        gs = d == 0 ? e : __fadd_rn(gs, e);
      }
      const float dlt = __fsub_rn(f[i], mean[i]);
      const float z = __fadd_rn(__fmul_rn(dlt, mul[i]), add[i]);
      dz[i] = z > 0.f ? gs : 0.f;
      xh[i] = __fmul_rn(dlt, rstd[i]);
    }
  }
};

// Folds the threads' sums (2 x 8 channels each) over the block's rows in a
// fixed order into chan (2, C), and adds them to the running sums cum.
__device__ void fold_channels(float (&acc)[2][8], float* red, float* chan, float* cum, int C) {
  const int lanes = C / 8, oct = threadIdx.x % lanes;
  int prow = threadIdx.x / lanes;
  bool write = true;
  if (lanes <= 32) {  // a warp holds 32 / lanes whole pixels: a butterfly over them
    for (int off = lanes; off < 32; off <<= 1)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[s][i] += __shfl_xor_sync(kFull, acc[s][i], off);
    prow = threadIdx.x / 32;
    write = (int)(threadIdx.x % 32) < lanes;
  }
  if (write)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 8; ++i) red[(prow * 2 + s) * C + channel(oct, i, C)] = acc[s][i];
  __syncthreads();
  const int nrows = fold_rows(C);
  for (int e = threadIdx.x; e < 2 * C; e += kThreads) {
    float v = 0.f;
    for (int r = 0; r < nrows; ++r) v += red[r * 2 * C + e];
    chan[e] = v;
    cum[e] += v;
  }
  __syncthreads();
}

// dst[j] = the sum over n rows of src[k * width + j] in row order, j <
// width, the rows read from L2 (written by other blocks in this launch).
// `per` threads share a sum, each adding rows sub, sub + per, ...; their
// partials are added in order.
__device__ void sum_rows(const float* src, float* dst, int n, int width, float* tmp) {
  int per = kThreads / width;
  per = per < 1 ? 1 : per;
  const int sub = threadIdx.x % per;
  for (int base = 0; base < width; base += kThreads / per) {
    const int j = base + threadIdx.x / per;
    float v = 0.f;
    if (j < width) {
#pragma unroll 16
      for (int k = sub; k < n; k += per) v += __ldcg(src + (long long)k * width + j);
    }
    tmp[threadIdx.x] = v;
    __syncthreads();
    if (sub == 0 && j < width) {
      float t = 0.f;
      for (int i = 0; i < per; ++i) t += tmp[threadIdx.x + i];
      dst[j] = t;
    }
    __syncthreads();
  }
}

// dgamma and dbeta, by the last block of fold group grp to publish its
// running sums: the group's rows in block order, then, by the last of those
// folds, the folds in order (a ticket each, left at 0).
__device__ void fold_params(const BackArgs& a, int grp, int first, float* chan, float* tmp,
                            int* flag) {
  const int C = a.C;
  const int members = min(kFoldFanIn, (int)gridDim.x - first);
  const int folds = (gridDim.x + kFoldFanIn - 1) / kFoldFanIn;
  __threadfence();
  sum_rows(a.rows + (long long)first * 2 * C, a.frows + (long long)grp * 2 * C, members, 2 * C,
           tmp);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    a.fold[grp] = 0;
    flag[2] = atomicAdd(a.final_ticket, 1) == folds - 1;
  }
  __syncthreads();
  if (!flag[2]) return;
  __threadfence();
  // frows: (folds, 2, C) with dz sums first: dparams is (dgamma, dbeta)
  sum_rows(a.frows, chan, folds, 2 * C, tmp);
  for (int e = threadIdx.x; e < 2 * C; e += kThreads) a.dparams[e < C ? C + e : e - C] = chan[e];
  if (threadIdx.x == 0) *a.final_ticket = 0;
  __syncthreads();
}

template <bool kUp, bool kOnChip>
__global__ void __launch_bounds__(kThreads, 2) backward_kernel(const BackArgs a) {
  extern __shared__ uint4 smem[];
  const int C = a.C, G = a.G, lanes = C / 8, ppass = kThreads / lanes;
  const int oct = threadIdx.x % lanes, row = threadIdx.x / lanes;
  uint4* stash = smem;  // on chip: dz and x of the item; else the ring
  float* red = reinterpret_cast<float*>(smem) + stage_bytes(C, a.part, kOnChip, kUp) / 4;
  float* chan = red + fold_rows(C) * 2 * C;
  float* cum = chan + 2 * C;
  float* gmean = cum + 2 * C;
  float* tmp = gmean + ((2 * G + 3) / 4) * 4;
  int* flag = reinterpret_cast<int*>(tmp + kThreads);
  const long long hw = (long long)a.h * a.w;
  const int u2 = kUp ? 4 : 1;
  const int gsz = C / G;
  const float n = (float)(hw * gsz);
  const int slots = gridDim.x / a.parts, part = blockIdx.x % a.parts;
  const int grp = blockIdx.x / kFoldFanIn, first = grp * kFoldFanIn;
  constexpr int kU = kUp ? 1 : 2;
  for (int e = threadIdx.x; e < 2 * C; e += kThreads) cum[e] = 0.f;
  __syncthreads();

  for (int s = blockIdx.x / a.parts; s < a.batch; s += slots) {
    Consts k;
    k.load(a, s, oct);
    const long long p0 = (long long)part * a.part;
    const long long p1 = min(hw, p0 + a.part);
    const uint2* xs = a.x + (long long)s * hw * 2 * lanes;
    const float* gs = a.g + (long long)s * hw * u2 * C;
    float acc[2][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[0][i] = acc[1][i] = 0.f;
    // 1. the reduce
    const auto reduce = [&](const Raw<kUp>& r, float (&dz)[8], float (&xh)[8]) {
      k.grads<kUp>(r, dz, xh);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[0][i] = __fadd_rn(acc[0][i], dz[i]);
        acc[1][i] = __fadd_rn(acc[1][i], __fmul_rn(dz[i], xh[i]));
      }
    };
    if (kOnChip) {  // kU pixels' loads in flight; dz and x kept for the apply
      int pass = 0;
      for (long long p = p0 + row; p < p1; p += kU * ppass, pass += kU) {
        Raw<kUp> r[kU];
#pragma unroll
        for (int j = 0; j < kU; ++j)
          if (p + j * ppass < p1) load_raw<kUp, true>(xs, gs, p + j * ppass, a.w, C, oct, r[j]);
#pragma unroll
        for (int j = 0; j < kU; ++j) {
          if (p + j * ppass >= p1) continue;
          float dz[8], xh[8];
          reduce(r[j], dz, xh);
          uint4* st = stash + (long long)(pass + j) * 3 * kThreads + threadIdx.x;
          st[0] = make_uint4(__float_as_uint(dz[0]), __float_as_uint(dz[1]),
                             __float_as_uint(dz[2]), __float_as_uint(dz[3]));
          st[kThreads] = make_uint4(__float_as_uint(dz[4]), __float_as_uint(dz[5]),
                                    __float_as_uint(dz[6]), __float_as_uint(dz[7]));
          st[2 * kThreads] = r[j].x;
        }
      }
    } else {
      ring_walk<kUp>(stash, xs, gs, p0 + row, p1, ppass, a.w, C, oct,
                     [&](long long, const Raw<kUp>& r) {
                       float dz[8], xh[8];
                       reduce(r, dz, xh);
                     });
    }
    fold_channels(acc, red, chan, cum, C);
    float* gp = a.gpart + ((long long)s * a.parts + part) * 2 * G;
    for (int j = threadIdx.x; j < 2 * G; j += kThreads) {  // gamma-weighted, channels in order
      const int sidx = j / G, gi = j % G;
      float v = 0.f;
      for (int c = gi * gsz; c < (gi + 1) * gsz; ++c)
        v = __fadd_rn(v, __fmul_rn(a.gamma[c], chan[sidx * C + c]));
      gp[j] = v;
    }
    // the block's last item: its dgamma / dbeta sums are complete, so they
    // are published now and the fold's ticket taken before the apply
    const bool last_item = s + slots >= a.batch;
    if (last_item)
      for (int e = threadIdx.x; e < 2 * C; e += kThreads)
        a.rows[(long long)blockIdx.x * 2 * C + e] = cum[e];
    // 2. the sample's barrier: the last item to arrive adds the group sums
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      flag[1] = last_item && atomicAdd(a.fold + grp, 1) == min(kFoldFanIn,
                                                                (int)gridDim.x - first) - 1;
      flag[0] = atomicAdd(a.arrive + s, 1) == a.parts - 1;
    }
    __syncthreads();
    float* gsum = a.gsum + (long long)s * 2 * G;
    if (flag[0]) {
      __threadfence();
      sum_rows(a.gpart + (long long)s * a.parts * 2 * G, gsum, a.parts, 2 * G, tmp);
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(a.arrive + s, 1);
    }
    // the last block of a fold group to publish folds dgamma and dbeta while
    // the sample's other items arrive, before its own apply
    if (flag[1]) fold_params(a, grp, first, chan, tmp, flag);
    if (!flag[0]) {
      if (threadIdx.x == 0) {  // a wait that does not end is a fault, not a hung card
        const volatile int* t = a.arrive + s;
        const unsigned long long t0 = global_ns();
        while (*t <= a.parts) {
          __nanosleep(32);
          if (global_ns() - t0 > kWaitLimitNs) __trap();
        }
        __threadfence();
      }
      __syncthreads();
    }
    for (int j = threadIdx.x; j < 2 * G; j += kThreads) gmean[j] = __fdiv_rn(__ldcg(gsum + j), n);
    __syncthreads();
    if (threadIdx.x == 0 && atomicAdd(a.leave + s, 1) == a.parts - 1) {
      a.arrive[s] = 0;  // every item has seen the sums: the sample's tickets back to 0
      a.leave[s] = 0;
    }
    // 3. the apply
    float gam[8], ma[8], mb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = channel(oct, i, C);
      gam[i] = a.gamma[c];
      ma[i] = gmean[c / gsz];
      mb[i] = gmean[G + c / gsz];
    }
    uint2* dys = a.dy + (long long)s * hw * 2 * lanes + oct;
    const auto store = [&](long long p, const float (&dz)[8], const float (&xh)[8]) {
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dxh = __fmul_rn(dz[i], gam[i]);
        o[i] = __fmul_rn(k.rstd[i], __fsub_rn(__fsub_rn(dxh, ma[i]), __fmul_rn(xh[i], mb[i])));
      }
      const uint4 w = pack8(o);
      __stcs(dys + p * 2 * lanes, make_uint2(w.x, w.y));
      __stcs(dys + p * 2 * lanes + lanes, make_uint2(w.z, w.w));
    };
    if (kOnChip) {
      int pass = 0;
      for (long long p = p0 + row; p < p1; p += ppass, ++pass) {
        const uint4* st = stash + (long long)pass * 3 * kThreads + threadIdx.x;
        const uint4 lo = st[0], hi = st[kThreads];
        const uint32_t d[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        float dz[8], xh[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) dz[i] = __uint_as_float(d[i]);
        k.normalized(st[2 * kThreads], xh);
        store(p, dz, xh);
      }
    } else {  // x and g again, through the ring
      ring_walk<kUp>(stash, xs, gs, p0 + row, p1, ppass, a.w, C, oct,
                     [&](long long p, const Raw<kUp>& r) {
                       float dz[8], xh[8];
                       k.grads<kUp>(r, dz, xh);
                       store(p, dz, xh);
                     });
    }
  }
}

template <bool kUp, bool kOnChip>
const void* backward_fn() {
  return reinterpret_cast<const void*>(backward_kernel<kUp, kOnChip>);
}

const void* backward_instance(int upsample, int on_chip) {
  if (upsample) return on_chip ? backward_fn<true, true>() : backward_fn<true, false>();
  return on_chip ? backward_fn<false, true>() : backward_fn<false, false>();
}

// The blocks of an instance one SM of the current device holds with `smem`
// dynamic shared bytes, and the device's SMs. The first query of an
// (instance, smem) on a device raises the instance's dynamic shared memory
// limit to the most a block may opt in to and asks the occupancy; later
// calls read the answer kept here (a launch then costs no CUDA query).
struct Occupancy {
  int dev;
  const void* fn;
  long long smem;
  int per_sm, sms;
};
std::mutex occupancy_mutex;
std::vector<Occupancy> occupancy_seen;

cudaError_t backward_occupancy(const void* fn, long long smem, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(occupancy_mutex);
  for (const Occupancy& o : occupancy_seen)
    if (o.dev == dev && o.fn == fn && o.smem == smem) {
      *per_sm = o.per_sm;
      *sms = o.sms;
      return cudaSuccess;
    }
  int optin = 0;
  Occupancy o{dev, fn, smem, 0, 0};
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > optin) err = cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, fn, kThreads, (size_t)smem);
  if (err != cudaSuccess) return err;
  occupancy_seen.push_back(o);
  *per_sm = o.per_sm;
  *sms = o.sms;
  return cudaSuccess;
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

// The card's limits for ops/group_norm.py:launch_plan: out[0] SMs, out[1]
// the dynamic shared memory a block may opt in to, out[2] L2 bytes.
extern "C" int group_norm_device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 2, cudaDevAttrL2CacheSize, dev);
  return (int)err;
}

// Blocks of the backward's instance (upsample, on_chip) one SM holds at once
// with `smem` bytes of dynamic shared memory, into *blocks_per_sm.
extern "C" int group_norm_backward_occupancy(int upsample, int on_chip, long long smem,
                                             int* blocks_per_sm) {
  if (smem < 0 || !blocks_per_sm) return (int)cudaErrorInvalidValue;
  int sms = 0;
  return (int)backward_occupancy(backward_instance(upsample, on_chip), smem, blocks_per_sm, &sms);
}

// The backward, one launch. x: (batch, h * w, C) bfloat16; g: (batch,
// (u h) * (u w), C) float32; mean, rstd: (batch, G) float32 from the
// forward; gamma, beta: C float32; every map 16-byte aligned. scratch:
// scratch_floats >= batch * parts * 2G + batch * 2G + (grid + folds) * 2C
// float32 (folds = ceil(grid / 16)); counters: n_counters >= 2 batch + folds
// + 1 int32, zero, and left zero. dy: (batch, h * w, C) bfloat16; dparams:
// (2, C) float32, dgamma then dbeta. The plan (ops/group_norm.py:
// launch_plan): on_chip, `part` pixels an item (parts = ceil(h w / part)
// items a sample), `grid` blocks (a multiple of parts, at most batch x
// parts), `smem` dynamic shared bytes (at least backward_smem). Refuses a
// grid the card cannot hold at once (its waits would not end). Returns a
// cudaError_t.
extern "C" int group_norm_backward(const void* x, const void* g, const void* mean,
                                   const void* rstd, const void* gamma, const void* beta,
                                   void* scratch, long long scratch_floats, void* counters,
                                   int n_counters, void* dy, void* dparams, int batch, int h,
                                   int w, int C, int G, int upsample, int on_chip, int part,
                                   int grid, long long smem, void* stream) {
  const long long hw = (long long)h * w;
  if (batch < 1 || hw < 1 || !channels_ok(C, G) || part < 1) return (int)cudaErrorInvalidValue;
  const long long parts = (hw + part - 1) / part;
  const int folds = (grid + kFoldFanIn - 1) / kFoldFanIn;
  if (parts > grid || grid % parts || grid / parts > batch ||
      smem < backward_smem(C, G, part, on_chip != 0, upsample != 0) ||
      scratch_floats < (long long)batch * (parts + 1) * 2 * G + (long long)(grid + folds) * 2 * C ||
      n_counters < 2 * batch + folds + 1)
    return (int)cudaErrorInvalidValue;
  const void* fn = backward_instance(upsample, on_chip);
  int sms = 0, per_sm = 0;
  cudaError_t err = backward_occupancy(fn, smem, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if ((long long)grid > (long long)sms * per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  float* sc = static_cast<float*>(scratch);
  int* ct = static_cast<int*>(counters);
  BackArgs a{static_cast<const uint2*>(x), static_cast<const float*>(g),
             static_cast<const float*>(mean), static_cast<const float*>(rstd),
             static_cast<const float*>(gamma), static_cast<const float*>(beta),
             sc, sc + (long long)batch * parts * 2 * G, sc + (long long)batch * (parts + 1) * 2 * G,
             sc + (long long)batch * (parts + 1) * 2 * G + (long long)grid * 2 * C,
             ct, ct + batch, ct + 2 * batch, ct + 2 * batch + folds,
             static_cast<uint2*>(dy), static_cast<float*>(dparams), batch, h, w, C, G, part,
             (int)parts};
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, (size_t)smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
