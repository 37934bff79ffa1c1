// Tile-order probability accumulation of the average and average_weights
// stitches, one launch per batch of tiles.
//
// Replaces what XLA fused on the TPU in DeviceZoneRunner._run_accumulate
// (flairtpu/zone/device_engine.py:203-211): softmax of each tile's logits,
// the product with (w * valid), and flairtpu/ops/fused.py:56-76
// scatter_accumulate, which adds the tiles into the (Hp, Wp, K) accumulator
// and the (Hp, Wp) divisor one after another in tile order:
//
//   for each tile j of the batch, in order, for each pixel (ly, lx) of it:
//     wv = w[ly, lx] * valid[j]               (ones for plain average)
//     p_k = exp(v_k - max v) / sum_k exp(v_k - max v)
//     acc[r0 + ly, c0 + lx, k] += p_k * wv;   div[r0 + ly, c0 + lx] += wv
//
// Gather form: each thread owns one accumulator pixel of the batch's
// footprint and visits the tiles that cover it in tile order, so its sums
// are taken in the reference's order, with no atomics (atomicAdd would add
// in another order, and not even the same one from run to run). A tile
// whose valid is 0 (the duplicates that pad the last batch) is left out: it
// would add exactly 0.
//
// Bound: bytes. Each covered pixel reads its tiles' logits (K floats each)
// and reads and writes its K + 1 accumulators once per batch; a few
// operations a byte.
//
// Design for the bound. The accumulators are K-innermost, so one pixel's K
// floats lie K floats from its neighbour's. Stored straight from a thread's
// registers, one warp store instruction scatters 32 4-byte pieces over
// about 32 sectors, and the K store instructions of a warp make L2 take
// about 8 times the transactions that the bytes need: in the kernel that
// kept its accumulators in registers, those stores were most of its time
// (ops/accumulate_probs_phases.py splits it). So a block owns a strip of
// kRows x kCols pixels of the footprint; each of its rows of accumulators
// is one contiguous run of kCols * K floats in the plane. The block
//   1. lists the batch's tiles that meet the strip, in tile order (one tile
//      a thread, a warp ballot and a prefix over the warps); a strip that no
//      tile meets is left alone;
//   2. copies its accumulator rows into shared memory with cp.async,
//      consecutive threads on consecutive floats: 4-byte copies, so neither
//      the origins nor Wp * K need any alignment;
//   3. adds each covering tile into the shared accumulators, one thread a
//      pixel, at a shared stride of K | 1 floats: an odd stride puts the 32
//      lanes on 32 distinct banks (FLAIR's K is 13, 15 or 19; an even K is
//      padded by one). The logits are read as csrc/merge_max.cu reads them,
//      K floats a thread, a warp on one contiguous run of a tile row; div
//      stays in a register, read and written coalesced;
//   4. writes its rows back as it read them: each warp store instruction
//      covers 128 consecutive bytes, so L2 sees whole sectors.
// The grid is one block a strip: blocks that walk the strips, taller and
// narrower strips, and a cap of 40 registers a thread all measured slower
// (the phases tool keeps them as variants).
//
// Numerics: __fmul_rn/__fadd_rn/__fdiv_rn keep every step rounded on its
// own (no FMA), in the plain version's order: the softmax sum over classes
// in ascending order, then (p * wv), then acc + that. expf, no fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 2, kCols = 128, kThreads = kRows * kCols, kWarps = kThreads / 32;

struct Args {
  const float* logits;   // (batch, size, size, k)
  const int* origins;    // (batch, 2): (row, col) of each tile in the planes
  const float* valid;    // (batch,)
  const float* weights;  // (size, size), or null for ones
  float* acc;            // (rows, wp, k)
  float* div;            // (rows, wp)
  int batch, size, k, wp;
  int y0, x0, fh, fw;  // the batch's footprint in the planes
};

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Adds the batch into strip s of the footprint (strips numbered row-major).
template <int KP>
__device__ __forceinline__ void add_strip(const Args& a, int s) {
  extern __shared__ float strip[];  // (kRows, kCols, ks) accumulators
  __shared__ int list[kThreads];
  __shared__ int warp_count[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strips_x = (a.fw + kCols - 1) / kCols;
  const int sy0 = a.y0 + (s / strips_x) * kRows, sx0 = a.x0 + (s % strips_x) * kCols;
  const int rows = min(kRows, a.y0 + a.fh - sy0), cols = min(kCols, a.x0 + a.fw - sx0);
  const int r = tid / kCols, col = tid % kCols;
  const int y = sy0 + r, x = sx0 + col;
  const bool live = r < rows && col < cols;
  const int ks = a.k | 1;  // shared stride of a pixel: odd, so conflict-free
  float* const mine = strip + (r * kCols + col) * ks;
  // a row's run of cols * k floats, walked kThreads at a time: float i is
  // class c of pixel p, kept in shared memory at p * ks + c
  const int run = cols * a.k, p0 = tid / a.k, c0 = tid % a.k;
  const int dp = kThreads / a.k, dc = kThreads % a.k;
  float div = 0.f;
  bool loaded = false;

  for (int base = 0; base < a.batch; base += kThreads) {
    // this chunk's tiles that meet the strip, in tile order
    const int t = base + tid;
    bool meets = false;
    if (t < a.batch && a.valid[t] != 0.f) {
      const int r0 = a.origins[2 * t], c0 = a.origins[2 * t + 1];
      meets = r0 < sy0 + rows && r0 + a.size > sy0 && c0 < sx0 + cols && c0 + a.size > sx0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? warp_count[w] : 0;
      n += warp_count[w];
    }
    if (meets) list[off + __popc(ballot & ((1u << lane) - 1))] = t;

    if (n > 0 && !loaded) {  // n is the same in every thread of the block
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        if (rr >= rows) break;
        const float* src = a.acc + ((size_t)(sy0 + rr) * a.wp + sx0) * a.k;
        float* dst = strip + rr * kCols * ks;
        for (int i = tid, p = p0, c = c0; i < run; i += kThreads) {
          copy4_async(dst + p * ks + c, src + i);
          p += dp;
          c += dc;
          if (c >= a.k) c -= a.k, ++p;
        }
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
      if (live) div = a.div[(size_t)y * a.wp + x];
      loaded = true;
    }
    __syncthreads();

    for (int i = 0; live && i < n; ++i) {
      const int j = list[i];
      const int ly = y - a.origins[2 * j], lx = x - a.origins[2 * j + 1];
      if (ly < 0 || ly >= a.size || lx < 0 || lx >= a.size) continue;
      // w * valid first, as the reference forms it before it multiplies the probabilities
      const float wv =
          a.weights ? __fmul_rn(a.weights[ly * a.size + lx], a.valid[j]) : a.valid[j];
      const float* v = a.logits + (((size_t)j * a.size + ly) * a.size + lx) * a.k;
      float e[KP];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        e[c] = c < a.k ? v[c] : -INFINITY;
        mx = fmaxf(mx, e[c]);
      }
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        if (c < a.k) {
          e[c] = expf(e[c] - mx);
          sum = __fadd_rn(sum, e[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        if (c < a.k) mine[c] = __fadd_rn(mine[c], __fmul_rn(__fdiv_rn(e[c], sum), wv));
      }
      div = __fadd_rn(div, wv);
    }
    __syncthreads();  // the list is rewritten by the next chunk; the strip is read below
  }
  if (!loaded) return;
  if (live) a.div[(size_t)y * a.wp + x] = div;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    if (rr >= rows) break;
    float* dst = a.acc + ((size_t)(sy0 + rr) * a.wp + sx0) * a.k;
    const float* src = strip + rr * kCols * ks;
    for (int i = tid, p = p0, c = c0; i < run; i += kThreads) {
      dst[i] = src[p * ks + c];
      p += dp;
      c += dc;
      if (c >= a.k) c -= a.k, ++p;
    }
  }
}

// One block a strip; a smaller grid walks the strips (each strip's first
// barrier orders its copy after the previous strip's write-back).
template <int KP>
__global__ void __launch_bounds__(kThreads) accumulate_kernel(Args a, int strips) {
  for (int s = blockIdx.x; s < strips; s += gridDim.x) add_strip<KP>(a, s);
}

template <int KP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int strips = ((a.fw + kCols - 1) / kCols) * ((a.fh + kRows - 1) / kRows);
  const size_t shared = (size_t)kRows * kCols * (a.k | 1) * sizeof(float);
  accumulate_kernel<KP><<<strips, kThreads, shared, stream>>>(a, strips);
  return cudaGetLastError();
}

}  // namespace

// logits: (batch, size, size, k) float32; origins: (batch, 2) int32 (row,
//   col) of each tile in the planes; valid: (batch,) float32; weights:
//   (size, size) float32 or null (ones); acc: (rows, wp, k) and div:
//   (rows, wp) float32, updated in place. (y0, x0, fh, fw): a rectangle of
//   the planes that holds every tile of the batch whose valid is not 0.
//   1 <= k <= 32. Returns cudaGetLastError() after the launch.
extern "C" int accumulate_probs(const void* logits, const void* origins, const void* valid,
                                const void* weights, void* acc, void* div, int batch, int size,
                                int k, int wp, int y0, int x0, int fh, int fw, void* stream) {
  if (k < 1 || k > 32 || batch < 1 || size < 1 || fh < 1 || fw < 1 || y0 < 0 || x0 < 0 ||
      x0 + fw > wp)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(logits), static_cast<const int*>(origins),
               static_cast<const float*>(valid), static_cast<const float*>(weights),
               static_cast<float*>(acc), static_cast<float*>(div), batch, size, k, wp,
               y0, x0, fh, fw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((k + 7) / 8) {
    case 1: return (int)launch<8>(a, st);
    case 2: return (int)launch<16>(a, st);
    case 3: return (int)launch<24>(a, st);
    default: return (int)launch<32>(a, st);
  }
}
