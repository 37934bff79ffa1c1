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
// in another order, and not even the same one from run to run). A block of
// 32 x 8 pixels first lists, in tile order, the batch's tiles that meet it
// (one tile a thread, a warp ballot and a prefix over the warps), so a
// pixel tests only those. A tile whose valid is 0 (the duplicates that pad
// the last batch) is left out: it would add exactly 0.
//
// Bound: bytes. Each covered pixel reads its tiles' logits (K floats each)
// and reads and writes its K + 1 accumulators once per batch; a few
// operations a byte. Logits and accumulators are K-innermost, so a warp's
// 32 pixels read one contiguous run of 32 K floats per tile, class by class
// through L1.
//
// Numerics: __fmul_rn/__fadd_rn/__fdiv_rn keep every step rounded on its
// own (no FMA), in the plain version's order: the softmax sum over classes
// in ascending order, then (p * wv), then acc + that. expf, no fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBW = 32, kBH = 8, kThreads = kBW * kBH, kWarps = kThreads / 32;

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

template <int KP>
__global__ void __launch_bounds__(kThreads) accumulate_kernel(Args a) {
  __shared__ int list[kThreads];
  __shared__ int warp_count[kWarps];
  const int tid = threadIdx.y * kBW + threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int by0 = a.y0 + blockIdx.y * kBH, bx0 = a.x0 + blockIdx.x * kBW;
  const int y = by0 + threadIdx.y, x = bx0 + threadIdx.x;
  const bool live = y < a.y0 + a.fh && x < a.x0 + a.fw;
  const size_t pix = (size_t)y * a.wp + x;
  float acc[KP];
  float div = 0.f;
  bool loaded = false;

  for (int base = 0; base < a.batch; base += kThreads) {
    // this chunk's tiles that meet the block's pixels, in tile order
    const int t = base + tid;
    bool meets = false;
    if (t < a.batch && a.valid[t] != 0.f) {
      const int r0 = a.origins[2 * t], c0 = a.origins[2 * t + 1];
      meets = r0 < by0 + kBH && r0 + a.size > by0 && c0 < bx0 + kBW && c0 + a.size > bx0;
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
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      const int j = list[i];
      const int ly = y - a.origins[2 * j], lx = x - a.origins[2 * j + 1];
      if (!live || ly < 0 || ly >= a.size || lx < 0 || lx >= a.size) continue;
      if (!loaded) {
#pragma unroll
        for (int c = 0; c < KP; ++c) acc[c] = c < a.k ? a.acc[pix * a.k + c] : 0.f;
        div = a.div[pix];
        loaded = true;
      }
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
        if (c < a.k) acc[c] = __fadd_rn(acc[c], __fmul_rn(__fdiv_rn(e[c], sum), wv));
      }
      div = __fadd_rn(div, wv);
    }
    __syncthreads();  // the list is rewritten by the next chunk
  }
  if (loaded) {
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      if (c < a.k) a.acc[pix * a.k + c] = acc[c];
    }
    a.div[pix] = div;
  }
}

template <int KP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.fw + kBW - 1) / kBW, (a.fh + kBH - 1) / kBH), block(kBW, kBH);
  accumulate_kernel<KP><<<grid, block, 0, stream>>>(a);
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
