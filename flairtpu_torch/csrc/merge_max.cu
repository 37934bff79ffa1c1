// Tile-order best-confidence merge of the max stitch, one launch per batch
// of tiles.
//
// Replaces what XLA fused on the TPU in DeviceZoneRunner._run_max
// (flairtpu/zone/device_engine.py:517-534): softmax_argmax of each tile's
// logits (flairtpu/ops/fused.py:38-44) and the scan that merges the tiles
// into a float32 best-probability plane and a uint8 class plane, one after
// another in tile order:
//
//   for each tile j of the batch, in order, for each pixel (ly, lx) of it:
//     c = argmax_k v_k (first maximum), p = 1 / sum_k exp(v_k - max v)
//     where p > best_p[r0 + ly, c0 + lx]: best_p = p, best_c = c
//
// The comparison is strict and on the float32 p, so on a tie the earlier
// tile keeps the pixel. Gather form, as csrc/accumulate_probs.cu: each
// thread owns one pixel of the batch's footprint and visits the tiles that
// cover it in tile order; a block of 32 x 8 pixels first lists the batch's
// tiles that meet it. Tiles whose valid is 0 (the duplicates that pad the
// last batch) are left out: each repeats an earlier tile's p, which the
// strict comparison never takes.
//
// Bound: bytes (each covering tile's K logits a pixel, the planes read and
// written once a batch). The sum over classes is taken in ascending order,
// as the plain version takes it; 1.0f / sum is an IEEE division. expf, no
// fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBW = 32, kBH = 8, kThreads = kBW * kBH, kWarps = kThreads / 32;

struct Args {
  const float* logits;  // (batch, size, size, k)
  const int* origins;   // (batch, 2)
  const float* valid;   // (batch,)
  float* best_p;        // (rows, wp)
  uint8_t* best_c;      // (rows, wp)
  int batch, size, k, wp;
  int y0, x0, fh, fw;
};

template <int KP>
__global__ void __launch_bounds__(kThreads) merge_max_kernel(Args a) {
  __shared__ int list[kThreads];
  __shared__ int warp_count[kWarps];
  const int tid = threadIdx.y * kBW + threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int by0 = a.y0 + blockIdx.y * kBH, bx0 = a.x0 + blockIdx.x * kBW;
  const int y = by0 + threadIdx.y, x = bx0 + threadIdx.x;
  const bool live = y < a.y0 + a.fh && x < a.x0 + a.fw;
  const size_t pix = (size_t)y * a.wp + x;
  float bp = 0.f;
  int bc = 0;
  bool loaded = false, changed = false;

  for (int base = 0; base < a.batch; base += kThreads) {
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
        bp = a.best_p[pix];
        bc = a.best_c[pix];
        loaded = true;
      }
      const float* v = a.logits + (((size_t)j * a.size + ly) * a.size + lx) * a.k;
      float e[KP];
      float mx = -INFINITY;
      int am = 0;
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        e[c] = c < a.k ? v[c] : -INFINITY;
        if (e[c] > mx) {  // strict: the first maximum wins
          mx = e[c];
          am = c;
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        if (c < a.k) sum = __fadd_rn(sum, expf(e[c] - mx));
      }
      const float p = __fdiv_rn(1.0f, sum);
      if (p > bp) {
        bp = p;
        bc = am;
        changed = true;
      }
    }
    __syncthreads();  // the list is rewritten by the next chunk
  }
  if (changed) {
    a.best_p[pix] = bp;
    a.best_c[pix] = (uint8_t)bc;
  }
}

template <int KP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.fw + kBW - 1) / kBW, (a.fh + kBH - 1) / kBH), block(kBW, kBH);
  merge_max_kernel<KP><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// logits: (batch, size, size, k) float32; origins: (batch, 2) int32 (row,
//   col) of each tile in the planes; valid: (batch,) float32; best_p:
//   (rows, wp) float32 and best_c: (rows, wp) uint8, updated in place.
//   (y0, x0, fh, fw): a rectangle of the planes that holds every tile of the
//   batch whose valid is not 0. 1 <= k <= 32. Returns cudaGetLastError().
extern "C" int merge_max(const void* logits, const void* origins, const void* valid,
                         void* best_p, void* best_c, int batch, int size, int k, int wp,
                         int y0, int x0, int fh, int fw, void* stream) {
  if (k < 1 || k > 32 || batch < 1 || size < 1 || fh < 1 || fw < 1 || y0 < 0 || x0 < 0 ||
      x0 + fw > wp)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(logits), static_cast<const int*>(origins),
               static_cast<const float*>(valid), static_cast<float*>(best_p),
               static_cast<uint8_t*>(best_c), batch, size, k, wp, y0, x0, fh, fw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((k + 7) / 8) {
    case 1: return (int)launch<8>(a, st);
    case 2: return (int)launch<16>(a, st);
    case 3: return (int)launch<24>(a, st);
    default: return (int)launch<32>(a, st);
  }
}
