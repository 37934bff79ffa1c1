// Strided-head tail of the smp decoders: the align-corners upsample of the
// head's float32 logits to the tile, the softmax epilogue and the writes into
// the zone planes, one launch per batch of tiles.
//
// Replaces what XLA fused on the TPU after the head of the strided-head
// archs (deeplabv3plus, fpn and pan at upsample factor U = 4, deeplabv3 and
// pspnet at U = 8, linknet at U = 1): the windowed align-corners upsample
// (flairtpu/models/deeplab.py:73-91, called at flairtpu/models/factory.py:
// 285-293; the whole-tile one at :296-300), softmax_argmax
// (flairtpu/ops/fused.py:38-45) and the exact-clip plane writes
// (flairtpu/zone/device_engine.py:140-160, 176-185).
//
// x: (batch, n, n, k) float32 logits, k innermost; the tile is s0 = U n
// pixels, and its output window rows and columns [m, s0 - m) are indexed
// r = 0 .. s - 1. Output row r of a tile reads source rows lo[r] and hi[r]
// with weights wl[r] and wh[r] (the same taps for columns; square tiles), as
// flairtpu's _align_corners_weights gives them (ops/strided_tail.py:taps):
//
//   H pass: t(col) = wl[r] x[lo[r], col] + wh[r] x[hi[r], col]
//   W pass: v      = wl[c] t(lo[c])      + wh[c] t(hi[c])
//
// each product and sum rounded on its own (__fmul_rn / __fadd_rn), the
// zero-weight taps of the dense matrices left out (their products are 0,
// and so is a tap's whose weight is 0, for finite logits).
// Then, per pixel, by mode:
//   0 argmax: class = the first maximum, prob = rint(255 / sum_j exp(v_j - max))
//             into two uint8 planes (H, pitch) at (R0 + r, C0 + c);
//   1 probs:  rint(255 * exp(v_j - max) / sum) into one (H, pitch, k) uint8 plane;
//   2 logits: v into one (H, pitch, k) float32 plane (the whole tile: m = 0,
//             windows that write tile b at rows [b s, (b + 1) s)),
// only inside the tile's owned window (windows[b] = R0, C0, rlo, rhi, clo,
// chi), the sum over classes in ascending order (expf, IEEE division).
//
// Bound: operations in the argmax mode at U = 4 and 8 (9 float32 operations a
// value for the two passes, 3 for the softmax, on few source bytes), bytes
// at U = 1 and in the probs and logits modes (chip_smoke.py:strided_cost
// counts both). One block of 128 threads takes 128 output columns of one
// row of one tile, a thread a pixel with its k values in registers; the
// four taps' k logits are contiguous runs that neighbouring threads share,
// so the reads hit L1. A pixel whose row and column both have one tap
// (every pixel at U = 1, where the weights are 1 and 0) reads only that
// one. The probs and logits stores are staged in shared memory (a pixel
// stride of k | 1 floats, odd, so the per-thread writes do not conflict)
// and leave in consecutive bytes; argmax's two bytes a pixel are
// consecutive already.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;
enum Mode { kArgmax = 0, kProbs = 1, kLogits = 2 };

struct Args {
  const float* x;       // (batch, n, n, k)
  const int* idx;       // (2, s): lo, hi
  const float* wts;     // (2, s): wl, wh
  const int* windows;   // (batch, 6)
  void* out0;
  uint8_t* out1;        // argmax: the prob plane
  long long pitch;      // plane columns
  int n, s, k;
};

template <int KP, int MODE>
__global__ void __launch_bounds__(kCols) strided_tail_kernel(Args a) {
  __shared__ float sh[kCols * (KP + 1)];
  const int b = blockIdx.z, r = blockIdx.y, c0 = blockIdx.x * kCols;
  const int* win = a.windows + 6 * b;
  const int R0 = win[0], C0 = win[1], rlo = win[2], rhi = win[3], clo = win[4], chi = win[5];
  if (r < rlo || r >= rhi) return;
  const int cb = max(clo, c0), ce = min(chi, c0 + kCols);
  if (cb >= ce) return;  // both block-uniform: no thread passes a barrier alone
  const int c = c0 + threadIdx.x, k = a.k, s = a.s, ks = k | 1;
  const bool active = c >= cb && c < ce;

  float v[KP];
  if (active) {
    const int lr = a.idx[r], hr = a.idx[s + r], lc = a.idx[c], hc = a.idx[s + c];
    const float wlr = a.wts[r], whr = a.wts[s + r], wlc = a.wts[c], whc = a.wts[s + c];
    const float* base = a.x + (long long)b * a.n * a.n * k;
    const float* p00 = base + ((long long)lr * a.n + lc) * k;
    const float* p10 = base + ((long long)hr * a.n + lc) * k;
    const float* p01 = base + ((long long)lr * a.n + hc) * k;
    const float* p11 = base + ((long long)hr * a.n + hc) * k;
    if (whr == 0.f && whc == 0.f) {
      // one tap (every pixel at U = 1): wl x + 0 x' is wl x for finite logits
#pragma unroll
      for (int j = 0; j < KP; ++j)
        if (j < k) v[j] = __fmul_rn(wlc, __fmul_rn(wlr, __ldg(p00 + j)));
    } else {
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        if (j < k) {
          const float t0 =
              __fadd_rn(__fmul_rn(wlr, __ldg(p00 + j)), __fmul_rn(whr, __ldg(p10 + j)));
          const float t1 =
              __fadd_rn(__fmul_rn(wlr, __ldg(p01 + j)), __fmul_rn(whr, __ldg(p11 + j)));
          v[j] = __fadd_rn(__fmul_rn(wlc, t0), __fmul_rn(whc, t1));
        }
      }
    }
  }
  const long long row = (long long)(R0 + r) * a.pitch + C0;  // plane pixel of column 0

  if (MODE == kLogits) {
    if (active) {
#pragma unroll
      for (int j = 0; j < KP; ++j)
        if (j < k) sh[threadIdx.x * ks + j] = v[j];
    }
  } else if (active) {
    float mx = -INFINITY;
    int am = 0;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      if (j < k && v[j] > mx) {  // strict: the first maximum wins
        mx = v[j];
        am = j;
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      if (j < k) {
        v[j] = expf(v[j] - mx);
        sum = __fadd_rn(sum, v[j]);
      }
    }
    if (MODE == kArgmax) {
      static_cast<uint8_t*>(a.out0)[row + c] = (uint8_t)am;
      a.out1[row + c] = (uint8_t)rintf(__fmul_rn(__fdiv_rn(1.0f, sum), 255.0f));
      return;
    }
    uint8_t* sh8 = reinterpret_cast<uint8_t*>(sh);
#pragma unroll
    for (int j = 0; j < KP; ++j)
      if (j < k) sh8[threadIdx.x * k + j] = (uint8_t)rintf(__fmul_rn(__fdiv_rn(v[j], sum), 255.0f));
  }
  if (MODE == kArgmax) return;
  __syncthreads();
  // the block's run of (ce - cb) pixels x k values, contiguous in the plane
  const int total = (ce - cb) * k;
  if (MODE == kProbs) {
    const uint8_t* sh8 = reinterpret_cast<const uint8_t*>(sh) + (cb - c0) * k;
    uint8_t* dst = static_cast<uint8_t*>(a.out0) + (row + cb) * k;
    for (int i = threadIdx.x; i < total; i += kCols) dst[i] = sh8[i];
  } else {
    float* dst = static_cast<float*>(a.out0) + (row + cb) * k;
    const int dp = kCols / k, dc = kCols - dp * k;
    int wp = threadIdx.x / k, wj = threadIdx.x - wp * k;  // element i is (pixel wp, class wj)
    for (int i = threadIdx.x; i < total; i += kCols) {
      dst[i] = sh[(cb - c0 + wp) * ks + wj];
      wp += dp;
      wj += dc;
      if (wj >= k) {
        wj -= k;
        ++wp;
      }
    }
  }
}

template <int KP>
cudaError_t launch(int mode, const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.s + kCols - 1) / kCols, a.s, batch);
  if (mode == kArgmax)
    strided_tail_kernel<KP, kArgmax><<<grid, kCols, 0, stream>>>(a);
  else if (mode == kProbs)
    strided_tail_kernel<KP, kProbs><<<grid, kCols, 0, stream>>>(a);
  else
    strided_tail_kernel<KP, kLogits><<<grid, kCols, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, n, n, k) float32; idx: (2, s) int32 (lo, hi source indices of
// window index 0 .. s - 1); wts: (2, s) float32 (their weights); windows:
// (batch, 6) int32. mode 0: out0, out1 the (H, pitch) uint8 class and prob
// planes; mode 1: out0 the (H, pitch, k) uint8 plane; mode 2: out0 the (H,
// pitch, k) float32 plane. 1 <= k <= 32, 1 <= s <= 65535. Returns
// cudaGetLastError().
extern "C" int strided_tail(const void* x, const void* idx, const void* wts, const void* windows,
                            void* out0, void* out1, int pitch, int batch, int n, int s, int k,
                            int mode, void* stream) {
  if (mode < 0 || mode > 2 || k < 1 || k > 32 || batch < 1 || batch > 65535 || n < 1 ||
      s < 1 || s > 65535 || pitch < 1 || (mode == kArgmax && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x), static_cast<const int*>(idx),
               static_cast<const float*>(wts), static_cast<const int*>(windows), out0,
               static_cast<uint8_t*>(out1), pitch, n, s, k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((k + 7) / 8) {
    case 1: return (int)launch<8>(mode, a, batch, st);
    case 2: return (int)launch<16>(mode, a, batch, st);
    case 3: return (int)launch<24>(mode, a, batch, st);
    default: return (int)launch<32>(mode, a, batch, st);
  }
}
