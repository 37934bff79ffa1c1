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
// flairtpu's _align_corners_weights gives them (ops/strided_tail.py:taps;
// the host passes hi = lo where wh = 0, so a tap of weight 0 reads nothing
// that is not staged):
//
//   H pass: t(col) = wl[r] x[lo[r], col] + wh[r] x[hi[r], col]
//   W pass: v      = wl[c] t(lo[c])      + wh[c] t(hi[c])
//
// each product and sum rounded on its own (__fmul_rn / __fadd_rn), the
// zero-weight taps of the dense matrices left out (their products are 0 for
// finite logits; a sum may differ from the dense one in the sign of a zero).
// Then, per pixel, by mode (the values of the per-pixel kernel it replaced,
// fe34f71's, bit for bit but for the sign of a zero logit):
//   0 argmax: class = the first maximum, prob = rint(255 / sum_j exp(v_j - max))
//             into two uint8 planes (H, pitch) at (R0 + r, C0 + c);
//   1 probs:  rint(255 * exp(v_j - max) / sum) into one (H, pitch, k) uint8 plane;
//   2 logits: v into one (H, pitch, k) float32 plane (the whole tile: m = 0,
//             windows that write tile b at rows [b s, (b + 1) s)),
// only inside the tile's owned window (windows[b] = R0, C0, rlo, rhi, clo,
// chi), the sum over classes in ascending order (expf, IEEE division).
//
// Bound: operations in the argmax mode at U = 4 and 8 (3 float32 operations
// a class at each window row and needed source column, 3 at each window
// pixel, 3 for the softmax; chip_smoke.py counts them), bytes at U = 1 and
// in the probs and logits modes. Below that bound lies the floor of the
// special-function units: one expf a value, 16 a clock an SM. What holds
// the argmax and probs modes is the rate at which the SM dispatches the
// epilogue's instructions (ops/strided_tail_phases.py: its exp_only and
// copy_only variants): the exact expf is 8 instructions a value, the
// upsample's two passes 3 and the first maximum about 4 compares and
// selects, which run at a lower rate than the float pipe's; its data
// movement alone takes about half of the call.
//
// Design: the upsample is separable, so a block computes each H-pass value
// once and each pixel reads two of them. One block of kThreads takes a band
// of `rows` window rows by a chunk of `cols` window columns of one tile (the
// host's plan, ops/strided_tail.py:launch_plan; a band outside the owned
// window exits before any barrier):
//   1. it stages the band's source run (source rows lo[first row] ..
//      hi[last row], columns lo[first col] .. hi[last col], k floats each)
//      in shared memory; each staged row is one contiguous run of the
//      source row, copied with 16-byte cp.async where it is aligned and
//      4-byte ones at its ragged ends, placed at the same alignment;
//   2. H pass: each (window row, staged source column, 4 classes) once, as
//      a float4 into a buffer whose columns are an odd number of 16-byte
//      chunks apart (col_stride), so that the W pass's 16-byte reads of
//      neighbouring columns fall on distinct banks. A thread keeps the two
//      source rows' values in registers while the rows' taps stay the same;
//   3. W pass: one thread a pixel of a window row, its k values in
//      registers, two 16-byte reads per 4 classes; the epilogue as above.
//      At U = 1 (the identity: weights 1 and 0) there is no H pass and the
//      pixel reads its staged source values;
//   4. stores leave in whole chunks: argmax's bytes are consecutive along
//      the plane row; probs and logits stage the block's run of a window
//      row (contiguous in the plane) in one of two row buffers, at the
//      plane's alignment, and store it as 16-byte chunks with ragged ends
//      (logits by __stcs: 2.55 GB a call pass L2 once), one barrier a row.
// Shared memory above 48 KB is opted into at each launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// floats past a staged run in its row: the run's alignment shift (at most
// 3) and the H pass's last float4 of a column (at most 3 past the run)
constexpr int kRunPad = 6;
// bytes past an output row run in its buffer: its alignment shift
constexpr int kOutPadBytes = 16;
enum Mode { kArgmax = 0, kProbs = 1, kLogits = 2 };

struct Args {
  const float* x;      // (batch, n, n, k)
  const int* idx;      // (2, s): lo, hi
  const float* wts;    // (2, s): wl, wh
  const int* windows;  // (batch, 6)
  void* out0;
  uint8_t* out1;       // argmax: the prob plane
  long long pitch;     // plane columns
  int n, s, k;
  int rows, cols;          // a block's window rows and columns (the plan)
  int src_rows, src_cols;  // the most source rows and columns a block stages
  bool identity;           // U = 1: no H pass
};

// The shared-memory layout, mirrored by ops/strided_tail.py:smem_bytes.
__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int stage_pitch(int src_cols, int k) {
  return round4(src_cols * k + kRunPad);
}
__host__ __device__ inline int col_stride(int k) { return 4 * (((k + 3) / 4) | 1); }
__host__ __device__ inline int out_row_bytes(int cols, int k, int mode) {
  if (mode == kProbs) return (cols * k + kOutPadBytes + 15) & ~15;
  return mode == kLogits ? 4 * round4(cols * k + kOutPadBytes / 4) : 0;
}
__host__ __device__ inline long long smem_bytes(const Args& a, int mode) {
  const long long hbuf = a.identity ? 0 : (long long)a.rows * a.src_cols * col_stride(a.k);
  return 4 * ((long long)a.src_rows * stage_pitch(a.src_cols, a.k) + hbuf) +
         2LL * out_row_bytes(a.cols, a.k, mode);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The float (0 .. 3) of a 16-byte chunk at which global address p lies.
__device__ __forceinline__ int shift_of(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Copy the run of len floats at src into dst + shift_of(src) (dst 16-byte
// aligned): the aligned middle by 16-byte cp.async, the ragged ends by 4-byte
// ones; thread t of kThreads.
__device__ __forceinline__ void stage_run(float* dst, const float* src, int len, int t) {
  const int sh = shift_of(src);
  const int head = min((4 - sh) & 3, len);
  const int body = (len - head) >> 2;
  const int tail = len - head - 4 * body;
  float* d = dst + sh;
  for (int i = t; i < body; i += kThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(d + head + 4 * i)),
                 "l"(src + head + 4 * i) : "memory");
  }
  const int e = t < head ? t : head + 4 * body + (t - head);
  if (t < head + tail) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(d + e)),
                 "l"(src + e) : "memory");
  }
}

// One pass of the upsample: two products and their sum, each rounded.
__device__ __forceinline__ float lerp2(float wa, float a, float wb, float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

// Store len elements (T: uint8_t or float) of a staged row run src (at the
// alignment of dst) to dst: 16-byte chunks, the ragged ends one by one.
template <typename T>
__device__ __forceinline__ void store_run(T* dst, const T* src, int len, int t) {
  constexpr int per = 16 / sizeof(T);
  const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
  const int head = min((per - sh) % per, len);
  const int body = (len - head) / per;
  const int tail = len - head - per * body;
  for (int i = t; i < body; i += kThreads) {
    const uint4 chunk = *reinterpret_cast<const uint4*>(src + head + per * i);
    if constexpr (sizeof(T) == 4)
      __stcs(reinterpret_cast<uint4*>(dst + head + per * i), chunk);
    else
      *reinterpret_cast<uint4*>(dst + head + per * i) = chunk;
  }
  const int e = t < head ? t : head + per * body + (t - head);
  if (t < head + tail) dst[e] = src[e];
}

// RN(a / b) for 0 <= a <= 1 <= b, from r = RN(1 / b): q = RN(a r) lies
// within an ulp of a / b, the FMA gives its remainder a - b q exactly, and
// q + r (a - b q) rounds to RN(a / b) (Markstein's theorem): the value
// __fdiv_rn(a, b) gives, without a reciprocal and a range check a division.
// For a below 2^-100, where an intermediate may leave the normal range, both
// quotients lie below 2^-100, and 255 times either rounds to the byte 0.
__device__ __forceinline__ float quotient(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-b, q, a), r, q);
}

// rint(y) for 0 <= y <= 255 as a byte: y + 1.5 2^23 rounds to the nearest
// integer, ties to even, in the low bits of the sum (an add, where a
// conversion instruction would take a slower pipe).
__device__ __forceinline__ uint8_t rint_byte(float y) {
  return static_cast<uint8_t>(__float_as_uint(__fadd_rn(y, 12582912.0f)));
}

// The softmax epilogue of a pixel's k values v: argmax, its class and prob
// bytes at cls and prob; probs, its k bytes at o.
template <int KT, int MODE>
__device__ __forceinline__ void softmax_out(float* v, int k, uint8_t* cls, uint8_t* prob,
                                            uint8_t* o) {
  // the first maximum: the largest value, then the first class that holds
  // it (a bit a class, the lowest set bit), which costs fewer compare and
  // select instructions than a running (value, class) pair
  float mx = v[0];
#pragma unroll
  for (int j = 1; j < KT; ++j)
    if (j < k) mx = fmaxf(mx, v[j]);
  unsigned hits = 0;
#pragma unroll
  for (int j = 0; j < KT; ++j)
    if (j < k) hits |= (unsigned)(v[j] == mx) << j;
  const int am = __ffs(hits) - 1;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j < k) {
      v[j] = expf(v[j] - mx);
      sum = __fadd_rn(sum, v[j]);
    }
  }
  const float r = __fdiv_rn(1.0f, sum);
  if (MODE == kArgmax) {
    *cls = (uint8_t)am;
    *prob = rint_byte(__fmul_rn(r, 255.0f));
    return;
  }
#pragma unroll
  for (int j = 0; j < KT; ++j)
    if (j < k) o[j] = rint_byte(__fmul_rn(quotient(v[j], sum, r), 255.0f));
}

template <int KT, bool EXACT, int MODE>
__global__ void __launch_bounds__(kThreads) strided_tail_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NC = (KT + 3) / 4;       // float4 chunks of a column's classes
  constexpr int CS4 = NC | 1;            // col_stride in float4s
  const int k = EXACT ? KT : a.k;
  const bool identity = a.identity;
  const int t = threadIdx.x, b = blockIdx.z;
  const int* win = a.windows + 6 * b;
  const int R0 = win[0], C0 = win[1];
  const int rb = max(win[2], (int)blockIdx.y * a.rows);
  const int re = min(win[3], ((int)blockIdx.y + 1) * a.rows);
  const int cb = max(win[4], (int)blockIdx.x * a.cols);
  const int ce = min(win[5], ((int)blockIdx.x + 1) * a.cols);
  if (rb >= re || cb >= ce) return;  // block-uniform, before any barrier
  const int s = a.s;
  const int *lo = a.idx, *hi = a.idx + s;
  const float *wl = a.wts, *wh = a.wts + s;
  const int sr0 = lo[rb], sc0 = lo[cb];
  const int nsr = hi[re - 1] - sr0 + 1, nsc = hi[ce - 1] - sc0 + 1;
  if (nsr > a.src_rows || nsc > a.src_cols) __trap();  // the plan does not cover the taps

  // 1. the source run: nsr rows of nsc * k floats
  const int sp = stage_pitch(a.src_cols, k);
  float* stage = smem;
  const long long xrow = (long long)a.n * k;
  const float* x0 = a.x + ((long long)b * a.n + sr0) * xrow + (long long)sc0 * k;
  for (int i = 0; i < nsr; ++i) stage_run(stage + i * sp, x0 + i * xrow, nsc * k, t);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // staged source row i, at its run's first float
  auto srow = [&](int i) { return stage + i * sp + shift_of(x0 + i * xrow); };

  // 2. the H pass: (window row, staged column, 4 classes) -> one float4
  float4* hbuf = reinterpret_cast<float4*>(stage + a.src_rows * sp);
  const int hrow = a.src_cols * CS4;  // float4s a window row
  if (!identity) {
    for (int u = t; u < nsc * NC; u += kThreads) {
      const int c = u / NC, q = u - c * NC;
      const int e = c * k + 4 * q;
      int cur_l = -1, cur_h = -1;
      float4 xl, xh;
      for (int r = rb; r < re; ++r) {
        const int l = __ldg(lo + r), h = __ldg(hi + r);
        if (l != cur_l || h != cur_h) {  // neighbouring rows mostly share their taps
          const float* pl = srow(l - sr0) + e;
          const float* ph = srow(h - sr0) + e;
          xl = make_float4(pl[0], pl[1], pl[2], pl[3]);
          xh = make_float4(ph[0], ph[1], ph[2], ph[3]);
          cur_l = l;
          cur_h = h;
        }
        const float wlr = __ldg(wl + r), whr = __ldg(wh + r);
        hbuf[(r - rb) * hrow + c * CS4 + q] =
            make_float4(lerp2(wlr, xl.x, whr, xh.x), lerp2(wlr, xl.y, whr, xh.y),
                        lerp2(wlr, xl.z, whr, xh.z), lerp2(wlr, xl.w, whr, xh.w));
      }
    }
    __syncthreads();
  }

  // 3-4. the W pass and the epilogue, a window row at a time: thread t
  // takes column c of each row (cols <= kThreads), its taps held throughout
  uint8_t* obuf = reinterpret_cast<uint8_t*>(hbuf + (identity ? 0 : a.rows * hrow));
  const int ob = out_row_bytes(a.cols, k, MODE);
  const int c = cb + t;
  const bool active = c < ce;
  const int lc = active ? __ldg(lo + c) - sc0 : 0, hc = active ? __ldg(hi + c) - sc0 : 0;
  const float wlc = active ? __ldg(wl + c) : 0.f, whc = active ? __ldg(wh + c) : 0.f;
  for (int r = rb; r < re; ++r) {
    const long long prow = (long long)(R0 + r) * a.pitch + C0;  // plane pixel of column 0
    uint8_t* orow = obuf + ((r - rb) & 1) * ob;
    uint8_t* dst8 = static_cast<uint8_t*>(a.out0) + (prow + cb) * k;
    float* dst32 = static_cast<float*>(a.out0) + (prow + cb) * k;
    const int oshift = MODE == kProbs ? (int)(reinterpret_cast<uintptr_t>(dst8) & 15)
                                      : shift_of(dst32);
    const float4* hr = hbuf + (r - rb) * hrow;
    const float* xr = identity ? srow(__ldg(lo + r) - sr0) : nullptr;
    if (active) {
      float v[4 * NC];
      if (identity) {
        const float* px = xr + lc * k;
#pragma unroll
        for (int j = 0; j < KT; ++j) v[j] = px[j];
      } else {
        const float4* pl = hr + lc * CS4;
        const float4* ph = hr + hc * CS4;
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const float4 A = pl[q], B = ph[q];
          v[4 * q] = lerp2(wlc, A.x, whc, B.x);
          v[4 * q + 1] = lerp2(wlc, A.y, whc, B.y);
          v[4 * q + 2] = lerp2(wlc, A.z, whc, B.z);
          v[4 * q + 3] = lerp2(wlc, A.w, whc, B.w);
        }
      }
      if (MODE == kLogits) {
        float* o = reinterpret_cast<float*>(orow) + oshift + (c - cb) * k;
#pragma unroll
        for (int j = 0; j < KT; ++j)
          if (j < k) o[j] = v[j];
      } else {
        softmax_out<KT, MODE>(v, k, static_cast<uint8_t*>(a.out0) + prow + c,
                              a.out1 + prow + c, orow + oshift + (c - cb) * k);
      }
    }
    if (MODE == kArgmax) continue;
    __syncthreads();  // the row run is staged; the other buffer is free again
    if (MODE == kProbs)
      store_run(dst8, orow + oshift, (ce - cb) * k, t);
    else
      store_run(dst32, reinterpret_cast<const float*>(orow) + oshift, (ce - cb) * k, t);
  }
}

template <int KT, bool EXACT, int MODE>
cudaError_t launch(const Args& a, int batch, int smem, cudaStream_t stream) {
  auto* kernel = strided_tail_kernel<KT, EXACT, MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.s + a.cols - 1) / a.cols, (a.s + a.rows - 1) / a.rows, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KT, bool EXACT>
cudaError_t launch_mode(int mode, const Args& a, int batch, int smem, cudaStream_t st) {
  if (mode == kArgmax) return launch<KT, EXACT, kArgmax>(a, batch, smem, st);
  if (mode == kProbs) return launch<KT, EXACT, kProbs>(a, batch, smem, st);
  return launch<KT, EXACT, kLogits>(a, batch, smem, st);
}

}  // namespace

// x: (batch, n, n, k) float32; idx: (2, s) int32 (lo, hi source indices of
// window index 0 .. s - 1, hi = lo where its weight is 0, both
// nondecreasing); wts: (2, s) float32 (their weights); windows: (batch, 6)
// int32. mode 0: out0, out1 the (H, pitch) uint8 class and prob planes;
// mode 1: out0 the (H, pitch, k) uint8 plane; mode 2: out0 the (H, pitch, k)
// float32 plane. rows, cols (at most kThreads), src_rows, src_cols and smem:
// the host's plan (ops/strided_tail.py:launch_plan); smem must be the
// layout's size.
// identity: U = 1 (weights 1 and 0). 1 <= k <= 32, 1 <= s <= 65535.
// Returns cudaGetLastError().
extern "C" int strided_tail(const void* x, const void* idx, const void* wts, const void* windows,
                            void* out0, void* out1, int pitch, int batch, int n, int s, int k,
                            int mode, int rows, int cols, int src_rows, int src_cols,
                            int identity, int smem, void* stream) {
  if (mode < 0 || mode > 2 || k < 1 || k > 32 || batch < 1 || batch > 65535 || n < 1 ||
      s < 1 || s > 65535 || pitch < 1 || (mode == kArgmax && out1 == nullptr) || rows < 1 ||
      cols < 1 || (s + rows - 1) / rows > 65535 || src_rows < 1 || src_rows > n ||
      cols > kThreads || src_cols < 1 || src_cols > n)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x), static_cast<const int*>(idx),
               static_cast<const float*>(wts), static_cast<const int*>(windows), out0,
               static_cast<uint8_t*>(out1), pitch, n, s, k, rows, cols, src_rows, src_cols,
               identity != 0};
  if (smem != smem_bytes(a, mode)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 19) return (int)launch_mode<19, true>(mode, a, batch, smem, st);  // FLAIR's 19
  if (k == 13) return (int)launch_mode<13, true>(mode, a, batch, smem, st);  // and 13 classes
  switch ((k + 3) / 4) {
    case 1: return (int)launch_mode<4, false>(mode, a, batch, smem, st);
    case 2: return (int)launch_mode<8, false>(mode, a, batch, smem, st);
    case 3: return (int)launch_mode<12, false>(mode, a, batch, smem, st);
    case 4: return (int)launch_mode<16, false>(mode, a, batch, smem, st);
    case 5: return (int)launch_mode<20, false>(mode, a, batch, smem, st);
    case 6: return (int)launch_mode<24, false>(mode, a, batch, smem, st);
    case 7: return (int)launch_mode<28, false>(mode, a, batch, smem, st);
    default: return (int)launch_mode<32, false>(mode, a, batch, smem, st);
  }
}
