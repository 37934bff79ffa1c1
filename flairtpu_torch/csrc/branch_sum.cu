// MobileOne's branch sum: the inference BatchNorms of up to five conv
// branches and of the skip, summed in flairtpu's order, then ReLU or
// nothing, in one pass over the branches' conv outputs.
//
// Replaces what XLA fused on the TPU at flairtpu/models/mobileone.py:97-112
// (MobileOneBlock): each branch's ConvBN output (the BatchNorm in float32,
// flairtpu/models/resnet.py:62-70), their sum in float32, and the ReLU
// (:112) or, at a squeeze-excite block, the sum alone for the SE (:110-111).
// No Pallas kernel computed it; PyTorch would write each branch's float32
// BatchNorm output and read it back for every add.
//
//   v = 0 + (y_0 * s_0 + t_0) + ... + (y_{n-1} * s_{n-1} + t_{n-1})
//         [+ (x * s_n + t_n)]                              (the skip)
//   v = max(v, 0)                                          (optional)
//   out = bf16(v) (round to nearest even); out32 = v       (either or both)
//
// The terms are added in flairtpu's order: the k x k branches j = 0..n-1
// (rbr_conv.j), then the 1x1 scale branch (rbr_scale, the last y where the
// block has one), then the skip (rbr_skip, a bare BatchNorm of the block's
// float32 input x), starting from flairtpu's 0.0 (which turns a -0 first
// term into +0). Every multiply and add is rounded on its own
// (__fmul_rn / __fadd_rn, no FMA contraction), as the plain PyTorch version
// (ops/branch_sum.py) computes it, so the outputs have its bits. The ReLU
// is a compare that passes NaN, as torch.relu does.
//
// y_j, out: (n_pix, C) bfloat16, NHWC (an NCHW channels_last tensor); x,
// out32: (n_pix, C) float32; scale, shift: (terms, C) float32, row j the
// j-th term's inference BatchNorm as gamma * rsqrt(var + eps) and beta -
// mean * scale, terms = branches + 1 where the block has a skip. Three
// modes: ReLU into bf16 (a block whose next block has no skip), ReLU into
// bf16 and float32 (the next block adds the float32 value as its skip), and
// the float32 sum alone, no activation (a squeeze-excite block:
// csrc/se_gate.cu's MobileOne squeeze and excite read it).
//
// Bound: bytes. Per element the pass does 3 float32 operations a term on
// 2 bytes read a branch, 4 for the skip and 2 to 6 written: far below the
// card's operations-per-byte balance. conv_epilogue.cu's design: a thread
// handles 8 channels of one pixel at a time (one 16-byte load a branch, two
// for the skip, one 16-byte bf16 store, two float32 ones), issuing every
// load of the pixel before it computes; neighbouring threads take
// neighbouring groups; the grid-stride step is a multiple of C / 8, so each
// thread keeps one channel group and holds its terms' BatchNorm constants
// in registers for the whole walk; a grid of as many blocks as fit on the
// SMs at once. The kernel is instantiated for each branch count, skip and
// mode, so a thread's loads and constants are unrolled. C not a multiple of
// 8, or an operand not 16-byte aligned, takes a separate
// one-element-a-thread kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBranches = 5;
// conv_epilogue.cu's activation codes, of which the sum takes two
enum Activation { kIdentity = 0, kRelu = 1 };
// the outputs written: a bit each
enum Outputs { kOutBf16 = 1, kOutF32 = 2, kOutBoth = 3 };

struct Args {
  const __nv_bfloat16* y[kMaxBranches];
  const float* skip;   // null: no skip
  const float* scale;  // (terms, C)
  const float* shift;  // (terms, C)
  __nv_bfloat16* out;  // kOutBf16
  float* out32;        // kOutF32
  long long n_pix;
  int channels;
  int branches;
  int act;
};

__device__ __forceinline__ float bn(float y, float s, float t) {
  return __fadd_rn(__fmul_rn(y, s), t);
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

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// One group of 8 channels a step; `lanes` (the grid's threads rounded down
// to a multiple of C / 8) is the step, so a thread's channel group is fixed.
template <int kBranches, bool kSkip, int kAct, int kOut>
__global__ void __launch_bounds__(kThreads)
    branch_sum_vec(const Args a, long long n_groups, int groups_per_pix, int lanes) {
  constexpr int kTerms = kBranches + (kSkip ? 1 : 0);
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const int c0 = (lane % groups_per_pix) * 8;
  float s[kTerms][8], t[kTerms][8];
#pragma unroll
  for (int i = 0; i < kTerms; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = __ldg(a.scale + (long long)i * a.channels + c0 + j);
      t[i][j] = __ldg(a.shift + (long long)i * a.channels + c0 + j);
    }
  const float4* x = reinterpret_cast<const float4*>(a.skip);
  uint4* out = reinterpret_cast<uint4*>(a.out);
  float4* out32 = reinterpret_cast<float4*>(a.out32);
  for (long long g = lane; g < n_groups; g += lanes) {
    uint4 w[kBranches];
#pragma unroll
    for (int i = 0; i < kBranches; ++i) w[i] = __ldg(reinterpret_cast<const uint4*>(a.y[i]) + g);
    float4 x0, x1;
    if constexpr (kSkip) {
      x0 = __ldg(x + 2 * g);
      x1 = __ldg(x + 2 * g + 1);
    }
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kBranches; ++i) {
      float f[8];
      unpack8(w[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], bn(f[j], s[i][j], t[i][j]));
    }
    if constexpr (kSkip) {
      const float f[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = __fadd_rn(v[j], bn(f[j], s[kBranches][j], t[kBranches][j]));
    }
    if constexpr (kAct == kRelu) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = v[j] < 0.f ? 0.f : v[j];  // NaN passes, as torch.relu
    }
    if constexpr ((kOut & kOutBf16) != 0)
      out[g] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                          pack2(v[6], v[7]));
    if constexpr ((kOut & kOutF32) != 0) {
      out32[2 * g] = make_float4(v[0], v[1], v[2], v[3]);
      out32[2 * g + 1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// Any C and alignment: one element a step, the same arithmetic in the same
// order.
__global__ void __launch_bounds__(kThreads) branch_sum_scalar(const Args a) {
  const long long n = a.n_pix * a.channels;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += step) {
    const int c = (int)(e % a.channels);
    float v = 0.f;
    for (int i = 0; i < a.branches; ++i)
      v = __fadd_rn(v, bn(__bfloat162float(a.y[i][e]), a.scale[(long long)i * a.channels + c],
                          a.shift[(long long)i * a.channels + c]));
    if (a.skip)
      v = __fadd_rn(v, bn(a.skip[e], a.scale[(long long)a.branches * a.channels + c],
                          a.shift[(long long)a.branches * a.channels + c]));
    if (a.act == kRelu) v = v < 0.f ? 0.f : v;
    if (a.out) a.out[e] = __float2bfloat16_rn(v);
    if (a.out32) a.out32[e] = v;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// As many blocks as fit on the card at once, or fewer if `work` threads need fewer.
template <typename Kernel>
cudaError_t grid_size(Kernel kernel, long long work, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (work + kThreads - 1) / kThreads;
  const long long full = (long long)sms * per_sm;
  *grid = (int)(need < full ? need : full);
  if (*grid < 1) *grid = 1;
  return cudaSuccess;
}

template <int kBranches, bool kSkip, int kAct, int kOut>
cudaError_t launch_vec(const Args& a, cudaStream_t stream) {
  const int groups_per_pix = a.channels / 8;
  const long long n_groups = a.n_pix * groups_per_pix;
  int grid = 0;
  cudaError_t err;
  if ((err = grid_size(branch_sum_vec<kBranches, kSkip, kAct, kOut>, n_groups, &grid)) !=
      cudaSuccess)
    return err;
  if ((long long)grid * kThreads < groups_per_pix)
    grid = (groups_per_pix + kThreads - 1) / kThreads;
  const int lanes = grid * kThreads / groups_per_pix * groups_per_pix;
  branch_sum_vec<kBranches, kSkip, kAct, kOut><<<grid, kThreads, 0, stream>>>(
      a, n_groups, groups_per_pix, lanes);
  return cudaGetLastError();
}

template <int kBranches, bool kSkip>
cudaError_t by_mode(const Args& a, int outputs, cudaStream_t stream) {
  if (a.act == kIdentity) return launch_vec<kBranches, kSkip, kIdentity, kOutF32>(a, stream);
  if (outputs == kOutBoth) return launch_vec<kBranches, kSkip, kRelu, kOutBoth>(a, stream);
  return launch_vec<kBranches, kSkip, kRelu, kOutBf16>(a, stream);
}

template <int kBranches>
cudaError_t by_skip(const Args& a, int outputs, cudaStream_t stream) {
  return a.skip ? by_mode<kBranches, true>(a, outputs, stream)
                : by_mode<kBranches, false>(a, outputs, stream);
}

}  // namespace

// y0..y4: the branches' (n_pix, channels) bf16 conv outputs, the first
// `branches` of them non-null (1 <= branches <= kMaxBranches, the scale
// branch last); skip: (n_pix, channels) float32 or null; scale, shift:
// (branches + (skip != null), channels) float32. act: 0 none, 1 ReLU.
// out: (n_pix, channels) bf16 or null; out32: (n_pix, channels) float32 or
// null; ReLU takes out (and out32, or not), no activation out32 alone.
// Returns cudaGetLastError() after the launch.
extern "C" int branch_sum(const void* y0, const void* y1, const void* y2, const void* y3,
                          const void* y4, int branches, const void* skip, const void* scale,
                          const void* shift, void* out, void* out32, long long n_pix,
                          int channels, int act, void* stream) {
  const void* ys[kMaxBranches] = {y0, y1, y2, y3, y4};
  const int outputs = (out ? kOutBf16 : 0) | (out32 ? kOutF32 : 0);
  if (branches < 1 || branches > kMaxBranches || channels < 1 || n_pix < 0 || !scale ||
      !shift || (act == kRelu && !(outputs & kOutBf16)) ||
      (act == kIdentity && outputs != kOutF32) || (act != kRelu && act != kIdentity))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kMaxBranches; ++i)
    if ((i < branches) != (ys[i] != nullptr)) return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return (int)cudaSuccess;
  Args a{};
  for (int i = 0; i < kMaxBranches; ++i) a.y[i] = static_cast<const __nv_bfloat16*>(ys[i]);
  a.skip = static_cast<const float*>(skip);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.out32 = static_cast<float*>(out32);
  a.n_pix = n_pix;
  a.channels = channels;
  a.branches = branches;
  a.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool vec = channels % 8 == 0 && (!skip || aligned16(skip)) && (!out || aligned16(out)) &&
             (!out32 || aligned16(out32));
  for (int i = 0; i < branches; ++i) vec = vec && aligned16(ys[i]);
  if (!vec) {
    int grid = 0;
    cudaError_t err = grid_size(branch_sum_scalar, n_pix * channels, &grid);
    if (err != cudaSuccess) return (int)err;
    branch_sum_scalar<<<grid, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  switch (branches) {
    case 1: return (int)by_skip<1>(a, outputs, s);
    case 2: return (int)by_skip<2>(a, outputs, s);
    case 3: return (int)by_skip<3>(a, outputs, s);
    case 4: return (int)by_skip<4>(a, outputs, s);
    default: return (int)by_skip<5>(a, outputs, s);
  }
}
