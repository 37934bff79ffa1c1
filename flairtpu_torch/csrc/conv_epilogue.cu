// Conv epilogue: inference BatchNorm + residual + ReLU, SiLU or ReLU6 + casts
// in one pass over a convolution's output.
//
// Replaces what XLA fused into the output of each encoder and decoder conv
// on the TPU: the BatchNorm, the residual add and the ReLU of
// flairtpu/models/resnet.py:177-189 (BasicBlock), :208-222 (Bottleneck) and
// :269-273 (stem), and of flairtpu/models/unet.py:71-76 (decoder block),
// with the casts between the bfloat16 convs and the float32 BatchNorm:
//
//   v = y * scale + shift                      (y: the bf16 conv output)
//   v = (v * inv_keep) * mask[b]               (optional: the drop-connect)
//   v = v + r            or   v = v + (d * scale_d + shift_d)    (optional)
//   v = max(v, 0)  or  v * (1 / (1 + exp(-v)))  or  clip(v, 0, 6)  (optional)
//   out = bf16(v) (round to nearest even); out32 = v             (optional)
//
// y, d, out: (n_pix, C) bfloat16, NHWC (an NCHW channels_last tensor);
// r: (n_pix, C) float32, or bfloat16 (the BatchNorm-folded walk's identity,
// flairtpu/models/fold.py, which keeps no float32 copies); out32: (n_pix, C)
// float32; scale, shift, scale_d, shift_d: C float32,
// an inference BatchNorm as gamma * rsqrt(var + eps) and beta - mean * scale.
// d is the downsample conv's output, its BatchNorm folded into this pass.
// __fmul_rn/__fadd_rn keep every multiply and add rounded on its own, as the
// plain PyTorch version (ops/epilogue.py) does; no FMA contraction. The SiLU
// (EfficientNet's stem and expand sites, flairtpu/models/efficientnet.py:182,
// :244-245) is v * sigmoid(v) with sigmoid = 1 / (1 + expf(-v)), the accurate
// expf and a rounded divide, as torch.sigmoid computes it on the card. The
// ReLU6 (MobileNetV2's stem, expand, depthwise and features.18 sites,
// flairtpu/models/tv_encoders.py:111, 115, 143, 165: jnp.clip(v, 0, 6)) is
// two compares that pass NaN, as jnp.clip and torch.clamp do (fminf and
// fmaxf would drop it). The
// drop-connect is EfficientNet's at a train-mode project site with an
// identity (flairtpu/models/efficientnet.py:202-211): each sample b's
// BatchNorm output divided by keep, as flairtpu computes it, and multiplied
// by its float32 keep mask (0 or 1), before the float32 identity is added;
// a dropped sample's output is its identity, bit for bit. The division is a
// multiply by inv_keep, keep's float32 reciprocal (ops/epilogue.py:
// inverse_keep), as PyTorch divides a CUDA tensor by a scalar, so the
// plain version has these bits. b = pixel / hw.
//
// Bound: bytes. Per element the pass does at most 7 float32 operations on 2
// to 16 bytes of traffic, far below the card's operations-per-byte balance.
// The design moves each byte once, in 16-byte accesses: a thread handles 8
// channels of one pixel at a time (one 16-byte bf16 load and store, two
// 16-byte float32 accesses), neighbouring threads take neighbouring groups,
// and the grid-stride step is a multiple of C / 8, so each thread keeps one
// channel phase and holds its 8 (or 16) BatchNorm constants in registers for
// the whole walk. A grid of as many blocks as fit on the SMs at once walks
// the tensor. C not a multiple of 8, or an operand not 16-byte aligned, takes
// a separate one-element-a-thread kernel, so the vector loop has no tail.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum Residual { kNone = 0, kFloat = 1, kBranch = 2, kHalf = 3 };
enum Activation { kIdentity = 0, kRelu = 1, kSilu = 2, kRelu6 = 3 };

struct Args {
  const __nv_bfloat16* y;
  const float* scale;
  const float* shift;
  const float* res;         // kFloat
  const __nv_bfloat16* res16;  // kHalf
  const __nv_bfloat16* d;   // kBranch
  const float* scale_d;     // kBranch
  const float* shift_d;     // kBranch
  __nv_bfloat16* out;
  float* out32;             // null: no float32 output
  long long n_pix;
  int channels;
  const float* mask;        // kDrop: (n_pix / hw) keep masks
  float inv_keep;           // kDrop: 1 / the keep probability, in float32
  long long hw;             // kDrop: pixels a sample
};

template <int kRes, int kAct, bool kDrop = false>
__device__ __forceinline__ float epilogue(float y, float s, float t, float r, float d, float sd,
                                          float td, float m = 1.f, float inv_keep = 1.f) {
  float v = __fadd_rn(__fmul_rn(y, s), t);
  if constexpr (kDrop) v = __fmul_rn(__fmul_rn(v, inv_keep), m);
  if constexpr (kRes == kFloat || kRes == kHalf) v = __fadd_rn(v, r);
  if constexpr (kRes == kBranch) v = __fadd_rn(v, __fadd_rn(__fmul_rn(d, sd), td));
  if constexpr (kAct == kRelu) v = v < 0.f ? 0.f : v;  // NaN passes, as torch.relu
  if constexpr (kAct == kSilu) v = __fmul_rn(v, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))));
  if constexpr (kAct == kRelu6) v = v < 0.f ? 0.f : (v > 6.f ? 6.f : v);  // NaN passes
  return v;
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
template <int kRes, int kAct, bool kF32, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_vec(const Args a, long long n_groups, int groups_per_pix, int lanes) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const int c0 = (lane % groups_per_pix) * 8;
  float s[8], t[8], sd[8], td[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = __ldg(a.scale + c0 + j);
    t[j] = __ldg(a.shift + c0 + j);
    if constexpr (kRes == kBranch) {
      sd[j] = __ldg(a.scale_d + c0 + j);
      td[j] = __ldg(a.shift_d + c0 + j);
    } else {
      sd[j] = td[j] = 0.f;
    }
  }
  const uint4* y = reinterpret_cast<const uint4*>(a.y);
  const uint4* d = reinterpret_cast<const uint4*>(a.d);
  const float4* r = reinterpret_cast<const float4*>(a.res);
  uint4* out = reinterpret_cast<uint4*>(a.out);
  const uint4* r16 = reinterpret_cast<const uint4*>(a.res16);
  float4* out32 = reinterpret_cast<float4*>(a.out32);
  for (long long g = lane; g < n_groups; g += lanes) {
    float v[8], rv[8], dv[8];
    unpack8(__ldg(y + g), v);
    if constexpr (kRes == kFloat) {
      const float4 r0 = __ldg(r + 2 * g), r1 = __ldg(r + 2 * g + 1);
      rv[0] = r0.x; rv[1] = r0.y; rv[2] = r0.z; rv[3] = r0.w;
      rv[4] = r1.x; rv[5] = r1.y; rv[6] = r1.z; rv[7] = r1.w;
    } else if constexpr (kRes == kHalf) {
      unpack8(__ldg(r16 + g), rv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) rv[j] = 0.f;
    }
    if constexpr (kRes == kBranch) {
      unpack8(__ldg(d + g), dv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) dv[j] = 0.f;
    }
    float m = 1.f;
    if constexpr (kDrop) m = __ldg(a.mask + g / (a.hw * groups_per_pix));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = epilogue<kRes, kAct, kDrop>(v[j], s[j], t[j], rv[j], dv[j], sd[j], td[j], m,
                                         a.inv_keep);
    out[g] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
    if constexpr (kF32) {
      out32[2 * g] = make_float4(v[0], v[1], v[2], v[3]);
      out32[2 * g + 1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// Any C and alignment: one element a step.
template <int kRes, int kAct, bool kF32, bool kDrop>
__global__ void __launch_bounds__(kThreads) conv_epilogue_scalar(const Args a) {
  const long long n = a.n_pix * a.channels;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += step) {
    const int c = (int)(e % a.channels);
    float r = 0.f, d = 0.f, sd = 0.f, td = 0.f;
    if constexpr (kRes == kFloat) r = a.res[e];
    if constexpr (kRes == kHalf) r = __bfloat162float(a.res16[e]);
    if constexpr (kRes == kBranch) {
      d = __bfloat162float(a.d[e]);
      sd = a.scale_d[c];
      td = a.shift_d[c];
    }
    const float m = kDrop ? a.mask[e / (a.hw * a.channels)] : 1.f;
    const float v = epilogue<kRes, kAct, kDrop>(__bfloat162float(a.y[e]), a.scale[c], a.shift[c],
                                                r, d, sd, td, m, a.inv_keep);
    a.out[e] = __float2bfloat16_rn(v);
    if constexpr (kF32) a.out32[e] = v;
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
  return cudaSuccess;
}

template <int kRes, int kAct, bool kF32, bool kDrop = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  cudaError_t err;
  int grid = 0;
  const bool vec = a.channels % 8 == 0 && aligned16(a.y) && aligned16(a.out) &&
                   (kRes != kFloat || aligned16(a.res)) && (kRes != kHalf || aligned16(a.res16)) &&
                   (kRes != kBranch || aligned16(a.d)) &&
                   (!kF32 || aligned16(a.out32));
  if (vec) {
    const int groups_per_pix = a.channels / 8;
    const long long n_groups = a.n_pix * groups_per_pix;
    if ((err = grid_size(conv_epilogue_vec<kRes, kAct, kF32, kDrop>, n_groups, &grid)) !=
        cudaSuccess)
      return err;
    if ((long long)grid * kThreads < groups_per_pix)
      grid = (groups_per_pix + kThreads - 1) / kThreads;
    const int lanes = grid * kThreads / groups_per_pix * groups_per_pix;
    conv_epilogue_vec<kRes, kAct, kF32, kDrop><<<grid, kThreads, 0, stream>>>(
        a, n_groups, groups_per_pix, lanes);
  } else {
    if ((err = grid_size(conv_epilogue_scalar<kRes, kAct, kF32, kDrop>, a.n_pix * a.channels,
                         &grid)) != cudaSuccess)
      return err;
    conv_epilogue_scalar<kRes, kAct, kF32, kDrop><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int kRes, int kAct>
cudaError_t dispatch_f32(const Args& a, cudaStream_t stream) {
  return a.out32 ? launch<kRes, kAct, true>(a, stream) : launch<kRes, kAct, false>(a, stream);
}

template <int kRes>
cudaError_t dispatch(const Args& a, int act, cudaStream_t stream) {
  if (act == kRelu) return dispatch_f32<kRes, kRelu>(a, stream);
  if (act == kSilu) return dispatch_f32<kRes, kSilu>(a, stream);
  if (act == kRelu6) return dispatch_f32<kRes, kRelu6>(a, stream);
  return dispatch_f32<kRes, kIdentity>(a, stream);
}

}  // namespace

// y: (n_pix, channels) bf16; scale, shift: channels float32. At most one of
// residual ((n_pix, channels) float32, or bf16 where residual_bf16 is
// nonzero) and branch ((n_pix, channels) bf16, with scale_d and shift_d) is
// non-null. out: (n_pix, channels) bf16; out32:
// (n_pix, channels) float32 or null. act: 0 none, 1 ReLU, 2 SiLU, 3 ReLU6. mask:
// null, or the drop-connect's (n_pix / hw) float32 keep masks with
// inv_keep (keep's float32 reciprocal), taken only with a float32 residual
// and no activation. Returns
// cudaGetLastError() after the launch.
extern "C" int conv_epilogue(const void* y, const void* scale, const void* shift,
                             const void* residual, const void* branch, const void* scale_d,
                             const void* shift_d, void* out, void* out32, long long n_pix,
                             int channels, int act, int residual_bf16, const void* mask,
                             float inv_keep, long long hw, void* stream) {
  if (channels < 1 || n_pix < 0 || (residual && branch) || (branch && !(scale_d && shift_d)) ||
      act < kIdentity || act > kRelu6 ||
      (mask && (!residual || residual_bf16 || act != kIdentity || hw < 1 || n_pix % hw ||
                !(inv_keep >= 1.f))))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return (int)cudaSuccess;
  const Args a{static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(scale),
               static_cast<const float*>(shift),
               residual_bf16 ? nullptr : static_cast<const float*>(residual),
               residual_bf16 ? static_cast<const __nv_bfloat16*>(residual) : nullptr,
               static_cast<const __nv_bfloat16*>(branch), static_cast<const float*>(scale_d),
               static_cast<const float*>(shift_d), static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(out32), n_pix, channels, static_cast<const float*>(mask),
               inv_keep, hw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask)
    return (int)(out32 ? launch<kFloat, kIdentity, true, true>(a, s)
                       : launch<kFloat, kIdentity, false, true>(a, s));
  if (branch) return (int)dispatch<kBranch>(a, act, s);
  if (residual && residual_bf16) return (int)dispatch<kHalf>(a, act, s);
  if (residual) return (int)dispatch<kFloat>(a, act, s);
  return (int)dispatch<kNone>(a, act, s);
}
