// int8 implicit-GEMM convolution with its dequantize epilogue, on the
// mma.sync s8 tensor cores.
//
// Replaces the XLA int8 convolution of flairtpu/models/quantize.py:218-230
// (_quant_conv: int8 x int8 -> int32, then y * deq + b), reached from the
// encoder walk (:95-138) and the U-Net decoder walk (:159-197), with the
// element-wise ops XLA fused into it on the TPU: the residual add and the
// ReLU of the walk, and the next site's requantize (quantize.py:14-18, 223).
//
// GEMM view: M = B * Ho * Wo output pixels, N = Co, K = kh * kw * Cp with
// k = (ky * kw + kx) * Cp + c, channel innermost. A is gathered from the NHWC
// int8 activations (B, H, W, Cp) on the fly (implicit im2col, zero outside
// the image and past K); B is the weight packed (Co, Kp) by ops/int8_conv.py
// (Kp = K rounded up to 32, zeros past K and in padded channels). Cp is a
// multiple of 8, so an 8-byte group of K never crosses a tap: the stem's 5
// channels are padded to 8 by quantize_act.
//
// Epilogue, per output element, every operation rounded on its own:
//   v = fma(float(acc), deq[n], b[n])   XLA contracts y * deq + b on its
//                                        jitted walk; __fmaf_rn is that FMA
//   v = v + r[m, n]                      (optional residual, float32)
//   v = max(v, 0)                        (optional ReLU)
//   out32 = v                            (optional)
//   outq = clamp(rint(v * inv_sx), -127, 127)  (optional; x / sx with a
//        constant sx is x * float32(1 / sx) in XLA's program, and round is
//        half to even, as jnp.round)
//
// Bound: at the main path's sites, operations (int8 MACs at 1,979 TOPS) or,
// at the stem and the wide shallow sites, the float32 output bytes. This
// first design is simple and right: a 128 x 64 block tile, eight warps of
// 32 x 32, K in chunks of 32 bytes through a three-stage cp.async ring in
// shared memory (8-byte gathers for A with zero fill, 16-byte rows for B),
// ldmatrix into mma.sync.m16n8k32 fragments, and the epilogue straight from
// the accumulators. A wgmma version is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 64, kBK = 32, kStages = 3, kThreads = 256;
// shared row stride in bytes: 16-byte aligned rows for ldmatrix, and 3
// 16-byte units apart, so the 8 rows of one ldmatrix phase hit 8 distinct
// bank groups
constexpr int kLds = kBK + 16;

struct Args {
  const int8_t* x;     // (B, H, W, Cp)
  const int8_t* w;     // (Co, Kp)
  const float* deq;    // (Co,)
  const float* bias;   // (Co,)
  const float* res;    // (M, Co) or null
  float* out32;        // (M, Co) or null
  int8_t* outq;        // (M, Co) or null
  float inv_sx;
  int batch, H, W, Cp, Ho, Wo, Co, kh, kw, stride, pad, dil, Kp, relu;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int8_t quantize(float v, float inv) {
  const float t = rintf(__fmul_rn(v, inv));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(t, -127.f), 127.f)));
}

__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const Args a) {
  __shared__ __align__(128) int8_t sa[kStages][kBM * kLds];
  __shared__ __align__(128) int8_t sb[kStages][kBN * kLds];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long hw_out = (long long)a.Ho * a.Wo;
  const long long M = (long long)a.batch * hw_out;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int taps = a.kh * a.kw;
  const int n_chunks = a.Kp / kBK;

  // A: each thread gathers 8-byte group j of rows r and r + 64 of every chunk
  const int j = tid & 3;
  long long a_img[2];
  int a_iy0[2], a_ix0[2];
  bool a_row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + 64 * i;
    a_row_ok[i] = m < M;
    const long long mm = a_row_ok[i] ? m : 0;
    const long long b = mm / hw_out, rem = mm - b * hw_out;
    const int oy = (int)(rem / a.Wo), ox = (int)(rem - (long long)oy * a.Wo);
    a_img[i] = b * a.H * a.W * a.Cp;
    a_iy0[i] = oy * a.stride - a.pad;
    a_ix0[i] = ox * a.stride - a.pad;
  }
  // the group's position in K for the next chunk to load: tap (ky, kx), channel c
  int tap = (8 * j) / a.Cp, c = (8 * j) % a.Cp;
  int ky = tap / a.kw, kx = tap % a.kw;

  // B: threads 0..127 load 16 bytes of weight row n0 + tid / 2 of every chunk
  const int b_row = tid >> 1, b_half = tid & 1;
  const bool b_ok = tid < 2 * kBN && n0 + b_row < a.Co;
  const int8_t* b_src = a.w + (long long)(b_ok ? n0 + b_row : 0) * a.Kp + 16 * b_half;

  auto load_chunk = [&](int chunk, int stage) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int iy = a_iy0[i] + ky * a.dil, ix = a_ix0[i] + kx * a.dil;
      const bool ok = a_row_ok[i] && tap < taps && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      const int8_t* src = ok ? a.x + a_img[i] + ((long long)iy * a.W + ix) * a.Cp + c : a.x;
      cp_async8(&sa[stage][((tid >> 2) + 64 * i) * kLds + 8 * j], src, ok ? 8 : 0);
    }
    if (tid < 2 * kBN)
      cp_async16(&sb[stage][b_row * kLds + 16 * b_half], b_ok ? b_src + chunk * kBK : a.w,
                 b_ok ? 16 : 0);
    // advance the group by one chunk of 32 bytes of K
    c += kBK;
    while (c >= a.Cp) {
      c -= a.Cp;
      ++tap;
      if (++kx == a.kw) {
        kx = 0;
        ++ky;
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }

  const int warp_m = warp & 3, warp_n = warp >> 2;
  for (int kc = 0; kc < n_chunks; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kc is in; every warp is done with chunk kc - 1
    const int next = kc + kStages - 1;
    if (next < n_chunks) load_chunk(next, next % kStages);
    cp_async_commit();

    const int8_t* A = sa[kc % kStages];
    const int8_t* Bs = sb[kc % kStages];
    uint32_t af[2][4], bf[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = warp_m * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(af[mt], A + row * kLds + (lane >> 4) * 16);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int row = warp_n * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(bf[np], Bs + row * kLds + ((lane >> 3) & 1) * 16);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_s8(acc[mt][nt], af[mt], bf[nt >> 1][2 * (nt & 1)], bf[nt >> 1][2 * (nt & 1) + 1]);
  }
  cp_async_wait<0>();

  // epilogue: thread holds rows g, g + 8 and columns 2 t, 2 t + 1 of each tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + warp_n * 32 + nt * 8 + 2 * t;
    if (n >= a.Co) continue;  // Co is a multiple of 8: n + 1 < Co too
    const float d0 = __ldg(a.deq + n), d1 = __ldg(a.deq + n + 1);
    const float b0 = __ldg(a.bias + n), b1 = __ldg(a.bias + n + 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + warp_m * 32 + mt * 16 + g + 8 * h;
        if (m >= M) continue;
        const long long o = m * a.Co + n;
        float v0 = __fmaf_rn(__int2float_rn(acc[mt][nt][2 * h]), d0, b0);
        float v1 = __fmaf_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), d1, b1);
        if (a.res) {
          const float2 r = *reinterpret_cast<const float2*>(a.res + o);
          v0 = __fadd_rn(v0, r.x);
          v1 = __fadd_rn(v1, r.y);
        }
        if (a.relu) {  // NaN passes, as jax.nn.relu
          v0 = v0 < 0.f ? 0.f : v0;
          v1 = v1 < 0.f ? 0.f : v1;
        }
        if (a.out32) *reinterpret_cast<float2*>(a.out32 + o) = make_float2(v0, v1);
        if (a.outq) {
          char2 q;
          q.x = quantize(v0, a.inv_sx);
          q.y = quantize(v1, a.inv_sx);
          *reinterpret_cast<char2*>(a.outq + o) = q;
        }
      }
  }
}

}  // namespace

// x: (batch, H, W, cp) int8; w: (co, kp) int8 packed; deq, bias: co float32;
// res: (batch * ho * wo, co) float32 or null; out32: the same shape float32
// or null; outq: the same shape int8 or null (at least one output). cp and
// co multiples of 8, kp a multiple of 32, 16-byte aligned pointers. Returns
// cudaGetLastError() after the launch.
extern "C" int int8_conv(const void* x, const void* w, const void* deq, const void* bias,
                         const void* res, void* out32, void* outq, float inv_sx, int batch,
                         int H, int W, int cp, int ho, int wo, int co, int kh, int kw, int stride,
                         int pad, int dil, int kp, int relu, void* stream) {
  if (batch < 0 || cp < 8 || cp % 8 || co < 8 || co % 8 || kp % kBK || kp < kh * kw * cp ||
      stride < 1 || dil < 1 || (!out32 && !outq))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)batch * ho * wo;
  if (M == 0) return (int)cudaSuccess;
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               static_cast<const float*>(deq), static_cast<const float*>(bias),
               static_cast<const float*>(res), static_cast<float*>(out32),
               static_cast<int8_t*>(outq), inv_sx, batch, H, W, cp, ho, wo, co, kh, kw, stride,
               pad, dil, kp, relu};
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((co + kBN - 1) / kBN));
  int8_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
