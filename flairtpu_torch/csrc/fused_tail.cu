// Fused U-Net decoder tail: last decoder block + segmentation head +
// softmax max/argmax epilogue + exact-clipping plane writes, one kernel.
//
// Replaces the Pallas kernel benchmarks/pallas_fused_tail.py:make_kernel
// (pallas_call at :229), which fuses the same stretch of the resnet34-unet
// inner decode, the XLA path the zone program runs for it
// (flairtpu/models/unet.py:145-154, flairtpu/models/factory.py:270-274,
// flairtpu/zone/device_engine.py:143-146), and the zone program's plane
// writes (flairtpu/zone/device_engine.py:148-156):
//
//   x3 (B, E3, E3, 32) -> 2x nearest upsample, crop [uc, uc+E4)
//     -> conv3x3 32->16, *scale1 + shift1, relu     (BatchNorm as an epilogue)
//     -> conv3x3 16->16, *scale2 + shift2, relu
//     -> head conv3x3 16->K, + bias, crop [hc, hc+s)
//     -> one of three epilogues (MODE, a template parameter, so that each
//        mode compiles to its own kernel and the others cost it nothing):
//        argmax: argmax over K (first max wins) and round(255 * 1/sum
//          exp(x - max)) into the class and prob planes (uint8);
//        probs (output_type class_prob, flairtpu/zone/device_engine.py:
//          164-192): round(255 * exp(x - max) / sum) for every class, K
//          bytes a pixel, into one (H, W, K) uint8 plane, the sum taken in
//          ascending class order;
//        logits (the average and max stitches, device_engine.py:206, :519,
//          which decode the whole tile: margin 0): the float32 logits, K
//          floats a pixel, into a (B s, s, K) array.
//   out: tile b's interior pixel (r, c), for (r, c) in its owned window
//        [rlo, rhi) x [clo, chi), goes to plane pixel (R0 + r, C0 + c). The
//        host computes the windows so that last-write-wins tile order needs
//        no ordering here (the logits mode takes windows that hold each
//        tile whole).
//
// The geometry (E3, uc, E4, hc, s) comes from plan_inner_crops(S, m) and K
// is at most 32, so the kernel serves every resnet*_unet at any tile size
// and margin (their last two decoder widths are always 32 and 16). Each conv
// zero-pads the edges of its own E4 extent, as F.conv2d(padding=1) on the
// cropped extent does.
//
// Bound: operations. At 512/128 with K = 19 the tail needs about 1.29 GFLOP
// per tile against 1.3 MB of input and output, far above the card's
// operations-per-byte balance point, so the design puts every conv on the
// tensor cores and keeps everything but x3 and the two planes on chip:
// - Implicit GEMM with mma.sync m16n8k16 (bf16 in, float32 sums): rows are
//   positions, columns output channels, depth 9 taps x input channels.
//   ldmatrix takes one address per row, so im2col, the 2x nearest upsample
//   (row address = x3 position floor((uc + u) / 2)) and the conv zero pad
//   (row address = a zeroed row) cost no data movement.
// - One block per 16 x 32 output patch of a tile at a time; persistent
//   blocks (2 per SM) load the packed weights once and walk the (tile,
//   patch) items in a fixed stride, skipping items outside the tile's owned
//   window. The next item's x3 window is prefetched with cp.async (16 B a
//   copy, src-size 0 zero-fills rows outside E3) into the other of two
//   buffers while the current item computes.
// - Shared memory is position-major and channel-contiguous, XOR-swizzled in
//   16-byte units (x3: 64 B a position, conv1/conv2: 32 B) so that eight
//   consecutive ldmatrix rows hit distinct banks; weight rows are padded to
//   an odd number of 16-byte units for the same reason. 95 KB a block for
//   K = 19, so two blocks (16 warps) share an SM.
//
// Numerics follow the plain PyTorch version (ops/fused_tail.py): the two
// block convs accumulate in float32 and round their result to bfloat16 (as a
// bfloat16 cuDNN conv does) before the float32 BatchNorm epilogue; the
// head's float32 sum is the logit, unrounded; __fmul_rn/__fadd_rn keep the
// epilogues from being contracted into an FMA; argmax takes the first
// maximum; the probability is rintf((1.0f / s) * 255.0f), round half to
// even, as jnp.round and torch.round do. No fast math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC3 = 32;  // channels into the last decoder block
constexpr int kC4 = 16;  // channels of the last decoder block
constexpr int kTH = 16, kTW = 32;  // output rows x cols per work item
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kXH = (kTH + 6) / 2 + 1, kXW = (kTW + 6) / 2 + 1;  // x3 window (3-px halo, upsampled)
constexpr int kXPos = kXH * kXW;
constexpr int kH1 = kTH + 4, kW1 = kTW + 4, kP1 = kH1 * kW1;  // conv1 window
constexpr int kH2 = kTH + 2, kW2 = kTW + 2, kP2 = kH2 * kW2;  // conv2 window
constexpr int kPO = kTH * kTW;                                // head outputs
// packed weight rows, bf16: depth 9 x C_in (tap-major, channel-minor) + 8 zeros
constexpr int kRow1 = 9 * kC3 + 8, kRow2 = 9 * kC4 + 8;

// Shared-memory byte offsets for NT head n-tiles (K padded to 8 * NT).
template <int NT>
struct Smem {
  static constexpr int kp = 8 * NT;
  static constexpr int w1 = 0;
  static constexpr int w2 = w1 + kC4 * kRow1 * 2;
  static constexpr int wh = w2 + kC4 * kRow2 * 2;
  static constexpr int wbytes = wh + kp * kRow2 * 2;
  static constexpr int epi = wbytes;  // scale1, shift1, scale2, shift2 (16 each), bias (kp)
  static constexpr int epi_floats = 4 * kC4 + kp;
  static constexpr int x3 = epi + epi_floats * 4;  // two buffers of kXPos x 64 B
  static constexpr int zero = x3 + 2 * kXPos * 64;
  static constexpr int c1 = zero + 64;
  static constexpr int c2 = c1 + kP1 * 32;
  static constexpr int total = c2 + kP2 * 32;
};

struct Geometry {
  int e3, uc, e4, hc, s, k;
};

enum Mode { kArgmax = 0, kProbs = 1, kLogits = 2 };

__device__ __forceinline__ int floor_div2(int v) { return v >= 0 ? v / 2 : -((1 - v) / 2); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// byte offset of 16-byte unit `u` of position `p`: x3 (4 units) and conv windows (2 units)
__device__ __forceinline__ int x3_off(int p, int u) { return p * 64 + ((u ^ ((p >> 1) & 3)) << 4); }
__device__ __forceinline__ int cw_off(int p, int u) { return p * 32 + ((u ^ ((p >> 2) & 1)) << 4); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block-conv epilogue for one warp's 2 m-tiles x 16 channels: round to bf16,
// BatchNorm, ReLU, zero outside E4 (the next conv's pad), bf16 into the
// window `dst` of width WD whose position 0 is E4 pixel (qr0, qc0).
template <int WD, int NPOS>
__device__ __forceinline__ void block_epilogue(const float (&acc)[2][2][4], int mbase, int lane,
                                               const float* sc, const float* sh, uint8_t* dst,
                                               int qr0, int qc0, int e4) {
  const int gr = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = mbase + t * 16 + gr + 8 * hr;
      if (m >= NPOS) continue;
      const int qr = qr0 + m / WD, qc = qc0 + m % WD;
      const bool in = qr >= 0 && qr < e4 && qc >= 0 && qc < e4;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ch = nt * 8 + 2 * q;
        float v0 = 0.f, v1 = 0.f;
        if (in) {
          v0 = fmaxf(__fadd_rn(__fmul_rn(round_bf16(acc[t][nt][2 * hr]), sc[ch]), sh[ch]), 0.f);
          v1 = fmaxf(__fadd_rn(__fmul_rn(round_bf16(acc[t][nt][2 * hr + 1]), sc[ch + 1]),
                               sh[ch + 1]),
                     0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + cw_off(m, nt) + 4 * q) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int NT, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
fused_tail_kernel(const __nv_bfloat16* __restrict__ x3, const uint4* __restrict__ wpack,
                  const uint4* __restrict__ epi, const int* __restrict__ windows,
                  void* __restrict__ out0, void* __restrict__ out1, int pitch, int n_items,
                  int npx, int ppt, Geometry g) {
  using L = Smem<NT>;
  uint8_t* cls = static_cast<uint8_t*>(out0);  // argmax: class plane; probs: the K-plane
  uint8_t* prob = static_cast<uint8_t*>(out1);
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, q = lane & 3;
  const float* ep = reinterpret_cast<const float*>(smem + L::epi);

  // packed weights and epilogue constants, once per block
  for (int i = tid; i < L::wbytes / 16; i += kThreads) cp_async16(sbase + 16 * i, wpack + i, true);
  for (int i = tid; i < L::epi_floats / 4; i += kThreads)
    cp_async16(sbase + L::epi + 16 * i, epi + i, true);
  if (tid < 4) reinterpret_cast<uint4*>(smem + L::zero)[tid] = make_uint4(0, 0, 0, 0);
  cp_async_commit();

  // the first item at or after `it`, in this block's stride, whose output
  // patch meets its tile's owned window
  auto next_item = [&](int it) {
    for (; it < n_items; it += gridDim.x) {
      const int b = it / ppt, p = it - b * ppt;
      const int r0 = (p / npx) * kTH, c0 = (p % npx) * kTW;
      const int* w = windows + 6 * b;
      if (r0 < w[3] && r0 + kTH > w[2] && c0 < w[5] && c0 + kTW > w[4]) break;
    }
    return it;
  };
  // x3 rows/cols whose 2x upsample covers the item's upsampled window
  // [h0-3, h0+kTH+3) x [w0-3, w0+kTW+3); x3 is NHWC (channels_last)
  auto load_x3 = [&](int it, int buf) {
    const int b = it / ppt, p = it - b * ppt;
    const int h0 = g.hc + (p / npx) * kTH, w0 = g.hc + (p % npx) * kTW;
    const int xr0 = floor_div2(g.uc + h0 - 3), xc0 = floor_div2(g.uc + w0 - 3);
    const __nv_bfloat16* xb = x3 + (size_t)b * g.e3 * g.e3 * kC3;
    const uint32_t dst = sbase + L::x3 + buf * kXPos * 64;
    for (int i = tid; i < kXPos * 4; i += kThreads) {
      const int pos = i >> 2, u = i & 3;
      const int xr = xr0 + pos / kXW, xc = xc0 + pos % kXW;
      const bool in = xr >= 0 && xr < g.e3 && xc >= 0 && xc < g.e3;
      cp_async16(dst + x3_off(pos, u), in ? xb + ((size_t)xr * g.e3 + xc) * kC3 + u * 8 : xb, in);
    }
    cp_async_commit();
  };

  // this lane's ldmatrix rows: A row (lane & 15) of an m-tile, k half
  // (lane >> 4); B (x4) row n = (lane & 7) + 8 (lane >> 4) of an n-tile pair,
  // k half ((lane >> 3) & 1); B (x2) row n = lane & 7
  const int arow = lane & 15, ahalf = lane >> 4;
  const int bn = (lane & 7) + 8 * (lane >> 4), bk = ((lane >> 3) & 1) * 8;
  const uint32_t w1b = sbase + L::w1 + (bn * kRow1 + bk) * 2;
  const uint32_t w2b = sbase + L::w2 + (bn * kRow2 + bk) * 2;
  const uint32_t whb = sbase + L::wh + (bn * kRow2 + bk) * 2;
  const uint32_t whb2 = sbase + L::wh + ((lane & 7) * kRow2 + bk) * 2;

  int it = next_item(blockIdx.x);
  if (it < n_items) load_x3(it, 0);
  for (int buf = 0; it < n_items; buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this item's window has landed; the other buffer is free
    const int nxt = next_item(it + gridDim.x);
    if (nxt < n_items) load_x3(nxt, buf ^ 1);

    const int b = it / ppt, p = it - b * ppt;
    const int r0 = (p / npx) * kTH, c0 = (p % npx) * kTW;  // output coords in the tile
    const int h0 = g.hc + r0, w0 = g.hc + c0;                // same, in E4 coords
    const int xr0 = floor_div2(g.uc + h0 - 3), xc0 = floor_div2(g.uc + w0 - 3);
    const uint32_t xs = sbase + L::x3 + buf * kXPos * 64;

    // conv1 on the upsampled, cropped x3: window rows/cols [h0-2, h0+kTH+2)
    for (int mp = warp; mp < (kP1 + 31) / 32; mp += kWarps) {
      // per m-tile: x3 row offset (x kXW) and col for each tap row/col, -1 outside E4
      int roff[2][3], coff[2][3];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int m = mp * 32 + t * 16 + arow;
        const bool live = m < kP1;
        const int qr = h0 - 2 + m / kW1, qc = w0 - 2 + m % kW1;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int ur = qr + d - 1, uq = qc + d - 1;
          roff[t][d] = live && ur >= 0 && ur < g.e4 ? (floor_div2(g.uc + ur) - xr0) * kXW : -1;
          coff[t][d] = live && uq >= 0 && uq < g.e4 ? floor_div2(g.uc + uq) - xc0 : -1;
        }
      }
      float acc[2][2][4] = {};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint32_t arow_addr[2];
        int asw[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int ro = roff[t][tap / 3], co = coff[t][tap % 3];
          const bool ok = ro >= 0 && co >= 0;
          const int pos = ro + co;
          arow_addr[t] = ok ? xs + pos * 64 : sbase + L::zero;
          asw[t] = ok ? (pos >> 1) & 3 : 0;
        }
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          uint32_t bf[4];
          ldsm_x4(w1b + (tap * kC3 + kc * 16) * 2, bf);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            uint32_t a[4];
            ldsm_x4(arow_addr[t] + (((2 * kc + ahalf) ^ asw[t]) << 4), a);
            mma(acc[t][0], a, bf[0], bf[1]);
            mma(acc[t][1], a, bf[2], bf[3]);
          }
        }
      }
      block_epilogue<kW1, kP1>(acc, mp * 32, lane, ep, ep + kC4, smem + L::c1, h0 - 2, w0 - 2,
                               g.e4);
    }
    __syncthreads();

    // conv2: window rows/cols [h0-1, h0+kTH+1); neighbours lie in the conv1 window
    for (int mp = warp; mp < (kP2 + 31) / 32; mp += kWarps) {
      int base[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int m = min(mp * 32 + t * 16 + arow, kP2 - 1);
        base[t] = (m / kW2) * kW1 + m % kW2;
      }
      float acc[2][2][4] = {};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint32_t bf[4];
        ldsm_x4(w2b + tap * kC4 * 2, bf);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int pos = base[t] + (tap / 3) * kW1 + tap % 3;
          uint32_t a[4];
          ldsm_x4(sbase + L::c1 + cw_off(pos, ahalf), a);
          mma(acc[t][0], a, bf[0], bf[1]);
          mma(acc[t][1], a, bf[2], bf[3]);
        }
      }
      block_epilogue<kW2, kP2>(acc, mp * 32, lane, ep + 2 * kC4, ep + 3 * kC4, smem + L::c2,
                               h0 - 1, w0 - 1, g.e4);
    }
    __syncthreads();

    // head + softmax max/argmax + plane writes on the output patch
    const int* win = windows + 6 * b;
    const int R0 = win[0], C0 = win[1], rlo = win[2], rhi = win[3], clo = win[4], chi = win[5];
    const float* bias = ep + 4 * kC4;
    for (int mp = warp; mp < kPO / 32; mp += kWarps) {
      int base[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int m = mp * 32 + t * 16 + arow;
        base[t] = (m / kTW) * kW2 + m % kTW;
      }
      float acc[2][NT][4] = {};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint32_t a[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int pos = base[t] + (tap / 3) * kW2 + tap % 3;
          ldsm_x4(sbase + L::c2 + cw_off(pos, ahalf), a[t]);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(whb + (np * 16 * kRow2 + tap * kC4) * 2, bf);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            mma(acc[t][2 * np], a[t], bf[0], bf[1]);
            mma(acc[t][2 * np + 1], a[t], bf[2], bf[3]);
          }
        }
        if (NT & 1) {
          uint32_t b0, b1;
          ldsm_x2(whb2 + ((NT - 1) * 8 * kRow2 + tap * kC4) * 2, b0, b1);
#pragma unroll
          for (int t = 0; t < 2; ++t) mma(acc[t][NT - 1], a[t], b0, b1);
        }
      }
      // rows gr and gr + 8 of each m-tile: a quad holds one row's logits,
      // two classes per n-tile and lane, in ascending class order per lane
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float v[NT][2];
          float mx = -INFINITY;
          int am = 0x7fffffff;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ch = nt * 8 + 2 * q + e;
              // float32 logits: the head's sum is not rounded to bf16
              v[nt][e] = __fadd_rn(acc[t][nt][2 * hr + e], bias[ch]);
              if (MODE != kLogits && ch < g.k && v[nt][e] > mx) {
                mx = v[nt][e];
                am = ch;
              }
            }
          }
          const int m = mp * 32 + t * 16 + gr + 8 * hr;
          const int r = r0 + m / kTW, c = c0 + m % kTW;
          const bool owned = r >= rlo && r < rhi && c >= clo && c < chi;
          const size_t px = (size_t)(R0 + r) * pitch + C0 + c;
          if constexpr (MODE == kLogits) {
            if (owned) {
              float* dst = static_cast<float*>(out0) + px * g.k;
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (nt * 8 + 2 * q + e < g.k) dst[nt * 8 + 2 * q + e] = v[nt][e];
                }
              }
            }
            continue;
          }
          // first maximum over the quad: larger value, or equal value at a lower class
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, mx, o);
            const int oa = __shfl_xor_sync(0xffffffffu, am, o);
            if (om > mx || (om == mx && oa < am)) {
              mx = om;
              am = oa;
            }
          }
          if constexpr (MODE == kArgmax) {
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (nt * 8 + 2 * q + e < g.k) sum += expf(v[nt][e] - mx);
              }
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);  // commutative: the quad agrees
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (q == hr && owned) {
              cls[px] = (uint8_t)am;
              prob[px] = (uint8_t)rintf(__fmul_rn(1.0f / sum, 255.0f));
            }
          } else {
            // every lane of the quad gathers the quad's exponentials and sums
            // them in ascending class order, the plain version's order
            float ex[NT][2];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
              for (int e = 0; e < 2; ++e) ex[nt][e] = expf(v[nt][e] - mx);
            }
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
              for (int qq = 0; qq < 4; ++qq) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float x = __shfl_sync(0xffffffffu, ex[nt][e], (lane & ~3) | qq);
                  if (nt * 8 + 2 * qq + e < g.k) sum += x;
                }
              }
            }
            if (owned) {
              uint8_t* dst = cls + px * g.k;
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int ch = nt * 8 + 2 * q + e;
                  if (ch < g.k)
                    dst[ch] = (uint8_t)rintf(__fmul_rn(__fdiv_rn(ex[nt][e], sum), 255.0f));
                }
              }
            }
          }
        }
      }
    }
    it = nxt;
  }
  cp_async_wait_all();  // a block with no item still has the weight copies in flight
}

template <int NT, int MODE>
cudaError_t launch(const void* x3, const void* wpack, const void* epi, const int* windows,
                   void* out0, void* out1, int pitch, int batch, const Geometry& g,
                   cudaStream_t stream) {
  constexpr int smem = Smem<NT>::total;
  cudaError_t err = cudaFuncSetAttribute(fused_tail_kernel<NT, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_tail_kernel<NT, MODE>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int npx = (g.s + kTW - 1) / kTW, npy = (g.s + kTH - 1) / kTH;
  const int n_items = batch * npx * npy;
  const int grid = n_items < sms * per_sm ? n_items : sms * per_sm;
  fused_tail_kernel<NT, MODE><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x3), static_cast<const uint4*>(wpack),
      static_cast<const uint4*>(epi), windows, out0, out1, pitch, n_items, npx, npx * npy, g);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const void* x3, const void* wpack, const void* epi, const int* windows,
                        void* out0, void* out1, int pitch, int batch, const Geometry& g,
                        cudaStream_t st) {
  switch ((g.k + 7) / 8) {
    case 1: return launch<1, MODE>(x3, wpack, epi, windows, out0, out1, pitch, batch, g, st);
    case 2: return launch<2, MODE>(x3, wpack, epi, windows, out0, out1, pitch, batch, g, st);
    case 3: return launch<3, MODE>(x3, wpack, epi, windows, out0, out1, pitch, batch, g, st);
    default: return launch<4, MODE>(x3, wpack, epi, windows, out0, out1, pitch, batch, g, st);
  }
}

}  // namespace

// x3: (batch, e3, e3, 32) NHWC bfloat16, 16-byte aligned.
// wpack: bfloat16 conv weights, rows of depth 9 x C_in (tap-major,
//   channel-minor) padded with 8 zeros: w1 16 x 296, w2 16 x 152, wh
//   KP x 152 (zero rows past k), KP = 8 ceil(k / 8); 16-byte aligned.
// epi: float32 scale1, shift1, scale2, shift2 (16 each), bias (KP, zero past k).
// windows: (batch, 6) int32 (R0, C0, rlo, rhi, clo, chi); tile b's interior
//   pixel (r, c) with rlo <= r < rhi, clo <= c < chi goes to plane pixel
//   (R0 + r, C0 + c); the windows must lie in [0, s) and in the planes.
// mode 0 (argmax): out0, out1 the class and prob uint8 planes; mode 1
//   (probs): out0 a uint8 (H, pitch, k) plane; mode 2 (logits): out0 a
//   float32 (H, pitch, k) array. `pitch` is the planes' row length in
//   pixels. Geometry from plan_inner_crops; needs uc >= 0, hc >= 0,
//   hc + s <= e4, (uc + e4 - 1) / 2 < e3, 1 <= k <= 32.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_tail(const void* x3, const void* wpack, const void* epi, const void* windows,
                          void* out0, void* out1, int pitch, int batch, int e3, int uc, int e4,
                          int hc, int s, int k, int mode, void* stream) {
  if (k < 1 || k > 32 || uc < 0 || hc < 0 || hc + s > e4 || (uc + e4 - 1) / 2 >= e3 ||
      batch < 1 || mode < kArgmax || mode > kLogits)
    return (int)cudaErrorInvalidValue;
  const Geometry g{e3, uc, e4, hc, s, k};
  const int* w = static_cast<const int*>(windows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == kArgmax)
    err = launch_mode<kArgmax>(x3, wpack, epi, w, out0, out1, pitch, batch, g, st);
  else if (mode == kProbs)
    err = launch_mode<kProbs>(x3, wpack, epi, w, out0, out1, pitch, batch, g, st);
  else
    err = launch_mode<kLogits>(x3, wpack, epi, w, out0, out1, pitch, batch, g, st);
  return (int)err;
}
