// int8 implicit-GEMM convolution with its dequantize epilogue, on Hopper's
// warpgroup tensor cores (wgmma s8), with TMA weight tiles and an mbarrier
// ring.
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
// (Kp = K rounded up to 32, zeros past K and in padded channels). Both are
// K-major, as integer wgmma requires.
//
// Epilogue, per output element, every operation rounded on its own:
//   v = fma(float(acc), deq[n], b[n])   XLA contracts y * deq + b on its
//                                        jitted walk; __fmaf_rn is that FMA
//   v = v + r[m, n]                      (optional residual, float32)
//   v = max(v, 0)                        (optional ReLU; NaN passes)
//   out32 = v                            (optional)
//   outq = clamp(rint(v * inv_sx), -127, 127)  (optional; x / sx with a
//        constant sx is x * float32(1 / sx) in XLA's program, and round is
//        half to even, as jnp.round)
// The int32 sums are exact in any order (K * 127^2 < 2^31).
//
// Bound on an H100 (int8 at 1,979 TOPS, 3.35 TB/s), per site class of the
// resnet U-Nets at 512 x 512 tiles: the 3x3 sites of 128-512 channels by
// operations; the stem (7x7/2 over 8 padded channels into 64) and the
// 64-channel sites that write float32 (and read a float32 residual) by
// those bytes, which are most of the walk's bytes.
//
// Design. A persistent grid (one block per SM) walks 128 x BN output tiles,
// the BN-wide column tiles of one row tile next to each other, so that
// neighbouring blocks load the same activations while they are in L2 (the
// weights, 2.4 MB at most, stay there in any order). BN is 128, or 64 where
// Co <= 64. A block is five warpgroups, each with its own registers
// (setmaxnreg): A's loaders, two MMA consumers of 64 rows each, and the
// epilogue. K runs in stages through a ring in shared memory, each stage one
// swizzled row a tile row, with a full and an empty mbarrier; no block
// barrier follows the set-up. The weight tile comes by TMA (2D tiled map
// over (Co, Kp), box {a stage's bytes, BN rows}, zeros past Co and Kp). A
// comes one of three ways, chosen by the wrapper from Cp:
// - Cp % 128 == 0 (every site from layer 2 on): a stage of 128 bytes lies
//   in one tap, and one im2col TMA a stage loads it (128B swizzle);
// - Cp % 64 == 0 (layer 1): the same with 64-byte stages (64B swizzle);
// - otherwise (the stem's 8 channels, 32-channel decoder sites): two
//   producer warpgroups gather it with cp.async, 16-byte groups where
//   Cp % 16 == 0, else 8-byte, two threads a row, each finding its row's
//   pixel once a tile and its groups' tap offsets in a table in shared
//   memory, written in the 128B swizzle; they arrive on "full" through
//   cp.async.mbarrier.arrive.noinc (its count: the 256 gathering threads
//   and the TMA thread's expect_tx).
// With TMA, one producer thread does it all and the second producer
// warpgroup joins the epilogue. Each consumer waits on "full", issues
// wgmma.m64nBNk32 from shared-memory descriptors (the start address
// advances 32 bytes a step inside the swizzled row), keeps one to three
// wgmma groups in flight and releases the stages behind them on "empty";
// at the tile's end it writes its int32 sums to a staging tile in shared
// memory (its own, not the ring's) and goes on to the next tile. The
// epilogue warps drain the staging tile meanwhile, a row at a time: the
// residual (asked of L2 by a bulk prefetch before the tile is staged) and
// the float32 output as 16-byte accesses over whole rows, the int8 output
// as 4-byte ones. So the K loop, the loads of the next stages and the
// epilogue's memory traffic overlap.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                    // output rows (pixels) a tile
// warpgroups 0-1 gather A (where A comes by im2col TMA, warpgroup 0 only
// issues the loads and warpgroup 1 drains), 2-3 run the MMA, 4 drains
constexpr int kProducers = 2;               // gathering warpgroups, 64 rows each
constexpr int kConsumerWarps = 8;           // two MMA warpgroups, 64 rows each
constexpr int kThreads = 128 * (kProducers + 3);
constexpr int kFullArrivals = 128 * kProducers + 1;  // gathering threads + the TMA thread
// registers a thread: the block gets kLaunchRegs a thread at launch (and
// ptxas compiles every warpgroup's code within them); setmaxnreg moves
// them between warpgroups within that pool: 256 x 40 + 128 x 80 + 256 x 160
// with two gathering warpgroups, 128 x 40 + 256 x 80 + 256 x 136 with one
constexpr int kLaunchRegs = (65536 / kThreads) & ~7;
constexpr int kProducerRegs = 40, kDrainRegs = 80, kConsumerRegs = 160, kConsumerRegsTma = 136;
static_assert(256 * kProducerRegs + 128 * kDrainRegs + 256 * kConsumerRegs <=
                      kThreads * kLaunchRegs &&
                  128 * kProducerRegs + 256 * kDrainRegs + 256 * kConsumerRegsTma <=
                      kThreads * kLaunchRegs,
              "setmaxnreg asks for more registers than the block has");

// VEC: how A's rows are loaded: 8- or 16-byte cp.async groups, or im2col
// TMA boxes of 128- or 64-byte rows (VEC 128 or 64)
template <int BN, int VEC>
struct Tile {
  // bytes of K a stage, one swizzled row a tile row: 64 (64B swizzle) for
  // the 64-byte im2col rows, else 128 (128B swizzle)
  static constexpr int kBK = VEC == 64 ? 64 : 128;
  static constexpr int kStages = (BN == 128 ? 4 : 6) * (128 / kBK);
  // wgmma groups a consumer keeps in flight: short groups (64 columns, or
  // two k32 steps) want more, and the ring leaves the producer the rest
  static constexpr int kInFlight = kBK == 64 ? 3 : BN == 128 ? 1 : 2;
  static constexpr int kAStage = kBM * kBK;
  static constexpr int kBStage = BN * kBK;
  static constexpr int kPitch = BN + 8;     // staging row in words: rows 8 banks apart
  static constexpr int kStaging = kBM * kPitch * 4;
  static constexpr int kSmem = 1024 + kStages * (kAStage + kBStage) + kStaging + 16 * (kStages + 1);
};

struct Args {
  const int8_t* x;     // (B, H, W, Cp)
  const float* deq;    // (Co,)
  const float* bias;   // (Co,)
  const float* res;    // (M, Co) or null
  float* out32;        // (M, Co) or null
  int8_t* outq;        // (M, Co) or null
  float inv_sx;
  int batch, H, W, Cp, Ho, Wo, Co, kh, kw, stride, pad, dil, Kp, relu;
  int n_tiles, n_col_tiles, n_stages, n_groups;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// wait for the phase of parity `parity` to complete; a wait of a second is a
// fault (a count that cannot be reached), and traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 1000000000ull) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// arrive on bar once every cp.async this thread issued so far has landed
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// im2col mode over the (N, H, W, C) activations: a box row of channels from
// c of 128 output pixels, starting at the pixel whose tap (0, 0) is (w, h)
// of image n, each moved by the tap offset (ow, oh); zeros outside
__device__ __forceinline__ void tma_load_im2col(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int c, int w, int h, int n,
                                                uint16_t ow, uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n), "h"(ow),
      "h"(oh)
      : "memory");
}

// K-major operand in swizzled rows of BK bytes (128B swizzle for 128, 64B
// for 64), 8-row groups 8 BK bytes apart (stride byte offset); the leading
// offset is unused there
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * BK / 16) << 32) | (static_cast<uint64_t>(BK == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma<128>(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<64>(int (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ int8_t quantize(float v, float inv) {
  const float t = rintf(__fmul_rn(v, inv));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(t, -127.f), 127.f)));
}

// The gather table: entry q says where the VEC-byte group of K at q * VEC
// lies for a row: its offset from the row's pixel at tap (0, 0) and the
// tap's (dy, dx), packed as {offset, dx << 16 | dy}. Groups past K get
// dy = -32768, which no row brings into the image (H < 32768 - pad).
template <int VEC>
__device__ __forceinline__ void fill_table(const Args& a, int2* table) {
  for (int q = threadIdx.x; q < a.n_groups; q += 128 * kProducers) {
    const int k = q * VEC, tap = k / a.Cp, c = k - tap * a.Cp, ky = tap / a.kw;
    const int dy = ky * a.dil, dx = (tap - ky * a.kw) * a.dil;
    table[q] = ky < a.kh ? make_int2((dy * a.W + dx) * a.Cp + c, (dx << 16) | (dy & 0xffff))
                         : make_int2(0, 0x8000);
  }
}

// A producer warpgroup pw: thread t gathers row 64 pw + t / 2 of A, the
// VEC-byte groups 2 g + t % 2 of each stage; thread 0 of warpgroup 0 also
// loads B. The row's pixel at tap (0, 0) is found once a tile; a group
// then costs a table entry, a bounds test and a cp.async. A row past M has
// an iy that no tap brings into the image.
template <int BN, int VEC>
__device__ __forceinline__ void produce(const CUtensorMap* map, const Args& a, const int2* table,
                                        uint32_t sa, uint32_t sb, uint32_t full0,
                                        uint32_t empty0) {
  using T = Tile<BN, VEC>;
  constexpr int kBK = T::kBK, kGroups = kBK / (2 * VEC);
  const int t = threadIdx.x & 127, half = t & 1;
  const int r = 64 * (threadIdx.x >> 7) + (t >> 1);
  const long long hw_out = (long long)a.Ho * a.Wo, M = (long long)a.batch * hw_out;
  const uint32_t row_dst = sa + r * kBK;
  int it = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int mt = tile / a.n_col_tiles, nt = tile - mt * a.n_col_tiles;
    const long long m = (long long)mt * kBM + r, mm = m < M ? m : 0;
    const long long b = mm / hw_out, rem = mm - b * hw_out;
    const int oy = (int)(rem / a.Wo), ox = (int)(rem - (long long)oy * a.Wo);
    const int iy = m < M ? oy * a.stride - a.pad : -(1 << 30), ix = ox * a.stride - a.pad;
    const int8_t* px = a.x + ((b * a.H + (oy * a.stride - a.pad)) * a.W + ix) * a.Cp;
    for (int kc = 0; kc < a.n_stages; ++kc, ++it) {
      const int s = it % T::kStages;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((it / T::kStages) & 1) ^ 1);
      if (threadIdx.x == 0) {
        mbar_expect_tx(full, T::kBStage);
        tma_load_2d(sb + s * T::kBStage, map, full, kc * kBK, nt * BN);
      }
      const uint32_t dst = row_dst + s * T::kAStage;
      const int2* entry = table + kc * (kBK / VEC) + half;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int byte = (2 * g + half) * VEC;
        const uint32_t sw = (((byte >> 4) ^ (r & 7)) << 4) | (byte & 15);
        const int2 e = entry[2 * g];
        const int dy = (e.y << 16) >> 16, dx = e.y >> 16;
        const bool ok = (unsigned)(iy + dy) < (unsigned)a.H && (unsigned)(ix + dx) < (unsigned)a.W;
        cp_async<VEC>(dst + sw, ok ? px + e.x : a.x, ok ? VEC : 0);
      }
      cp_async_arrive_noinc(full);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The producer where Cp % VEC == 0 (VEC 128 or 64): a stage of K lies in
// one tap, so thread 0 loads A by one im2col TMA a stage beside B's, in the
// same swizzle; the full barrier waits for that one arrival and the bytes.
template <int BN, int VEC>
__device__ __forceinline__ void produce_tma(const CUtensorMap* map, const CUtensorMap* amap,
                                            const Args& a, uint32_t sa, uint32_t sb,
                                            uint32_t full0, uint32_t empty0) {
  using T = Tile<BN, VEC>;
  constexpr int kBK = T::kBK;
  if (threadIdx.x != 0) return;
  const long long hw_out = (long long)a.Ho * a.Wo;
  int it = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int mt = tile / a.n_col_tiles, nt = tile - mt * a.n_col_tiles;
    const long long m = (long long)mt * kBM, b = m / hw_out, rem = m - b * hw_out;
    const int oy = (int)(rem / a.Wo), ox = (int)(rem - (long long)oy * a.Wo);
    const int w0 = ox * a.stride - a.pad, h0 = oy * a.stride - a.pad;
    int ky = 0, kx = 0, c = 0;
    for (int kc = 0; kc < a.n_stages; ++kc, ++it) {
      const int s = it % T::kStages;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((it / T::kStages) & 1) ^ 1);
      mbar_expect_tx(full, T::kAStage + T::kBStage);
      tma_load_2d(sb + s * T::kBStage, map, full, kc * kBK, nt * BN);
      tma_load_im2col(sa + s * T::kAStage, amap, full, c, w0, h0, (int)b,
                      (uint16_t)(kx * a.dil), (uint16_t)(ky * a.dil));
      if ((c += kBK) == a.Cp) {
        c = 0;
        if (++kx == a.kw) {
          kx = 0;
          ++ky;
        }
      }
    }
  }
}

// A consumer warpgroup: rows 64 g .. 64 g + 63 of each tile, into the
// staging tile once the epilogue warpgroup has drained the one before.
template <int BN, int VEC>
__device__ __forceinline__ void consume(const Args& a, uint32_t sa, uint32_t sb, int* staging,
                                        uint32_t full0, uint32_t empty0, uint32_t staged) {
  using T = Tile<BN, VEC>;
  constexpr int kBK = T::kBK;
  const int g = (threadIdx.x >> 7) - kProducers, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  int* stage_w = staging + (64 * g + 16 * warp) * T::kPitch;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int it = 0, j = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, ++j) {
    for (int kc = 0; kc < a.n_stages; ++kc, ++it) {
      const int s = it % T::kStages;
      mbar_wait(full0 + 8 * s, (it / T::kStages) & 1);
      // the gathers are generic-proxy writes; wgmma reads through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t a_s = sa + s * T::kAStage + g * 64 * kBK, b_s = sb + s * T::kBStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma<BN>(acc, smem_desc<kBK>(a_s + 32 * kk), smem_desc<kBK>(b_s + 32 * kk),
                  kc > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<T::kInFlight>();
      if (kc >= T::kInFlight && lane == 0)
        mbar_arrive(empty0 + 8 * ((it - T::kInFlight) % T::kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
    if (lane == 0)
      for (int d = a.n_stages < T::kInFlight ? a.n_stages : T::kInFlight; d > 0; --d)
        mbar_arrive(empty0 + 8 * ((it - d) % T::kStages));

    mbar_wait(staged + 8, (j & 1) ^ 1);  // the epilogue is done with tile j - 1
    // n-block jn: rows lane / 4 (+ 8), columns 8 jn + 2 (lane % 4) (+ 1)
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(stage_w + (lane / 4 + 8 * h) * T::kPitch + 8 * jn +
                                 2 * (lane % 4)) = make_int2(acc[4 * jn + 2 * h],
                                                             acc[4 * jn + 2 * h + 1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(staged);
  }
}

// An epilogue warp w of DW takes rows R w .. R w + R - 1 of each staged
// tile (R = 128 / DW), BN / 4 threads a row, four columns a thread. Before
// it waits for a tile, each of R lanes asks L2 for one row of the tile's
// residual, so that the residual's loads hit L2 while the tile's K loop
// still runs.
template <int BN, int VEC, int DW>
__device__ __forceinline__ void drain(const Args& a, const int* staging, uint32_t staged,
                                      int warp) {
  using T = Tile<BN, VEC>;
  constexpr int TPR = BN / 4, RPP = 32 / TPR, kBatch = 4, kRows = kBM / DW;
  const int lane = threadIdx.x & 31, col = 4 * (lane % TPR);
  const long long M = (long long)a.batch * a.Ho * a.Wo;
  int j = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, ++j) {
    const int mt = tile / a.n_col_tiles, nt = tile - mt * a.n_col_tiles;
    const long long m_w = (long long)mt * kBM + kRows * warp;
    const int n0 = nt * BN, n = n0 + col;
    if (a.res && lane < kRows && m_w + lane < M) {
      const int cols = a.Co - n0 < BN ? a.Co - n0 : BN;
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                       a.res + (m_w + lane) * a.Co + n0),
                   "r"(4 * cols)
                   : "memory");
    }
    mbar_wait(staged, j & 1);
    if (n < a.Co) {  // Co is a multiple of 8: columns n .. n + 3 are all in
      float d[4], b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[e] = __ldg(a.deq + n + e);
        b[e] = __ldg(a.bias + n + e);
      }
#pragma unroll
      for (int p0 = 0; p0 < kRows / RPP; p0 += kBatch) {
        int4 s4[kBatch];
        float4 r[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int row = kRows * warp + (p0 + u) * RPP + lane / TPR;
          const long long m = (long long)mt * kBM + row;
          s4[u] = *reinterpret_cast<const int4*>(staging + row * T::kPitch + col);
          if (a.res && m < M) r[u] = __ldcs(reinterpret_cast<const float4*>(a.res + m * a.Co + n));
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const long long m = m_w + (p0 + u) * RPP + lane / TPR;
          if (m >= M) continue;
          float v[4] = {__fmaf_rn(__int2float_rn(s4[u].x), d[0], b[0]),
                        __fmaf_rn(__int2float_rn(s4[u].y), d[1], b[1]),
                        __fmaf_rn(__int2float_rn(s4[u].z), d[2], b[2]),
                        __fmaf_rn(__int2float_rn(s4[u].w), d[3], b[3])};
          const long long o = m * a.Co + n;
          if (a.res) {
            v[0] = __fadd_rn(v[0], r[u].x);
            v[1] = __fadd_rn(v[1], r[u].y);
            v[2] = __fadd_rn(v[2], r[u].z);
            v[3] = __fadd_rn(v[3], r[u].w);
          }
          if (a.relu) {  // NaN passes, as jax.nn.relu
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = v[e] < 0.f ? 0.f : v[e];
          }
          if (a.out32)
            *reinterpret_cast<float4*>(a.out32 + o) = make_float4(v[0], v[1], v[2], v[3]);
          if (a.outq) {
            char4 q;
            q.x = quantize(v[0], a.inv_sx);
            q.y = quantize(v[1], a.inv_sx);
            q.z = quantize(v[2], a.inv_sx);
            q.w = quantize(v[3], a.inv_sx);
            *reinterpret_cast<char4*>(a.outq + o) = q;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(staged + 8);  // the staging tile is free
  }
}

template <int BN, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap map,
                     const __grid_constant__ CUtensorMap amap, const Args a) {
  using T = Tile<BN, VEC>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sa = smem_u32(smem), sb = sa + T::kStages * T::kAStage;
  int* staging = reinterpret_cast<int*>(smem + T::kStages * (T::kAStage + T::kBStage));
  // full[s], empty[s], then the staging tile's full and empty
  const uint32_t full0 = smem_u32(staging) + T::kStaging, empty0 = full0 + 8 * T::kStages;
  const uint32_t staged = empty0 + 8 * T::kStages;
  int2* table = reinterpret_cast<int2*>(reinterpret_cast<uint8_t*>(staging) + T::kStaging +
                                        16 * (T::kStages + 1));
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full0 + 8 * s, VEC >= 64 ? 1 : kFullArrivals);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    mbar_init(staged, kConsumerWarps);
    mbar_init(staged + 8, VEC >= 64 ? 8 : 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  if constexpr (VEC >= 64) {
    if (wg == 0) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
      produce_tma<BN, VEC>(&map, &amap, a, sa, sb, full0, empty0);
    } else if (wg == 2 || wg == 3) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegsTma));
      consume<BN, VEC>(a, sa, sb, staging, full0, empty0, staged);
    } else {  // warpgroups 1 and 4: eight epilogue warps
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kDrainRegs));
      drain<BN, VEC, 8>(a, staging, staged, warp + (wg == 4 ? 4 : 0));
    }
  } else {
    if (wg < kProducers) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
      fill_table<VEC>(a, table);
      // named barrier 1, the producers' own: the table is complete
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kProducers) : "memory");
      produce<BN, VEC>(&map, a, table, sa, sb, full0, empty0);
    } else if (wg < kProducers + 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
      consume<BN, VEC>(a, sa, sb, staging, full0, empty0, staged);
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kDrainRegs));
      drain<BN, VEC, 4>(a, staging, staged, warp);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeIm2col encode_im2col() {
  static EncodeIm2col fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeIm2col", &p,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeIm2col>(p);
  }
  return fn;
}

CUtensorMapSwizzle swizzle(int bk) {
  return bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
}

// A's im2col map over x (N, H, W, Cp) int8: boxes of 128 pixels by bk bytes
// of channels, swizzled as the stage; the pixels walk the output grid in
// input coordinates (corners -pad and pad - dil (k - 1), steps of the stride)
int encode_a(CUtensorMap* amap, const void* x, const Args& a, int bk) {
  const EncodeIm2col encode = encode_im2col();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)a.Cp, (cuuint64_t)a.W, (cuuint64_t)a.H,
                              (cuuint64_t)a.batch};
  const cuuint64_t strides[3] = {(cuuint64_t)a.Cp, (cuuint64_t)a.Cp * a.W,
                                 (cuuint64_t)a.Cp * a.W * a.H};
  const int lower[2] = {-a.pad, -a.pad};
  const int upper[2] = {a.pad - a.dil * (a.kw - 1), a.pad - a.dil * (a.kh - 1)};
  const cuuint32_t elem[4] = {1, (cuuint32_t)a.stride, (cuuint32_t)a.stride, 1};
  if (encode(amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, lower,
             upper, bk, kBM, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(bk),
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

template <int BN, int VEC>
int launch(const void* w, Args a, cudaStream_t stream) {
  using T = Tile<BN, VEC>;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  // (Co, Kp) int8, K innermost: box of a stage's bytes by BN rows, zeros outside
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)a.Kp, (cuuint64_t)a.Co};
  const cuuint64_t strides[1] = {(cuuint64_t)a.Kp};
  const cuuint32_t box[2] = {T::kBK, BN}, elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(T::kBK),
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap = {};
  if constexpr (VEC >= 64) {
    const int err = encode_a(&amap, a.x, a, T::kBK);
    if (err) return err;
  }
  a.n_stages = (a.Kp + T::kBK - 1) / T::kBK;
  a.n_groups = VEC >= 64 ? 0 : a.n_stages * (T::kBK / VEC);
  const int smem = T::kSmem + 8 * a.n_groups;  // the ring, staging, barriers, gather table
  cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<BN, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // fewer registers at launch than setmaxnreg hands out would block the
  // consumers' setmaxnreg.inc for ever
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, int8_conv_kernel<BN, VEC>)) != cudaSuccess) return (int)err;
  if (attr.numRegs < kLaunchRegs) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long M = (long long)a.batch * a.Ho * a.Wo;
  const long long tiles = (M + kBM - 1) / kBM * ((a.Co + BN - 1) / BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.n_tiles = (int)tiles;
  a.n_col_tiles = (a.Co + BN - 1) / BN;
  const int grid = (int)(tiles < sms ? tiles : sms);
  int8_conv_kernel<BN, VEC><<<grid, kThreads, smem, stream>>>(map, amap, a);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0; }

}  // namespace

// x: (batch, H, W, cp) int8; w: (co, kp) int8 packed; deq, bias: co float32;
// res: (batch * ho * wo, co) float32 or null; out32: the same shape float32
// or null; outq: the same shape int8 or null (at least one output). cp and
// co multiples of 8, kp a multiple of 32. instance: bit 1 selects 128
// output columns a tile (else 64); bit 2 loads A by im2col TMA in rows of
// 128 bytes, or 64 with bit 0 (cp a multiple of the row, kp = kh kw cp, pad
// and dil (k - 1) - pad in -128..127), else bit 0 selects 16-byte gathers
// (cp a multiple of 16; else 8-byte). x 16-byte aligned but for 8-byte
// gathers (8); w, res and out32 16-byte aligned, outq 4. Returns
// cudaGetLastError() after the launch.
extern "C" int int8_conv(const void* x, const void* w, const void* deq, const void* bias,
                         const void* res, void* out32, void* outq, float inv_sx, int batch,
                         int H, int W, int cp, int ho, int wo, int co, int kh, int kw, int stride,
                         int pad, int dil, int kp, int relu, void* stream, int instance) {
  const bool wide = instance & 2, tma = instance & 4, vec16 = (instance & 1) || tma;
  const int row = tma ? (instance & 1 ? 64 : 128) : 0;  // bytes of an im2col row
  if (batch < 0 || cp < 8 || cp % 8 || co < 8 || co % 8 || kp % 32 || kp < kh * kw * cp ||
      stride < 1 || dil < 1 || (!out32 && !outq) || instance < 0 || instance > 7 ||
      (vec16 && cp % 16) || !aligned(x, vec16 ? 16 : 8) || !aligned(w, 16) ||
      !aligned(res, 16) || !aligned(out32, 16) || !aligned(outq, 4))
    return (int)cudaErrorInvalidValue;
  if (tma && (cp % row || kp != kh * kw * cp || pad > 127 || dil * (kh - 1) - pad > 128 ||
              dil * (kw - 1) - pad > 128 || stride > 8))
    return (int)cudaErrorInvalidValue;
  // the gather table's offsets are int32 and its sentinel needs H, W < 32768 - pad
  if ((((long long)(kh - 1) * dil * W + (long long)(kw - 1) * dil) + 1) * cp >= (1ll << 31) ||
      H + pad >= 32768 || W + pad >= 32768 || (kh - 1) * dil >= 32768 || pad < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * ho * wo == 0) return (int)cudaSuccess;
  const Args a{static_cast<const int8_t*>(x), static_cast<const float*>(deq),
               static_cast<const float*>(bias), static_cast<const float*>(res),
               static_cast<float*>(out32), static_cast<int8_t*>(outq), inv_sx, batch, H, W, cp,
               ho, wo, co, kh, kw, stride, pad, dil, kp, relu, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tma && row == 64) return wide ? launch<128, 64>(w, a, s) : launch<64, 64>(w, a, s);
  if (tma) return wide ? launch<128, 128>(w, a, s) : launch<64, 128>(w, a, s);
  if (wide) return vec16 ? launch<128, 16>(w, a, s) : launch<128, 8>(w, a, s);
  return vec16 ? launch<64, 16>(w, a, s) : launch<64, 8>(w, a, s);
}

// ---------------------------------------------------------------------------
// int8_conv_grouped: the grouped convolution of a ResNeXt's 3x3
// ---------------------------------------------------------------------------
//
// Replaces the same XLA int8 convolution (flairtpu/models/quantize.py:
// 218-230, _quant_conv with feature_group_count = groups), reached from the
// encoder walk's grouped 3x3 (:122-124) of the resnext encoders
// (flairtpu/models/resnet.py:30-37, :192-222), with the same epilogue as
// the ungrouped entry point above, operation for operation: fma(acc, deq,
// b), the optional residual, ReLU, float32 and / or the next site's int8.
//
// Each output channel n of group n / cg sums over the cg input channels of
// its group only (a ResNeXt has as many output as input channels a group).
// Bound on an H100: 9 cg multiply-adds an output value against about 1
// byte of input and 1 (int8) or 5 (float32 too) bytes of output, so at the
// card's int8 rate (1,979 TOPS) every site of the resnext walk is bound by
// HBM bytes, 36 to 288 multiply-adds a byte.
//
// Design: s8 tensor cores (mma.sync m16n8k32, int32 sums, exact in any
// order: K * 127^2 < 2^31), the input of a band of output rows staged row
// by row in shared memory, each input row once.
// - The MMA. Rows (M) are 16 output pixels of one row; columns (N) 8 output
//   channels; K runs over one tap row (ky): kx = 0..2 by the channels of a
//   bundle, the smallest run of whole groups that is a multiple of 8
//   channels (cb = lcm(cg, 8): 2 groups at cg 4). K comes in 8-byte units,
//   unit t = kx * cb / 8 + (channels / 8); a k32 step holds units 4 s ..
//   4 s + 3, lane tig taking unit 4 s + tig (its a0 / a2 words, 8 bytes of
//   one pixel: one shared-memory load a row half); units past 3 cb / 8 read
//   the last unit again against zero weights. The weights (packed once a
//   site by ops/int8_conv.py, (bundles, 3, steps, cb / 8, 32 lanes) of
//   8-byte b0 / b1 pairs) are block-diagonal: zero where an output
//   channel's group does not own the input channel. Multiply-adds done /
//   useful: 2.67 at cg 4, 1.33 at cg 8 and 16, 1 at cg 32.
// - Blocks. A block owns a band of output rows of one image, a segment of
//   at most 128 of their columns (64 at stride 2, so a staged row stays
//   within 256 columns at any width) and a slab of 128 channels (whole
//   bundles). It walks down the band; the input rows it needs come one by
//   one into a ring in shared memory, depth output rows ahead of the row
//   it computes, so each input row of the band is read once and its copy
//   overlaps the rows before.
// - Staging, fast instances: one thread loads a row by one TMA box
//   (128 channels by the segment's columns, zeros outside the image), its
//   arrival counted on the slot's mbarrier, so no other thread spends an
//   instruction on copies. The box lands in TMA's 128-byte swizzle (chunk
//   q of column c at c * 128 + (q ^ (c & 7)) * 16): each lane's column
//   offset within a tile is constant, so the swizzle folds into its
//   per-lane offsets, and the 8 (16 at cg 32) bytes a lane reads hit
//   distinct banks across the warp (at cg 32, stride 1, with the tile's
//   rows taking pixels 0, 2, 4, 6, 1, 3, 5, 7: neighbouring pixels' chunk
//   pairs would collide).
// - Staging, the general instance: 16-byte cp.async by all threads, one
//   commit group an output row; a staged row is chunk-major (16-byte chunk
//   q of column c at q * cs + c, cs odd).
// - A step's rhythm (a step: rows_step output rows of the fast instances,
//   up to 4 where a row has few tiles, so the fixed costs below come once
//   a step; one row for the general one): the copies of the rows depth
//   ahead; the wait for the step's inputs (each thread on the slots'
//   barriers, or the copies and a block barrier); the MMAs and epilogue of
//   each row into one of two output tiles; one block barrier; the tile's
//   stores. The slots and laps roll on without a division. The fast
//   instances store the int8 tile by one TMA store a row (the tile is in
//   the 128-byte swizzle already), issued by one thread, which waits for
//   the step before's to have read their tile just before the next
//   barrier; the general one by 16-byte stores of every thread.
// - Warps. A warp owns 16 (cg 4, 8: two bundles, one 16-byte load a row
//   half), 16 or 32 of the slab's channels and keeps their weights in
//   registers for the whole band; it takes every 16-pixel tile of the
//   segment. The fast instances are compiled for cg in {4, 8, 16, 32} and
//   stride 1 or 2 at pad 1, dilation 1: every offset then folds to a
//   constant and no division runs past the block's set-up. The general
//   instance (CG 0) takes any other 3x3 (dilation, padding, other cg): its
//   warps walk (tile, n8) items and load the weights from L1 each step.
// - Epilogue. Each lane's sums are finished in registers (float32 and the
//   residual straight to and from global memory, 8 bytes a lane, only when
//   asked), with the conversions on the FMA pipes (small_int_to_float,
//   quantize_bits: the same bits); the walk's case (ReLU, int8 only) takes
//   lean_pair, about 9 instructions an output, with no bounds test inside
//   a whole tile. The int8 outputs go to a tile in shared memory (16-byte
//   chunks XOR-swizzled by pixel), then out as whole 16-byte lines of each
//   pixel's channels. An output costs instructions more than bytes: at 20
//   instructions an output, resnext50's 16 sites' 1.84 G outputs would
//   take longer to issue than their bytes take to move.
// - The grid. ops/int8_conv.py:grouped_plan picks the band (a cost of
//   waves x band rows with their halo), the copy depth (about 24 KB of a
//   block's input in flight) and the rows a step per site; a block is 256
//   threads (128 at cg 32, whose 72 weight registers a lane allow three
//   blocks an SM).

namespace {

// the fast instances' constants (CG 0: the general instance)
template <int CG>
struct Grouped {
  static constexpr int kCB = CG == 4 ? 8 : CG;  // channels a bundle
  static constexpr int kU = kCB / 8;            // 8-byte units a tap
  static constexpr int kT = 3 * kU;             // units a tap row (kw = 3)
  static constexpr int kS = (kT + 3) / 4;       // k32 steps a tap row
  static constexpr int kNJ = kCB / 8;           // n8 tiles a bundle
  static constexpr int kBW = kCB == 8 ? 2 : 1;  // bundles a warp
  static constexpr int kWarps = CG == 32 ? 4 : 8;
  static constexpr int kMinBlocks = CG == 32 ? 3 : 2;
  static constexpr int kMT = CG == 32 ? 1 : 2;  // 16-pixel tiles an item
  static_assert(kWarps * kBW * kCB == 128, "a slab is 128 channels");
};
template <>
struct Grouped<0> {
  static constexpr int kWarps = 8, kMinBlocks = 2;
};

constexpr int kGroupedSlab = 128;  // channels a block of the fast instances
constexpr int kGroupedMaxDepth = 8;

struct GroupedArgs {
  const int8_t* x;     // (B, H, W, Cp)
  const int2* w;       // (bundles, 3, steps, nj, 32) b0 / b1 pairs
  const float* deq;    // (Co,)
  const float* bias;   // (Co,)
  const float* res;    // (M, Co) or null
  float* out32;        // (M, Co) or null
  int8_t* outq;        // (M, Co) or null
  float inv_sx;
  int H, W, Cp, Ho, Wo, Co, stride, pad, dil, relu;
  int cb, u, steps, nj;  // the bundle: channels, units a tap, k32 steps a tap row, n8 tiles
  int slab, n_slabs, seg, n_segs, band, n_bands, depth, rows_step, ring, cols, cs, slot_bytes, osw,
      vec16;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n commit groups are in flight (n <= kGroupedMaxDepth)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    default: cp_async_wait<0>();
  }
}

// a TMA box of the (B, H, W, Cp) input: channels from c, columns from w
// (negative: zeros), row h of image n
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int w, int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n)
      : "memory");
}

// a TMA store of the output tile: 128 channels from c by the segment's
// pixels from w, of row h of image n (outside the tensor: dropped)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c, int w,
                                             int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(w), "r"(h), "r"(n)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's shared-memory writes ordered before later async-proxy
// reads (a TMA store's)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the last bulk store has read its tile
__device__ __forceinline__ void tma_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue's conversions on the FMA pipes: the conversion unit does 16
// a clock an SM, and three an output (int to float, rintf, float to int)
// would hold the kernel above its bytes (1.84 G outputs at resnext50's 16
// sites). Both give the conversion unit's bits.
// float(acc) for |acc| <= 2^22 (cg <= 16: |acc| <= 144 * 127^2), from the
// sum biased by the bits of 1.5 * 2^23 (the MMA's accumulators start at
// kSmallBias), whose unit in the last place is 1: 1.5 * 2^23 taken off,
// exactly
constexpr int kSmallBias = 0x4B400000;
__device__ __forceinline__ float small_int_to_float(int biased) {
  return __fsub_rn(__int_as_float(biased), 12582912.f);
}

// ReLU letting NaN pass in one instruction; -0 becomes +0, which quantizes
// to the same int8 (the int8-only epilogue's ReLU)
__device__ __forceinline__ float relu_nan(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;\n" : "=f"(r) : "f"(v));
  return r;
}

// quantize(v, inv) as the low byte of the result: clamping to [-127, 127]
// before rounding gives the same integer (the bounds are integers; NaN
// becomes -127 either way), and adding 1.5 * 2^23 rounds half to even as
// rintf does, leaving the integer in the low bits of the sum
__device__ __forceinline__ uint32_t quantize_bits(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// The walk's epilogue (ReLU, int8 out only) of two sums of one pixel,
// columns n and n + 1, into the output tile at dst
template <bool kSmall>
__device__ __forceinline__ void lean_pair(int d0, int d1, float2 dq, float2 bb, float inv,
                                          uint8_t* dst) {
  const float f0 = kSmall ? small_int_to_float(d0) : __int2float_rn(d0);
  const float f1 = kSmall ? small_int_to_float(d1) : __int2float_rn(d1);
  const float v0 = relu_nan(__fmaf_rn(f0, dq.x, bb.x)), v1 = relu_nan(__fmaf_rn(f1, dq.y, bb.y));
  *reinterpret_cast<uint16_t*>(dst) =
      static_cast<uint16_t>(__byte_perm(quantize_bits(v0, inv), quantize_bits(v1, inv), 0x0040));
}

// one n8 tile's sums of a 16-pixel tile (d: the segment's pixels px and px
// + 8, columns n and n + 1, n the lane's first output channel and cl its
// place in the slab; pix0 the output pixel of the segment's first, end its
// width): the epilogue, float32 out and int8 into the output tile. kSmall:
// the sums are within 2^22, biased by kSmallBias (small_int_to_float)
template <bool kSmall>
__device__ __forceinline__ void grouped_epilogue(const GroupedArgs& a, const int (&d)[4],
                                                 float2 dq, float2 bb, long long pix0, int px,
                                                 int end, int n, int cl, uint8_t* out_tile) {
#pragma unroll
  for (int h = 0; h < 2; ++h, px += 8) {
    if (px >= end) return;
    const float f0 = kSmall ? small_int_to_float(d[2 * h]) : __int2float_rn(d[2 * h]);
    const float f1 = kSmall ? small_int_to_float(d[2 * h + 1]) : __int2float_rn(d[2 * h + 1]);
    float v0 = __fmaf_rn(f0, dq.x, bb.x);
    float v1 = __fmaf_rn(f1, dq.y, bb.y);
    const long long o = (pix0 + px) * a.Co + n;
    if (a.res) {
      const float2 r = __ldcs(reinterpret_cast<const float2*>(a.res + o));
      v0 = __fadd_rn(v0, r.x);
      v1 = __fadd_rn(v1, r.y);
    }
    if (a.relu) {  // NaN passes, as jax.nn.relu
      v0 = v0 < 0.f ? 0.f : v0;
      v1 = v1 < 0.f ? 0.f : v1;
    }
    if (a.out32) *reinterpret_cast<float2*>(a.out32 + o) = make_float2(v0, v1);
    if (a.outq) {
      const uint32_t q = __byte_perm(quantize_bits(v0, a.inv_sx), quantize_bits(v1, a.inv_sx),
                                     0x0040);  // the two low bytes
      *reinterpret_cast<uint16_t*>(out_tile + px * a.slab + ((((cl >> 4) ^ (px & a.osw))) << 4) +
                                   (cl & 15)) = static_cast<uint16_t>(q);
    }
  }
}

template <int CG, int STRIDE>
__global__ void __launch_bounds__(32 * Grouped<CG>::kWarps, Grouped<CG>::kMinBlocks)
    int8_conv_grouped_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap ymap, const GroupedArgs a) {
  using G = Grouped<CG>;
  constexpr int kThreads = 32 * G::kWarps;
  constexpr bool kFast = CG > 0;
  extern __shared__ uint8_t gsm_raw[];
  // TMA's 128-byte swizzle wants the slots 1024-byte aligned
  uint8_t* gsm = gsm_raw + ((1024 - (smem_u32(gsm_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  // the block: slab, segment, band, image (slabs, then segments, then bands
  // of an image, side by side)
  int rest = blockIdx.x;
  const int slab_i = rest % a.n_slabs;
  rest /= a.n_slabs;
  const int seg_i = rest % a.n_segs;
  rest /= a.n_segs;
  const int band_i = rest % a.n_bands;
  const long long b = rest / a.n_bands;
  const int c0 = slab_i * a.slab, slab_valid = min(a.slab, a.Co - c0);
  const int ox0 = seg_i * a.seg, seg_w = min(a.seg, a.Wo - ox0), n_mt = (seg_w + 15) / 16;
  const int oy0 = band_i * a.band, rows = min(a.band, a.Ho - oy0);
  const int stride = kFast ? STRIDE : a.stride, dil = kFast ? 1 : a.dil;
  const int span = 2 * dil + 1;                      // input rows an output row reads
  const int in_rows = (rows - 1) * stride + span;    // input rows the band reads
  const int iy0 = oy0 * stride - a.pad, ix0 = ox0 * stride - a.pad;
  const int slot_bytes = a.slot_bytes;
  // two (rows_step, seg, slab) int8 output tiles, swizzled, in turns: a
  // step writes one while the step before's leaves from the other
  uint8_t* const tiles = gsm + a.ring * slot_bytes;
  const int tile_bytes = a.rows_step * a.seg * a.slab;
  const uint32_t ring0 = smem_u32(gsm);
  const uint32_t full0 = smem_u32(tiles + 2 * tile_bytes);  // fast: a barrier a slot
  const long long img_row0 = b * a.Ho;               // output rows before this image's

  if constexpr (kFast) {
    if (tid == 0) {
      for (int s = 0; s < a.ring; ++s) mbar_init(full0 + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // general staging: thread tid copies the 16-byte chunk sq of columns
  // scol0 + k sstep, chunk-major
  const int q16n = a.slab >> 4;
  const int sq = tid % q16n, scol0 = tid / q16n, sstep = kThreads / q16n;
  const int sbytes = 16 * sq < slab_valid ? min(16, slab_valid - 16 * sq) : 0;
  const uint32_t sdst0 = ring0 + sq * a.cs * 16;
  const int8_t* sx0 = a.x + c0 + 16 * sq + b * a.H * (long long)a.W * a.Cp;
  // the ring's slots go round without a division: a row's slot and the
  // count of its slot's fills so far
  auto next_slot = [&](int& slot, int& lap) {
    if (++slot == a.ring) slot = 0, ++lap;
  };
  int issued = 0, issue_slot = 0, issue_lap = 0;
  // stage input rows [issued, upto) of the band (fast: one TMA box a row by
  // thread 0; general: one commit group)
  auto issue_to = [&](int upto) {
    upto = min(upto, in_rows);
    if constexpr (kFast) {
      for (; issued < upto; ++issued, next_slot(issue_slot, issue_lap))
        if (tid == 0) {
          const int slot = issue_slot;
          const uint32_t bar = full0 + 8 * slot;
          mbar_expect_tx(bar, slot_bytes);
          tma_load_4d(ring0 + slot * slot_bytes, &xmap, bar, c0, ix0, iy0 + issued, (int)b);
        }
    } else {
      for (; issued < upto; ++issued, next_slot(issue_slot, issue_lap)) {
        const int iy = iy0 + issued;
        const uint32_t dst = sdst0 + issue_slot * slot_bytes;
        const bool row_in = (unsigned)iy < (unsigned)a.H && sbytes > 0;
        const int8_t* src_row = sx0 + (long long)iy * a.W * a.Cp;
        if (scol0 < sstep)
          for (int col = scol0; col < a.cols; col += sstep) {
            const int ix = ix0 + col;
            const bool ok = row_in && (unsigned)ix < (unsigned)a.W;
            cp_async<16>(dst + col * 16, ok ? src_row + (long long)ix * a.Cp : a.x,
                         ok ? sbytes : 0);
          }
      }
      cp_async_commit();
    }
  };
  for (int i = 0; i < a.depth; ++i) issue_to(i * stride + span);
  // fast: the rows whose barrier this thread has seen complete, the slot and
  // lap of the next
  int landed = 0, land_slot = 0, land_lap = 0;
  // the rows of output row i: landed for this thread (fast: its own wait on
  // the slots' barriers; general: its copies, then a block barrier)
  auto wait_rows = [&](int i) {
    if constexpr (kFast) {
      for (const int need = min(i * stride + span, in_rows); landed < need;
           ++landed, next_slot(land_slot, land_lap))
        mbar_wait(full0 + 8 * land_slot, land_lap & 1);
    } else {
      cp_async_wait_n(a.depth);
      __syncthreads();
    }
  };
  // the slots of output row i's three tap rows (i stride + ky dil), rolled
  // on by stride a row
  int tap_slot[3];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) tap_slot[ky] = (ky * dil) % a.ring;
  auto next_taps = [&]() {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
      for (int k = 0; k < stride; ++k)
        if (++tap_slot[ky] == a.ring) tap_slot[ky] = 0;
  };

  // the stores: thread tid writes vec-byte piece oq of pixels opx0 + k ostep
  const int ovec = a.vec16 ? 16 : 8, per_px = slab_valid / ovec;
  const int oq = tid % per_px, opx0 = tid / per_px, ostep = kThreads / per_px;
  auto store_row = [&](long long pix0, const uint8_t* out_tile) {
    if (a.outq && opx0 < ostep)
      for (int px = opx0; px < seg_w; px += ostep) {
        const int byte = oq * ovec;
        const uint8_t* src = out_tile + px * a.slab + ((((byte >> 4) ^ (px & a.osw))) << 4) +
                             (byte & 15);
        int8_t* dst = a.outq + (pix0 + px) * a.Co + c0 + byte;
        if (a.vec16)
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
        else
          *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
      }
  };

  if constexpr (kFast) {
    // this warp's bundles, their weights, deq and b, for the whole band
    constexpr int kS = G::kS, kNJ = G::kNJ, kBW = G::kBW, kCB = G::kCB, kU = G::kU;
    constexpr bool kSmall = CG <= 16, kPerm = CG == 32 && STRIDE == 1;
    constexpr int kRow = 128, kCol = STRIDE * kRow;  // a staged column; an output pixel's step
    const int cw0 = warp * kBW * kCB;  // the warp's first channel in the slab
    const int gb0 = c0 / kCB + warp * kBW;
    int2 bw[kBW][3][kS][kNJ];
    float2 dq[kBW][kNJ], bb[kBW][kNJ];
#pragma unroll
    for (int k = 0; k < kBW; ++k) {
      const bool valid = cw0 + k * kCB < slab_valid;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int s = 0; s < kS; ++s)
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
            bw[k][ky][s][j] = valid ? __ldg(a.w + ((((gb0 + k) * 3 + ky) * kS + s) * kNJ + j) * 32 +
                                            lane)
                                    : make_int2(0, 0);
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int n = c0 + cw0 + k * kCB + 8 * j + 2 * tig;
        dq[k][j] = valid ? __ldg(reinterpret_cast<const float2*>(a.deq + n)) : make_float2(0.f, 0.f);
        bb[k][j] = valid ? __ldg(reinterpret_cast<const float2*>(a.bias + n)) : make_float2(0.f, 0.f);
      }
    }
    // rows g and g + 8 of a tile: its pixels prow and prow + 8
    const int prow = kPerm ? ((g & 3) << 1 | (g >> 2)) : g;
    // this lane's A bytes in a staged row, k32 step s: unit t of the tap row
    // at column prow * STRIDE + kx, swizzled; a tile's and a row half's
    // columns are whole swizzle periods (multiples of 8) further
    int a_off[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int t = min(4 * s + tig, G::kT - 1), kx = t / kU, byte = cw0 + 8 * (t % kU);
      const int col = prow * STRIDE + kx;
      a_off[s] = col * kRow + (((byte >> 4) ^ (col & 7)) << 4) + (byte & 15);
    }
    const bool active = cw0 < slab_valid;
    // the walk's case: ReLU, int8 out only (lean_pair)
    const bool lean = a.outq && !a.res && !a.out32 && a.relu;
    using Acc = int[G::kMT][kBW * kNJ][4];
    const int row_bytes = a.seg * kGroupedSlab;     // one output row of the tile

    // an item's MMAs: tiles mt .. mt + kMT - 1 of the row whose tap rows
    // start at tap[0..2] bytes into the ring
    auto mma_item = [&](const int (&tap)[3], int mt, Acc& acc) {
#pragma unroll
      for (int m = 0; m < G::kMT; ++m)
#pragma unroll
        for (int r = 0; r < kBW * kNJ; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][r][e] = kSmall ? kSmallBias : 0;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          uint32_t af[G::kMT][kBW][4];
#pragma unroll
          for (int m = 0; m < G::kMT; ++m) {
            const uint8_t* p0 = gsm + tap[ky] + a_off[s] + 16 * (mt + m) * kCol;
            const uint8_t* p1 = p0 + 8 * kCol;
            if constexpr (kBW == 2) {
              const uint4 v0 = *reinterpret_cast<const uint4*>(p0);
              const uint4 v1 = *reinterpret_cast<const uint4*>(p1);
              af[m][0][0] = v0.x, af[m][0][1] = v1.x, af[m][0][2] = v0.y, af[m][0][3] = v1.y;
              af[m][1][0] = v0.z, af[m][1][1] = v1.z, af[m][1][2] = v0.w, af[m][1][3] = v1.w;
            } else {
              const uint2 v0 = *reinterpret_cast<const uint2*>(p0);
              const uint2 v1 = *reinterpret_cast<const uint2*>(p1);
              af[m][0][0] = v0.x, af[m][0][1] = v1.x, af[m][0][2] = v0.y, af[m][0][3] = v1.y;
            }
          }
#pragma unroll
          for (int m = 0; m < G::kMT; ++m)
#pragma unroll
            for (int k = 0; k < kBW; ++k)
#pragma unroll
              for (int j = 0; j < kNJ; ++j)
                mma_s8(acc[m][k * kNJ + j], af[m][k], bw[k][ky][s][j].x, bw[k][ky][s][j].y);
        }
      }
    };
    // an item's epilogue into its row of the output tile (row_tile; oy:
    // the output row)
    auto epilogue_item = [&](uint8_t* row_tile, int oy, int mt, const Acc& acc) {
#pragma unroll
      for (int m = 0; m < G::kMT; ++m) {
        if (mt + m >= n_mt) break;
        const int px = 16 * (mt + m) + prow;
        if (lean && px + 8 < seg_w) {
          // pixels px and px + 8 in; px & 7 == prow picks the tile's swizzle
          uint8_t* row_p = row_tile + px * kGroupedSlab;
#pragma unroll
          for (int k = 0; k < kBW; ++k)
#pragma unroll
            for (int j = 0; j < kNJ; ++j) {
              const int cl = cw0 + k * kCB + 8 * j + 2 * tig;
              uint8_t* dst = row_p + (((cl >> 4) ^ prow) << 4) + (cl & 15);
              const int(&d)[4] = acc[m][k * kNJ + j];
              lean_pair<kSmall>(d[0], d[1], dq[k][j], bb[k][j], a.inv_sx, dst);
              lean_pair<kSmall>(d[2], d[3], dq[k][j], bb[k][j], a.inv_sx, dst + 8 * kGroupedSlab);
            }
          continue;
        }
#pragma unroll
        for (int k = 0; k < kBW; ++k) {
          const int cl = cw0 + k * kCB;
          if (cl >= slab_valid) break;
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
            grouped_epilogue<kSmall>(a, acc[m][k * kNJ + j], dq[k][j], bb[k][j],
                                     (img_row0 + oy) * a.Wo + ox0, px, seg_w,
                                     c0 + cl + 8 * j + 2 * tig, cl + 8 * j + 2 * tig, row_tile);
        }
      }
    };

    // a step: rows_step output rows (the last of the band fewer), row by row
    for (int i = 0, step = 0; i < rows; i += a.rows_step, ++step) {
      const int nr = min(a.rows_step, rows - i);
      issue_to((i + nr - 1 + a.depth) * stride + span);
      wait_rows(i + nr - 1);
      uint8_t* const out_tile = tiles + (step & 1) * tile_bytes;
#pragma unroll 1
      for (int r = 0; r < nr; ++r, next_taps()) {
        int tap[3];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) tap[ky] = tap_slot[ky] * slot_bytes;
        uint8_t* const row_tile = out_tile + r * row_bytes;
        if (active)
#pragma unroll 1
          for (int mt = 0; mt < n_mt; mt += G::kMT) {
            Acc acc;
            mma_item(tap, mt, acc);
            epilogue_item(row_tile, oy0 + i + r, mt, acc);
          }
      }
      // the output tile is whole (its writes ordered before the bulk
      // stores' reads), the step before's stores have read the other tile,
      // and the ring slots of rows before the next step's are free
      if (a.outq) {
        fence_proxy_async();
        if (tid == 0 && step > 0) tma_store_read_wait();
      }
      __syncthreads();
      if (a.outq && tid == 0)
        for (int r = 0; r < nr; ++r)
          tma_store_4d(&ymap, smem_u32(out_tile + r * row_bytes), c0, ox0, oy0 + i + r, (int)b);
    }
    if (a.outq && tid == 0) tma_store_read_wait();  // the tiles stay until read
  } else {
    // the general instance: warps walk (16-pixel tile, n8 tile) items, the
    // weights from L1 each k32 step
    const int n8 = slab_valid >> 3, items = n_mt * n8, t_last = 3 * a.u - 1;
    const int chunk_bytes = a.cs * 16;
    for (int i = 0; i < rows; ++i, next_taps()) {
      issue_to((i + a.depth) * stride + span);
      wait_rows(i);
      const long long pix0 = (img_row0 + oy0 + i) * a.Wo + ox0;
      uint8_t* const out_tile = tiles + (i & 1) * tile_bytes;
      for (int it = warp; it < items; it += G::kWarps) {
        const int mt = it / n8, nt = it - mt * n8;
        const int bi = nt / a.nj, j = nt - bi * a.nj, gb = c0 / a.cb + bi;
        const int px = 16 * mt + g;
        int acc[4] = {0, 0, 0, 0};
        for (int ky = 0; ky < 3; ++ky) {
          const uint8_t* tap = gsm + tap_slot[ky] * slot_bytes;
          for (int s = 0; s < a.steps; ++s) {
            const int t = min(4 * s + tig, t_last), kx = t / a.u;
            const int byte = bi * a.cb + 8 * (t - kx * a.u);
            const uint8_t* p0 = tap + (byte >> 4) * chunk_bytes +
                                (px * stride + kx * dil) * 16 + (byte & 15);
            const uint2 v0 = *reinterpret_cast<const uint2*>(p0);
            const uint2 v1 = *reinterpret_cast<const uint2*>(p0 + 8 * stride * 16);
            const uint32_t af[4] = {v0.x, v1.x, v0.y, v1.y};
            const int2 w = __ldg(a.w + (((gb * 3 + ky) * a.steps + s) * a.nj + j) * 32 + lane);
            mma_s8(acc, af, w.x, w.y);
          }
        }
        const int cl = 8 * nt + 2 * tig, n = c0 + cl;
        grouped_epilogue<false>(a, acc, __ldg(reinterpret_cast<const float2*>(a.deq + n)),
                                __ldg(reinterpret_cast<const float2*>(a.bias + n)), pix0, px,
                                seg_w, n, cl, out_tile);
      }
      __syncthreads();
      store_row(pix0, out_tile);
    }
    cp_async_wait<0>();  // the last groups are empty; no copy outlives the block
  }
}

template <int CG, int STRIDE>
int launch_grouped(const CUtensorMap& xmap, const CUtensorMap& ymap, GroupedArgs a, int smem,
                   int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(int8_conv_grouped_kernel<CG, STRIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int8_conv_grouped_kernel<CG, STRIDE>
      <<<blocks, 32 * Grouped<CG>::kWarps, (size_t)smem, stream>>>(xmap, ymap, a);
  return (int)cudaGetLastError();
}

int gcd(int p, int q) { return q ? gcd(q, p % q) : p; }

}  // namespace

// x: (batch, H, W, cp) int8, 16-byte aligned, cp a multiple of 16; w: the
// packed weights of ops/int8_conv.py:pack_grouped, 8-byte aligned; deq,
// bias: co float32, 8-byte aligned; res: (batch * ho * wo, co) float32 or
// null; out32: the same shape float32 or null; outq: the same shape int8
// or null (at least one output); res, out32 and outq 8-byte aligned. co ==
// cp, cg = cp / groups a multiple of 4; a 3x3 kernel. instance: 0 the
// general one, else 1 + 2 log2(cg / 4) + stride - 1 (pad 1, dilation 1);
// slab: channels a block (128 for a fast instance, else a multiple of
// lcm(cg, 8, 16)); band: output rows a block; depth: output rows of input
// staged ahead (1-8); rows_step: output rows a step (1-4; 1 for the general
// one). The plan's shared-memory layout, which the entry point takes as it
// is (ops/int8_conv.py:grouped_layout): seg, a block's output columns (a
// multiple of 16); cols, the input columns a staged row holds; ring, its
// slots (input rows); slot_bytes, a slot (fast: a TMA box of slot_bytes /
// 128 columns by 128 channels; general: slab channels by slot_bytes / slab
// columns, an odd chunk stride); smem, the launch's dynamic shared memory,
// refused where it does not hold the ring, two output tiles and a barrier a
// slot after 1024 bytes of alignment, or is over the H100's 227 KB.
// Returns cudaGetLastError() after the launch, or an error where the
// arguments or the plan do not fit.
extern "C" int int8_conv_grouped(const void* x, const void* w, const void* deq, const void* bias,
                                 const void* res, void* out32, void* outq, float inv_sx,
                                 int batch, int H, int W, int cp, int ho, int wo, int co,
                                 int stride, int pad, int dil, int groups, int relu,
                                 void* stream, int instance, int slab, int band, int depth,
                                 int rows_step, int seg, int cols, int ring, int slot_bytes,
                                 int smem) {
  if (batch < 0 || H < 1 || W < 1 || ho < 0 || wo < 0 || groups < 1 || cp != co ||
      cp % groups || cp % 16 || (cp / groups) % 4 || stride < 1 || dil < 1 || pad < 0 ||
      (!out32 && !outq) || !aligned(x, 16) || !aligned(w, 8) || !aligned(deq, 8) ||
      !aligned(bias, 8) || !aligned(res, 8) || !aligned(out32, 8) || !aligned(outq, 8) ||
      instance < 0 || instance > 8 || band < 1 || depth < 1 || depth > kGroupedMaxDepth ||
      rows_step < 1 || rows_step > 4 || (!instance && rows_step != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * ho * wo == 0) return (int)cudaSuccess;
  const int cg = cp / groups, cb = cg * 8 / gcd(cg, 8), step16 = cb * 16 / gcd(cb, 16);
  const int fast_cg = instance ? 4 << ((instance - 1) / 2) : 0;
  const int fast_stride = instance ? 1 + (instance - 1) % 2 : 0;
  if (instance && (cg != fast_cg || stride != fast_stride || pad != 1 || dil != 1 ||
                   slab != kGroupedSlab))
    return (int)cudaErrorInvalidValue;
  if (slab < cb || slab % step16) return (int)cudaErrorInvalidValue;
  const int box_cols = slot_bytes / 128, cs = instance ? 0 : slot_bytes / slab;
  if (seg < 16 || seg % 16 || cols < 1 || ring < 1 || slot_bytes < 1 ||
      (instance ? slot_bytes % 1024 || box_cols < cols || box_cols > 256 || seg > 256
                : slot_bytes % slab || cs < cols || cs % 2 == 0))
    return (int)cudaErrorInvalidValue;
  const int q = slab / 16;
  const int osw = (q & -q) >= 8 ? 7 : (q & -q) - 1;  // XOR within the largest power of 2 dividing q
  const long long n_segs = (wo + seg - 1) / seg, n_bands = (ho + band - 1) / band;
  const long long n_slabs = (co + slab - 1) / slab, blocks = n_slabs * n_segs * n_bands * batch;
  if (smem < 1024 + (long long)ring * slot_bytes + 2ll * rows_step * seg * slab + 8ll * ring ||
      smem > 227 * 1024 || blocks > 0x7fffffff || (long long)H * W * cp >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap = {}, ymap = {};
  if (instance) {
    // (B, H, W, cp) uint8 in boxes of 128 channels by box_cols columns, and
    // the (B, ho, wo, co) int8 output in boxes of 128 channels by a
    // segment, both in the 128-byte swizzle
    const EncodeTiled encode = encode_tiled();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const cuuint64_t dims[4] = {(cuuint64_t)cp, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)cp, (cuuint64_t)cp * W, (cuuint64_t)cp * W * H};
    const cuuint32_t box[4] = {(cuuint32_t)kGroupedSlab, (cuuint32_t)box_cols, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, box,
               elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    if (outq) {
      if (!aligned(outq, 16)) return (int)cudaErrorInvalidValue;
      const cuuint64_t ydims[4] = {(cuuint64_t)co, (cuuint64_t)wo, (cuuint64_t)ho,
                                   (cuuint64_t)batch};
      const cuuint64_t ystrides[3] = {(cuuint64_t)co, (cuuint64_t)co * wo,
                                      (cuuint64_t)co * wo * ho};
      const cuuint32_t ybox[4] = {(cuuint32_t)kGroupedSlab, (cuuint32_t)seg, 1, 1};
      if (encode(&ymap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, outq, ydims, ystrides, ybox, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_NONE,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    }
  }
  const GroupedArgs a{static_cast<const int8_t*>(x), static_cast<const int2*>(w),
                      static_cast<const float*>(deq), static_cast<const float*>(bias),
                      static_cast<const float*>(res), static_cast<float*>(out32),
                      static_cast<int8_t*>(outq), inv_sx, H, W, cp, ho, wo, co, stride, pad, dil,
                      relu, cb, cb / 8, (3 * (cb / 8) + 3) / 4, cb / 8, slab, (int)n_slabs, seg,
                      (int)n_segs, band, (int)n_bands, depth, rows_step, ring, cols, cs,
                      slot_bytes, osw, co % 16 == 0 && aligned(outq, 16)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sm = smem, nb = (int)blocks;
  switch (instance) {
    case 1: return launch_grouped<4, 1>(xmap, ymap, a, sm, nb, s);
    case 2: return launch_grouped<4, 2>(xmap, ymap, a, sm, nb, s);
    case 3: return launch_grouped<8, 1>(xmap, ymap, a, sm, nb, s);
    case 4: return launch_grouped<8, 2>(xmap, ymap, a, sm, nb, s);
    case 5: return launch_grouped<16, 1>(xmap, ymap, a, sm, nb, s);
    case 6: return launch_grouped<16, 2>(xmap, ymap, a, sm, nb, s);
    case 7: return launch_grouped<32, 1>(xmap, ymap, a, sm, nb, s);
    case 8: return launch_grouped<32, 2>(xmap, ymap, a, sm, nb, s);
    default: return launch_grouped<0, 0>(xmap, ymap, a, sm, nb, s);
  }
}
