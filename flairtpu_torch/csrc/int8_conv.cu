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
