// Squeeze-excite at an EfficientNet block's depthwise site, in two launches
// around the gate's two small convs, and in training the gate's gradient.
//
// Replaces what XLA fused on the TPU at flairtpu/models/efficientnet.py:
// 191-201: the depthwise conv's BatchNorm and SiLU (:191), the squeeze-excite
// mean in float32 (:193), and the sigmoid gate's multiply on the float32 SiLU
// value (:199), cast to the compute dtype at the project conv (:200-201).
// No Pallas kernel computed it; PyTorch would write the float32 SiLU map
// (4 bytes an element) and read it back twice.
//
//   squeeze: mean[b, c] = sum_p silu(y[b, p, c] * scale[c] + shift[c]) / HW
//   excite:  out[b, p, c] = bf16(silu(y[b, p, c] * scale[c] + shift[c]) * gate[b, c])
//   backward: dgate[b, c] = sum_p g[b, p, c] * silu(y[b, p, c] * scale[c] + shift[c])
//
// The backward replaces the excite's VJP that XLA fused into the train step
// (flairtpu/models/efficientnet.py:193-199 under jax.value_and_grad): the
// gradient of the gate, whose (B, C) float32 value the gate's small convs
// take back to the squeeze (ops/bn_train.py:se_site_backward). It is the
// squeeze with a second operand, g (the gradient of the excite's bf16
// output), on the same plan, grid and ordered combine, with the accurate
// sigmoid (silu_bn, the excite's arithmetic) and no division. Bound: bytes
// (4 an element read; 2 SFU-free expf-and-divide sigmoids cost about 40
// instructions an element, which at 4 bytes an element is about 2/3 of the
// card's float32 rate per HBM byte: both are near their limits together).
//
// y, out: (B, HW, C) bfloat16, NHWC (an NCHW channels_last tensor), C a
// multiple of 8, 16-byte aligned; scale, shift: C float32 (the inference
// BatchNorm); gate: (B, C) float32, the sigmoid of the small convs' output.
// Both read in 16-byte accesses, 8 channels a thread, neighbouring threads
// on neighbouring channel groups of a pixel and then of the next pixel, each
// thread issuing its loads of several pixels before it computes any of them.
//
// Excite: silu(v) = v * (1 / (1 + exp(-v))), every multiply, add and divide
// rounded on its own (no FMA contraction) and expf the accurate one, as the
// plain PyTorch version (ops/se_gate.py: v * torch.sigmoid(v)) computes it,
// so its bf16 output has the plain version's bits. Block (x, b) walks b's
// map with a grid-stride step that is a multiple of C / 8, so each thread
// keeps one channel group, with its scale, shift and gate in registers, for
// the whole walk. Bound: bytes (4 an element, read and write).
//
// Squeeze: its output is a float32 mean that the gate casts to the compute
// dtype, so it takes the sigmoid from the special-function units (SFU):
// v = fma(y, s, t), silu = v * rcp.approx(1 + ex2.approx(-log2(e) v)),
// added to the sum by an FMA: 4 float32 operations, 2 SFU operations and
// one integer unpack an element, where the accurate expf and rounded divide
// take about 40 instructions (PERF.md). The largest error is a few float32 ulps of
// each term. At 16 SFU results a clock on an SM, 2 an element take 80% of
// the time the 2 bytes an element take from HBM, and the SFU then set the
// pace with the loads (se_gate_phases): so half the channels (kNewtonRcp
// of each 8) take the reciprocal by Newton steps on the FMA pipe instead,
// 1.5 SFU and 7 float32 operations an element. (-log2(e) v costs one
// multiply: folding it into a second scale and shift pair would save none
// and hold 16 more registers a thread.)
//
// The squeeze's work is balanced over a grid of at most as many blocks as
// the card holds at once (ops/se_gate.py:squeeze_plan, from the occupancy
// se_squeeze_occupancy reports). A map's channels are cut into tiles of
// `group_tile` 8-channel groups (a divisor of C / 8, at most 256, as wide
// as keeps 90% of a block's threads busy: most maps take whole pixels, the
// widest a few tiles, whose pixels' rows another block reads at another
// time); a column is one (b, tile) over its HW pixels, and
// the batch's columns laid end to end make batch x tiles x HW units.
// Block i takes units [U i / G, U (i + 1) / G): a run of columns, the
// first and last in part. In each column it meets, each thread sums a
// fixed group and every `rows`-th pixel (rows = 256 / group_tile) of its
// share; the block's rows are summed in a fixed order in shared memory into
// its partial for the column, at row i + col (no two (block, column) pairs
// that meet share a row). The last block of a column to finish, by an
// atomic ticket, sums the column's partials in block order and divides by
// HW: the result does not depend on which block finished when. It sets the
// ticket back to 0, so the tickets are zero before and after every launch
// and no launch clears them (ops/se_gate.py keeps them a stream). A block
// that holds a whole column writes its mean at once, with no partial,
// fence or ticket. Each thread keeps kSqueezeUnroll 16-byte loads in
// flight, and its registers are capped so that an SM holds
// kSqueezeMinBlocks blocks (4 was no faster, PERF.md).

// MobileOne's squeeze-excite (flairtpu/models/mobileone.py:60-74, 110-112;
// XLA-fused on the TPU) takes two more instances. Its SE reads the float32
// branch sum v (csrc/branch_sum.cu's "sum" mode) before any activation:
//
//   squeeze (kSumMode): mean[b, c] = sum_p v[b, p, c] / HW
//   excite (se_excite_relu): out[b, p, c] = relu(v[b, p, c] * gate[b, c])
//
// The sum squeeze runs on the squeeze's plan, grid and ordered combine,
// with 8 float32 channels a thread (two 16-byte loads a pixel, kSumUnroll
// pixels in flight) and each add rounded on its own, so its mean is a
// fixed function of the plan: ops/se_gate.py:se_squeeze_sum_plain, given
// the plan, adds in the same order and has its bits. The ReLU excite
// multiplies once (__fmul_rn) and passes NaN, as torch.relu, into bf16 and,
// where the next block adds it as its skip, float32 (`outputs`: bit 1 bf16,
// bit 2 float32, csrc/branch_sum.cu's bits); the excite's walk and grid.
// Both bound by bytes: 4 an element read by the squeeze; 4 read and 2 or 6
// written by the excite.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroupTile = kThreads;
// channel groups the excite loads before it computes any of them: 16-byte
// loads in flight a thread
constexpr int kUnroll = 2;
// pixels the squeeze loads before it computes any of them
constexpr int kSqueezeUnroll = 4;
// of each 8 channels, how many the squeeze takes the reciprocal of by
// Newton steps on the FMA pipe rather than on the SFU
constexpr int kNewtonRcp = 4;
// the squeeze's blocks an SM at the least: its registers a thread are
// capped to fit them
constexpr int kSqueezeMinBlocks = 3;
constexpr float kNegLog2e = -1.4426950408889634f;
// the squeeze's instances: EfficientNet's mean of the SiLU, its gradient's
// sum, MobileOne's mean of a float32 map
enum SqueezeMode { kSiluMode = 0, kGradMode = 1, kSumMode = 2 };
// float32 pixels the sum squeeze loads before it sums any of them (two
// 16-byte loads each)
constexpr int kSumUnroll = 2;
// the ReLU excite's outputs: a bit each (csrc/branch_sum.cu's)
enum ExciteOutputs { kOutBf16 = 1, kOutF32 = 2 };

__device__ __forceinline__ float silu_bn(float y, float s, float t) {
  const float v = __fadd_rn(__fmul_rn(y, s), t);
  return __fmul_rn(v, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))));
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 1 / x for x in [1, 2^126]: a bit-trick seed (within 12%) and three Newton
// steps, 1 integer and 6 float32 operations
__device__ __forceinline__ float rcp_newton(float x) {
  float r = __int_as_float(0x7ef311c3 - __float_as_int(x));
#pragma unroll
  for (int k = 0; k < 3; ++k) r = fmaf(r, fmaf(-x, r, 1.f), r);
  return r;
}

// acc + silu(y * s + t), the sigmoid on the SFU (or its reciprocal by
// rcp_newton, where `newton`)
__device__ __forceinline__ float silu_bn_fast(float y, float s, float t, float acc,
                                              bool newton) {
  const float v = fmaf(y, s, t);
  if (newton) return fmaf(v, rcp_newton(1.f + ex2_approx(fminf(v * kNegLog2e, 126.f))), acc);
  return fmaf(v, rcp_approx(1.f + ex2_approx(v * kNegLog2e)), acc);
}

// 16 bytes of a map that the squeeze reads once: not kept in L1
__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
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

struct SqueezeArgs {
  const uint4* y;           // bf16 (kSiluMode, kGradMode), or float32 (kSumMode: two a group)
  const uint4* g;           // the backward's gradient (kGrad)
  const float* scale;
  const float* shift;
  float* partial;           // (blocks + batch * tiles - 1, group_tile * 8)
  unsigned int* tickets;    // (batch, tiles), zero before and after the launch
  float* mean;              // (batch, C)
  long long hw;
  long long units;          // batch * tiles * hw
  int channels;
  int group_tile;
  int tiles;
};

// the block whose units hold unit x
__device__ __forceinline__ long long block_of(long long x, long long units, long long blocks) {
  return ((x + 1) * blocks - 1) / units;
}

// acc[j] += silu of each of the 8 channels of w
__device__ __forceinline__ void squeeze8(const uint4 w, const float (&s)[8], const float (&sh)[8],
                                         float (&acc)[8]) {
  float v[8];
  unpack8(w, v);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = silu_bn_fast(v[j], s[j], sh[j], acc[j], j < kNewtonRcp);
}

// acc[j] += g * silu of each of the 8 channels of w (the accurate sigmoid)
__device__ __forceinline__ void grad8(const uint4 w, const uint4 gw, const float (&s)[8],
                                      const float (&sh)[8], float (&acc)[8]) {
  float v[8], gv[8];
  unpack8(w, v);
  unpack8(gw, gv);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = fmaf(gv[j], silu_bn(v[j], s[j], sh[j]), acc[j]);
}

// acc[j] += each of 8 float32 channels, two 16-byte words (the sum squeeze)
__device__ __forceinline__ void sum8(const uint4 w0, const uint4 w1, float (&acc)[8]) {
  const uint32_t u[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __uint_as_float(u[j]));
}

// The squeeze (kSiluMode: the mean of silu), the backward (kGradMode: the
// sum of g * silu, loads of two maps in flight, fewer pixels at once) and
// MobileOne's squeeze (kSumMode: the mean of a float32 map).
template <int kMode>
__global__ void __launch_bounds__(kThreads, kSqueezeMinBlocks)
    se_squeeze_kernel(const SqueezeArgs a) {
  constexpr bool kGrad = kMode == kGradMode;
  constexpr int kUnrollPix =
      kMode == kSumMode ? kSumUnroll : (kGrad ? (kSqueezeUnroll + 1) / 2 : kSqueezeUnroll);
  __shared__ float sums[kThreads * 8];
  __shared__ bool last;
  const int t = threadIdx.x, gt = a.group_tile, rows = kThreads / gt, width = gt * 8;
  const int c8 = a.channels / 8, g = t % gt, r = t / gt;
  const long long blocks = gridDim.x, i = blockIdx.x;
  const long long u1 = a.units * (i + 1) / blocks;
  for (long long u = a.units * i / blocks; u < u1;) {
    const long long col = u / a.hw, col_end = min(u1, (col + 1) * a.hw);
    const long long b = col / a.tiles;
    const int tile = (int)(col - b * a.tiles);
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    // this thread's pixels of the segment: p0 + r, p0 + r + rows, ...
    const long long p0 = u - col * a.hw + r;
    int count = r < rows && p0 < col_end - col * a.hw
                    ? (int)((col_end - col * a.hw - p0 + rows - 1) / rows) : 0;
    if constexpr (kMode == kSumMode) {
      if (count > 0) {
        const int c0 = (tile * gt + g) * 8;
        const long long step = 2LL * rows * c8;
        const uint4* v = a.y + 2 * ((b * a.hw + p0) * c8 + c0 / 8);
        for (; count >= kUnrollPix; count -= kUnrollPix, v += kUnrollPix * step) {
          uint4 w[2 * kUnrollPix];
#pragma unroll
          for (int k = 0; k < kUnrollPix; ++k) {
            w[2 * k] = load_once(v + k * step);
            w[2 * k + 1] = load_once(v + k * step + 1);
          }
#pragma unroll
          for (int k = 0; k < kUnrollPix; ++k) sum8(w[2 * k], w[2 * k + 1], acc);
        }
        for (; count > 0; --count, v += step) sum8(load_once(v), load_once(v + 1), acc);
      }
    } else if (count > 0) {
      const int c0 = (tile * gt + g) * 8;
      float s[8], sh[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = __ldg(a.scale + c0 + j);
        sh[j] = __ldg(a.shift + c0 + j);
      }
      const long long step = (long long)rows * c8;
      const long long at = (b * a.hw + p0) * c8 + c0 / 8;
      const uint4* y = a.y + at;
      if constexpr (kGrad) {
        const uint4* gp = a.g + at;
        for (; count >= kUnrollPix;
             count -= kUnrollPix, y += kUnrollPix * step, gp += kUnrollPix * step) {
          uint4 w[kUnrollPix], gw[kUnrollPix];
#pragma unroll
          for (int k = 0; k < kUnrollPix; ++k) {
            w[k] = load_once(y + k * step);
            gw[k] = load_once(gp + k * step);
          }
#pragma unroll
          for (int k = 0; k < kUnrollPix; ++k) grad8(w[k], gw[k], s, sh, acc);
        }
        for (; count > 0; --count, y += step, gp += step)
          grad8(load_once(y), load_once(gp), s, sh, acc);
      } else {
        for (; count >= kUnrollPix; count -= kUnrollPix, y += kUnrollPix * step) {
          uint4 w[kUnrollPix];
#pragma unroll
          for (int k = 0; k < kUnrollPix; ++k) w[k] = load_once(y + k * step);
#pragma unroll
          for (int k = 0; k < kUnrollPix; ++k) squeeze8(w[k], s, sh, acc);
        }
        for (; count > 0; --count, y += step) squeeze8(load_once(y), s, sh, acc);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sums[t * 8 + j] = acc[j];  // row r, column g * 8 + j
    __syncthreads();
    // the block's rows summed in order, a column of the tile a thread
    const long long first = block_of(col * a.hw, a.units, blocks);
    const long long n = block_of((col + 1) * a.hw - 1, a.units, blocks) - first + 1;
    float* mean = a.mean + b * a.channels + (long long)tile * width;
    for (int c = t; c < width; c += kThreads) {
      float total = 0.f;
      for (int rr = 0; rr < rows; ++rr) total = __fadd_rn(total, sums[rr * width + c]);
      if (n == 1)  // the block holds the whole column: the combine's 0 + total, at once
        mean[c] = kGrad ? total : __fdiv_rn(total, (float)a.hw);
      else
        a.partial[(i + col) * width + c] = total;
    }
    if (n > 1) {
      __threadfence();
      __syncthreads();
      if (t == 0) {
        last = atomicAdd(a.tickets + col, 1u) == (unsigned int)(n - 1);
        if (last) a.tickets[col] = 0u;  // every block of the column has counted
      }
      __syncthreads();
      if (last)
        for (int c = t; c < width; c += kThreads) {
          float total = 0.f;
          for (long long k = first; k < first + n; ++k)
            total = __fadd_rn(total, __ldcg(a.partial + (k + col) * width + c));
          mean[c] = kGrad ? total : __fdiv_rn(total, (float)a.hw);
        }
    }
    __syncthreads();  // the rows are read before the next column writes them
    u = col_end;
  }
}

struct ExciteArgs {
  const uint4* y;
  const float* scale;
  const float* shift;
  const float* gate;  // (B, C)
  uint4* out;
  long long hw;
  int channels;
  int lanes;          // threads a b walks with: a multiple of C / 8
};

__global__ void __launch_bounds__(kThreads) se_excite_kernel(const ExciteArgs a) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.lanes) return;
  const int b = blockIdx.y, c8 = a.channels / 8;
  const int g = lane % c8, c0 = g * 8;
  float s[8], sh[8], gate[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = __ldg(a.scale + c0 + j);
    sh[j] = __ldg(a.shift + c0 + j);
    gate[j] = __ldg(a.gate + (long long)b * a.channels + c0 + j);
  }
  const long long n = a.hw * c8, base = (long long)b * n;
  for (long long e = lane; e < n; e += kUnroll * (long long)a.lanes) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (e + u * (long long)a.lanes < n) w[u] = __ldg(a.y + base + e + u * (long long)a.lanes);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = e + u * (long long)a.lanes;
      if (at >= n) break;
      float v[8];
      unpack8(w[u], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(silu_bn(v[j], s[j], sh[j]), gate[j]);
      a.out[base + at] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                                    pack2(v[6], v[7]));
    }
  }
}

struct ExciteReluArgs {
  const float4* v;     // (B, HW, C) float32
  const float* gate;   // (B, C)
  uint4* out;          // bf16
  float4* out32;       // kOutF32
  long long hw;
  int channels;
  int lanes;           // threads a b walks with: a multiple of C / 8
};

// MobileOne's excite: relu(v * gate) into bf16 and, with kOutF32, float32;
// the walk of se_excite_kernel.
template <int kOut>
__global__ void __launch_bounds__(kThreads) se_excite_relu_kernel(const ExciteReluArgs a) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.lanes) return;
  const int b = blockIdx.y, c8 = a.channels / 8;
  const int c0 = (lane % c8) * 8;
  float gate[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) gate[j] = __ldg(a.gate + (long long)b * a.channels + c0 + j);
  const long long n = a.hw * c8, base = (long long)b * n;
  for (long long e = lane; e < n; e += kUnroll * (long long)a.lanes) {
    float4 w[2 * kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (e + u * (long long)a.lanes < n) {
        w[2 * u] = __ldg(a.v + 2 * (base + e + u * (long long)a.lanes));
        w[2 * u + 1] = __ldg(a.v + 2 * (base + e + u * (long long)a.lanes) + 1);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = e + u * (long long)a.lanes;
      if (at >= n) break;
      float v[8] = {w[2 * u].x, w[2 * u].y, w[2 * u].z, w[2 * u].w,
                    w[2 * u + 1].x, w[2 * u + 1].y, w[2 * u + 1].z, w[2 * u + 1].w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = __fmul_rn(v[j], gate[j]);
        v[j] = v[j] < 0.f ? 0.f : v[j];  // NaN passes, as torch.relu
      }
      a.out[base + at] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                                    pack2(v[6], v[7]));
      if constexpr ((kOut & kOutF32) != 0) {
        a.out32[2 * (base + at)] = make_float4(v[0], v[1], v[2], v[3]);
        a.out32[2 * (base + at) + 1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The excites' grid: as many blocks as fit on the card at once, shared
// out over the batch, each b walked by a whole number of channel-group rows.
template <typename Kernel>
cudaError_t excite_grid(Kernel kernel, int batch, long long hw, int channels, long long* per_b,
                        long long* lanes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int c8 = channels / 8;
  const long long n = hw * c8;
  *per_b = ((long long)sms * per_sm + batch - 1) / batch;
  const long long need = (n + kThreads - 1) / kThreads;
  if (*per_b > need) *per_b = need;
  *lanes = *per_b * kThreads / c8 * c8;
  if (*lanes < c8) {
    *lanes = c8;
    *per_b = (c8 + kThreads - 1) / kThreads;
  }
  return cudaSuccess;
}

}  // namespace

namespace {

template <int kMode>
int squeeze_launch(const void* g, const void* y, const void* scale, const void* shift,
                   void* partial, void* tickets, void* out, int batch, long long hw,
                   int channels, int group_tile, int blocks, void* stream) {
  constexpr bool kGrad = kMode == kGradMode;
  if (batch < 1 || hw < 1 || channels < 8 || channels % 8 || group_tile < 1 ||
      group_tile > kMaxGroupTile || (channels / 8) % group_tile || blocks < 1 ||
      !aligned16(y) || (kGrad && !aligned16(g)))
    return (int)cudaErrorInvalidValue;
  const int tiles = channels / 8 / group_tile;
  const SqueezeArgs a{static_cast<const uint4*>(y), static_cast<const uint4*>(g),
                      static_cast<const float*>(scale), static_cast<const float*>(shift),
                      static_cast<float*>(partial), static_cast<unsigned int*>(tickets),
                      static_cast<float*>(out), hw, (long long)batch * tiles * hw, channels,
                      group_tile, tiles};
  if (blocks > a.units) return (int)cudaErrorInvalidValue;
  se_squeeze_kernel<kMode><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// y: (batch, hw, channels) bf16; scale, shift: channels float32; partial:
// (blocks + batch * tiles - 1) x group_tile * 8 float32 scratch; tickets:
// batch x tiles uint32, zero (and left zero); mean: (batch, channels)
// float32, where tiles = channels / 8 / group_tile. group_tile divides
// channels / 8 and is at most 32; blocks is at most batch * tiles * hw
// (ops/se_gate.py:squeeze_plan). Returns cudaGetLastError() after the
// launch.
extern "C" int se_squeeze(const void* y, const void* scale, const void* shift, void* partial,
                          void* tickets, void* mean, int batch, long long hw, int channels,
                          int group_tile, int blocks, void* stream) {
  return squeeze_launch<kSiluMode>(nullptr, y, scale, shift, partial, tickets, mean, batch, hw,
                                   channels, group_tile, blocks, stream);
}

// The squeeze kernel's blocks an SM holds at once, into *per_sm.
extern "C" int se_squeeze_occupancy(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm,
                                                           se_squeeze_kernel<kSiluMode>,
                                                           kThreads, 0);
}

// g: (batch, hw, channels) bf16, the gradient of the excite's output; the
// other operands as se_squeeze's, dgate (batch, channels) float32 in place
// of the mean (blocks from squeeze_plan at se_backward_occupancy). Returns
// cudaGetLastError() after the launch.
extern "C" int se_backward(const void* g, const void* y, const void* scale, const void* shift,
                           void* partial, void* tickets, void* dgate, int batch, long long hw,
                           int channels, int group_tile, int blocks, void* stream) {
  return squeeze_launch<kGradMode>(g, y, scale, shift, partial, tickets, dgate, batch, hw,
                                   channels, group_tile, blocks, stream);
}

// The backward kernel's blocks an SM holds at once, into *per_sm.
extern "C" int se_backward_occupancy(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm,
                                                           se_squeeze_kernel<kGradMode>,
                                                           kThreads, 0);
}

// y, out: (batch, hw, channels) bf16; scale, shift: channels float32; gate:
// (batch, channels) float32. Returns cudaGetLastError() after the launch.
extern "C" int se_excite(const void* y, const void* scale, const void* shift, const void* gate,
                         void* out, int batch, long long hw, int channels, void* stream) {
  if (batch < 1 || hw < 1 || channels < 8 || channels % 8 || !aligned16(y) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  long long per_b = 0, lanes = 0;
  const cudaError_t err = excite_grid(se_excite_kernel, batch, hw, channels, &per_b, &lanes);
  if (err != cudaSuccess) return (int)err;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const ExciteArgs a{static_cast<const uint4*>(y), static_cast<const float*>(scale),
                     static_cast<const float*>(shift), static_cast<const float*>(gate),
                     static_cast<uint4*>(out), hw, channels, (int)lanes};
  se_excite_kernel<<<dim3((unsigned)per_b, batch), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// MobileOne's squeeze. v: (batch, hw, channels) float32, 16-byte aligned;
// partial, tickets, mean and the plan as se_squeeze's (blocks from
// squeeze_plan at se_squeeze_sum_occupancy). Returns cudaGetLastError()
// after the launch.
extern "C" int se_squeeze_sum(const void* v, void* partial, void* tickets, void* mean,
                              int batch, long long hw, int channels, int group_tile, int blocks,
                              void* stream) {
  return squeeze_launch<kSumMode>(nullptr, v, nullptr, nullptr, partial, tickets, mean, batch,
                                  hw, channels, group_tile, blocks, stream);
}

// The sum squeeze's blocks an SM holds at once, into *per_sm.
extern "C" int se_squeeze_sum_occupancy(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, se_squeeze_kernel<kSumMode>,
                                                           kThreads, 0);
}

// MobileOne's excite. v: (batch, hw, channels) float32; gate: (batch,
// channels) float32; out: (batch, hw, channels) bf16; out32: the same in
// float32 where outputs has kOutF32 (bit 2), else null; outputs has
// kOutBf16 (bit 1). Returns cudaGetLastError() after the launch.
extern "C" int se_excite_relu(const void* v, const void* gate, void* out, void* out32, int batch,
                              long long hw, int channels, int outputs, void* stream) {
  const bool f32 = (outputs & kOutF32) != 0;
  if (batch < 1 || batch > 65535 || hw < 1 || channels < 8 || channels % 8 ||
      (outputs != kOutBf16 && outputs != (kOutBf16 | kOutF32)) || !aligned16(v) ||
      !aligned16(out) || f32 != (out32 != nullptr) || (f32 && !aligned16(out32)))
    return (int)cudaErrorInvalidValue;
  long long per_b = 0, lanes = 0;
  cudaError_t err = f32 ? excite_grid(se_excite_relu_kernel<kOutBf16 | kOutF32>, batch, hw,
                                      channels, &per_b, &lanes)
                        : excite_grid(se_excite_relu_kernel<kOutBf16>, batch, hw, channels,
                                      &per_b, &lanes);
  if (err != cudaSuccess) return (int)err;
  const ExciteReluArgs a{static_cast<const float4*>(v), static_cast<const float*>(gate),
                         static_cast<uint4*>(out), static_cast<float4*>(out32), hw, channels,
                         (int)lanes};
  const dim3 grid((unsigned)per_b, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    se_excite_relu_kernel<kOutBf16 | kOutF32><<<grid, kThreads, 0, s>>>(a);
  else
    se_excite_relu_kernel<kOutBf16><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
