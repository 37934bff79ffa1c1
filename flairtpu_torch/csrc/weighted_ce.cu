// Weighted cross-entropy over per-pixel logits, its gradient, and the
// confusion matrix of the first-maximum argmax.
//
// Replaces what XLA fused around the loss of the train and eval steps on
// the TPU: flairtpu/train/loop.py:255-269 (_loss, torch's
// CrossEntropyLoss(weight=w) as a weighted mean of the NLL, the weights of
// weight-0 classes included), its VJP, and :307-310 / :399-400 with
// flairtpu/ops/confmat.py:19-41 (confusion_matrix of argmax(logits), rows =
// target).
//
// Forward, one pass over the float32 logits (N, K), K innermost:
//   logp_t = (l_t - max) - log(sum_c exp(l_c - max))
//   sum += -logp_t * w[t];  wsum += w[t];  cm[t][argmax_c l_c] += 1
//   loss = sum / max(wsum, 1e-8)                 (out[0]; out[1] = wsum)
// Backward:
//   dl_c = (softmax_c - [c == t]) * w[t] * (g / max(wsum, 1e-8))
// with g and wsum read from the card, so that no step waits on the host.
//
// Bound: bytes. The forward reads 4 N K + 4 N bytes (335.5 MB for a batch
// of 16 512 x 512 patches at K = 19) and does about 6 K operations a pixel;
// the backward reads as much and writes 4 N K.
//
// Design. A pixel's K logits are one run of 4 K bytes (76 at K = 19), so a
// thread that loads its own pixel sends a warp to 32 sectors 4 K bytes
// apart on each of K loads, and on each of K stores writes 4 bytes into
// each of them. Here the tiles are staged instead. A tile is kTile = 256
// pixels: its logits are one contiguous run of 1024 K bytes (19,456 at K =
// 19) and its targets one of 1 KB, both multiples of 16 bytes. A persistent
// grid (the card's SMs x the kernel's occupancy, weighted_ce_occupancy)
// walks the tiles b, b + grid, ...; thread 0 of each block keeps a ring of
// stages in flight with 1-D TMA bulk copies, each stage completed on its
// own mbarrier, so the next tiles arrive while this one is computed. A
// thread takes one pixel of the tile: it reads its row from shared memory
// once into registers (at odd K the 32 lanes' rows start in 32 banks; at
// even K two lanes share a bank), finds the first maximum (strict >, as
// jnp.argmax), the sum of exp(l - max) and the target's log-probability.
// The backward computes each exp once, multiplies it by w[t] g / sum,
// writes the row's gradient back over its logits in the same stage, and
// thread 0 stores the whole tile with one bulk store; a stage is refilled
// only once its store has been read (cp.async.bulk.wait_group.read), so the
// backward keeps one stage fewer of loads ahead. Every byte of dlogits is
// written once, in whole sectors. A tile that is not a whole 256 pixels
// (the last, where N is not a multiple of 256), or whose pointers are not
// 16-byte aligned, is loaded and stored by all threads with coalesced
// 4-byte accesses instead: slower, and the same result.
//
// Confusion counts go to the block's K x K int32 matrix in shared memory,
// keyed by target K + argmax, one shared atomic a pixel. With spatially
// coherent labels, once the model has learned, most of a warp's lanes add
// to one address; aggregating them first (the lanes grouped by key with
// __match_any_sync, or a warp whose lanes share one key adding 32 once)
// cost more than it saved on the H100, on random and coherent labels alike
// (ops/weighted_ce_phases.py's match_any and warp_uniform variants): the
// pass is bound by its bytes, and the atomics hide behind the copies. The
// block adds its matrix to the card's, which accumulates over a whole
// epoch, once, after its last tile. Counts are exact in any order.
//
// The forward is one launch. Each block folds its threads' float32 sums
// (warp shuffles, then its warps in order) into one (sum, wsum) pair and
// takes a ticket (an int32 counter, after __threadfence). The last block to
// arrive sums the pairs in double in a fixed order (each thread a strided
// set of blocks, then fixed shuffle trees and its warps in order), so the
// result does not depend on which block came last and no float atomic is
// used: two calls give the same bits. It writes the loss and weight sum and
// resets the counter to 0 for the next call on the stream; no block waits
// for another.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;  // pixels a tile, one a thread
constexpr int kMaxClasses = 32;
constexpr int kForwardStages = 3;   // tiles of the forward's ring
constexpr int kBackwardStages = 3;  // tiles of the backward's ring
constexpr int kCounterWords = 4;    // int32s before the forward's partials: the ticket, padding

static_assert(kTile == kThreads, "a thread takes one pixel of a tile");
static_assert(kTile % 4 == 0, "a tile's runs must be whole multiples of 16 bytes");

struct Args {
  const float* logits;
  const int* target;
  const float* weight;
  long long n;
  int k;
  // forward
  int* cm;
  int* ticket;
  float* partials;
  float* out;
  // backward
  const float* wsum;
  const float* grad;
  float* dlogits;
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

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
// fault (a copy that cannot land), and traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 1000000000ull) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// 1-D TMA: `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 1-D TMA from shared to global memory, committed as one bulk group of this
// thread
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's bulk groups are still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The ring's stage s: a tile's kTile K logits, then its kTile targets.
struct Ring {
  float* base;
  int k;
  __device__ float* logits(int s) const { return base + s * kTile * (k + 1); }
  __device__ int* target(int s) const {
    return reinterpret_cast<int*>(base + s * kTile * (k + 1) + kTile * k);
  }
};

// A block's tiles: blockIdx.x + i gridDim.x for i < mine. Tiles below
// bulk_loads (bulk_stores) move by TMA: the whole tiles, where the pointers
// are 16-byte aligned.
struct Walk {
  long long bulk_loads, bulk_stores;
  int mine;
  __device__ Walk(const Args& a, bool backward) {
    const long long tiles = (a.n + kTile - 1) / kTile, whole = a.n / kTile;
    bulk_loads = aligned16(a.logits) && aligned16(a.target) ? whole : 0;
    bulk_stores = backward && aligned16(a.dlogits) ? whole : 0;
    mine = blockIdx.x < tiles ? (int)((tiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  }
  __device__ static long long tile(int i) { return blockIdx.x + (long long)i * gridDim.x; }
};

// Thread 0: the copies of the block's i-th tile into stage i % S.
template <int S>
__device__ __forceinline__ void load_tile(const Args& a, const Ring& ring, uint64_t* full, int i) {
  const int s = i % S;
  const long long tile = Walk::tile(i);
  const uint32_t lbytes = kTile * a.k * 4, tbytes = kTile * 4, bar = smem_u32(&full[s]);
  mbar_expect_tx(bar, lbytes + tbytes);
  bulk_load(smem_u32(ring.logits(s)), a.logits + tile * kTile * a.k, lbytes, bar);
  bulk_load(smem_u32(ring.target(s)), a.target + tile * kTile, tbytes, bar);
}

// All threads: a tile's first `rem` pixels into a stage, 4 bytes a thread.
__device__ __forceinline__ void plain_load(const Args& a, float* sl, int* st, long long tile,
                                           int rem) {
  const float* src = a.logits + tile * kTile * a.k;
  for (int e = threadIdx.x; e < rem * a.k; e += kThreads) sl[e] = src[e];
  if (threadIdx.x < rem) st[threadIdx.x] = a.target[tile * kTile + threadIdx.x];
}

// The pixel's K logits from its row of the stage, with the first maximum
// and its index.
__device__ __forceinline__ void read_row(const float* row, int k, float (&x)[kMaxClasses],
                                         float& m, int& arg) {
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c)
    if (c < k) x[c] = row[c];
  m = x[0];
  arg = 0;
#pragma unroll
  for (int c = 1; c < kMaxClasses; ++c)
    if (c < k && x[c] > m) {  // strict: the first maximum wins
      m = x[c];
      arg = c;
    }
}

// Adds the lane's key (target K + argmax; -1: no pixel) to the block's
// counts, one shared atomic a pixel.
__device__ __forceinline__ void count(int* s_cm, int key) {
  if (key >= 0) atomicAdd(&s_cm[key], 1);
}

// The forward's end: the block's counts into the card's matrix, its sums
// into its pair of partials, its ticket; the last block to arrive combines
// the pairs and resets the ticket.
__device__ __forceinline__ void finish_forward(const Args& a, float sum, float wsum,
                                               const int* s_cm) {
  __shared__ float s_part[kWarps][2];
  __shared__ double s_total[kWarps][2];
  __shared__ int s_last;
  const int k = a.k, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  sum = warp_sum(sum);
  wsum = warp_sum(wsum);
  if (lane == 0) {
    s_part[warp][0] = sum;
    s_part[warp][1] = wsum;
  }
  __syncthreads();
  if (a.cm)
    for (int e = tid; e < k * k; e += kThreads)
      if (s_cm[e]) atomicAdd(&a.cm[e], s_cm[e]);
  if (tid == 0) {
    float bs = 0.f, bw = 0.f;
    for (int j = 0; j < kWarps; ++j) {
      bs += s_part[j][0];
      bw += s_part[j][1];
    }
    a.partials[2 * blockIdx.x] = bs;
    a.partials[2 * blockIdx.x + 1] = bw;
    __threadfence();
    s_last = atomicAdd(a.ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  double ds = 0.0, dw = 0.0;
  for (int b = tid; b < (int)gridDim.x; b += kThreads) {
    ds += __ldcg(&a.partials[2 * b]);
    dw += __ldcg(&a.partials[2 * b + 1]);
  }
  ds = warp_sum(ds);
  dw = warp_sum(dw);
  if (lane == 0) {
    s_total[warp][0] = ds;
    s_total[warp][1] = dw;
  }
  __syncthreads();
  if (tid == 0) {
    ds = dw = 0.0;
    for (int j = 0; j < kWarps; ++j) {
      ds += s_total[j][0];
      dw += s_total[j][1];
    }
    const float ws = (float)dw;
    a.out[0] = (float)ds / fmaxf(ws, 1e-8f);
    a.out[1] = ws;
    *a.ticket = 0;
  }
}

template <bool kBackward>
__global__ void __launch_bounds__(kThreads) weighted_ce_kernel(const Args a) {
  constexpr int S = kBackward ? kBackwardStages : kForwardStages;
  // tiles whose copies are started ahead of the one computed: the backward
  // refills a stage one tile after it started the stage's store
  constexpr int kAhead = kBackward && S > 1 ? S - 1 : S;
  extern __shared__ __align__(128) float ring_smem[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ float s_w[kMaxClasses];
  __shared__ int s_cm[kBackward ? 1 : kMaxClasses * kMaxClasses];

  const int k = a.k, tid = threadIdx.x;
  const Ring ring{ring_smem, k};
  const Walk w(a, kBackward);
  if (tid < k) s_w[tid] = a.weight[tid];
  if constexpr (!kBackward)
    for (int e = tid; e < k * k; e += kThreads) s_cm[e] = 0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kAhead && i < w.mine; ++i)
      if (Walk::tile(i) < w.bulk_loads) load_tile<S>(a, ring, full, i);
  }
  __syncthreads();
  const float g = kBackward ? a.grad[0] / fmaxf(a.wsum[0], 1e-8f) : 0.f;

  float sum = 0.f, wsum = 0.f;
  for (int i = 0; i < w.mine; ++i) {
    const long long tile = Walk::tile(i);
    const int s = i % S;
    float* sl = ring.logits(s);
    int* st = ring.target(s);
    const int rem = (int)(a.n - tile * kTile < kTile ? a.n - tile * kTile : kTile);
    if (tile < w.bulk_loads) {
      mbar_wait(smem_u32(&full[s]), (i / S) & 1);
    } else {
      if constexpr (kBackward) {
        if (tid == 0) bulk_wait_read<0>();  // the stage's last store has been read
        __syncthreads();
      }
      plain_load(a, sl, st, tile, rem);
      __syncthreads();
    }
    float x[kMaxClasses], m;
    int arg;
    if constexpr (!kBackward) {
      int key = -1;
      if (tid < rem) {
        read_row(sl + tid * k, k, x, m, arg);
        const int t = st[tid];
        float se = 0.f, lt = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxClasses; ++c)
          if (c < k) {
            se += expf(x[c] - m);
            if (c == t) lt = x[c];
          }
        const float wt = s_w[t];
        sum += -((lt - m) - logf(se)) * wt;
        wsum += wt;
        key = t * k + arg;
      }
      if (a.cm) count(s_cm, key);
      __syncthreads();  // every thread is done with stage s
      if (tid == 0 && i + S < w.mine && Walk::tile(i + S) < w.bulk_loads)
        load_tile<S>(a, ring, full, i + S);
    } else {
      const bool bulk_store_tile = tile < w.bulk_stores;
      if (tid < rem) {
        float* row = sl + tid * k;
        read_row(row, k, x, m, arg);
        const int t = st[tid];
        float se = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxClasses; ++c)
          if (c < k) {
            x[c] = expf(x[c] - m);
            se += x[c];
          }
        const float scale = s_w[t] * g, inv = scale / se;
#pragma unroll
        for (int c = 0; c < kMaxClasses; ++c)
          if (c < k) row[c] = c == t ? x[c] * inv - scale : x[c] * inv;
      }
      float* dst = a.dlogits + tile * kTile * k;
      if (bulk_store_tile) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // rows -> TMA
        __syncthreads();
        if (tid == 0) bulk_store(dst, smem_u32(sl), kTile * k * 4);
      } else {
        __syncthreads();
        for (int e = tid; e < rem * k; e += kThreads) dst[e] = sl[e];
        __syncthreads();
      }
      const int next = i + kAhead;
      if (tid == 0 && next < w.mine && Walk::tile(next) < w.bulk_loads) {
        // stage next % S last held tile next - S, whose store must have been read
        if (S > 1 && bulk_store_tile)
          bulk_wait_read<1>();
        else
          bulk_wait_read<0>();
        load_tile<S>(a, ring, full, next);
      }
    }
  }

  if constexpr (kBackward) {
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  } else {
    finish_forward(a, sum, wsum, s_cm);
  }
}

int ring_bytes(int k, bool backward) {
  return (backward ? kBackwardStages : kForwardStages) * kTile * (k + 1) * (int)sizeof(float);
}

template <bool kBackward>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  const int smem = ring_bytes(a.k, kBackward);
  cudaError_t err = cudaFuncSetAttribute(weighted_ce_kernel<kBackward>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  weighted_ce_kernel<kBackward><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kBackward>
cudaError_t occupancy(int k, int* blocks_per_sm) {
  const int smem = ring_bytes(k, kBackward);
  cudaError_t err = cudaFuncSetAttribute(weighted_ce_kernel<kBackward>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                       weighted_ce_kernel<kBackward>,
                                                       kThreads, smem);
}

}  // namespace

// The blocks of the forward (backward: 1) kernel that one SM holds at once
// at k classes, into *blocks_per_sm. Returns a cudaError_t.
extern "C" int weighted_ce_occupancy(int backward, int k, int* blocks_per_sm) {
  if (k < 1 || k > kMaxClasses || !blocks_per_sm) return (int)cudaErrorInvalidValue;
  return (int)(backward ? occupancy<true>(k, blocks_per_sm)
                        : occupancy<false>(k, blocks_per_sm));
}

// logits: (n, k) float32; target: n int32 in [0, k); weight: k float32; cm:
// (k, k) int32 added to (null: not counted); partials: 16-byte aligned
// scratch of 4 int32 (the first a ticket counter: zero, and left zero) and
// then 2 * blocks float32; out: 2 float32 (loss, weight sum). One launch of
// `blocks` blocks (the card's SMs x weighted_ce_occupancy, or fewer where
// there are fewer tiles of 256 pixels). Returns cudaGetLastError().
extern "C" int weighted_ce_forward(const void* logits, const void* target, const void* weight,
                                   void* cm, void* partials, int blocks, void* out,
                                   long long n, int k, void* stream) {
  if (n < 1 || k < 1 || k > kMaxClasses || blocks < 1 || !partials || !aligned16(partials) ||
      !out)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.logits = static_cast<const float*>(logits);
  a.target = static_cast<const int*>(target);
  a.weight = static_cast<const float*>(weight);
  a.n = n;
  a.k = k;
  a.cm = static_cast<int*>(cm);
  a.ticket = static_cast<int*>(partials);
  a.partials = reinterpret_cast<float*>(static_cast<int*>(partials) + kCounterWords);
  a.out = static_cast<float*>(out);
  return (int)launch<false>(a, blocks, static_cast<cudaStream_t>(stream));
}

// wsum: 1 float32, the forward's weight sum; grad: 1 float32, the loss's
// incoming gradient; dlogits: (n, k) float32. One launch of `blocks` blocks
// (the card's SMs x weighted_ce_occupancy, or fewer). Returns
// cudaGetLastError().
extern "C" int weighted_ce_backward(const void* logits, const void* target, const void* weight,
                                    const void* wsum, const void* grad, void* dlogits,
                                    int blocks, long long n, int k, void* stream) {
  if (n < 1 || k < 1 || k > kMaxClasses || blocks < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  a.logits = static_cast<const float*>(logits);
  a.target = static_cast<const int*>(target);
  a.weight = static_cast<const float*>(weight);
  a.n = n;
  a.k = k;
  a.wsum = static_cast<const float*>(wsum);
  a.grad = static_cast<const float*>(grad);
  a.dlogits = static_cast<float*>(dlogits);
  return (int)launch<true>(a, blocks, static_cast<cudaStream_t>(stream));
}
