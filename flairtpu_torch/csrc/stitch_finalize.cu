// The last step of the average and max stitches, one launch per zone: the
// accumulated planes -> the packed uint8 class and prob planes of the zone.
//
// Replaces what XLA fused on the TPU at the end of
// DeviceZoneRunner._run_accumulate (flairtpu/zone/device_engine.py:216-220)
// and _run_max (:539), with the crop of :728-729 and :742-743:
//
//   mean (average, average_weights):
//     mean_k = acc_k / max(div, 1e-8); class = argmax_k mean_k (first
//     maximum); prob = round(255 * max_k mean_k)
//   max: class = best_c; prob = round(255 * best_p)
//
// computed only on the crop [oy, oy + h) x [ox, ox + w) of the padded
// planes, which is all the zone keeps, and written as one (2, h, w) uint8
// array (class plane, then prob plane), so one device-to-host copy brings
// both back. round is rintf, round half to even, as jnp.round.
//
// Bound: bytes (K + 1 floats read, 2 bytes written a pixel in mean mode).
// One thread a pixel; a warp's 32 pixels read one contiguous run of 32 K
// floats, class by class through L1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBW = 32, kBH = 8;

__global__ void __launch_bounds__(kBW * kBH)
finalize_mean(const float* __restrict__ acc, const float* __restrict__ div,
              uint8_t* __restrict__ out, int k, int wp, int oy, int ox, int h, int w) {
  const int x = blockIdx.x * kBW + threadIdx.x, y = blockIdx.y * kBH + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t pix = (size_t)(oy + y) * wp + ox + x;
  const float d = fmaxf(div[pix], 1e-8f);
  const float* a = acc + pix * k;
  float mx = -INFINITY;
  int am = 0;
  for (int c = 0; c < k; ++c) {
    const float m = __fdiv_rn(a[c], d);
    if (m > mx) {  // strict: the first maximum wins
      mx = m;
      am = c;
    }
  }
  out[(size_t)y * w + x] = (uint8_t)am;
  out[(size_t)h * w + (size_t)y * w + x] = (uint8_t)rintf(__fmul_rn(mx, 255.0f));
}

__global__ void __launch_bounds__(kBW * kBH)
finalize_max(const float* __restrict__ best_p, const uint8_t* __restrict__ best_c,
             uint8_t* __restrict__ out, int wp, int oy, int ox, int h, int w) {
  const int x = blockIdx.x * kBW + threadIdx.x, y = blockIdx.y * kBH + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t pix = (size_t)(oy + y) * wp + ox + x;
  out[(size_t)y * w + x] = best_c[pix];
  out[(size_t)h * w + (size_t)y * w + x] = (uint8_t)rintf(__fmul_rn(best_p[pix], 255.0f));
}

}  // namespace

// mode 0 (mean): a0 = acc (rows, wp, k) float32, a1 = div (rows, wp) float32;
// mode 1 (max): a0 = best_p (rows, wp) float32, a1 = best_c (rows, wp) uint8.
// out: (2, h, w) uint8, the class and prob of the crop whose top-left
// corner is (oy, ox) in the planes. Returns cudaGetLastError().
extern "C" int stitch_finalize(int mode, const void* a0, const void* a1, void* out, int k,
                               int wp, int oy, int ox, int h, int w, void* stream) {
  if (mode < 0 || mode > 1 || k < 1 || h < 1 || w < 1 || oy < 0 || ox < 0 || ox + w > wp)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kBW - 1) / kBW, (h + kBH - 1) / kBH), block(kBW, kBH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (mode == 0)
    finalize_mean<<<grid, block, 0, st>>>(static_cast<const float*>(a0),
                                          static_cast<const float*>(a1), o, k, wp, oy, ox, h, w);
  else
    finalize_max<<<grid, block, 0, st>>>(static_cast<const float*>(a0),
                                         static_cast<const uint8_t*>(a1), o, wp, oy, ox, h, w);
  return (int)cudaGetLastError();
}
