// Blind-spot flood fill: blocked bits, then the road mask, fused with the
// marker stage's first pass or on its own.
//
// Replaces three TPU kernels of urban_road_filter_tpu/ops/flood_scan.py:
//   * blocked_pallas (K8): per (ring k, sweep start i in 0..361), is any
//     curb slot of ring k inside the forward window [i, i + w_k] or the
//     backward window [i - w_k, i]?  The TPU streamed (ring, slot) blocks
//     with the 362 starts on sublanes, in three 128-start windows skipped by
//     a min/max precheck.
//   * labeled_markerf_pallas (K9): a slot is road when a reachable start of
//     either sweep has it in its window; in the same pass, per one-degree
//     azimuth bin, the smallest (ring, alpha, slot) key over the slots that
//     are NOT road afterwards (the marker stage's "first non-road point in
//     scan order", lidar_segmentation.cpp:317-339).
//   * labeled_pallas (K12): the same road mask without the marker pass, as
//     an (R, P) bool mask; the azimuth-sharded path and the unfused
//     blind_spots(want_marker_f=False) run it.  K9 and K12 are one template
//     (labeled_kernel<kMarker>) behind two C entry points.
// Between the two, the caller turns blocked bits into reach (a (rings, 362)
// min-reduce over rings, ops/blind_spots.py:reach_of).
//
// Float semantics are those of the dense formulation (ops/blind_spots.py):
// integer starts as f32, window bounds i +- w_k rounded once in f32 (built
// with --fmad=false, nothing to contract here anyway), the exact-equality
// specials i == 360 - bz (forward hi -> 360) and i == bz (backward lo -> 0)
// for rings k >= 1 only, and NaN azimuths that never block and never
// become road (every compare with NaN is false).
//
// What bounds it on Hopper: neither memory (one read of alpha/label per
// slot, ~2 MB per OS1-64 layout) nor arithmetic in earnest.  K8 is bounded
// by the number of curb slots per ring, which is small: one block per ring
// compacts the ring's curb azimuths into shared memory (order does not
// matter to "any"), then one thread per start scans that short list.  K9
// and K12 give each (ring, slot) thread a loop over the 362 starts against
// the ring's reach bits in shared memory: ~190M predicated compares per
// layout, a few tens of microseconds of issue: compare-bound.  K9's key
// minimum is a 64-bit atomicMin per non-road slot into a shared per-bin
// table, flushed to the global table once per touched bin per block, so
// global atomics stay a few per bin.  K12 writes one byte per slot.
//
// Marker key: (ring << 48) | (bits(alpha) << 16) | slot.  alpha is in
// [0, 360] on this path, and a non-negative float's bits order like its
// value, so the key orders like (ring, alpha, slot): the position in the
// reference's azimuth-sorted traversal, ties in input order.  Requires
// rings < 2^15 and capacity <= 2^16 (checked by the caller).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStarts = 362;  // sweep starts 0..361 (361 used, one pad)
constexpr int kBins = 361;    // one-degree azimuth bins 0..360
constexpr int kCurb = 2;      // LABEL_CURB
constexpr int kRoad = 1;      // LABEL_ROAD
constexpr unsigned long long kNoKey = 0x7fffffffffffffffULL;

__device__ __forceinline__ unsigned long long marker_key(int ring, float a,
                                                         int slot) {
  // a + 0.0f turns a -0.0 into +0.0, which compares equal to it anyway.
  return ((unsigned long long)ring << 48) |
         ((unsigned long long)__float_as_uint(a + 0.0f) << 16) |
         (unsigned long long)slot;
}

// Grid: one block per ring, kStarts threads or more.
__global__ void blocked_kernel(const float* __restrict__ alpha,
                               const int* __restrict__ label,
                               const int* __restrict__ counts,
                               const float* __restrict__ w, int p, float bz,
                               bool* __restrict__ blocked_f,
                               bool* __restrict__ blocked_b) {
  extern __shared__ float curb_alpha[];  // [p]
  __shared__ int n_curb;
  const int r = blockIdx.x;
  if (threadIdx.x == 0) n_curb = 0;
  __syncthreads();
  const int n = min(counts[r], p);
  const size_t row = (size_t)r * p;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    if (label[row + s] != kCurb) continue;
    const float a = alpha[row + s];
    if (a == a) curb_alpha[atomicAdd(&n_curb, 1)] = a;  // NaN never blocks
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= kStarts) return;
  const float fi = (float)i;
  const float wk = w[r];
  const bool ge1 = r >= 1;
  const float hi = (ge1 && fi == 360.0f - bz) ? 360.0f : fi + wk;
  const float lo = (ge1 && fi == bz) ? 0.0f : fi - wk;
  bool bf = false, bb = false;
  const int m = n_curb;
  for (int c = 0; c < m; ++c) {
    const float a = curb_alpha[c];
    bf |= (a >= fi) && (a <= hi);
    bb |= (a >= lo) && (a <= fi);
  }
  blocked_f[(size_t)r * kStarts + i] = bf;
  blocked_b[(size_t)r * kStarts + i] = bb;
}

// Grid: (slot tiles, rings).  kMarker (K9): label_out and kf; without it
// (K12): road_out only, and label_in, num_rings, label_out, kf are unused.
template <bool kMarker>
__global__ void labeled_kernel(const float* __restrict__ alpha,
                               const int* __restrict__ label_in,
                               const int* __restrict__ counts,
                               const float* __restrict__ w,
                               const bool* __restrict__ reach_f,
                               const bool* __restrict__ reach_b,
                               const int* __restrict__ num_rings, int p,
                               float bz, int* __restrict__ label_out,
                               unsigned long long* __restrict__ kf,
                               bool* __restrict__ road_out) {
  __shared__ bool rf[kStarts];
  __shared__ bool rb[kStarts];
  __shared__ unsigned long long kf_blk[kMarker ? kBins : 1];
  const int r = blockIdx.y;
  for (int i = threadIdx.x; i < kStarts; i += blockDim.x) {
    rf[i] = reach_f[(size_t)r * kStarts + i];
    rb[i] = reach_b[(size_t)r * kStarts + i];
  }
  if constexpr (kMarker)
    for (int b = threadIdx.x; b < kBins; b += blockDim.x) kf_blk[b] = kNoKey;
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < p) {
    const size_t at = (size_t)r * p + s;
    const float a = alpha[at];
    const bool a_ok = s < counts[r] && a >= 0.0f && a <= 360.0f;
    bool road = false;
    if (a_ok) {
      const float wk = w[r];
      const bool ge1 = r >= 1;
      const float sp_f = 360.0f - bz;
      for (int i = 0; i < kStarts; ++i) {
        const float fi = (float)i;
        const float hi = (ge1 && fi == sp_f) ? 360.0f : fi + wk;
        const float lo = (ge1 && fi == bz) ? 0.0f : fi - wk;
        road |= (rf[i] && a >= fi && a <= hi) || (rb[i] && a >= lo && a <= fi);
      }
    }
    if constexpr (kMarker) {
      const int lab = label_in[at];
      const int out = (road && lab != kCurb) ? kRoad : lab;
      label_out[at] = out;
      if (a_ok && out != kRoad && r < *num_rings)
        atomicMin(&kf_blk[(int)floorf(a)], marker_key(r, a, s));
    } else {
      road_out[at] = road;
    }
  }
  if constexpr (kMarker) {
    __syncthreads();
    for (int b = threadIdx.x; b < kBins; b += blockDim.x)
      if (kf_blk[b] != kNoKey) atomicMin(&kf[b], kf_blk[b]);
  }
}

}  // namespace

// blocked_f / blocked_b: (rings, 362) bool.  alpha (rings, p) f32, label
// (rings, p) int32, counts (rings,) int32, w (rings,) f32.
extern "C" int urf_flood_blocked(const float* alpha, const int* label,
                                 const int* counts, const float* w, int rings,
                                 int p, float bz, bool* blocked_f,
                                 bool* blocked_b, void* stream) {
  const size_t smem = (size_t)p * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (rings > 0)
    blocked_kernel<<<rings, 384, smem, (cudaStream_t)stream>>>(
        alpha, label, counts, w, p, bz, blocked_f, blocked_b);
  return (int)cudaGetLastError();
}

// label_out (rings, p) int32: LABEL_ROAD where the flood reaches a non-curb
// slot, else label_in.  kf (361,) uint64: must hold kNoKey on entry; per
// bin, the smallest marker key of a non-road slot of a ring < num_rings.
extern "C" int urf_flood_labeled(const float* alpha, const int* label_in,
                                 const int* counts, const float* w,
                                 const bool* reach_f, const bool* reach_b,
                                 const int* num_rings, int rings, int p,
                                 float bz, int* label_out,
                                 unsigned long long* kf, void* stream) {
  const dim3 grid((p + 255) / 256, rings);
  if (rings > 0 && p > 0)
    labeled_kernel<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        alpha, label_in, counts, w, reach_f, reach_b, num_rings, p, bz,
        label_out, kf, nullptr);
  return (int)cudaGetLastError();
}

// road (rings, p) bool: a slot with a valid azimuth (slot < counts, alpha
// in [0, 360]) inside a reached window of either sweep (K12).
extern "C" int urf_flood_road(const float* alpha, const int* counts,
                              const float* w, const bool* reach_f,
                              const bool* reach_b, int rings, int p, float bz,
                              bool* road, void* stream) {
  const dim3 grid((p + 255) / 256, rings);
  if (rings > 0 && p > 0)
    labeled_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        alpha, nullptr, counts, w, reach_f, reach_b, nullptr, p, bz, nullptr,
        nullptr, road);
  return (int)cudaGetLastError();
}
