// Star-shaped roadside search: the per-beam edge walk.
//
// Replaces urban_road_filter_tpu/ops/star_scan.py:star_scan_pallas (K4).
// The reference walks each of 360 radial beams outward
// (star_shaped_search.cpp:111-151): per step i >= 1 it forms the slope
// between consecutive points, folds it into a running mean and mean
// absolute deviation (NaN slopes are counted and skipped), and marks the
// first point whose slope exceeds a constant or an adaptive threshold,
// then breaks.  The TPU kernel turned the recurrences into segmented
// prefix sums over the (beam, radius)-sorted stream, because its grid has
// no cheap sequential walk.
//
// Input: the four streams of ops/star.py after its stable (beam, radius)
// sort: beam id (360 = the sink of dropped points, last), radius, z and
// the point's index.  Output: hp[b] = 1 + index of beam b's first
// triggering point, 0 where the beam has none.
//
// What bounds it on Hopper: the walk's dependent chain, not memory.  A
// beam holds a few hundred points of an OS1-64 scan; each step is two
// IEEE divisions and ~15 dependent float operations.  There are only 360
// independent walks, so most of the card idles.
//
// Design.  One block (one warp) per beam.  The warp finds the beam's
// segment by binary search in the sorted beam ids, then stages it in
// chunks into shared memory with coalesced loads, and lane 0 runs the
// literal recurrence of the reference on the staged chunk:
//   m   = i - (NaN slopes so far)
//   avg = (avg * (m - 1) + slp) * (1 / m)
//   dev = (dev * (m - 1) + |slp - avg|) * (1 / m)
//   trip: slp > slope_param, or i > dmin and
//         (slp*slp - avg*avg) * kdev * ((bx - ax) * kdist) > dev
// every operation rounded to f32 in that order (built with --fmad=false,
// so no multiply-add is contracted), which the plain twin in ops/star.py
// repeats op for op.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBeams = 360;
constexpr int kChunk = 1024;  // points staged per pass
constexpr int kWarp = 32;

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Grid: one 32-thread block per beam.
__global__ void star_walk_kernel(const int* __restrict__ fk,
                                 const float* __restrict__ r,
                                 const float* __restrict__ z,
                                 const int* __restrict__ pid, int n,
                                 float slope_param, float kdev, float kdist,
                                 int dmin, int* __restrict__ hp) {
  __shared__ float sr[kChunk];
  __shared__ float sz[kChunk];
  __shared__ int s_hit;
  const int b = blockIdx.x;
  const int lo = lower_bound(fk, n, b);
  const int hi = lower_bound(fk, n, b + 1);
  if (threadIdx.x == 0) s_hit = 0;

  // Walk state, meaningful in lane 0 only.
  float avg = 0.0f, dev = 0.0f, nan_count = 0.0f, bx = 0.0f, by = 0.0f;
  for (int base = lo; base < hi; base += kChunk) {
    const int len = min(kChunk, hi - base);
    __syncthreads();  // the previous chunk is consumed, s_hit is final
    if (s_hit != 0) break;
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      sr[t] = r[base + t];
      sz[t] = z[base + t];
    }
    __syncthreads();
    if (threadIdx.x != 0) continue;
    for (int t = 0; t < len; ++t) {
      const int i = base + t - lo;  // walk index within the beam
      if (i == 0) {
        bx = sr[t];
        by = sz[t];
        continue;
      }
      const float ax = bx, ay = by;
      bx = sr[t];
      by = sz[t];
      const float slp = (by - ay) / (bx - ax);
      if (isnan(slp)) {
        nan_count = nan_count + 1.0f;
      } else {
        const float m = (float)i - nan_count;
        const float inv_m = 1.0f / m;
        avg = avg * (m - 1.0f);
        avg = avg + slp;
        avg = avg * inv_m;
        dev = dev * (m - 1.0f);
        dev = dev + fabsf(slp - avg);
        dev = dev * inv_m;
      }
      const float lhs = (slp * slp - avg * avg) * kdev * ((bx - ax) * kdist);
      if (slp > slope_param || (i > dmin && lhs > dev)) {
        s_hit = pid[base + t] + 1;
        break;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) hp[b] = s_hit;
}

}  // namespace

// fk (n,) int32 ascending, r/z (n,) f32, pid (n,) int32: the beam-sorted
// streams.  hp (360,) int32.
extern "C" int urf_star_walk(const int* fk, const float* r, const float* z,
                             const int* pid, int n, float slope_param,
                             float kdev, float kdist, int dmin, int* hp,
                             void* stream) {
  star_walk_kernel<<<kBeams, kWarp, 0, (cudaStream_t)stream>>>(
      fk, r, z, pid, n, slope_param, kdev, kdist, dmin, hp);
  return (int)cudaGetLastError();
}
