// Batch ingest over (B, N) point streams: ROI mask, star keys and in-ROI
// count (K1), greedy ring discovery (K2), ring assignment (K3).
//
// Replaces three TPU kernels of urban_road_filter_tpu/ops/ingest_scan.py:
//   * ingest_prep_pallas (K1).  On the TPU the atan2 was an XLA op fed in
//     as a fifth stream, because Mosaic has no atan2; here the kernel takes
//     the float64 atan2 itself, rounded to f32 as the oracle bins.
//   * discover_rings_pallas (K2).  On the TPU whole scans sat in VMEM
//     (with a "wide" variant for 262k-point scans) and each of the <= 128
//     rounds swept the scan.  A scan of 131072-262144 floats does not fit
//     in shared memory, so here one block walks its scan in global memory
//     once, in input order, keeping only the ring table in shared memory.
//   * assign_rings_pallas (K3).  On the TPU an unrolled loop over the
//     rings compared every point with every ring; here a thread stops at
//     its point's first match.
//
// What bounds them on Hopper.  K1 and K3 are memory streams: K1 reads 12
// bytes and writes 9 per point, K3 reads 5 and writes 4, against a 512-byte
// table in shared memory.  K2 is latency-bound: one block per scan walks
// its points chunk by chunk, and a chunk that discovers a ring needs a
// block-wide minimum before the next ring can be tested.  With B >= 128
// scans the blocks fill the card's 132 SMs; at B = 1 one SM does the walk.
//
// Semantics (held bit-equal against the plain twins in ops/ingest.py):
//   * K1: the ROI compare chain of geometry.roi_mask_xyz with (x + y) + z
//     != 0 in that order; r_key = sqrt_rn(x*x + y*y), not contracted (the
//     build uses --fmad=false and the products are explicit); the sector
//     is the float64 atan2 rounded to f32, plus 2 pi in float64 when
//     negative and rounded again, times f32(STAR_KFI), truncated, mod 360.
//   * K2: ring k + 1's representative is the first point, in input order,
//     that is valid and matches none of rings 0..k (|alpha - a| <= tol).
//     A valid point whose alpha is NaN matches no ring, not even its own,
//     so it is taken again in every later round: the table fills with NaN
//     and the count becomes `rings`, as the oracle and the XLA loop give.
//     The angles are written in discovery order, padded with +inf; the
//     caller sorts the <= 128 of them.
//   * K3: the first ring, in ascending order, with |alpha - a| <= tol;
//     `rings` for an invalid point or when nothing matches.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kStarRep = 360;
constexpr int kMaxRings = 128;
constexpr int kPrepThreads = 256;
constexpr int kDiscoverThreads = 1024;
constexpr int kItems = 4;  // points per thread in a discovery chunk
constexpr int kChunk = kDiscoverThreads * kItems;
constexpr int kAssignThreads = 256;
constexpr double kTwoPi = 6.283185307179586;

struct Roi {
  float min_x, max_x, min_y, max_y, min_z, max_z;
};

// One thread per point; grid (ceil(n / kPrepThreads), B).  x/y/z are read
// through a scan stride and a point stride, so rows (B, N, C) and planar
// (3, B, N) input both arrive without a copy.  piece must be zeroed.
__global__ void ingest_prep_kernel(const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   const float* __restrict__ z,
                                   long long scan_stride,
                                   long long point_stride, int n, Roi roi,
                                   float kfi, int want_keys,
                                   bool* __restrict__ valid,
                                   int* __restrict__ fk,
                                   float* __restrict__ r_key,
                                   int* __restrict__ piece) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool v = false;
  if (i < n) {
    const long long off = (long long)b * scan_stride + i * point_stride;
    const float xx = x[off];
    const float yy = y[off];
    const float zz = z[off];
    v = (xx >= roi.min_x) & (xx <= roi.max_x) & (yy >= roi.min_y) &
        (yy <= roi.max_y) & (zz >= roi.min_z) & (zz <= roi.max_z) &
        (__fadd_rn(__fadd_rn(xx, yy), zz) != 0.0f);
    const long long o = (long long)b * n + i;
    valid[o] = v;
    if (want_keys) {
      int f = kStarRep;
      float r = INFINITY;
      if (v) {
        r = __fsqrt_rn(__fadd_rn(__fmul_rn(xx, xx), __fmul_rn(yy, yy)));
        float fi = __double2float_rn(atan2((double)yy, (double)xx));
        if (fi < 0.0f) fi = __double2float_rn((double)fi + kTwoPi);
        // A sector of 360 (fi a few ulps below 2 pi) is beam 0's.
        f = (int)__fmul_rn(fi, kfi) % kStarRep;
      }
      fk[o] = f;
      r_key[o] = r;
    }
  }
  const int cnt = __syncthreads_count(v);
  if (threadIdx.x == 0 && cnt > 0) atomicAdd(&piece[b], cnt);
}

// Block-wide minimum of v; every thread gets it.  Uses red[0..32].
__device__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = __reduce_min_sync(0xffffffffu, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? red[lane] : INT_MAX;
    w = __reduce_min_sync(0xffffffffu, w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  const int out = red[32];
  __syncthreads();  // red is reused by the next call
  return out;
}

// One block of kDiscoverThreads per scan.  Each chunk of kChunk points is
// held in registers (kItems per thread, neighbouring threads on
// neighbouring points); a point is open while it is valid and matches no
// ring found so far.  While the chunk has an open point, the first one in
// input order becomes the next ring and the open points are tested against
// it.  The table and the count k are the same in every thread.
__global__ void discover_kernel(const float* __restrict__ alpha,
                                const bool* __restrict__ valid, int n,
                                float tol, int rings,
                                float* __restrict__ angles,
                                int* __restrict__ count) {
  __shared__ float table[kMaxRings];
  __shared__ int red[33];
  const int b = blockIdx.x;
  const float* a_scan = alpha + (size_t)b * n;
  const bool* v_scan = valid + (size_t)b * n;
  int k = 0;
  for (int base = 0; base < n && k < rings; base += kChunk) {
    float a[kItems];
    bool open[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + j * kDiscoverThreads + threadIdx.x;
      open[j] = i < n && v_scan[i];
      a[j] = open[j] ? a_scan[i] : 0.0f;
      for (int m = 0; m < k && open[j]; ++m)
        if (fabsf(__fsub_rn(a[j], table[m])) <= tol) open[j] = false;
    }
    while (k < rings) {
      int mine = INT_MAX;
#pragma unroll
      for (int j = kItems - 1; j >= 0; --j)
        if (open[j]) mine = base + j * kDiscoverThreads + threadIdx.x;
      if (!__syncthreads_or(mine != INT_MAX)) break;
      const int first = block_min(mine, red);
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (base + j * kDiscoverThreads + threadIdx.x == first)
          table[k] = a[j];
      __syncthreads();
      const float na = table[k];
      ++k;
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (open[j] && fabsf(__fsub_rn(a[j], na)) <= tol) open[j] = false;
    }
  }
  for (int m = threadIdx.x; m < rings; m += blockDim.x)
    angles[(size_t)b * rings + m] = m < k ? table[m] : INFINITY;
  if (threadIdx.x == 0) count[b] = k;
}

// One thread per point; grid (ceil(n / kAssignThreads), B).  The scan's
// sorted table is staged in shared memory and read as a broadcast.
__global__ void assign_kernel(const float* __restrict__ alpha,
                              const bool* __restrict__ valid,
                              const float* __restrict__ angles, int n,
                              int rings, float tol, int* __restrict__ ring) {
  __shared__ float table[kMaxRings];
  const int b = blockIdx.y;
  for (int m = threadIdx.x; m < rings; m += blockDim.x)
    table[m] = angles[(size_t)b * rings + m];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)b * n + i;
  int r = rings;
  if (valid[o]) {
    const float a = alpha[o];
    for (int m = 0; m < rings; ++m)
      if (fabsf(__fsub_rn(a, table[m])) <= tol) {
        r = m;
        break;
      }
  }
  ring[o] = r;
}

}  // namespace

extern "C" int urf_ingest_prep(const float* x, const float* y, const float* z,
                               int b, int n, int scan_stride,
                               int point_stride, float min_x, float max_x,
                               float min_y, float max_y, float min_z,
                               float max_z, float kfi, int want_keys,
                               bool* valid, int* fk, float* r_key, int* piece,
                               void* stream) {
  if (b > 0 && n > 0) {
    const Roi roi = {min_x, max_x, min_y, max_y, min_z, max_z};
    const dim3 grid((n + kPrepThreads - 1) / kPrepThreads, b);
    ingest_prep_kernel<<<grid, kPrepThreads, 0, (cudaStream_t)stream>>>(
        x, y, z, scan_stride, point_stride, n, roi, kfi, want_keys, valid, fk,
        r_key, piece);
  }
  return (int)cudaGetLastError();
}

extern "C" int urf_discover_rings(const float* alpha, const bool* valid,
                                  int b, int n, float tol, int rings,
                                  float* angles, int* count, void* stream) {
  if (rings > kMaxRings) return (int)cudaErrorInvalidValue;
  if (b > 0)
    discover_kernel<<<b, kDiscoverThreads, 0, (cudaStream_t)stream>>>(
        alpha, valid, n, tol, rings, angles, count);
  return (int)cudaGetLastError();
}

extern "C" int urf_assign_rings(const float* alpha, const bool* valid,
                                const float* angles, int b, int n, int rings,
                                float tol, int* ring, void* stream) {
  if (rings > kMaxRings) return (int)cudaErrorInvalidValue;
  if (b > 0 && n > 0) {
    const dim3 grid((n + kAssignThreads - 1) / kAssignThreads, b);
    assign_kernel<<<grid, kAssignThreads, 0, (cudaStream_t)stream>>>(
        alpha, valid, angles, n, rings, tol, ring);
  }
  return (int)cudaGetLastError();
}
