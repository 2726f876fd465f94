// Marker points: per one-degree azimuth bin, the farthest road point that
// comes before the bin's first non-road point in scan order.
//
// Replaces urban_road_filter_tpu/ops/marker_scan.py:
// marker_points_unsorted_pallas (K10, its _marker_cand_kernel pass and the
// winner gather).  The reference walks its rings outward and each ring in
// azimuth order (lidar_segmentation.cpp:295-351); per bin it keeps the
// farthest road point, updating on a strictly greater distance (ties keep
// the first point), and stops the bin at its first non-road point.  The TPU
// streamed (ring, slot) blocks in order with the bins on sublanes and a
// running per-bin state.
//
// Scan order without sorting: the key (ring << 48) | (bits(alpha) << 16) |
// slot orders like the position in the azimuth-sorted traversal (see
// csrc/flood.cu, which computes kf, the per-bin key of the first non-road
// point, during the flood fill).  A slot is a candidate when it is road,
// has a valid azimuth, d2 > 0 and a key below kf[bin].
//
// What bounds it on Hopper: memory and launch latency.  Each pass reads
// alpha, d2 and label once (~3 MB per OS1-64 layout); the per-bin results
// are reduced in shared memory and flushed with a few global atomics per
// bin per block.
//
// Design.  Three launches:
//   1. max_kernel: per bin, the largest candidate distance (a positive
//      float's bits order like its value, so a 32-bit atomicMax);
//   2. winner_kernel: per bin, the smallest key among the candidates at
//      that distance (the first in scan order, the strict-> rule);
//   3. table_kernel: one thread per bin writes [exists, x, y, z, red, bin],
//      gathering the winner's coordinates at its (ring, slot) address.
// maxd and the winner keys are scratch the caller zeroes / fills with
// kNoKey.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 361;
constexpr int kRoad = 1;  // LABEL_ROAD
constexpr unsigned long long kNoKey = 0x7fffffffffffffffULL;

__device__ __forceinline__ unsigned long long marker_key(int ring, float a,
                                                         int slot) {
  return ((unsigned long long)ring << 48) |
         ((unsigned long long)__float_as_uint(a + 0.0f) << 16) |
         (unsigned long long)slot;
}

// Candidate test shared by both passes; sets *bin and *key.
__device__ __forceinline__ bool candidate(
    const float* __restrict__ alpha, const float* __restrict__ d2,
    const int* __restrict__ label, const int* __restrict__ counts,
    const int* __restrict__ num_rings,
    const unsigned long long* __restrict__ kf, int r, int s, int p, float* d,
    int* bin, unsigned long long* key) {
  if (s >= p || s >= counts[r] || r >= *num_rings) return false;
  const size_t at = (size_t)r * p + s;
  const float a = alpha[at];
  if (!(a >= 0.0f && a <= 360.0f) || label[at] != kRoad) return false;
  *d = d2[at];
  if (!(*d > 0.0f)) return false;
  *bin = (int)floorf(a);
  *key = marker_key(r, a, s);
  return *key < kf[*bin];
}

// Grid: (slot tiles, rings).
__global__ void max_kernel(const float* __restrict__ alpha,
                           const float* __restrict__ d2,
                           const int* __restrict__ label,
                           const int* __restrict__ counts,
                           const int* __restrict__ num_rings,
                           const unsigned long long* __restrict__ kf, int p,
                           unsigned int* __restrict__ maxd) {
  __shared__ unsigned int blk[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) blk[b] = 0u;
  __syncthreads();
  float d;
  int bin;
  unsigned long long key;
  if (candidate(alpha, d2, label, counts, num_rings, kf, blockIdx.y,
                blockIdx.x * blockDim.x + threadIdx.x, p, &d, &bin, &key))
    atomicMax(&blk[bin], __float_as_uint(d));
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (blk[b] != 0u) atomicMax(&maxd[b], blk[b]);
}

__global__ void winner_kernel(const float* __restrict__ alpha,
                              const float* __restrict__ d2,
                              const int* __restrict__ label,
                              const int* __restrict__ counts,
                              const int* __restrict__ num_rings,
                              const unsigned long long* __restrict__ kf, int p,
                              const unsigned int* __restrict__ maxd,
                              unsigned long long* __restrict__ win) {
  __shared__ unsigned long long blk[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) blk[b] = kNoKey;
  __syncthreads();
  float d;
  int bin;
  unsigned long long key;
  if (candidate(alpha, d2, label, counts, num_rings, kf, blockIdx.y,
                blockIdx.x * blockDim.x + threadIdx.x, p, &d, &bin, &key) &&
      __float_as_uint(d) == maxd[bin])
    atomicMin(&blk[bin], key);
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (blk[b] != kNoKey) atomicMin(&win[b], blk[b]);
}

__global__ void table_kernel(const float* __restrict__ x,
                             const float* __restrict__ y,
                             const float* __restrict__ z, int p,
                             const unsigned long long* __restrict__ kf,
                             const unsigned int* __restrict__ maxd,
                             const unsigned long long* __restrict__ win,
                             float* __restrict__ table) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= kBins) return;
  const bool exists = maxd[b] != 0u;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (exists) {
    const unsigned long long k = win[b];
    const size_t at = (size_t)(k >> 48) * p + (size_t)(k & 0xffffULL);
    px = x[at];
    py = y[at];
    pz = z[at];
  }
  float* row = table + (size_t)b * 6;
  row[0] = exists ? 1.0f : 0.0f;
  row[1] = px;
  row[2] = py;
  row[3] = pz;
  row[4] = kf[b] != kNoKey ? 1.0f : 0.0f;
  row[5] = (float)b;
}

}  // namespace

// table (361, 6) f32: [exists, x, y, z, red, bin].  Layout arrays are
// (rings, p) row-major; kf (361,) from urf_flood_labeled; maxd (361,) uint32
// zeroed and win (361,) uint64 filled with kNoKey by the caller.
extern "C" int urf_marker_points(const float* x, const float* y,
                                 const float* z, const float* alpha,
                                 const float* d2, const int* label,
                                 const int* counts, const int* num_rings,
                                 const unsigned long long* kf, int rings,
                                 int p, unsigned int* maxd,
                                 unsigned long long* win, float* table,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rings > 0 && p > 0) {
    const dim3 grid((p + 255) / 256, rings);
    max_kernel<<<grid, 256, 0, st>>>(alpha, d2, label, counts, num_rings, kf,
                                     p, maxd);
    winner_kernel<<<grid, 256, 0, st>>>(alpha, d2, label, counts, num_rings,
                                        kf, p, maxd, win);
  }
  table_kernel<<<(kBins + 127) / 128, 128, 0, st>>>(x, y, z, p, kf, maxd, win,
                                                    table);
  return (int)cudaGetLastError();
}
