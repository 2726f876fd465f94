// Marker points: per one-degree azimuth bin, the farthest road point that
// comes before the bin's first non-road point in scan order.
//
// Replaces three TPU kernels of urban_road_filter_tpu/ops/marker_scan.py:
//   * marker_points_unsorted_pallas (K10, its _marker_cand_kernel pass and
//     the winner gather) on the unsorted layout, given kf;
//   * _marker_f_kernel (K13), pass 1 of the unsorted path on its own: kf,
//     per bin the key of the first non-road point, when the flood fill did
//     not fuse it (the unfused path, marker_points(kf=None));
//   * marker_state_pallas (K14, _marker_kernel): the per-bin state
//     [f, maxd, gstar, x, y, z] on the AZIMUTH-SORTED layout with a scan
//     position g = g_offset[ring] + slot, which the azimuth-sharded path
//     runs twice per wedge (g_offset and the global f floor f_init make
//     each wedge's state its share of the global one).
// The reference walks its rings outward and each ring in azimuth order
// (lidar_segmentation.cpp:295-351); per bin it keeps the farthest road
// point, updating on a strictly greater distance (ties keep the first
// point), and stops the bin at its first non-road point.  The TPU streamed
// (ring, slot) blocks in order with the bins on sublanes and a running
// per-bin state.  Blocks run in no order here, so each running state
// becomes an order-free reduction: "first in scan order" is a minimum of a
// key that orders like the scan position, "farthest" a maximum, and the
// strict-> tie rule the minimum key among the points at that maximum.
//
// Scan order on the unsorted layout (K10, K13): the key (ring << 48) |
// (bits(alpha) << 16) | slot orders like the position in the azimuth-sorted
// traversal (see csrc/flood.cu, whose K9 computes the same kf during the
// flood fill).  A slot is a K10 candidate when it is road, has a valid
// azimuth, d2 > 0 and a key below kf[bin].  On the sorted layout (K14) the
// scan position is g itself: it rises along the stream, so
//   f     = min(f_init, min g of the bin's non-road points),
//   maxd  = max d over road points with d > 0 and g < f,
//   gstar = min g among those at maxd,
// which is what the TPU's running state ends at.  g < 2^24 is exact in
// f32, where the TPU kept it; d = sqrtf(x*x + y*y), as marker_scan.py:86
// (no FMA: built with --fmad=false).  The f32 sentinel of "no non-road
// point yet" is 3e38 (marker_scan.py:44), passed in f_init.
//
// What bounds them on Hopper: memory and launch latency.  Each pass reads
// alpha, d2 (or x, y) and label once (~3 MB per OS1-64 layout); the per-bin
// results are reduced in shared memory and flushed with a few global
// atomics per bin per block.  Floats are reduced through their ordered
// integer images (a non-negative float's bits order like its value).
//
// Design.  K10 and K14 are chains of small launches behind one entry:
//   K10: max_kernel (per bin the largest candidate distance, a 32-bit
//        atomicMax), winner_kernel (the smallest key at that distance),
//        table_kernel (one thread per bin gathers the winner's x, y, z);
//   K13: first_nonroad_kernel (a 64-bit atomicMin per non-road slot);
//   K14: state_init_kernel, state_f_kernel (atomicMin of g per non-road
//        slot), state_max_kernel, state_win_kernel (atomicMin of
//        g << 32 | flat slot index, so the winner's address rides along),
//        state_table_kernel.
// K10's maxd and winner keys and K13's kf are scratch the caller zeroes /
// fills with kNoKey; K14 initialises its own scratch.

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

// K13.  Grid: (slot tiles, rings).  kf must hold kNoKey on entry.
__global__ void first_nonroad_kernel(const float* __restrict__ alpha,
                                     const int* __restrict__ label,
                                     const int* __restrict__ counts,
                                     const int* __restrict__ num_rings,
                                     int p,
                                     unsigned long long* __restrict__ kf) {
  __shared__ unsigned long long blk[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) blk[b] = kNoKey;
  __syncthreads();
  const int r = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < p && s < counts[r] && r < *num_rings) {
    const size_t at = (size_t)r * p + s;
    const float a = alpha[at];
    if (a >= 0.0f && a <= 360.0f && label[at] != kRoad)
      atomicMin(&blk[(int)floorf(a)], marker_key(r, a, s));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (blk[b] != kNoKey) atomicMin(&kf[b], blk[b]);
}

// K14.  The ordered integer image of a float: unsigned order == float order.
__device__ __forceinline__ unsigned int ordered(float v) {
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void state_init_kernel(const float* __restrict__ f_init,
                                  unsigned int* __restrict__ f_img,
                                  unsigned int* __restrict__ maxd,
                                  unsigned long long* __restrict__ win) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= kBins) return;
  f_img[b] = ordered(f_init[b]);
  maxd[b] = 0u;
  win[b] = kNoKey;
}

// A slot of the sorted layout with a valid azimuth on an active ring: sets
// *bin, *g (its scan position) and *road.
__device__ __forceinline__ bool state_slot(const float* __restrict__ alpha,
                                           const int* __restrict__ label,
                                           const int* __restrict__ counts,
                                           const int* __restrict__ num_rings,
                                           const int* __restrict__ goff,
                                           int r, int s, int p, int* bin,
                                           int* g, bool* road) {
  if (s >= p || s >= counts[r] || r >= *num_rings) return false;
  const size_t at = (size_t)r * p + s;
  const float a = alpha[at];
  if (!(a >= 0.0f && a <= 360.0f)) return false;
  *bin = (int)floorf(a);
  *g = goff[r] + s;
  *road = label[at] == kRoad;
  return true;
}

// A K14 candidate: road, d > 0 and g < f of its bin; sets *d.
__device__ __forceinline__ bool state_cand(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ alpha, const int* __restrict__ label,
    const int* __restrict__ counts, const int* __restrict__ num_rings,
    const int* __restrict__ goff, const unsigned int* __restrict__ f_img,
    int r, int s, int p, int* bin, int* g, float* d) {
  bool road;
  if (!state_slot(alpha, label, counts, num_rings, goff, r, s, p, bin, g,
                  &road) || !road)
    return false;
  const size_t at = (size_t)r * p + s;
  const float px = x[at];
  const float py = y[at];
  *d = sqrtf(px * px + py * py);
  return *d > 0.0f && (float)*g < unordered(f_img[*bin]);
}

__global__ void state_f_kernel(const float* __restrict__ alpha,
                               const int* __restrict__ label,
                               const int* __restrict__ counts,
                               const int* __restrict__ num_rings,
                               const int* __restrict__ goff, int p,
                               unsigned int* __restrict__ f_img) {
  __shared__ unsigned int blk[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) blk[b] = 0xffffffffu;
  __syncthreads();
  int bin, g;
  bool road;
  if (state_slot(alpha, label, counts, num_rings, goff, blockIdx.y,
                 blockIdx.x * blockDim.x + threadIdx.x, p, &bin, &g, &road) &&
      !road)
    atomicMin(&blk[bin], ordered((float)g));
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (blk[b] != 0xffffffffu) atomicMin(&f_img[b], blk[b]);
}

__global__ void state_max_kernel(const float* __restrict__ x,
                                 const float* __restrict__ y,
                                 const float* __restrict__ alpha,
                                 const int* __restrict__ label,
                                 const int* __restrict__ counts,
                                 const int* __restrict__ num_rings,
                                 const int* __restrict__ goff, int p,
                                 const unsigned int* __restrict__ f_img,
                                 unsigned int* __restrict__ maxd) {
  __shared__ unsigned int blk[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) blk[b] = 0u;
  __syncthreads();
  int bin, g;
  float d;
  if (state_cand(x, y, alpha, label, counts, num_rings, goff, f_img,
                 blockIdx.y, blockIdx.x * blockDim.x + threadIdx.x, p, &bin,
                 &g, &d))
    atomicMax(&blk[bin], __float_as_uint(d));
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (blk[b] != 0u) atomicMax(&maxd[b], blk[b]);
}

__global__ void state_win_kernel(const float* __restrict__ x,
                                 const float* __restrict__ y,
                                 const float* __restrict__ alpha,
                                 const int* __restrict__ label,
                                 const int* __restrict__ counts,
                                 const int* __restrict__ num_rings,
                                 const int* __restrict__ goff, int p,
                                 const unsigned int* __restrict__ f_img,
                                 const unsigned int* __restrict__ maxd,
                                 unsigned long long* __restrict__ win) {
  __shared__ unsigned long long blk[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) blk[b] = kNoKey;
  __syncthreads();
  int bin, g;
  float d;
  const int r = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (state_cand(x, y, alpha, label, counts, num_rings, goff, f_img, r, s, p,
                 &bin, &g, &d) &&
      __float_as_uint(d) == maxd[bin])
    atomicMin(&blk[bin], ((unsigned long long)(unsigned int)g << 32) |
                             (unsigned long long)((size_t)r * p + s));
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (blk[b] != kNoKey) atomicMin(&win[b], blk[b]);
}

__global__ void state_table_kernel(const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   const float* __restrict__ z,
                                   const unsigned int* __restrict__ f_img,
                                   const unsigned int* __restrict__ maxd,
                                   const unsigned long long* __restrict__ win,
                                   float* __restrict__ state) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= kBins) return;
  float* row = state + (size_t)b * 6;
  row[0] = unordered(f_img[b]);
  float md = 0.0f, gs = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
  if (maxd[b] != 0u) {
    const unsigned long long k = win[b];
    const size_t at = (size_t)(k & 0xffffffffULL);
    md = __uint_as_float(maxd[b]);
    gs = (float)(unsigned int)(k >> 32);
    px = x[at];
    py = y[at];
    pz = z[at];
  }
  row[1] = md;
  row[2] = gs;
  row[3] = px;
  row[4] = py;
  row[5] = pz;
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

// kf (361,) uint64: filled with kNoKey by the caller; per bin, the smallest
// marker key of a non-road slot (valid azimuth, ring < num_rings) (K13).
extern "C" int urf_marker_first_nonroad(const float* alpha, const int* label,
                                        const int* counts,
                                        const int* num_rings, int rings, int p,
                                        unsigned long long* kf, void* stream) {
  if (rings > 0 && p > 0)
    first_nonroad_kernel<<<dim3((p + 255) / 256, rings), 256, 0,
                           (cudaStream_t)stream>>>(alpha, label, counts,
                                                   num_rings, p, kf);
  return (int)cudaGetLastError();
}

// state (361, 6) f32: [f, maxd, gstar, x, y, z] per bin from the
// azimuth-sorted layout (K14).  goff (rings,) int32 scan-position offsets
// (g = goff[ring] + slot must stay below 2^24); f_init (361,) f32 floors.
// f_img, maxd (361,) uint32 and win (361,) uint64 are scratch.
extern "C" int urf_marker_state(const float* x, const float* y,
                                const float* z, const float* alpha,
                                const int* label, const int* counts,
                                const int* num_rings, const int* goff,
                                const float* f_init, int rings, int p,
                                unsigned int* f_img, unsigned int* maxd,
                                unsigned long long* win, float* state,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  state_init_kernel<<<(kBins + 127) / 128, 128, 0, st>>>(f_init, f_img, maxd,
                                                         win);
  if (rings > 0 && p > 0) {
    const dim3 grid((p + 255) / 256, rings);
    state_f_kernel<<<grid, 256, 0, st>>>(alpha, label, counts, num_rings,
                                         goff, p, f_img);
    state_max_kernel<<<grid, 256, 0, st>>>(x, y, alpha, label, counts,
                                           num_rings, goff, p, f_img, maxd);
    state_win_kernel<<<grid, 256, 0, st>>>(x, y, alpha, label, counts,
                                           num_rings, goff, p, f_img, maxd,
                                           win);
  }
  state_table_kernel<<<(kBins + 127) / 128, 128, 0, st>>>(x, y, z, f_img,
                                                          maxd, win, state);
  return (int)cudaGetLastError();
}
