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
// What bounds them on Hopper: launch latency, not bytes.  Each reads
// alpha, d2 (or x, y) and label once (~3 MB per OS1-64 layout, ~1 us of
// HBM time); the per-bin results are reduced in shared memory.  Floats
// are reduced through their ordered integer images (a non-negative
// float's bits order like its value).
//
// K10 design: one cooperative launch, the layout read once, no scratch to
// pre-fill, so a call is one device op (a pass per reduction would read
// the layout twice and need pre-filled global bins).
//   Pass 1.  Each block owns whole ring rows (grid-striding when R exceeds
//   the grid; rows >= num_rings are skipped) and reads counts[r] and
//   *num_rings once, kf once into shared memory.  It reads a row's first
//   counts[r] slots of alpha, d2 and label once, in aligned 16-byte quads
//   (4-byte loads where a quad leaves the array or the bases are not
//   16-byte aligned; slots outside the row's valid range are masked), up
//   to 4096 slots per chunk with alpha and d kept in registers.  Per chunk:
//   the per-bin max of d's bits (shared 32-bit atomicMax), a barrier, a
//   per-bin step that forgets the key of a bin whose max rose, a barrier,
//   then the per-bin min key among the chunk's candidates at that max
//   (shared 64-bit atomicMin).  Each block then writes all 361 of its
//   (maxd, key) partials, bin-major, to caller scratch that nothing
//   initialises: every entry is written.
//   Pass 2.  After a grid barrier (cooperative_groups::this_grid().sync(),
//   the grid capped at the co-resident block count), one warp per bin
//   merges the bin's partials, a lane per partial and then shuffles:
//   larger d wins, equal d keeps the smaller key.  That order is total, so
//   the merge is exact in any order and the table equals the twin's.  The
//   warp reads kf[bin], gathers the winner's x, y, z (ring k >> 48, slot
//   k & 0xffff) and writes the row [exists, x, y, z, red, bin].  (A warp
//   rather than one thread per bin: the merge reads G / 32 partials per
//   lane instead of G in a row.)
//   On an H100 (tools/profile_ring_kernels.py) the launch takes 7.1-7.3 us
//   at 64 x 4096, 64 x 2048 and 128 x 2048 alike, against a bound below
//   1 us: fixed costs (launch, two shared-memory passes with their
//   barriers per row, the grid barrier, the merge), not bytes, set it.
// K13 and K14 are chains of small launches behind one entry:
//   K13: first_nonroad_kernel (a 64-bit atomicMin per non-road slot);
//   K14: state_init_kernel, state_f_kernel (atomicMin of g per non-road
//        slot), state_max_kernel, state_win_kernel (atomicMin of
//        g << 32 | flat slot index, so the winner's address rides along),
//        state_table_kernel.
// K13's kf is filled with kNoKey by the caller; K14 initialises its own
// scratch.

#include <cooperative_groups.h>
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

// K10.
constexpr int kMarkThreads = 256;
constexpr int kMarkQuads = 4;  // quads per thread per chunk
constexpr int kMarkChunk = kMarkThreads * kMarkQuads;  // quads per chunk

struct MarkerArgs {
  const float* field[3];  // x, y, z
  const float* alpha;
  const float* d2;
  const int* label;
  const int* counts;
  const int* num_rings;
  const unsigned long long* kf;
  unsigned long long* part_k;  // (361, grid) bin-major
  unsigned int* part_d;        // (361, grid)
  float* table;
  int rings, p;
  bool vec;  // alpha, d2 and label are 16-byte aligned
};

// A K10 candidate: road, valid azimuth, d > 0 and a key below kf[bin].
__device__ __forceinline__ bool marker_cand(float a, float d, int l, int r,
                                            int s,
                                            const unsigned long long* kf) {
  return a >= 0.0f && a <= 360.0f && l == kRoad && d > 0.0f &&
         marker_key(r, a, s) < kf[(int)floorf(a)];
}

__device__ __forceinline__ bool better(unsigned int d, unsigned long long k,
                                       unsigned int bd,
                                       unsigned long long bk) {
  return d > bd || (d == bd && k < bk);
}

__global__ void __launch_bounds__(kMarkThreads)
    marker_points_kernel(MarkerArgs a) {
  __shared__ unsigned long long s_kf[kBins], s_key[kBins];
  __shared__ unsigned int s_d[kBins], s_prev[kBins];
  __shared__ int s_nr, s_cnt;
  const int tid = threadIdx.x;
  for (int b = tid; b < kBins; b += kMarkThreads) {
    s_kf[b] = a.kf[b];
    s_key[b] = kNoKey;
    s_d[b] = 0u;
    s_prev[b] = 0u;
  }
  if (tid == 0) s_nr = min(*a.num_rings, a.rings);
  __syncthreads();
  const int nr = s_nr;
  const size_t total = (size_t)a.rings * a.p;

  // Pass 1: this block's rows.
  for (int r = blockIdx.x; r < nr; r += gridDim.x) {
    __syncthreads();  // every thread has read the previous row's s_cnt
    if (tid == 0) s_cnt = min(max(a.counts[r], 0), a.p);
    __syncthreads();
    const int cnt = s_cnt;
    const size_t row = (size_t)r * a.p;
    // Quads of the flat arrays that hold slots [0, cnt) of this row.
    const size_t q_lo = row / 4;
    const int nq = cnt > 0 ? (int)((row + cnt - 1) / 4 - q_lo + 1) : 0;
    for (int c = 0; c < nq; c += kMarkChunk) {
      // All of the chunk's loads first, then the tests and the atomics.
      float av[kMarkQuads][4], dv[kMarkQuads][4];
      int lv[kMarkQuads][4];
#pragma unroll
      for (int u = 0; u < kMarkQuads; ++u) {
        const int qi = c + tid + u * kMarkThreads;
        const size_t e = 4 * (q_lo + (size_t)qi);
        if (qi < nq && a.vec && e + 4 <= total) {
          const float4 a4 = __ldg(reinterpret_cast<const float4*>(a.alpha) +
                                  e / 4);
          const float4 d4 = __ldg(reinterpret_cast<const float4*>(a.d2) +
                                  e / 4);
          const int4 l4 = __ldg(reinterpret_cast<const int4*>(a.label) +
                                e / 4);
          av[u][0] = a4.x, av[u][1] = a4.y, av[u][2] = a4.z, av[u][3] = a4.w;
          dv[u][0] = d4.x, dv[u][1] = d4.y, dv[u][2] = d4.z, dv[u][3] = d4.w;
          lv[u][0] = l4.x, lv[u][1] = l4.y, lv[u][2] = l4.z, lv[u][3] = l4.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = qi < nq && e + j >= row && e + j < row + cnt;
            av[u][j] = in ? __ldg(a.alpha + e + j) : -1.0f;
            dv[u][j] = in ? __ldg(a.d2 + e + j) : 0.0f;
            lv[u][j] = in ? __ldg(a.label + e + j) : 0;
          }
        }
      }
      unsigned int cand = 0u;  // bit 4u + j: element j of quad u
#pragma unroll
      for (int u = 0; u < kMarkQuads; ++u) {
        const int qi = c + tid + u * kMarkThreads;
        const size_t e = 4 * (q_lo + (size_t)qi);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long s = (long long)(e + j) - (long long)row;
          if (qi < nq && s >= 0 && s < cnt &&
              marker_cand(av[u][j], dv[u][j], lv[u][j], r, (int)s, s_kf)) {
            cand |= 1u << (4 * u + j);
            atomicMax(&s_d[(int)floorf(av[u][j])],
                      __float_as_uint(dv[u][j]));
          }
        }
      }
      __syncthreads();
      for (int b = tid; b < kBins; b += kMarkThreads)
        if (s_d[b] != s_prev[b]) {  // the max rose: its old key is stale
          s_prev[b] = s_d[b];
          s_key[b] = kNoKey;
        }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kMarkQuads; ++u) {
        const size_t e = 4 * (q_lo + (size_t)(c + tid + u * kMarkThreads));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!(cand >> (4 * u + j) & 1u)) continue;
          const int bin = (int)floorf(av[u][j]);
          if (__float_as_uint(dv[u][j]) == s_d[bin])
            atomicMin(&s_key[bin],
                      marker_key(r, av[u][j], (int)(e + j - row)));
        }
      }
      __syncthreads();
    }
  }
  for (int b = tid; b < kBins; b += kMarkThreads) {
    a.part_d[(size_t)b * gridDim.x + blockIdx.x] = s_d[b];
    a.part_k[(size_t)b * gridDim.x + blockIdx.x] = s_key[b];
  }
  cooperative_groups::this_grid().sync();

  // Pass 2: one warp per bin merges the partials and writes the row.
  const int lane = tid & 31;
  const int nwarps = gridDim.x * (kMarkThreads / 32);
  for (int b = (blockIdx.x * kMarkThreads + tid) >> 5; b < kBins;
       b += nwarps) {
    unsigned int bd = 0u;
    unsigned long long bk = kNoKey;
    for (int g = lane; g < (int)gridDim.x; g += 32) {
      const size_t at = (size_t)b * gridDim.x + g;
      const unsigned int d = __ldcg(a.part_d + at);
      const unsigned long long k = __ldcg(a.part_k + at);
      if (better(d, k, bd, bk)) {
        bd = d;
        bk = k;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned int d = __shfl_xor_sync(~0u, bd, o);
      const unsigned long long k = __shfl_xor_sync(~0u, bk, o);
      if (better(d, k, bd, bk)) {
        bd = d;
        bk = k;
      }
    }
    const bool exists = bd != 0u;
    float v = 0.0f;
    if (lane == 0) {
      v = exists ? 1.0f : 0.0f;
    } else if (lane <= 3) {
      const float* f = lane == 1 ? a.field[0]
                       : lane == 2 ? a.field[1] : a.field[2];
      if (exists)
        v = f[(size_t)(bk >> 48) * a.p + (size_t)(bk & 0xffffULL)];
    } else if (lane == 4) {
      v = s_kf[b] != kNoKey ? 1.0f : 0.0f;
    } else {
      v = (float)b;
    }
    if (lane < 6) a.table[(size_t)b * 6 + lane] = v;
  }
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

// K10.  table (361, 6) f32: [exists, x, y, z, red, bin].  Layout arrays
// are (rings, p) row-major; kf (361,) from urf_flood_labeled or
// urf_marker_first_nonroad.  scratch: 12 * 361 * scratch_blocks bytes,
// 8-byte aligned, uninitialised; the grid is min(rings, the co-resident
// block count), at least 1, and must not exceed scratch_blocks.  One
// cooperative launch; a refused launch returns its error.
extern "C" int urf_marker_points(const float* x, const float* y,
                                 const float* z, const float* alpha,
                                 const float* d2, const int* label,
                                 const int* counts, const int* num_rings,
                                 const unsigned long long* kf, int rings,
                                 int p, void* scratch, int scratch_blocks,
                                 float* table, void* stream) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices];  // co-resident blocks, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, marker_points_kernel, kMarkThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * sms;
  }
  const int grid = max(1, min(rings, resident[dev]));
  if (grid > scratch_blocks || rings < 0 || p < 0)
    return (int)cudaErrorInvalidValue;
  auto is16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  MarkerArgs a{{x, y, z}, alpha, d2, label, counts, num_rings, kf,
               static_cast<unsigned long long*>(scratch),
               reinterpret_cast<unsigned int*>(
                   static_cast<unsigned long long*>(scratch) +
                   (size_t)kBins * grid),
               table, rings, p, is16(alpha) && is16(d2) && is16(label)};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)marker_points_kernel,
                                    dim3(grid), dim3(kMarkThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
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
