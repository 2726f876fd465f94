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
//     runs twice per wedge on the TPU (g_offset and the global f floor
//     f_init make each wedge's state its share of the global one); here
//     one launch per pass covers every wedge.
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
// K13 design: one launch, no fill, so a call is one device op (it was a
// kNoKey fill of kf, then a grid of (256-slot tiles, rings) blocks, most of
// them idle past counts[r], each ending in up to 361 global 64-bit atomics
// on the same 361 words).
//   Each block owns one ring row, with kFirstThreads slot threads, and
//   reads alpha and label of its slots, kFirstQuads aligned 16-byte quads
//   a thread a pass (4-byte loads at the row's ends or where the bases are
//   not 16-byte aligned).  (One row and two quads a thread timed best
//   against two rows a block and one to four quads a thread; PERF.md
//   section 6.)  The first pass's loads
//   are issued before counts[r] and num_rings arrive (its slots below p;
//   the fold masks them), later passes read only slots below counts[r].
//   A non-road slot with a valid azimuth, below counts[r] on a ring below
//   num_rings, has the key (ring << 48) | (bits(alpha) << 16) | slot; a
//   thread folds each run of one bin within a quad into one shared 64-bit
//   atomicMin (an azimuth-ordered row keeps neighbours in one bin), so the
//   block makes at most 361 global atomicMins into kf.
//   kf's initial value comes from the launch itself, as K9's does
//   (csrc/flood.cu), but from one extra warp per block, as K1's tickets do
//   (csrc/ingest.cu), so the slot threads never wait for it: its lane 0
//   reads the launch's first ticket and takes the block's ticket from
//   K13's own per-device counters, both in flight at once (only the block
//   holding the first ticket publishes the next, so the order of the two
//   reads does not matter).  In the block holding the first ticket the
//   warp writes kNoKey to kf, fences and publishes the next launch's first
//   ticket with a release store; in every other block it waits for that
//   (an acquire load; the first block took its ticket, so it is resident:
//   no deadlock).  A block barrier then orders the global atomics after
//   both.  The counters run on across launches, so K13 launches on one
//   device must not overlap on two streams (_build.TICKETED).  A minimum
//   is exact in any order, so kf equals the twin's.
// What bounds it: launch latency, the chain of the first block's ticket,
// its write of kf and the release its peers wait on.  It reads alpha and
// label of the active slots once (8 bytes a slot, ~0.5 MB for an OS1-64
// scan); its first pass may read slots past counts[r] besides.
// (tools/clock_flood_markers.py times the phases; PERF.md section 6 has
// the designs tried.)
//
// K14 design: one cooperative launch over any number of azimuth wedges (the
// sharded path's stacked layout: wedge w's ring k at row w * R + k), with
// no fill and no scratch that anything pre-fills, so a call is one device
// op, whatever the number of wedges.  Each wedge's active rings are cut
// into row groups (rings j, j + G, ... for group j of G), as many rows per
// group as one step of 512 threads x 2 quads holds; blocks grid-stride
// over the (wedge, group) pairs, the grid capped at the co-resident block
// count.  A thread holds 2 quads of the group's rows, 512 quads apart
// (alpha and label of the row's counted slots, 16-byte quads where
// aligned; azimuths outside [0, 360] or NaN are masked; x and y where the
// quad holds road), keeps them in registers, and makes one shared atomic
// per run of one bin in a quad (a sorted row's neighbours share a bin).
//   Phase 1.  Per group, the smallest g = goff[row] + slot of a non-road
//   slot per bin (atomicMin of its f32's ordered image in shared memory,
//   starting from f_init's image, 3e38's when none is given), written
//   whole to the group's partials.  Grid barrier.
//   Phase 2.  Each block merges its wedge's f per bin, the minimum of the
//   wedge's group partials (16-byte loads, the groups split over the
//   block's threads; the block of group 0 also writes it for phase 3),
//   then runs K10's chunk scheme on its group: a shared atomicMax of d's
//   bits over the
//   candidates (road, d > 0, g < f), a step that forgets the winner of a
//   bin whose max rose, and the min key g << 32 | flat slot at that max in
//   two 32-bit atomicMin passes (g's low word as a signed int, then the
//   flat slot among those at that g) in place of one 64-bit one.  When the
//   block has one group of one step, its slots stay in registers across
//   the barrier (x and y, which only phase 2 reads, are loaded before it,
//   so they arrive during it) and the layout is read once; otherwise it
//   reads its group again.  Partials written whole.  Grid barrier.
//   Phase 3.  8, 16 or 32 lanes (enough for the wedge's groups) per
//   (wedge, bin) merge the partials (larger d wins, equal d keeps the
//   smaller key), gather the winner's x, y, z and write the row [f, maxd,
//   gstar, x, y, z].
// Nothing outlives a launch: every scratch entry a launch reads it wrote
// before a grid barrier, so launches may overlap on other streams and a
// captured launch replays as it ran.
// What bounds it: latency, not bytes.  Its bytes (x, y, alpha, label)
// take ~1.6 us at 64 x 4096 and ~1.9 us per pass at the sharded path's
// 8 x 128 x 384; the launch, the two grid barriers (~1 us each), the
// chains of loads (counts, then the slots) and each phase's instruction
// fetch (every block runs the code once) take the rest
// (tools/clock_flood_markers.py times the phases).

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

// K13.
constexpr int kFirstThreads = 256;  // slot threads; one ticket warp more
constexpr int kFirstBlock = kFirstThreads + 32;
constexpr int kFirstQuads = 2;  // quads per slot thread per pass
constexpr int kFirstPass = kFirstThreads * kFirstQuads;  // quads a pass

// K13's per-device block tickets: every K13 block takes the next one as it
// starts, and the first ticket of the launch that initialises kf next.
__device__ unsigned long long g_mf_ticket = 0ULL;
__device__ unsigned long long g_mf_first = 0ULL;

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

struct FirstRow {
  const float* alpha;
  const int* label;
  size_t row;
  int r, t, cnt;
  bool vec;
};

// One pass of a thread's quads of its row: alpha and label of the row's
// slots [0, lim) (alpha -1 and label road elsewhere).  Quad qi holds slots
// 4 qi .. 4 qi + 3 of the row when the row starts on a quad; otherwise
// the quads are those of the flat arrays that cover the row.
__device__ __forceinline__ void first_load(const FirstRow& w, int c, int lim,
                                           float (&av)[kFirstQuads][4],
                                           int (&lv)[kFirstQuads][4]) {
  const size_t q_lo = w.row / 4;
#pragma unroll
  for (int u = 0; u < kFirstQuads; ++u) {
    const size_t e = 4 * (q_lo + (size_t)(c + w.t + u * kFirstThreads));
    if (w.vec && e >= w.row && e + 4 <= w.row + lim) {
      const float4 a4 = __ldg(reinterpret_cast<const float4*>(w.alpha) +
                              e / 4);
      const int4 l4 = __ldg(reinterpret_cast<const int4*>(w.label) + e / 4);
      av[u][0] = a4.x, av[u][1] = a4.y, av[u][2] = a4.z, av[u][3] = a4.w;
      lv[u][0] = l4.x, lv[u][1] = l4.y, lv[u][2] = l4.z, lv[u][3] = l4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = e + j >= w.row && e + j < w.row + lim;
        av[u][j] = in ? __ldg(w.alpha + e + j) : -1.0f;
        lv[u][j] = in ? __ldg(w.label + e + j) : kRoad;
      }
    }
  }
}

// Folds a pass into the block's shared minima: the row's non-road slots
// below cnt with a valid azimuth, one atomicMin per run of one bin within
// a quad.
__device__ __forceinline__ void first_fold(const FirstRow& w, int c,
                                           const float (&av)[kFirstQuads][4],
                                           const int (&lv)[kFirstQuads][4],
                                           unsigned long long* s_key) {
  const size_t q_lo = w.row / 4;
#pragma unroll
  for (int u = 0; u < kFirstQuads; ++u) {
    const size_t e = 4 * (q_lo + (size_t)(c + w.t + u * kFirstThreads));
    int run_bin = -1;
    unsigned long long run = kNoKey;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = av[u][j];
      const long long s = (long long)(e + j) - (long long)w.row;
      if (s >= w.cnt || !(v >= 0.0f && v <= 360.0f) || lv[u][j] == kRoad)
        continue;
      const int bin = (int)floorf(v);
      const unsigned long long k = marker_key(w.r, v, (int)s);
      if (bin == run_bin) {
        run = min(run, k);
      } else {
        if (run_bin >= 0) atomicMin(&s_key[run_bin], run);
        run_bin = bin;
        run = k;
      }
    }
    if (run_bin >= 0) atomicMin(&s_key[run_bin], run);
  }
}

__global__ void __launch_bounds__(kFirstBlock)
    first_nonroad_kernel(const float* __restrict__ alpha,
                         const int* __restrict__ label,
                         const int* __restrict__ counts,
                         const int* __restrict__ num_rings, int rings, int p,
                         bool vec, unsigned long long* __restrict__ kf) {
  __shared__ unsigned long long s_key[kBins];
  const int tid = threadIdx.x;
  for (int b = tid; b < kBins; b += kFirstBlock) s_key[b] = kNoKey;
  __syncthreads();

  if (tid >= kFirstThreads) {
    // The ticket warp.  Which ticket is the launch's first does not depend
    // on the order of the two reads (only the block holding it publishes
    // the next one), so both are in flight at once.
    const int lane = tid - kFirstThreads;
    unsigned long long ticket = 0ULL, first_ticket = 0ULL;
    if (lane == 0) {
      first_ticket = load_relaxed(&g_mf_first);
      ticket = atomicAdd(&g_mf_ticket, 1ULL);
    }
    ticket = __shfl_sync(~0u, ticket, 0);
    first_ticket = __shfl_sync(~0u, first_ticket, 0);
    const bool first = ticket == first_ticket;
    if (first) {  // kf's initial value, before any block's atomics
      for (int b = lane; b < kBins; b += 32) kf[b] = kNoKey;
      __threadfence();
      __syncwarp();
      if (lane == 0) store_release(&g_mf_first, ticket + gridDim.x);
    } else if (lane == 0) {
      // Wait (rarely long: the first block initialises kf as it starts)
      // until kf holds its initial value.
      while (load_acquire(&g_mf_first) <= ticket) {
      }
    }
  } else {
    // The slot threads, on the block's row.  The first pass's loads do not
    // wait for counts: they read the row's first pass of slots below p and
    // the fold masks them by counts.
    FirstRow w;
    w.alpha = alpha;
    w.label = label;
    w.r = blockIdx.x;
    w.t = tid;
    w.row = (size_t)w.r * p;
    w.vec = vec;
    const bool on = w.r < rings;
    float av[kFirstQuads][4];
    int lv[kFirstQuads][4];
    first_load(w, 0, on ? min(p, 4 * kFirstPass) : 0, av, lv);
    const int nr = min(__ldg(num_rings), rings);
    w.cnt = w.r < nr ? min(max(__ldg(counts + w.r), 0), p) : 0;
    first_fold(w, 0, av, lv, s_key);
    const int nq = w.cnt > 0
                       ? (int)((w.row + w.cnt - 1) / 4 - w.row / 4 + 1) : 0;
    for (int c = kFirstPass; c < nq; c += kFirstPass) {
      first_load(w, c, w.cnt, av, lv);
      first_fold(w, c, av, lv, s_key);
    }
  }
  __syncthreads();
  for (int b = tid; b < kBins; b += kFirstBlock)
    if (s_key[b] != kNoKey) atomicMin(&kf[b], s_key[b]);
}

// K14.  The ordered integer image of a float: unsigned order == float
// order (NaN excluded); kNoImage lies above every image.
constexpr unsigned int kNoImage = 0xffffffffu;
constexpr long long kNoState = 0x7fffffffffffffffLL;  // no winner key
constexpr float kFNone = 3.0e38f;  // f_init's default (marker_scan.py:44)
constexpr int kStateThreads = 512;
constexpr int kStateQuads = 2;  // quads per thread per step
constexpr int kStateStep = kStateThreads * kStateQuads;  // quads per step
// A group's f partials: 361 images padded to whole 16-byte quads, merged
// by kFSlices threads per quad, each over every kFSlices-th group.
constexpr int kFPad = 364;
constexpr int kFQuads = kFPad / 4;
constexpr int kFSlices = kStateThreads / kFQuads;
constexpr int kFBatch = 8;  // f partials in flight per thread

__device__ __forceinline__ unsigned int ordered(float v) {
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct StateArgs {
  const float* x;
  const float* y;
  const float* z;
  const float* alpha;
  const int* label;
  const int* counts;
  const int* num_rings;
  const int* goff;      // (wedges * rings,), or null: ring * p
  const float* f_init;  // (wedges, 361), wedge stride f_stride, or null
  unsigned int* part_f;  // (wedges, groups, kFPad): per row group, images
  unsigned int* f_out;   // (wedges, 361): each wedge's merged f, images
  unsigned int* part_d;  // (wedges, 361, groups): per row group
  long long* part_k;
  float* state;  // (wedges, 361, 6)
  long long f_stride;
  int wedges, rings, p;
  int groups;  // row groups per wedge
  int qp;      // quads one row may touch
  int lanes;   // lanes per (wedge, bin) in the merge: 8, 16 or 32
  bool vec;    // x, y, alpha and label are 16-byte aligned
};

// One step of a row group in registers: kStateQuads quads of the group's
// rows a thread, kStateThreads apart (row i of the group at quads
// [i * qp, (i + 1) * qp)), so a warp's loads are contiguous.
struct StateStep {
  float a[kStateQuads][4];
  float x[kStateQuads][4];  // loaded only where the quad holds road
  float y[kStateQuads][4];
  long long g0[kStateQuads];     // g of each quad's element 0
  unsigned int e[kStateQuads];   // flat index of each quad's element 0
  unsigned int ok;    // bit 4u + j: a slot of an active row, 0 <= a <= 360
  unsigned int road;  // bit 4u + j: ok and LABEL_ROAD
};

// Row group v of a call: wedge v / groups, rings j, j + groups, ... below
// nr, j = v % groups.  Sets the group's count of quads.
__device__ __forceinline__ int group_quads(const StateArgs& A, int j,
                                           int nr) {
  return j < nr ? ((nr - 1 - j) / A.groups + 1) * A.qp : 0;
}

// A step's alpha and label (each row's count and offset first: only the
// row's counted slots are read).
__device__ __forceinline__ void load_step(const StateArgs& A, int w, int j,
                                          int n_quads, int step,
                                          StateStep& S) {
  const size_t total = (size_t)A.wedges * A.rings * A.p;
  int cnt[kStateQuads];
  size_t row0[kStateQuads];
  int lv[kStateQuads][4];
#pragma unroll
  for (int u = 0; u < kStateQuads; ++u) {
    const int f = step * kStateStep + u * kStateThreads + threadIdx.x;
    const int i = A.qp > 0 ? f / A.qp : 0;
    const int q = A.qp > 0 ? f - i * A.qp : 0;
    const int k = j + i * A.groups;  // ring within the wedge
    const int row = w * A.rings + k;
    const bool in_q = f < n_quads;
    row0[u] = (size_t)row * A.p;
    const size_t e = 4 * (row0[u] / 4 + (size_t)q);
    cnt[u] = in_q ? min(max(__ldg(A.counts + row), 0), A.p) : 0;
    S.g0[u] = (in_q ? (A.goff ? (long long)__ldg(A.goff + row)
                              : (long long)k * A.p) : 0LL) +
              (long long)e - (long long)row0[u];
    S.e[u] = (unsigned int)e;
  }
#pragma unroll
  for (int u = 0; u < kStateQuads; ++u) {
    const size_t e = S.e[u];
    const bool quad = e < row0[u] + cnt[u];
    if (quad && A.vec && e + 4 <= total) {
      const float4 a4 =
          __ldg(reinterpret_cast<const float4*>(A.alpha) + e / 4);
      const int4 l4 = __ldg(reinterpret_cast<const int4*>(A.label) + e / 4);
      S.a[u][0] = a4.x, S.a[u][1] = a4.y, S.a[u][2] = a4.z, S.a[u][3] = a4.w;
      lv[u][0] = l4.x, lv[u][1] = l4.y, lv[u][2] = l4.z, lv[u][3] = l4.w;
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool in = quad && e + jj >= row0[u] && e + jj < row0[u] + cnt[u];
        S.a[u][jj] = in ? __ldg(A.alpha + e + jj) : -1.0f;
        lv[u][jj] = in ? __ldg(A.label + e + jj) : 0;
      }
    }
  }
  S.ok = 0u;
  S.road = 0u;
#pragma unroll
  for (int u = 0; u < kStateQuads; ++u)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const long long s = (long long)S.e[u] + jj - (long long)row0[u];
      const float a = S.a[u][jj];
      if (s >= 0 && s < cnt[u] && a >= 0.0f && a <= 360.0f) {
        S.ok |= 1u << (4 * u + jj);
        if (lv[u][jj] == kRoad) S.road |= 1u << (4 * u + jj);
      }
    }
}

// A step's x and y, where its quads hold road slots (phase 2 reads them;
// issued before the grid barrier, they arrive during it).
__device__ __forceinline__ void load_xy(const StateArgs& A, StateStep& S) {
  const size_t total = (size_t)A.wedges * A.rings * A.p;
#pragma unroll
  for (int u = 0; u < kStateQuads; ++u) {
    const size_t e = S.e[u];
    const unsigned int road = S.road >> (4 * u) & 0xfu;
    if (road && A.vec && e + 4 <= total) {
      const float4 x4 = __ldg(reinterpret_cast<const float4*>(A.x) + e / 4);
      const float4 y4 = __ldg(reinterpret_cast<const float4*>(A.y) + e / 4);
      S.x[u][0] = x4.x, S.x[u][1] = x4.y, S.x[u][2] = x4.z, S.x[u][3] = x4.w;
      S.y[u][0] = y4.x, S.y[u][1] = y4.y, S.y[u][2] = y4.z, S.y[u][3] = y4.w;
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool in = road >> jj & 1u;
        S.x[u][jj] = in ? __ldg(A.x + e + jj) : 0.0f;
        S.y[u][jj] = in ? __ldg(A.y + e + jj) : 0.0f;
      }
    }
  }
}

// Phase 1 of one step: per bin the smallest g of a non-road slot, one
// shared atomic per run of one bin in the thread's slots.
__device__ __forceinline__ void step_f(const StateStep& S,
                                       unsigned int* s_f) {
#pragma unroll
  for (int u = 0; u < kStateQuads; ++u) {
    int run = -1;
    unsigned int v = kNoImage;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int bit = 4 * u + jj;
      if (!((S.ok & ~S.road) >> bit & 1u)) continue;
      const int bin = (int)floorf(S.a[u][jj]);
      const unsigned int img = ordered(__ll2float_rn(S.g0[u] + jj));
      if (bin != run) {
        if (run >= 0) atomicMin(&s_f[run], v);
        run = bin;
        v = img;
      } else {
        v = min(v, img);
      }
    }
    if (run >= 0) atomicMin(&s_f[run], v);
  }
}

// Phase 2 of one step, K10's chunk scheme: the max of d's bits over the
// candidates (road, d > 0, g < f), a step that forgets the winner of a bin
// whose max rose, then the min key (g, flat slot) among those at the max,
// in two native 32-bit atomicMin passes: g's low 32 bits as a signed int
// (the order of g << 32 | flat as an int64), then the flat slot among
// those at that g (forgotten first where the bin's g fell).
__device__ __forceinline__ void step_win(const StateStep& S,
                                         const unsigned int* s_fm,
                                         unsigned int* s_d,
                                         unsigned int* s_prev, int* s_g,
                                         int* s_gseen,
                                         unsigned int* s_flat) {
  unsigned int cand = 0u;
  float d[kStateQuads][4];
#pragma unroll
  for (int u = 0; u < kStateQuads; ++u) {
    int run = -1;
    unsigned int v = 0u;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int bit = 4 * u + jj;
      // d as marker_scan.py:86; built with --fmad=false, so x*x and y*y
      // are rounded apart, as the twin rounds them.
      d[u][jj] = sqrtf(S.x[u][jj] * S.x[u][jj] + S.y[u][jj] * S.y[u][jj]);
      if (!(S.road >> bit & 1u)) continue;
      const int bin = (int)floorf(S.a[u][jj]);
      if (!(d[u][jj] > 0.0f &&
            __ll2float_rn(S.g0[u] + jj) < unordered(s_fm[bin])))
        continue;
      cand |= 1u << bit;
      const unsigned int db = __float_as_uint(d[u][jj]);
      if (bin != run) {
        if (run >= 0) atomicMax(&s_d[run], v);
        run = bin;
        v = db;
      } else {
        v = max(v, db);
      }
    }
    if (run >= 0) atomicMax(&s_d[run], v);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (s_d[b] != s_prev[b]) {  // the max rose: its old winner is stale
      s_prev[b] = s_d[b];
      s_g[b] = 0x7fffffff;
      s_gseen[b] = 0x7fffffff;
      s_flat[b] = 0xffffffffu;
    }
  __syncthreads();
  unsigned int top = 0u;  // bit 4u + j: a candidate at its bin's max
#pragma unroll
  for (int u = 0; u < kStateQuads; ++u) {
    int run = -1, gv = 0x7fffffff;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int bit = 4 * u + jj;
      if (!(cand >> bit & 1u)) continue;
      const int bin = (int)floorf(S.a[u][jj]);
      if (__float_as_uint(d[u][jj]) != s_d[bin]) continue;
      top |= 1u << bit;
      const int g = (int)(unsigned int)(S.g0[u] + jj);
      if (bin != run) {
        if (run >= 0) atomicMin(&s_g[run], gv);
        run = bin;
        gv = g;
      } else {
        gv = min(gv, g);
      }
    }
    if (run >= 0) atomicMin(&s_g[run], gv);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (s_g[b] != s_gseen[b]) {  // g fell: the old flat slot is stale
      s_gseen[b] = s_g[b];
      s_flat[b] = 0xffffffffu;
    }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kStateQuads; ++u) {
    int run = -1;
    unsigned int fv = 0xffffffffu;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int bit = 4 * u + jj;
      if (!(top >> bit & 1u)) continue;
      const int bin = (int)floorf(S.a[u][jj]);
      if ((int)(unsigned int)(S.g0[u] + jj) != s_g[bin]) continue;
      const unsigned int flat = S.e[u] + jj;
      if (bin != run) {
        if (run >= 0) atomicMin(&s_flat[run], fv);
        run = bin;
        fv = flat;
      } else {
        fv = min(fv, flat);
      }
    }
    if (run >= 0) atomicMin(&s_flat[run], fv);
  }
  __syncthreads();
}

__device__ __forceinline__ bool better_state(unsigned int d, long long k,
                                             unsigned int bd, long long bk) {
  return d > bd || (d == bd && k < bk);
}

__device__ __forceinline__ unsigned int f_init_image(const StateArgs& A,
                                                     int w, int b) {
  return ordered(A.f_init ? A.f_init[(size_t)w * A.f_stride + b] : kFNone);
}

__global__ void __launch_bounds__(kStateThreads)
    marker_state_kernel(StateArgs A) {
  __shared__ unsigned int s_f[kBins], s_d[kBins], s_prev[kBins];
  __shared__ unsigned int s_flat[kBins];
  __shared__ int s_g[kBins], s_gseen[kBins];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nr = min(max(*A.num_rings, 0), A.rings);
  const int groups = A.wedges * A.groups;
  // The layout stays in registers across the grid barrier when this block
  // has one row group of one step.
  const bool cached =
      (int)gridDim.x >= groups &&
      group_quads(A, blockIdx.x % A.groups, nr) <= kStateStep;
  StateStep S;

  // Phase 1: per row group, the smallest non-road g per bin against
  // f_init's image, written whole to the group's partials.
  for (int v = blockIdx.x; v < groups; v += gridDim.x) {
    const int w = v / A.groups, j = v % A.groups;
    const int n_quads = group_quads(A, j, nr);
    const int steps = max(1, (n_quads + kStateStep - 1) / kStateStep);
    for (int step = 0; step < steps; ++step) {
      load_step(A, w, j, n_quads, step, S);  // in flight over the reset
      if (step == 0) {
        for (int b = tid; b < kBins; b += blockDim.x)
          s_f[b] = f_init_image(A, w, b);
        __syncthreads();
      }
      step_f(S, s_f);
      if (cached) load_xy(A, S);  // read in phase 2, after the barrier
    }
    __syncthreads();
    for (int b = tid; b < kFPad; b += blockDim.x)
      A.part_f[(size_t)v * kFPad + b] = b < kBins ? s_f[b] : kNoImage;
    __syncthreads();
  }
  cooperative_groups::this_grid().sync();

  // Phase 2: per row group the winner's partials under the wedge's f.
  for (int v = blockIdx.x; v < groups; v += gridDim.x) {
    const int w = v / A.groups, j = v % A.groups;
    const int n_quads = group_quads(A, j, nr);
    const int steps = max(1, (n_quads + kStateStep - 1) / kStateStep);
    // The wedge's f: the minimum of its groups' partials, each of which
    // holds f_init already.
    // The loads of up to kFSlices * kFBatch groups are issued together (one
    // trip to memory), later ones kFBatch at a time.
    const int fq = tid % kFQuads, fs = tid / kFQuads;
    uint4 m = make_uint4(kNoImage, kNoImage, kNoImage, kNoImage);
    if (fs < kFSlices) {
      const uint4* pf = reinterpret_cast<const uint4*>(A.part_f) +
                        (size_t)w * A.groups * kFQuads + fq;
      for (int g0 = fs; g0 < A.groups; g0 += kFSlices * kFBatch) {
#pragma unroll
        for (int t = 0; t < kFBatch; ++t) {
          const int g = g0 + t * kFSlices;
          if (g < A.groups) {
            const uint4 u = __ldcg(pf + (size_t)g * kFQuads);
            m.x = min(m.x, u.x), m.y = min(m.y, u.y);
            m.z = min(m.z, u.z), m.w = min(m.w, u.w);
          }
        }
      }
    }
    for (int b = tid; b < kBins; b += blockDim.x) {
      s_f[b] = kNoImage;
      s_d[b] = 0u;
      s_prev[b] = 0u;
    }
    __syncthreads();
    if (fs < kFSlices) {
      const unsigned int mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * fq + c < kBins) atomicMin(&s_f[4 * fq + c], mv[c]);
    }
    __syncthreads();
    if (j == 0)
      for (int b = tid; b < kBins; b += blockDim.x)
        A.f_out[w * kBins + b] = s_f[b];
    for (int step = 0; step < steps; ++step) {
      if (!cached) {
        load_step(A, w, j, n_quads, step, S);
        load_xy(A, S);
      }
      step_win(S, s_f, s_d, s_prev, s_g, s_gseen, s_flat);
    }
    for (int b = tid; b < kBins; b += blockDim.x) {
      const size_t at = ((size_t)w * kBins + b) * A.groups + j;
      A.part_d[at] = s_d[b];
      A.part_k[at] = s_d[b] ? (long long)(
          (unsigned long long)(unsigned int)s_g[b] << 32 | s_flat[b])
                            : kNoState;
    }
    __syncthreads();
  }
  cooperative_groups::this_grid().sync();

  // Phase 3: A.lanes lanes per (wedge, bin) merge the partials (larger d
  // wins, equal d keeps the smaller key: a total order, so exact in any
  // order) and write the row [f, maxd, gstar, x, y, z].
  const int width = A.lanes;
  const int sub = lane & (width - 1);
  const int per_warp = 32 / width;
  const int pairs = A.wedges * kBins;
  const int gwarps = gridDim.x * (blockDim.x >> 5);
  for (int base = (blockIdx.x * (blockDim.x >> 5) + (tid >> 5)) * per_warp;
       base < pairs; base += gwarps * per_warp) {
    const int pair = base + lane / width;
    const bool live = pair < pairs;
    const int w = live ? pair / kBins : 0, b = live ? pair % kBins : 0;
    unsigned int bd = 0u;
    long long bk = kNoState;
    for (int g = sub; live && g < A.groups; g += width) {
      const size_t at = ((size_t)w * kBins + b) * A.groups + g;
      const unsigned int d = __ldcg(A.part_d + at);
      const long long k = __ldcg(A.part_k + at);
      if (better_state(d, k, bd, bk)) {
        bd = d;
        bk = k;
      }
    }
    for (int o = width >> 1; o > 0; o >>= 1) {
      const unsigned int d = __shfl_xor_sync(~0u, bd, o);
      const long long k = __shfl_xor_sync(~0u, bk, o);
      if (better_state(d, k, bd, bk)) {
        bd = d;
        bk = k;
      }
    }
    if (!live || sub >= 6) continue;
    const bool exists = bd != 0u;
    const size_t at = (size_t)((unsigned long long)bk & 0xffffffffULL);
    float val = 0.0f;
    if (sub == 0) {
      val = unordered(__ldcg(A.f_out + pair));
    } else if (sub == 1) {
      val = exists ? __uint_as_float(bd) : 0.0f;
    } else if (sub == 2) {
      val = exists ? __ll2float_rn(bk >> 32) : 0.0f;
    } else {
      const float* src = sub == 3 ? A.x : sub == 4 ? A.y : A.z;
      val = exists ? src[at] : 0.0f;
    }
    A.state[(size_t)pair * 6 + sub] = val;
  }
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

// K13.  kf (361,) uint64, written whole by the launch: per bin, the
// smallest marker key of a non-road slot with a valid azimuth, slot <
// counts[ring] and ring < num_rings; kNoKey where there is none.  One
// launch of a block a ring (at least 1); its blocks take tickets
// from per-device counters, so K13 launches on one device must not run
// concurrently on two streams.
extern "C" int urf_marker_first_nonroad(const float* alpha, const int* label,
                                        const int* counts,
                                        const int* num_rings, int rings, int p,
                                        unsigned long long* kf, void* stream) {
  if (rings < 0 || p < 0) return (int)cudaErrorInvalidValue;
  const int grid = max(1, rings);
  auto is16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  first_nonroad_kernel<<<grid, kFirstBlock, 0, (cudaStream_t)stream>>>(
      alpha, label, counts, num_rings, rings, p, is16(alpha) && is16(label),
      kf);
  return (int)cudaGetLastError();
}

// state (wedges, 361, 6) f32: per wedge and bin [f, maxd, gstar, x, y, z]
// from the azimuth-sorted layout (K14), ring k of wedge w at row
// w * rings + k of the (wedges * rings, p) arrays.  goff (wedges * rings,)
// int32 scan-position offsets (g = goff[row] + slot), or null for
// k * p; f_init: the wedges' (361,) f32 floors, wedge w at
// f_init + w * f_stride, or null for 3e38.  scratch: (4 * 364 + 12 * 361)
// * scratch_groups + 4 * 361 * wedges bytes, 16-byte aligned,
// uninitialised (every entry the launch reads it writes first); at most
// wedges * max(rings, 1) row groups are used.  One cooperative launch; a
// refused launch returns its error.
extern "C" int urf_marker_state(const float* x, const float* y,
                                const float* z, const float* alpha,
                                const int* label, const int* counts,
                                const int* num_rings, const int* goff,
                                const float* f_init, long long f_stride,
                                int wedges, int rings, int p, void* scratch,
                                int scratch_groups, float* state,
                                void* stream) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices];  // co-resident blocks, per device
  if (wedges < 0 || rings < 0 || p < 0) return (int)cudaErrorInvalidValue;
  if (wedges == 0) return (int)cudaGetLastError();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, marker_state_kernel, kStateThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * sms;
  }
  // Quads one row may touch (one more where rows are not 4-aligned); as
  // many rows per group as one step holds, so a group's slots stay in
  // registers across the grid barrier.
  const int qp = p == 0 ? 0 : p % 4 == 0 ? p / 4 : (p + 3) / 4 + 1;
  const int per_group = max(1, kStateStep / max(qp, 1));
  const int groups = max(1, (rings + per_group - 1) / per_group);
  const long long all = (long long)wedges * groups;
  if (all > scratch_groups ||
      (long long)wedges * rings * p > 0xffffffffLL ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (int)max(1LL, min(all, (long long)resident[dev]));
  auto is16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  // part_f first (16-byte quads), then part_k, part_d and f_out.
  unsigned int* part_f = static_cast<unsigned int*>(scratch);
  long long* part_k =
      reinterpret_cast<long long*>(part_f + (size_t)kFPad * all);
  unsigned int* part_d =
      reinterpret_cast<unsigned int*>(part_k + (size_t)kBins * all);
  const int lanes = groups <= 8 ? 8 : groups <= 16 ? 16 : 32;
  StateArgs a{x, y, z, alpha, label, counts, num_rings, goff, f_init,
              part_f, part_d + (size_t)kBins * all, part_d, part_k, state,
              f_stride, wedges, rings, p, groups, qp, lanes,
              is16(x) && is16(y) && is16(alpha) && is16(label)};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)marker_state_kernel,
                                    dim3(grid), dim3(kStateThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
