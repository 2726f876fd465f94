// Batch ingest over (B, N) point streams: ROI mask, star keys and in-ROI
// count (K1), greedy ring discovery (K2), ring assignment (K3).
//
// Replaces three TPU kernels of urban_road_filter_tpu/ops/ingest_scan.py:
//   * ingest_prep_pallas (K1).  On the TPU the atan2 was an XLA op fed in
//     as a fifth stream, because Mosaic has no atan2; here the kernel takes
//     the float64 atan2 itself, rounded to f32 as the oracle bins.
//   * discover_rings_pallas (K2).  On the TPU whole scans sat in VMEM
//     (with a "wide" variant for 262k-point scans) and each of the <= 128
//     rounds swept the scan.  Here the greedy is spread over every SM
//     (below), with only the ring table in shared memory.
//   * assign_rings_pallas (K3).  On the TPU an unrolled loop over the
//     rings compared every point with every ring; here each point bisects
//     the sorted table.
//
// What bounds them on Hopper, and why the designs are exact.
//   * K1 and K3 are memory streams: K1 reads 12 bytes and writes 9 per
//     point.  A batch (bytes bound it) takes 8 points a thread, planes a
//     float4 per plane and 4 points, rows of 4 floats a float4 per point,
//     4 valid bytes in one 32-bit store, int4 / float4 stores of the keys.
//     A call that fits one wave of blocks at two points a thread (one
//     scan: its float64 atan2's ~0.5 us latency and the launch bound it)
//     takes two points a thread, point by point.  Each
//     block adds its in-ROI count with one atomicAdd; the counts are
//     zeroed by the launch's first block (counts_ready), so a call is one
//     device op.  The atan2 runs only on points in the ROI.  K3 reads 5
//     and writes 4 (per
//     thread two float4s of alpha, 4 valid bytes in one 32-bit load each,
//     two int4 stores, with streaming cache hints), against a <= 1 KB
//     table in shared memory.
//   * K2, one launch with grid (S, B): S segments per scan, one wave of
//     blocks (S = 124 for one 131072-point scan, 1 at B = 128).  Every
//     block runs the greedy over its scan's first P = 4096 points (the
//     prefix: the same table T in every block, no synchronisation between
//     blocks), then marks the points of its own segment that match no
//     entry of T in a bitmask (one ballot word per 32 points).  The last
//     block of the scan to arrive (a __threadfence and an atomicAdd on a
//     per-scan counter that the host entry point zeroes) compacts the
//     marked points, chunk by chunk and in input order, into a list in
//     shared memory, and continues the greedy from T over that list.
//     Exact because a point that matches an entry of T never becomes a
//     ring and never changes the table (the table only grows), so dropping
//     it changes nothing; a valid NaN-angle point matches nothing, stays
//     marked and fills the table as below.  The table is kept sorted
//     throughout (the greedy's result does not depend on its order), so a
//     point's test against it is K3's search and the output needs no sort.
//     A round of the greedy lets warp 0 resolve the first 32 open points of
//     the chunk in input order (each a ring unless it matches a ring found
//     before it) and every thread drop its open points that match the
//     round's new rings; once at most 256 points are open, warp 0 gathers
//     them and resolves them alone.  Bound: the rounds, which are serial
//     (a round costs ~2.5K cycles on the H100: two block barriers and warp
//     0's scan, candidates and merge), and the prefix, which every block
//     pays (~20K cycles for a scan in firing order).  A ring-major scan
//     finds one ring a round, as the one-block walk did; scans whose rings
//     first appear late (azimuth-sorted, merged sensors) leave many points
//     marked, and the finishing block's list is most of the kernel's time.
//   * K3: over a table sorted as K2 returns it (finite ascending, then
//     +inf, then NaN), P(m) = !(fl(a - t_m) > tol) is false then true:
//     rounding is monotone, so fl(a - t) does not grow with t, and +inf or
//     NaN entries make P true.  Let lo be the first m with P true; every
//     earlier entry has fl(a - t_m) > tol and does not match; if lo does
//     not match, fl(a - t_lo) < -tol, or t_lo is +inf or NaN, or a is NaN,
//     and no later entry can match either.  So the first match is lo if
//     |fl(a - t_lo)| <= tol and there is none otherwise: at most 8 reads of
//     the table instead of up to `rings`.  The table is padded with +inf to
//     a power of two above `rings` (P stays monotone) and laid out with one
//     skipped bank per 32 entries, so that the search's pivots of one level
//     fall into different banks.  K2's tests use the same search.
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
//     and the count becomes `rings`, as the oracle and the XLA loop give
//     (likewise any point that does not match itself).  The angles are
//     sorted as torch.sort sorts them: ascending, +inf padding, NaN last,
//     bit patterns moved verbatim.
//   * K3: the first ring, in ascending order, with |alpha - a| <= tol;
//     `rings` for an invalid point or when nothing matches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStarRep = 360;
constexpr int kMaxRings = 128;
constexpr int kSearch = 2 * kMaxRings;            // padded table: a power
constexpr int kSearchSlots = kSearch + kSearch / 32;  // of two > rings
constexpr int kDiscoverThreads = 1024;
constexpr int kWarps = kDiscoverThreads / 32;
constexpr int kItems = 4;  // points per thread in a discovery chunk
constexpr int kChunk = kDiscoverThreads * kItems;  // also the prefix, P
constexpr int kFilterItems = 8;  // points per thread per filter step
constexpr int kSmall = 256;  // open points one warp resolves on its own
constexpr int kMinSegment = 1024;  // filter points per block, at least
constexpr int kTileWords = kDiscoverThreads * 16;  // mask words per pass
constexpr int kTileChunks = kTileWords * 32 / kChunk;
constexpr int kAssignThreads = 256;
constexpr int kAssignWaves = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kTwoPi = 6.283185307179586;

static_assert(kWarps * kItems == 4 * 32, "4 segment words per lane");
static_assert(kChunk % 32 == 0 && kMinSegment % 32 == 0, "whole words");

struct Roi {
  float min_x, max_x, min_y, max_y, min_z, max_z;
};

// K1's per-device block tickets (K9's pattern, csrc/flood.cu; these
// counters are K1's own, see counts_ready).  Like K9's, they need no host
// value, so a captured CUDA graph replays them, but two K1 launches on
// one device must not run at once on two streams (the wrapper raises when
// a launch's stream differs from the last one's and that one is still
// busy, _build.TICKETED).  They sit on L2 lines of their own, so the tickets'
// atomics and the polling of g_prep_first do not contend for one line.
__device__ __align__(128) unsigned long long g_prep_ticket = 0ULL;
__device__ __align__(128) unsigned long long g_prep_first = 0ULL;

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

// How K1 reads a scan's points: point by point through the strides; as
// planes (point stride 1), one float4 per plane and 4 points; or as rows
// of 4 floats (x, y, z, intensity), one float4 per point.
enum PrepMode { kStrided = 0, kPlanar = 1, kRows4 = 2 };

__device__ __forceinline__ bool in_roi(float xx, float yy, float zz,
                                       const Roi& roi) {
  return (xx >= roi.min_x) & (xx <= roi.max_x) & (yy >= roi.min_y) &
         (yy <= roi.max_y) & (zz >= roi.min_z) & (zz <= roi.max_z) &
         (__fadd_rn(__fadd_rn(xx, yy), zz) != 0.0f);
}

// The star sector and radius key of a point in the ROI.
__device__ __forceinline__ void star_key(float xx, float yy, float kfi,
                                         int& f, float& r) {
  r = __fsqrt_rn(__fadd_rn(__fmul_rn(xx, xx), __fmul_rn(yy, yy)));
  float fi = __double2float_rn(atan2((double)yy, (double)xx));
  if (fi < 0.0f) fi = __double2float_rn((double)fi + kTwoPi);
  // A sector of 360 (fi a few ulps below 2 pi) is beam 0's.
  f = (int)__fmul_rn(fi, kfi) % kStarRep;
}

// Points from p until p + size * i sits on a 4-element boundary, or -1
// when p is not aligned to its element.
__device__ __forceinline__ int head_of(const void* p, unsigned size) {
  const uintptr_t a = (uintptr_t)p;
  if (a % size) return -1;
  return (int)(((4u * size - a % (4u * size)) % (4u * size)) / size);
}

// The in-ROI counts without a fill, so a call is one device op.  Each
// block has one warp besides its point warps; its lane 0 takes a ticket
// as the block starts, while the point warps work.  Tickets run on across
// launches, and g_prep_first holds the first ticket of the launch that has
// not yet zeroed its counts.  The block holding the launch's first ticket
// zeroes piece[0..B) and publishes the next launch's first ticket (its
// own plus this launch's block count) with a release store; every other
// block waits, acquire loads, until that ticket has passed its own.  The
// same lane adds the block's count after the point warps' barrier.  The
// first block took its ticket, so it is resident and waits on nothing: no
// deadlock.  The lane's round trips (~1.6 us for one scan's 256 blocks,
// tools/clock_ingest_prep.py) run beside the point work.
__device__ __forceinline__ void counts_ready(int* piece) {
  const unsigned long long ticket = atomicAdd(&g_prep_ticket, 1ULL);
  if (load_acquire(&g_prep_first) == ticket) {
    for (int k = 0; k < (int)gridDim.y; ++k) piece[k] = 0;
    // The release orders this thread's zeroes before the publication.
    store_release(&g_prep_first,
                  ticket + (unsigned long long)gridDim.x * gridDim.y);
  } else {
    while (load_acquire(&g_prep_first) <= ticket) {
    }
  }
}

// K1's point threads per block, and its block (those and a ticket warp):
// threads of 2 points in blocks of 512 (fewer blocks take fewer tickets),
// vector threads in blocks of 256 (their registers).
template <int kPts>
struct Prep {
  static constexpr int kThreads = kPts == 2 ? 512 : 256;
  static constexpr int kBlock = kThreads + 32;
};

// Point i's coordinates, read through the strides.
__device__ __forceinline__ void load_point(const float* xb, const float* yb,
                                           const float* zb, int i,
                                           long long point_stride, float& xx,
                                           float& yy, float& zz) {
  const long long off = (long long)i * point_stride;
  xx = xb[off];
  yy = yb[off];
  zz = zb[off];
}

// Point i's ROI flag and star keys, stored; returns the flag.
__device__ __forceinline__ bool finish_point(float xx, float yy, float zz,
                                             int i, const Roi& roi,
                                             float kfi, int want_keys,
                                             bool* vb, int* fb, float* rb) {
  const bool v = in_roi(xx, yy, zz, roi);
  vb[i] = v;
  if (want_keys) {
    int f = kStarRep;
    float r = INFINITY;
    if (v) star_key(xx, yy, kfi, f, r);
    fb[i] = f;
    rb[i] = r;
  }
  return v;
}

// The point work of thread t (of X * Prep<kPts>::kThreads point threads)
// of scan b; returns its count of points in the ROI.  kPts 2, for calls
// that fit in one wave of blocks (one scan: the float64 atan2's latency,
// ~0.5 us, then bounds a thread), point by point in kStrided mode: thread
// t takes points t and t + the thread count, their loads in flight
// together.
// kPts 8, for batches (bytes bound them): each thread takes 8 points, two
// groups of 4 consecutive points whose loads are in flight together (a
// float4 per plane, or one per row of 4 floats), stored as 4 valid bytes
// in one 32-bit store and int4 / float4 stores of fk and r_key; points
// before the scan's first common 4-point boundary of the streams, and
// the tail, go point by point (in kStrided mode, and when the streams
// share no boundary, the whole scan).
template <int kMode, int kPts>
__device__ __forceinline__ int prep_points(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, long long scan_stride,
    long long point_stride, int n, const Roi& roi, float kfi, int want_keys,
    bool* __restrict__ valid, int* __restrict__ fk,
    float* __restrict__ r_key, int b, int tid, int stride) {
  const long long base = (long long)b * scan_stride;
  const float* xb = x + base;
  const float* yb = y + base;
  const float* zb = z + base;
  const size_t row = (size_t)b * n;
  bool* vb = valid + row;
  int* fb = want_keys ? fk + row : nullptr;
  float* rb = want_keys ? r_key + row : nullptr;
  int cnt = 0;
  if constexpr (kPts == 2) {
    static_assert(kMode == kStrided, "two-point threads read point by point");
    float px[kPts], py[kPts], pz[kPts];
#pragma unroll
    for (int u = 0; u < kPts; ++u)
      if (tid + u * stride < n)
        load_point(xb, yb, zb, tid + u * stride, point_stride, px[u], py[u],
                   pz[u]);
#pragma unroll
    for (int u = 0; u < kPts; ++u)
      if (tid + u * stride < n)
        cnt += finish_point(px[u], py[u], pz[u], tid + u * stride, roi, kfi,
                            want_keys, vb, fb, rb);
    return cnt;
  }
  int head = n;
  if (kMode != kStrided) {
    int h[6] = {head_of(vb, 1), -2, -2, -2, -2, -2};  // -2: free
    if (want_keys) {
      h[1] = head_of(fb, 4);
      h[2] = head_of(rb, 4);
    }
    if (kMode == kPlanar) {
      h[3] = head_of(xb, 4);
      h[4] = head_of(yb, 4);
      h[5] = head_of(zb, 4);
    }
    head = h[0];
#pragma unroll
    for (int k = 1; k < 6; ++k)
      if (h[k] != -2 && h[k] != h[0]) head = -1;
    head = head < 0 || head > n ? n : head;
  }
  // In kRows4 mode the scan's last point goes point by point.
  const int nvec = max(n - head - (kMode == kRows4 ? 1 : 0), 0) >> 2;
  for (int q = tid; q < nvec; q += 2 * stride) {
    float px[2][4], py[2][4], pz[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = head + 4 * min(q + u * stride, nvec - 1);
      if constexpr (kMode == kPlanar) {
        const float4 a = *reinterpret_cast<const float4*>(xb + i);
        const float4 c = *reinterpret_cast<const float4*>(yb + i);
        const float4 d = *reinterpret_cast<const float4*>(zb + i);
        px[u][0] = a.x; px[u][1] = a.y; px[u][2] = a.z; px[u][3] = a.w;
        py[u][0] = c.x; py[u][1] = c.y; py[u][2] = c.z; py[u][3] = c.w;
        pz[u][0] = d.x; pz[u][1] = d.y; pz[u][2] = d.z; pz[u][3] = d.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 a = *reinterpret_cast<const float4*>(xb + 4 * (i + e));
          px[u][e] = a.x;
          py[u][e] = a.y;
          pz[u][e] = a.z;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (q + u * stride >= nvec) break;
      const int i = head + 4 * (q + u * stride);
      unsigned v4 = 0u;
      int f[4];
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = in_roi(px[u][e], py[u][e], pz[u][e], roi);
        v4 |= (unsigned)v << (8 * e);
        cnt += v;
        f[e] = kStarRep;
        r[e] = INFINITY;
        if (want_keys && v) star_key(px[u][e], py[u][e], kfi, f[e], r[e]);
      }
      *reinterpret_cast<unsigned*>(vb + i) = v4;
      if (want_keys) {
        *reinterpret_cast<int4*>(fb + i) = make_int4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<float4*>(rb + i) =
            make_float4(r[0], r[1], r[2], r[3]);
      }
    }
  }
  // Point by point: [0, head), then [head + 4 nvec, n).
  for (int t = tid; t < n - 4 * nvec; t += stride) {
    const int i = t < head ? t : t + 4 * nvec;
    float xx, yy, zz;
    load_point(xb, yb, zb, i, point_stride, xx, yy, zz);
    cnt += finish_point(xx, yy, zz, i, roi, kfi, want_keys, vb, fb, rb);
  }
  return cnt;
}

// Grid (X, B), blocks of Prep<kPts>::kThreads point threads and one
// ticket warp.  The point warps sum their in-ROI points (warp sums, then
// the warps'), and the ticket lane adds the block's sum once counts_ready
// returned.
template <int kMode, int kPts>
__global__ void __launch_bounds__(Prep<kPts>::kBlock, 3)
    ingest_prep_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ z, long long scan_stride,
                       long long point_stride, int n,
                       const float* __restrict__ roi_p, float kfi,
                       int want_keys, bool* __restrict__ valid,
                       int* __restrict__ fk, float* __restrict__ r_key,
                       int* __restrict__ piece) {
  constexpr int kThreads = Prep<kPts>::kThreads;
  __shared__ int warp_cnt[kThreads / 32];
  __shared__ float s_roi[6];  // the ROI bounds, read once per block
  if (threadIdx.x < 6) s_roi[threadIdx.x] = __ldg(roi_p + threadIdx.x);
  __syncthreads();
  const Roi roi = {s_roi[0], s_roi[1], s_roi[2], s_roi[3], s_roi[4], s_roi[5]};
  if (threadIdx.x >= kThreads) {  // the ticket warp
    if (threadIdx.x == kThreads) counts_ready(piece);
  } else {
    int cnt = prep_points<kMode, kPts>(
        x, y, z, scan_stride, point_stride, n, roi, kfi, want_keys, valid,
        fk, r_key, blockIdx.y, blockIdx.x * kThreads + threadIdx.x,
        gridDim.x * kThreads);
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == kThreads) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_cnt[w];
    if (total > 0) atomicAdd(&piece[blockIdx.y], total);
  }
}

__device__ __forceinline__ bool matches(float a, float t, float tol) {
  return fabsf(__fsub_rn(a, t)) <= tol;
}

// The slot of sorted-table entry m: one bank skipped per 32 entries, so
// that the pivots of one level of a search fall into different banks.
__device__ __forceinline__ int slot(int m) { return m + (m >> 5); }

// The smallest power of two above `rings`: the search's padded size.
__device__ __forceinline__ int search_size(int rings) {
  int p = 1;
  while (p <= rings) p <<= 1;
  return p;
}

// K3's search (header), for kN points at once: over the sorted table
// padded with +inf to `size` entries, lo[j] = the number of leading
// entries with fl(a - t) > tol; the first match is lo[j] if it matches.
template <int kN>
__device__ __forceinline__ void search(const float (&a)[kN], const float* t,
                                       int size, float tol, int (&lo)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) lo[j] = 0;
  for (int step = size >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (__fsub_rn(a[j], t[slot(lo[j] + step - 1)]) > tol) lo[j] += step;
  }
}

__device__ __forceinline__ int first_match(float a, const float* t, int size,
                                           int rings, float tol) {
  float aa[1] = {a};
  int lo[1];
  search<1>(aa, t, size, tol, lo);
  return (lo[0] < rings && matches(a, t[slot(lo[0])], tol)) ? lo[0] : rings;
}

// One block's ring table and round state, in shared memory.  The table
// is kept sorted (search layout, +inf beyond its n entries): the greedy's
// result does not depend on the order of its table, so every membership
// test is one search and the output needs no sort.
struct Rings {
  // The chunk's alphas (prefix), or the finishing block's compacted open
  // points (up to two chunks' worth), for the resolving warp.
  float stage[2 * kChunk];
  float s[kSearchSlots];
  float fresh[32];  // the entries the last round added
  float list[kSmall];  // a chunk's few open points, in input order
  int cand[32];     // that round's candidates, by stage index
  unsigned seg[kItems * 32];  // open points per (item, warp) segment
  int off[kItems * 32];       // each segment's first slot in list/stage
  unsigned chunks[kTileChunks / 32];  // chunks of a tile with open points
  float fill;       // the ring that matched nothing, itself included
  int n;            // entries in s
  int nf;           // entries the last round added
  int done;         // the table is full (the cap, or a fill)
  int filled;       // fill took the table's remaining rounds
  int last;         // this block finishes its scan
  int small;        // the chunk's open count when warp 0 takes them all
  int count;        // compacted points in stage
};

// Warp 0: the open counts of segment words 4 lane .. 4 lane + 3 (in
// input order) and their exclusive prefix over the chunk; returns it and
// sets total.
__device__ __forceinline__ int word_prefix(const unsigned (&w)[kItems],
                                           int& total) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) cnt += __popc(w[q]);
  int pre = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, pre, d);
    if (lane >= d) pre += v;
  }
  total = __shfl_sync(kFull, pre, 31);
  return pre - cnt;
}

// Warp 0: merges the new entries av of the lanes in acc (distinct, and
// distinct from the table's) into the sorted table of n entries and
// lists them in sh.fresh.  An old entry moves up by the new ones below
// it; a new one lands after the old ones below it and the new ones below
// it.  Returns the new count.
__device__ int merge(Rings& sh, float av, unsigned acc, int n) {
  const int lane = threadIdx.x & 31;
  const int nf = __popc(acc);
  const bool mine = (acc >> lane) & 1u;
  float old[kMaxRings / 32];
  int shift[kMaxRings / 32];
#pragma unroll
  for (int q = 0; q < kMaxRings / 32; ++q) {
    old[q] = lane + 32 * q < n ? sh.s[slot(lane + 32 * q)] : 0.0f;
    shift[q] = 0;
  }
  // A new entry's count of old entries below it: a warp sum per entry
  // when one or two are new, else one search of the old table.
  const bool few = nf <= 2;
  int below = 0, pos = 0;
  for (unsigned it = acc; it != 0u; it &= it - 1u) {
    const int r = __ffs((int)it) - 1;
    const float v = __shfl_sync(kFull, av, r);
    below += v < av;
    int under = 0;
#pragma unroll
    for (int q = 0; q < kMaxRings / 32; ++q) {
      shift[q] += v < old[q];
      under += lane + 32 * q < n && old[q] < v;
    }
    if (few) {
      under = __reduce_add_sync(kFull, under);
      if (lane == r) pos = under;
    }
  }
  if (!few && mine)
    for (int step = kSearch >> 1; step > 0; step >>= 1)
      if (sh.s[slot(pos + step - 1)] < av) pos += step;
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kMaxRings / 32; ++q)
    if (lane + 32 * q < n) sh.s[slot(lane + 32 * q + shift[q])] = old[q];
  if (mine) {
    sh.s[slot(pos + below)] = av;
    sh.fresh[below] = av;
  }
  __syncwarp();
  return n + nf;
}

// Warp 0's part of a round: the first 32 open points of the chunk in
// input order (from the segment ballots) are resolved in order, each a
// ring unless it matches a ring found before it; the new rings are merged
// into the sorted table.  A ring that does not match itself (a NaN angle)
// is the first open point of every later round: it fills the table.
__device__ void resolve(Rings& sh, const float* stage, int rings,
                        float tol) {
  const int lane = threadIdx.x & 31;
  // Segment word q = j * 32 + warp holds points j * kDiscoverThreads + warp
  // * 32 + bit of the chunk, so the words in order are the points in order;
  // lane l holds words 4l..4l+3.
  unsigned w[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) w[q] = sh.seg[lane * kItems + q];
  int total;
  int pre = word_prefix(w, total);
  if (total <= kSmall) {  // warp 0 takes them all: where each segment goes
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      sh.off[lane * kItems + q] = pre;
      pre += __popc(w[q]);
    }
    if (lane == 0) sh.small = total;
    return;
  }
  if (lane == 0) sh.small = 0;
  // The first 32 open points' positions (word * 32 + bit = j *
  // kDiscoverThreads + warp * 32 + bit: their index in the stage), in
  // order.
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int word = lane * kItems + q;
    for (unsigned x = w[q]; x != 0u && pre < 32; x &= x - 1u)
      sh.cand[pre++] = word * 32 + __ffs((int)x) - 1;
  }
  __syncwarp();
  const int nc = min(total, 32);
  const float av = lane < nc ? stage[sh.cand[lane]] : 0.0f;
  unsigned todo = nc == 32 ? kFull : (1u << nc) - 1u;
  unsigned acc = 0u;
  const int n = sh.n;
  int nf = 0;
  bool filled = false;
  float fill = 0.0f;
  while (todo != 0u && n + nf < rings) {
    const int r = __ffs((int)todo) - 1;
    const float v = __shfl_sync(kFull, av, r);
    if (!matches(v, v, tol)) {
      filled = true;
      fill = v;
      break;
    }
    acc |= 1u << r;
    ++nf;
    todo &= ~__ballot_sync(kFull, ((todo >> lane) & 1u) &&
                                      matches(av, v, tol));
  }
  merge(sh, av, acc, n);
  if (lane == 0) {
    sh.n = n + nf;
    sh.nf = nf;
    sh.done = filled || n + nf >= rings;
    if (filled) {
      sh.filled = 1;
      sh.fill = fill;
    }
  }
}

// Warp 0's greedy over the chunk's last few open points, gathered in input
// order in sh.list: each is a ring unless it matches a ring found before
// it.  Resolves the chunk.
__device__ void resolve_small(Rings& sh, int total, int rings, float tol) {
  constexpr int kPer = kSmall / 32;
  const int lane = threadIdx.x & 31;
  float a[kPer];
  bool open[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    open[m] = m * 32 + lane < total;
    a[m] = open[m] ? sh.list[m * 32 + lane] : 0.0f;
  }
  int n = sh.n, nb = 0;
  unsigned acc = 0u;
  float batch = 0.0f;  // lane c holds the batch's c-th new entry
  bool filled = false;
  float fill = 0.0f;
  while (n + nb < rings) {
    int r = -1;
#pragma unroll
    for (int m = kPer - 1; m >= 0; --m) {
      const unsigned b = __ballot_sync(kFull, open[m]);
      if (b != 0u) r = m * 32 + __ffs((int)b) - 1;
    }
    if (r < 0) break;
    const float v = sh.list[r];
    if (!matches(v, v, tol)) {
      filled = true;
      fill = v;
      break;
    }
    if (lane == nb) batch = v;
    acc |= 1u << nb;
#pragma unroll
    for (int m = 0; m < kPer; ++m) open[m] = open[m] && !matches(a[m], v, tol);
    if (++nb == 32) {
      n = merge(sh, batch, acc, n);
      acc = 0u;
      nb = 0;
    }
  }
  if (nb > 0) n = merge(sh, batch, acc, n);
  if (lane == 0) {
    sh.n = n;
    if (filled) {
      sh.filled = 1;
      sh.fill = fill;
    }
  }
}

// The greedy over one chunk of kChunk points, kItems per thread (item j of
// thread t is point j * kDiscoverThreads + t of the chunk), whose alphas
// are staged in stage and whose open flags already exclude every point
// matching the table.  Round by round, warp 0 resolves the first 32 open
// points and every thread drops its open points that match the round's
// new rings.  Call only while the table is not full.
__device__ __forceinline__ void greedy_chunk(const float (&a)[kItems],
                                             bool (&open)[kItems], Rings& sh,
                                             const float* stage, int size,
                                             int rings, float tol) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  while (true) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned word = __ballot_sync(kFull, open[j]);
      if (lane == 0) sh.seg[j * 32 + warp] = word;
      any |= open[j];
    }
    if (!__syncthreads_or(any)) return;
    if (warp == 0) resolve(sh, stage, rings, tol);
    __syncthreads();
    if (const int small = sh.small) {  // gather them in order; warp 0 ends
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const unsigned word = __ballot_sync(kFull, open[j]);
        if (open[j])
          sh.list[sh.off[j * 32 + warp] +
                  __popc(word & ((1u << lane) - 1u))] = a[j];
      }
      __syncthreads();
      if (warp == 0) resolve_small(sh, small, rings, tol);
      __syncthreads();
      return;
    }
    if (sh.done) return;
    if (!__any_sync(kFull, any)) continue;
    const int nf = sh.nf;
    if (nf <= 8) {
      for (int m = 0; m < nf; ++m) {
        const float t = sh.fresh[m];
#pragma unroll
        for (int j = 0; j < kItems; ++j)
          open[j] = open[j] && !matches(a[j], t, tol);
      }
    } else {  // the table now holds them: one search per point
      int lo[kItems];
      search<kItems>(a, sh.s, size, tol, lo);
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        open[j] = open[j] && !matches(a[j], sh.s[slot(lo[j])], tol);
    }
  }
}

// The finishing block's greedy over the list of marked points compacted
// in sh.stage (input order), a chunk at a time: each point is first
// tested against the whole table (it matched none of T's entries).
__device__ __forceinline__ void finish_list(Rings& sh, int list, int size,
                                            int rings, float tol) {
  for (int p0 = 0; p0 < list && !sh.filled && sh.n < rings; p0 += kChunk) {
    float a[kItems];
    bool open[kItems];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int p = p0 + j * kDiscoverThreads + threadIdx.x;
      open[j] = p < list;
      a[j] = open[j] ? sh.stage[p] : 0.0f;
      any |= open[j];
    }
    if (__any_sync(kFull, any)) {
      int lo[kItems];
      search<kItems>(a, sh.s, size, tol, lo);
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        open[j] = open[j] && !(lo[j] < sh.n &&
                               matches(a[j], sh.s[slot(lo[j])], tol));
    }
    greedy_chunk(a, open, sh, sh.stage + p0, size, rings, tol);
  }
}

// Grid (S, B): block (s, b) runs the prefix greedy over scan b's first
// kChunk points, marks the open points of segment s (points kChunk + s *
// seg_len onwards) in mask, and the last block of scan b to arrive walks
// the marks and writes the sorted table and the count.  mask holds
// ceil(n / 32) words per scan; arrive one zeroed counter per scan.
__global__ void __launch_bounds__(kDiscoverThreads, 1)
    discover_kernel(const float* __restrict__ alpha,
                    const bool* __restrict__ valid, int n,
                    const float* __restrict__ tol_p, int rings, int seg_len,
                    unsigned* mask, int* arrive, float* __restrict__ angles,
                    int* __restrict__ count) {
  __shared__ Rings sh;
  __shared__ float s_tol;  // the interval, read once per block
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* a_scan = alpha + (size_t)b * n;
  const bool* v_scan = valid + (size_t)b * n;
  const int words = (n + 31) >> 5;
  unsigned* m_scan = mask + (size_t)b * words;
  const int size = search_size(rings);
  for (int m = threadIdx.x; m < kSearchSlots; m += blockDim.x)
    sh.s[m] = INFINITY;
  if (threadIdx.x == 0) {
    sh.n = 0;
    sh.filled = 0;
    s_tol = __ldg(tol_p);
  }

  // 1. The prefix.
  float a[kItems];
  bool open[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kDiscoverThreads + threadIdx.x;
    open[j] = i < n && v_scan[i];
    a[j] = i < n ? a_scan[i] : 0.0f;
    sh.stage[i] = a[j];
  }
  __syncthreads();
  const float tol = s_tol;
  if (rings > 0) greedy_chunk(a, open, sh, sh.stage, size, rings, tol);
  const int k_prefix = sh.n;

  // 2. The filter: segment s against the prefix's table T.
  if (!sh.filled && k_prefix < rings) {
    const long long lo = kChunk + (long long)blockIdx.x * seg_len;
    const int hi = (int)min((long long)n, lo + seg_len);
    for (int base = (int)min(lo, (long long)hi); base < hi;
         base += kDiscoverThreads * kFilterItems) {
      bool o[kFilterItems];
      float av[kFilterItems];
#pragma unroll
      for (int j = 0; j < kFilterItems; ++j) {
        const int i = base + j * kDiscoverThreads + threadIdx.x;
        o[j] = i < hi && v_scan[i];
        av[j] = i < hi ? a_scan[i] : 0.0f;
      }
      int at[kFilterItems];
      search<kFilterItems>(av, sh.s, size, tol, at);
#pragma unroll
      for (int j = 0; j < kFilterItems; ++j) {
        const int w0 = base + j * kDiscoverThreads + warp * 32;
        const bool keep = o[j] && !(at[j] < k_prefix &&
                                    matches(av[j], sh.s[slot(at[j])], tol));
        const unsigned word = __ballot_sync(kFull, keep);
        if (lane == 0 && w0 < hi) m_scan[w0 >> 5] = word;
      }
    }
  }

  // 3. The last block of the scan finishes it.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sh.last = atomicAdd(&arrive[b], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  int list = 0;  // marked points compacted into sh.stage, not yet resolved
  for (int t0 = kChunk / 32; t0 < words && !sh.filled && sh.n < rings;
       t0 += kTileWords) {
    // Which chunks of this tile hold an open point (a warp's words of one
    // load all lie in one chunk).
    if (threadIdx.x < kTileChunks / 32) sh.chunks[threadIdx.x] = 0u;
    __syncthreads();
    unsigned tile[kTileWords / kDiscoverThreads];
#pragma unroll
    for (int q = 0; q < kTileWords / kDiscoverThreads; ++q) {
      const int w = t0 + q * kDiscoverThreads + threadIdx.x;
      tile[q] = __ldcg(m_scan + min(w, words - 1)) * (w < words);
    }
#pragma unroll
    for (int q = 0; q < kTileWords / kDiscoverThreads; ++q) {
      const int c = (q * kDiscoverThreads + threadIdx.x) / (kChunk / 32);
      if (__any_sync(kFull, tile[q] != 0u) && lane == 0)
        atomicOr(&sh.chunks[c >> 5], 1u << (c & 31));
    }
    __syncthreads();
    for (int cw = 0; cw < kTileChunks / 32; ++cw) {
      for (unsigned cbits = sh.chunks[cw]; cbits != 0u; cbits &= cbits - 1u) {
        if (sh.filled || sh.n >= rings) break;
        // Append the chunk's marked points to the list, in input order.
        const int base =
            (t0 + (cw * 32 + __ffs((int)cbits) - 1) * (kChunk / 32)) * 32;
        unsigned word[kItems];
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int i = base + j * kDiscoverThreads + threadIdx.x;
          word[j] = i < n ? __ldcg(m_scan + (i >> 5)) : 0u;
          a[j] = i < n ? a_scan[i] : 0.0f;
          if (lane == 0) sh.seg[j * 32 + warp] = word[j];
        }
        __syncthreads();
        if (warp == 0) {
          unsigned w[kItems];
#pragma unroll
          for (int q = 0; q < kItems; ++q) w[q] = sh.seg[lane * kItems + q];
          int total;
          int pre = list + word_prefix(w, total);
#pragma unroll
          for (int q = 0; q < kItems; ++q) {
            sh.off[lane * kItems + q] = pre;
            pre += __popc(w[q]);
          }
          if (lane == 0) sh.count = list + total;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kItems; ++j)
          if ((word[j] >> lane) & 1u)
            sh.stage[sh.off[j * 32 + warp] +
                     __popc(word[j] & ((1u << lane) - 1u))] = a[j];
        list = sh.count;
        __syncthreads();
        if (list >= kChunk) {
          finish_list(sh, list, size, rings, tol);
          list = 0;
        }
      }
    }
    __syncthreads();
  }
  if (list > 0 && !sh.filled && sh.n < rings)
    finish_list(sh, list, size, rings, tol);

  // The sorted table, with the fill's copies where they sort (NaN last,
  // +inf after the finite entries, anything else first).
  const int ns = sh.n;
  const int nfill = sh.filled ? rings - ns : 0;
  const float fv = sh.fill;
  const int at = nfill > 0 && (isnan(fv) || fv > 0.0f) ? ns : 0;
  for (int m = threadIdx.x; m < rings; m += blockDim.x)
    angles[(size_t)b * rings + m] =
        m < at ? sh.s[slot(m)]
               : m < at + nfill ? fv
                                : (m - nfill < ns ? sh.s[slot(m - nfill)]
                                                  : INFINITY);
  if (threadIdx.x == 0) count[b] = ns + nfill;
}

// Grid (X, B), a few waves of blocks striding over each scan.  The scan's
// sorted table is staged in shared memory in the padded search layout.
// Each thread takes 4 points at a time: a float4 of alpha, the 4 valid
// bytes in one 32-bit load, an int4 store; a head before the first common
// 16-byte boundary of the streams, and the tail, point by point (the whole
// scan when the streams share no such boundary).
__global__ void __launch_bounds__(kAssignThreads)
    assign_kernel(const float* __restrict__ alpha,
                  const bool* __restrict__ valid,
                  const float* __restrict__ angles, int n, int rings,
                  const float* __restrict__ tol_p, int* __restrict__ ring) {
  __shared__ float table[kSearchSlots];
  __shared__ float s_tol;  // the interval, read once per block
  const int b = blockIdx.y;
  const int size = search_size(rings);
  for (int m = threadIdx.x; m < size; m += blockDim.x)
    table[slot(m)] = m < rings ? angles[(size_t)b * rings + m] : INFINITY;
  if (threadIdx.x == 0) s_tol = __ldg(tol_p);
  __syncthreads();
  const float tol = s_tol;
  const float* a = alpha + (size_t)b * n;
  const bool* v = valid + (size_t)b * n;
  int* out = ring + (size_t)b * n;
  const uintptr_t pa = (uintptr_t)a, pv = (uintptr_t)v, po = (uintptr_t)out;
  const int head_a = (int)(((16u - (pa & 15u)) & 15u) >> 2);
  const bool vec = (pa & 3u) == 0 && (po & 3u) == 0 &&
                   head_a == (int)(((16u - (po & 15u)) & 15u) >> 2) &&
                   head_a == (int)((4u - (pv & 3u)) & 3u);
  const int head = vec ? min(head_a, n) : n;
  const int nvec = (n - head) >> 2;
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  // Two vectors a thread per step, their loads in flight together; the
  // streams are read and written once (streaming cache hints).
  for (int q = tid; q < nvec; q += 2 * stride) {
    float4 a4[2];
    unsigned v4[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = head + 4 * min(q + u * stride, nvec - 1);
      a4[u] = __ldcs(reinterpret_cast<const float4*>(a + i));
      v4[u] = __ldcs(reinterpret_cast<const unsigned*>(v + i));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (q + u * stride >= nvec) break;
      const float pts[4] = {a4[u].x, a4[u].y, a4[u].z, a4[u].w};
      int lo[4];
      search<4>(pts, table, size, tol, lo);
      int r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r[e] = ((v4[u] >> (8 * e)) & 0xffu) && lo[e] < rings &&
                       matches(pts[e], table[slot(lo[e])], tol)
                   ? lo[e]
                   : rings;
      __stcs(reinterpret_cast<int4*>(out + head + 4 * (q + u * stride)),
             make_int4(r[0], r[1], r[2], r[3]));
    }
  }
  // Point by point: [0, head), then [head + 4 nvec, n).
  for (int s = tid; s < n - 4 * nvec; s += stride) {
    const int i = s < head ? s : s + 4 * nvec;
    out[i] = v[i] ? first_match(a[i], table, size, rings, tol) : rings;
  }
}

// SM count and resident blocks per SM of K2, K3 and K1's one-wave form,
// per device.
struct Fill {
  int sms = 0, discover_per_sm = 1, assign_per_sm = 1, prep_per_sm = 1;
};

Fill fill_of_current_device() {
  static Fill cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return Fill{1, 1, 1, 1};
  Fill& f = cache[dev];
  if (f.sms == 0) {
    Fill g;
    if (cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess || g.sms < 1)
      g.sms = 1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &g.discover_per_sm, discover_kernel, kDiscoverThreads, 0) !=
            cudaSuccess || g.discover_per_sm < 1)
      g.discover_per_sm = 1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &g.assign_per_sm, assign_kernel, kAssignThreads, 0) !=
            cudaSuccess || g.assign_per_sm < 1)
      g.assign_per_sm = 1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &g.prep_per_sm, ingest_prep_kernel<kStrided, 2>,
            Prep<2>::kBlock, 0) != cudaSuccess || g.prep_per_sm < 1)
      g.prep_per_sm = 1;
    cudaGetLastError();  // a failed query must not fail the launch
    f = g;
  }
  return f;
}

}  // namespace

// Each entry point writes the grid it launched to grid[0..2) (x, y), or
// zeros when it launched nothing.

template <int kMode, int kPts>
void launch_prep(dim3 grid, cudaStream_t s, const float* x, const float* y,
                 const float* z, long long scan_stride,
                 long long point_stride, int n, const float* roi, float kfi,
                 int want_keys, bool* valid, int* fk, float* r_key,
                 int* piece) {
  ingest_prep_kernel<kMode, kPts><<<grid, Prep<kPts>::kBlock, 0, s>>>(
      x, y, z, scan_stride, point_stride, n, roi, kfi, want_keys, valid, fk,
      r_key, piece);
}

// x, y, z: the (b, n) coordinate views, one stride pattern.  Rows of 4
// floats whose x is 16-byte aligned are read a float4 per point, planes a
// float4 per 4 points (batches), anything else point by point.  roi: the
// six bounds (min_x, max_x, min_y, max_y, min_z, max_z) in device memory,
// float32, read by each block as it starts, so a captured graph takes a
// new box from one write into them.
extern "C" int urf_ingest_prep(const float* x, const float* y, const float* z,
                               int b, int n, long long scan_stride,
                               long long point_stride, const float* roi,
                               float kfi, int want_keys, bool* valid, int* fk,
                               float* r_key, int* piece, int* grid_out,
                               void* stream) {
  grid_out[0] = grid_out[1] = 0;
  if (b <= 0) return (int)cudaGetLastError();
  const Fill f = fill_of_current_device();
  // Two points a thread, point by point, while the call's blocks fit in
  // one wave, else 8; at least one block per scan (it counts, and may
  // zero, when n is 0).
  const long long resident = (long long)f.sms * f.prep_per_sm;
  const long long m = n > 0 ? n : 1, t2 = 2 * Prep<2>::kThreads;
  const int pts = (m + t2 - 1) / t2 * b <= resident ? 2 : 8;
  const long long per_block = pts == 2 ? t2 : 8 * Prep<8>::kThreads;
  const dim3 grid((unsigned)((m + per_block - 1) / per_block), b);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool rows4 = point_stride == 4 && y == x + 1 && z == x + 2 &&
                     ((uintptr_t)x & 15u) == 0 && scan_stride % 4 == 0;
  decltype(&launch_prep<kStrided, 2>) launch = &launch_prep<kStrided, 2>;
  if (pts == 8)
    launch = point_stride == 1 ? &launch_prep<kPlanar, 8>
             : rows4           ? &launch_prep<kRows4, 8>
                               : &launch_prep<kStrided, 8>;
  launch(grid, s, x, y, z, scan_stride, point_stride, n, roi, kfi, want_keys,
         valid, fk, r_key, piece);
  grid_out[0] = (int)grid.x;
  grid_out[1] = (int)grid.y;
  return (int)cudaGetLastError();
}

// scratch: b arrival counters, then b * ceil(n / 32) mask words.  The
// counters are zeroed here, on the launch's stream.  tol (K2 and K3): the
// interval, one float32 in device memory, read by each block as it starts.
extern "C" int urf_discover_rings(const float* alpha, const bool* valid,
                                  int b, int n, const float* tol, int rings,
                                  float* angles, int* count, int* scratch,
                                  int* grid_out, void* stream) {
  grid_out[0] = grid_out[1] = 0;
  if (rings > kMaxRings) return (int)cudaErrorInvalidValue;
  if (b <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  int segs = 1;
  long long seg_len = kMinSegment;
  if (n > kChunk && rings > 0) {
    const long long rest = (long long)n - kChunk;
    const Fill f = fill_of_current_device();
    const long long resident = (long long)f.sms * f.discover_per_sm;
    const long long want = resident / b > 1 ? resident / b : 1;
    const long long most = (rest + kMinSegment - 1) / kMinSegment;
    const long long s0 = want < most ? want : most;
    seg_len = ((rest + s0 - 1) / s0 + 31) / 32 * 32;
    segs = (int)((rest + seg_len - 1) / seg_len);
  }
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * (size_t)b, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(segs, b);
  discover_kernel<<<grid, kDiscoverThreads, 0, s>>>(
      alpha, valid, n, tol, rings, (int)seg_len,
      reinterpret_cast<unsigned*>(scratch + b), scratch, angles, count);
  grid_out[0] = (int)grid.x;
  grid_out[1] = (int)grid.y;
  return (int)cudaGetLastError();
}

extern "C" int urf_assign_rings(const float* alpha, const bool* valid,
                                const float* angles, int b, int n, int rings,
                                const float* tol, int* ring, int* grid_out,
                                void* stream) {
  grid_out[0] = grid_out[1] = 0;
  if (rings > kMaxRings) return (int)cudaErrorInvalidValue;
  if (b > 0 && n > 0) {
    const Fill f = fill_of_current_device();
    const long long per_scan = ((long long)n + 4 * kAssignThreads - 1) /
                               (4 * kAssignThreads);
    const long long waves =
        ((long long)kAssignWaves * f.sms * f.assign_per_sm + b - 1) / b;
    const dim3 grid((unsigned)(per_scan < waves ? per_scan : waves), b);
    assign_kernel<<<grid, kAssignThreads, 0, (cudaStream_t)stream>>>(
        alpha, valid, angles, n, rings, tol, ring);
    grid_out[0] = (int)grid.x;
    grid_out[1] = (int)grid.y;
  }
  return (int)cudaGetLastError();
}
