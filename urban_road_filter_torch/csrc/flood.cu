// Blind-spot flood fill: blocked bits, then the road mask, fused with the
// marker stage's first pass or on its own.
//
// Replaces three TPU kernels of urban_road_filter_tpu/ops/flood_scan.py:
//   * blocked_pallas (K8): per (ring k, sweep start i in 0..361), is any
//     curb slot of ring k inside the forward window [i, i + w_k] or the
//     backward window [i - w_k, i]?  The TPU streamed (ring, slot) blocks
//     with the 362 starts on sublanes, in three 128-start windows skipped by
//     a min/max precheck.  Here over any number of azimuth wedges of R
//     rings in one launch (the sharded path's stacked layout).
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
// with --fmad=false; the adds below are __fadd_rn / __fsub_rn anyway), the
// exact-equality specials i == 360 - bz (forward hi -> 360) and i == bz
// (backward lo -> 0) for rings k >= 1 only, and NaN azimuths that never
// block and never become road (every compare with NaN is false).
//
// K8: the per-start loop turned around.  Start i's forward window
// [i, fl(i + w_k)] holds a curb exactly when the smallest curb azimuth a
// >= i does (the nearest curb at or after i is the first one the window
// can hold), and its backward window [fl(i - w_k), i] when the largest
// curb azimuth a <= i does.  For an integer i, a >= i holds exactly when
// top(a) >= i, with top(a) = floor(a) (361 for a >= 361, none for a < 0),
// and a <= i exactly when first(a) <= i, with first(a) = ceil(a) (0 for
// a <= 0, none for a > 361).  So per row the kernel reduces the smallest
// curb azimuth per top and the largest per first in shared memory
// (atomicMin / atomicMax of ordered images), then one block-wide scan per
// sweep takes a suffix minimum (forward) or a prefix maximum (backward)
// over the 362 starts and compares it with the twin's bound, rounded once
// in f32 (__fadd_rn / __fsub_rn), as the dense compare does.  The special
// starts (rings >= 1) replace the generic bound, so their bits are set on
// their own: forward i* == 360 - bz is blocked by a curb with i* <= a <= 360,
// backward bz by one with 0 <= a <= bz.  A NaN w_k makes every compare
// false; +-inf blocks every start with a curb on the right side.  Cost per
// row: O(curbs + 362), not O(362 x curbs).  One block per (wedge, ring)
// row, so the azimuth-sharded path's wedges are one launch.  What bounds
// it on Hopper: the launch and fixed costs per block, not bytes (~0.3 us
// of them per counted 64 x 4096 layout): the row's count, then its slots
// (two trips to memory), the reads of one SM, the barriers and the
// instruction fetches of code that each block runs once (PERF.md).
//
// K9 and K12: the starts that cover a slot form an interval.  For a slot
// of ring k with a valid azimuth a (0 <= a <= 360, not NaN):
//   * Forward, start i covers a when i <= a <= fl(i + w_k).  i <= a holds
//     exactly for i <= floor(a) (i is an integer, a a float).  fl(i + w_k)
//     is non-decreasing in i (f32 rounding is monotone), so a <= fl(i + w_k)
//     holds on an upward-closed set [i0, 361]: i0 is found by bisection over
//     the 362 starts, with the twin's exact f32 add at each probe.  The
//     slot is forward road when a reached start lies in [i0, floor(a)].
//   * Backward, the mirror case: fl(i - w_k) <= a holds on a
//     downward-closed set [0, i1] and a <= i for i >= ceil(a); the slot is
//     backward road when a reached start lies in [ceil(a), i1].
//   * The special starts (rings >= 1) break monotonicity and are tested on
//     their own: the forward start i* == fl(360 - bz), when it is an
//     integer in 0..361, covers a when i* <= a (its hi is 360 >= a); the
//     backward start i == bz covers a when a <= bz (its lo is 0).  The
//     interval test may count them with their generic bounds too: a start
//     the generic bound covers, the special bound covers as well, so the OR
//     is exact.
//   * A NaN w_k makes every probe false, so both intervals are empty (an
//     empty ring 0 has w = 0/0, ops/blind_spots.py:window_widths); +-inf
//     keeps fl(i +- w_k) monotone.
// "A reached start in [lo, hi]" is a difference of prefix counts: per block,
// the ring's 362 reach bits of each sweep are packed into 12 words in
// shared memory (warp ballots), with each word's count of set bits before
// it; a count below j is one word prefix plus one popc.  So each slot costs
// two 9-step bisections (an f32 add and a compare each) and four popcs
// instead of a loop over the 362 starts (~190M predicated compares per
// 64 x 4096 layout before).
//
// Layout of the work: one block per (ring, tile of 4 x blockDim slots),
// and for K9 per lane of a batch (the grid's third axis: a batch of scans'
// stacked layouts is one launch, each lane with its own w, reach bits,
// num_rings and row of kf, its keys counting rings within the lane);
// each thread takes four slots blockDim apart, so every load and store of a
// warp is one contiguous segment.  The slots' loads are issued before the
// block packs the reach bits, so the two overlap.  What bounds it on
// Hopper: memory (K9 reads alpha and label and writes label, 12 bytes per
// slot, ~3 MB per 64 x 4096 layout; K12 9 bytes) and the launch, with the
// bisections' ~150 instructions per slot spread over every SM.
//
// K9's marker keys: per slot that is not road afterwards, a shared 64-bit
// atomicMin of its key on its bin.  Keys are totally ordered, so any order
// of minima gives the same result.  (Meeting per bin inside the warp first,
// __match_any_sync and two __reduce_min_sync, measured slower on an H100:
// 0.0106 against 0.0063 ms per launch at 64 x 4096, PERF.md.)  Each block
// then folds its touched bins into kf with global atomicMin.  kf needs its
// initial value (kNoKey) before the first fold, and the launch writes it
// itself (every lane's row), so a call is one device op: as it starts,
// each block takes a
// ticket from a per-device counter; tickets run on across launches, and
// g_kf_first holds the first ticket of the launch that has not yet
// initialised kf.  The block holding that ticket writes kf, fences, and
// publishes the next launch's first ticket (its own plus the block count)
// with a release store; every other block waits, before its fold, until
// g_kf_first has passed its own ticket (an acquire load).  The first block
// took its ticket, so it is resident, and it waits on nothing: no
// deadlock.  It initialises as it starts, so the others find kf ready by
// the time they fold.  At 64 x 4096 on an H100 a launch takes 0.0049 ms,
// against 0.0062 for a last-arriving block that finishes kf from an
// accumulator and 0.0054 for a pre-fill plus the kernel (PERF.md).  The
// counters are this library's own device globals, so K9 launches on one
// device must not run concurrently (the port's paths issue them on one
// stream).
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
constexpr int kWords = (kStarts + 31) / 32;  // reach bits per sweep, packed
constexpr int kBins = 361;    // one-degree azimuth bins 0..360
constexpr int kCurb = 2;      // LABEL_CURB
constexpr int kRoad = 1;      // LABEL_ROAD
constexpr int kThreads = 256;  // K9 / K12 block size, at most
constexpr int kSlots = 4;      // slots per thread
constexpr unsigned long long kNoKey = 0x7fffffffffffffffULL;

// K9's per-device block tickets: every K9 block takes the next one as it
// starts, and the first ticket of the launch that initialises kf next.
__device__ unsigned long long g_kf_ticket = 0ULL;
__device__ unsigned long long g_kf_first = 0ULL;

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

__device__ __forceinline__ unsigned long long marker_key(int ring, float a,
                                                         int slot) {
  // a + 0.0f turns a -0.0 into +0.0, which compares equal to it anyway.
  return ((unsigned long long)ring << 48) |
         ((unsigned long long)__float_as_uint(a + 0.0f) << 16) |
         (unsigned long long)slot;
}

// One ring's reach bits of both sweeps (0 forward, 1 backward), packed, and
// per word the count of set bits in the words before it.
struct RingReach {
  unsigned int word[2][kWords];
  int before[2][kWords];
};

// Set bits of sweep sw among starts [0, j), j in 0..362.
__device__ __forceinline__ int reached_below(const RingReach& rr, int sw,
                                             int j) {
  const int v = j >> 5;  // <= 11
  return rr.before[sw][v] + __popc(rr.word[sw][v] & ((1u << (j & 31)) - 1u));
}

// Any set bit of sweep sw among starts [lo, hi]; 0 <= lo, hi <= 361.
__device__ __forceinline__ bool reached_in(const RingReach& rr, int sw,
                                           int lo, int hi) {
  return lo <= hi && reached_below(rr, sw, hi + 1) > reached_below(rr, sw, lo);
}

__device__ __forceinline__ bool reached_at(const RingReach& rr, int sw,
                                           int i) {
  return (rr.word[sw][i >> 5] >> (i & 31)) & 1u;
}

// The first start i in 0..361 with a <= fl(i + wk), or 362.  The starts
// before it are exactly those where the predicate fails (a prefix, since
// fl(i + wk) is non-decreasing), so nine halving steps count them.
__device__ __forceinline__ int first_forward(float a, float wk) {
  int n = 0;
#pragma unroll
  for (int step = 256; step > 0; step >>= 1)
    if (n + step <= kStarts && !(a <= __fadd_rn((float)(n + step - 1), wk)))
      n += step;
  return n;
}

// The number of starts i in 0..361 with fl(i - wk) <= a (a prefix, since
// fl(i - wk) is non-decreasing): the last such start plus one.
__device__ __forceinline__ int backward_end(float a, float wk) {
  int n = 0;
#pragma unroll
  for (int step = 256; step > 0; step >>= 1)
    if (n + step <= kStarts && __fsub_rn((float)(n + step - 1), wk) <= a)
      n += step;
  return n;
}

// K8.  The ordered integer image of a float: unsigned order == float
// order (NaN excluded).  kNoMin and kNoMax lie above and below every image.
constexpr unsigned int kNoMin = 0xffffffffu;
constexpr unsigned int kNoMax = 0u;

__device__ __forceinline__ unsigned int ordered(float v) {
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct BlockedArgs {
  const float* alpha;
  const int* label;
  const int* counts;
  const float* w;  // (wedges, rings), lane stride w_stride (0: shared)
  long long w_stride;
  bool* blocked_f;  // (rows, kStarts)
  bool* blocked_b;
  int rings;  // rings per wedge
  int rows;   // wedges * rings
  int p;
  const float* bz;  // the beam zone, in device memory
  bool vec;  // alpha and label are 16-byte aligned
};

constexpr int kScan = 384;  // the 362 starts, padded to whole warps

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int at = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies quads [qb, qb + n) of the flat alpha and label arrays into shared
// memory, 16 bytes a copy in flight at once where the bases are aligned
// (cp.async, no registers held), else element by element (0 past the end).
template <int kThreads>
__device__ __forceinline__ void blocked_stage(const BlockedArgs& A,
                                              size_t total, size_t qb, int n,
                                              float4* s_a, int4* s_l) {
  for (int qi = threadIdx.x; qi < n; qi += kThreads) {
    const size_t e = 4 * (qb + (size_t)qi);
    if (A.vec && e + 4 <= total) {
      cp_async16(s_a + qi, A.alpha + e);
      cp_async16(s_l + qi, A.label + e);
    } else {
      float av[4];
      int lv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        av[j] = e + j < total ? __ldg(A.alpha + e + j) : 0.0f;
        lv[j] = e + j < total ? __ldg(A.label + e + j) : 0;
      }
      s_a[qi] = make_float4(av[0], av[1], av[2], av[3]);
      s_l[qi] = make_int4(lv[0], lv[1], lv[2], lv[3]);
    }
  }
}

// Grid: one block per (wedge, ring) row, kThreads threads (128 or 384);
// thread t scans starts [t * kSeg, (t + 1) * kSeg).  The row's count, then
// its counted slots, go through shared memory in chunks of 3 * kThreads
// quads, so a row of up to 4096 slots is one chunk (the host takes 128
// threads up to 1024 slots), every copy of a chunk in flight at once.
// The code is kept compact (rolled loops): each block runs it once, so its
// instruction fetches, not its arithmetic, set much of its time
// (tools/clock_flood_markers.py splits it by phase).
template <int kThreads>
__global__ void __launch_bounds__(kThreads) blocked_kernel(BlockedArgs A) {
  constexpr int kSeg = kScan / kThreads;
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunk = 3 * kThreads;  // quads staged at a time
  __shared__ float4 s_aq[kChunk];
  __shared__ int4 s_lq[kChunk];
  __shared__ unsigned int s_min[kScan];  // per top start
  __shared__ unsigned int s_max[kScan];  // per first start
  __shared__ unsigned int s_wmin[kWarps], s_wmax[kWarps];
  __shared__ int s_special[2];
  __shared__ float s_bz;  // the beam zone, read once per block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x;
  const int k = row % A.rings;  // the ring within its wedge
  const size_t row0 = (size_t)row * A.p;
  const size_t total = (size_t)A.rows * A.p;
  // Quads of the flat arrays that hold the row's slots, from q_lo.
  const size_t q_lo = row0 / 4;
  const float wk = __ldg(A.w + (size_t)(row / A.rings) * A.w_stride + k);
  const int cnt = min(max(__ldg(A.counts + row), 0), A.p);
  // Quads that hold the row's counted slots [0, cnt).
  const int nq = cnt > 0 ? (int)((row0 + cnt - 1) / 4 - q_lo + 1) : 0;
  blocked_stage<kThreads>(A, total, q_lo, min(nq, kChunk), s_aq, s_lq);
  for (int b = tid; b < kScan; b += kThreads) {
    s_min[b] = kNoMin;
    s_max[b] = kNoMax;
  }
  if (tid < 2) s_special[tid] = 0;
  if (tid == 0) s_bz = __ldg(A.bz);
  cp_async_wait_all();
  __syncthreads();
  // The special starts, each an integer start or none (-1), rings >= 1.
  const float bz = s_bz;
  const float edge = __fsub_rn(360.0f, bz);
  const bool ge1 = k >= 1;
  const int i_f = (ge1 && edge >= 0.0f && edge <= 361.0f &&
                   edge == floorf(edge)) ? (int)edge : -1;
  const int i_b = (ge1 && bz >= 0.0f && bz <= 361.0f &&
                   bz == floorf(bz)) ? (int)bz : -1;

  // The row's curbs: per top the smallest azimuth, per first the largest.
  bool sp_f = false, sp_b = false;
  for (int c0 = 0; c0 < nq; c0 += kChunk) {
    if (c0 > 0) {  // rows longer than one chunk
      __syncthreads();
      blocked_stage<kThreads>(A, total, q_lo + c0, min(nq - c0, kChunk),
                              s_aq, s_lq);
      cp_async_wait_all();
      __syncthreads();
    }
    for (int qi = tid; qi < min(nq - c0, kChunk); qi += kThreads) {
      const int4 l4 = s_lq[qi];
      if (l4.x != kCurb && l4.y != kCurb && l4.z != kCurb && l4.w != kCurb)
        continue;
      const float4 a4 = s_aq[qi];
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const int lv[4] = {l4.x, l4.y, l4.z, l4.w};
      const long long s0 =
          (long long)(4 * (q_lo + (size_t)(c0 + qi))) - (long long)row0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long s = s0 + j;
        const float a = av[j];
        // NaN never blocks.
        if (!(s >= 0 && s < cnt && lv[j] == kCurb && a == a)) continue;
        const unsigned int img = ordered(a);
        if (a >= 0.0f)  // forward: blocks starts up to top
          atomicMin(&s_min[a >= 361.0f ? 361 : (int)floorf(a)], img);
        if (a <= 361.0f)  // backward: blocks starts from first
          atomicMax(&s_max[a <= 0.0f ? 0 : (int)ceilf(a)], img);
        sp_f |= i_f >= 0 && (float)i_f <= a && a <= 360.0f;
        sp_b |= i_b >= 0 && 0.0f <= a && a <= (float)i_b;
      }
    }
  }
  if (sp_f) s_special[0] = 1;
  if (sp_b) s_special[1] = 1;
  __syncthreads();

  // Forward: start i is blocked when the smallest curb azimuth at or above
  // it (a suffix minimum over the tops >= i) is <= fl(i + w_k); backward:
  // when the largest at or below it (a prefix maximum over the firsts
  // <= i) is >= fl(i - w_k).  One block-wide scan each: a thread's kSeg
  // starts, then its warp, then the warps' totals.  The special start
  // takes its own bound's bit, not the generic one's.
  const int i0 = kSeg * tid;
  unsigned int vf[kSeg], vb[kSeg];
#pragma unroll
  for (int t = 0; t < kSeg; ++t) {
    vf[t] = s_min[i0 + t];
    vb[t] = s_max[i0 + t];
  }
#pragma unroll
  for (int t = kSeg - 2; t >= 0; --t) vf[t] = min(vf[t], vf[t + 1]);
#pragma unroll
  for (int t = 1; t < kSeg; ++t) vb[t] = max(vb[t], vb[t - 1]);
  unsigned int tf = vf[0], tb = vb[kSeg - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int f = __shfl_down_sync(~0u, tf, o);
    const unsigned int b = __shfl_up_sync(~0u, tb, o);
    if (lane + o < 32) tf = min(tf, f);
    if (lane >= o) tb = max(tb, b);
  }
  if (lane == 0) s_wmin[warp] = tf;
  if (lane == 31) s_wmax[warp] = tb;
  unsigned int after = __shfl_down_sync(~0u, tf, 1);
  unsigned int before = __shfl_up_sync(~0u, tb, 1);
  if (lane == 31) after = kNoMin;
  if (lane == 0) before = kNoMax;
  __syncthreads();
  if (warp == 0) {  // over the warps' totals: exclusive, in place
    unsigned int f = lane < kWarps ? s_wmin[lane] : kNoMin;
    unsigned int b = lane < kWarps ? s_wmax[lane] : kNoMax;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const unsigned int g = __shfl_down_sync(~0u, f, o);
      const unsigned int h = __shfl_up_sync(~0u, b, o);
      if (lane + o < 32) f = min(f, g);
      if (lane >= o) b = max(b, h);
    }
    f = __shfl_down_sync(~0u, f, 1);
    b = __shfl_up_sync(~0u, b, 1);
    if (lane < kWarps) {
      s_wmin[lane] = lane + 1 < kWarps ? f : kNoMin;
      s_wmax[lane] = lane > 0 ? b : kNoMax;
    }
  }
  __syncthreads();
  after = min(after, s_wmin[warp]);
  before = max(before, s_wmax[warp]);
  bool* out_f = A.blocked_f + (size_t)row * kStarts;
  bool* out_b = A.blocked_b + (size_t)row * kStarts;
  const bool spf = s_special[0] != 0, spb = s_special[1] != 0;
#pragma unroll
  for (int t = 0; t < kSeg; ++t) {
    const int i = i0 + t;
    if (i >= kStarts) break;
    const unsigned int mf = min(vf[t], after), mb = max(vb[t], before);
    const bool hf = mf != kNoMin && unordered(mf) <= __fadd_rn((float)i, wk);
    const bool hb = mb != kNoMax && __fsub_rn((float)i, wk) <= unordered(mb);
    out_f[i] = i == i_f ? spf : hf;
    out_b[i] = i == i_b ? spb : hb;
  }
}

// Grid: (slot tiles of kSlots * blockDim, rings, lanes), blockDim a
// multiple of 32; ring r of lane b is row b * rings + r of the stacked
// (lanes * rings, p) layout, and of w and the reach bits.  kMarker (K9):
// label_out and kf (lanes, 361), with num_rings (lanes,); without it (K12,
// one lane): road_out only, and label_in, num_rings, label_out, kf are
// unused.
template <bool kMarker>
__global__ void __launch_bounds__(kThreads)
    labeled_kernel(const float* __restrict__ alpha,
                   const int* __restrict__ label_in,
                   const int* __restrict__ counts,
                   const float* __restrict__ w,
                   const bool* __restrict__ reach_f,
                   const bool* __restrict__ reach_b,
                   const int* __restrict__ num_rings, int p,
                   const float* __restrict__ bz_p,
                   int* __restrict__ label_out,
                   unsigned long long* __restrict__ kf,
                   bool* __restrict__ road_out) {
  __shared__ RingReach rr;
  __shared__ unsigned long long kf_blk[kMarker ? kBins : 1];
  __shared__ bool first;
  __shared__ float s_bz;  // the beam zone, read once per block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = blockIdx.y;  // the ring within its lane: the key's ring
  const size_t lr = (size_t)blockIdx.z * gridDim.y + r;  // the stacked row
  const size_t row = lr * p;
  const int tile = blockIdx.x * blockDim.x * kSlots;
  // K9: this block's ticket, and whether it is the launch's first.
  unsigned long long ticket = 0ULL, first_ticket = 1ULL;
  if (kMarker && tid == 0) {
    ticket = atomicAdd(&g_kf_ticket, 1ULL);
    first_ticket = load_acquire(&g_kf_first);
  }

  // The slots' loads first: they are in flight while the block packs the
  // ring's reach bits.
  float a[kSlots];
  int lab[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = tile + j * blockDim.x + tid;
    const bool in = s < p;
    a[j] = in ? alpha[row + s] : -1.0f;
    lab[j] = (kMarker && in) ? label_in[row + s] : 0;
  }
  const int cnt = counts[lr];
  const float wk = w[lr];
  const int nr = kMarker ? num_rings[blockIdx.z] : 0;

  for (int v = tid >> 5; v < 2 * kWords; v += blockDim.x >> 5) {
    const int sw = v / kWords, i = (v % kWords) * 32 + lane;
    const bool* reach = sw ? reach_b : reach_f;
    const bool bit = i < kStarts && reach[lr * kStarts + i];
    const unsigned int bits = __ballot_sync(~0u, bit);
    if (lane == 0) rr.word[sw][v % kWords] = bits;
  }
  if constexpr (kMarker) {
    for (int b = tid; b < kBins; b += blockDim.x) kf_blk[b] = kNoKey;
    if (tid == 0) first = ticket == first_ticket;
  }
  if (tid == 0) s_bz = __ldg(bz_p);
  __syncthreads();
  if (kMarker && first) {  // kf's initial value, before any block's minima
    for (int b = tid; b < kBins * (int)gridDim.z; b += blockDim.x)
      kf[b] = kNoKey;
    __threadfence();
  }
  if (tid < 2) {
    int c = 0;
    for (int v = 0; v < kWords; ++v) {
      rr.before[tid][v] = c;
      c += __popc(rr.word[tid][v]);
    }
  }
  __syncthreads();
  if (kMarker && first && tid == 0)
    store_release(&g_kf_first,
                  ticket + (unsigned long long)gridDim.x * gridDim.y *
                               gridDim.z);

  // The special starts, each an integer start or none (-1), rings >= 1.
  const float bz = s_bz;
  const float sp_f = 360.0f - bz;
  const bool ge1 = r >= 1;
  const int i_f = (ge1 && sp_f >= 0.0f && sp_f <= 361.0f &&
                   sp_f == floorf(sp_f)) ? (int)sp_f : -1;
  const int i_b = (ge1 && bz >= 0.0f && bz <= 361.0f && bz == floorf(bz))
                      ? (int)bz : -1;
  const bool special_f = i_f >= 0 && reached_at(rr, 0, i_f);
  const bool special_b = i_b >= 0 && reached_at(rr, 1, i_b);

#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = tile + j * blockDim.x + tid;
    const bool in = s < p;
    const float aj = a[j];
    const bool a_ok = in && s < cnt && aj >= 0.0f && aj <= 360.0f;
    bool road = false;
    if (a_ok) {
      road = reached_in(rr, 0, first_forward(aj, wk), (int)floorf(aj)) ||
             reached_in(rr, 1, (int)ceilf(aj), backward_end(aj, wk) - 1) ||
             (special_f && (float)i_f <= aj) ||
             (special_b && aj <= (float)i_b);
    }
    if constexpr (kMarker) {
      const int out = (road && lab[j] != kCurb) ? kRoad : lab[j];
      if (in) label_out[row + s] = out;
      const bool want = a_ok && out != kRoad && r < nr;
      if (want) atomicMin(&kf_blk[(int)floorf(aj)], marker_key(r, aj, s));
    } else {
      if (in) road_out[row + s] = road;
    }
  }

  if constexpr (kMarker) {
    // Wait (rarely: the first block initialises kf as it starts) until kf
    // holds its initial value, then fold this block's minima into it.
    if (tid == 0 && !first)
      while (load_acquire(&g_kf_first) <= ticket) {
      }
    __syncthreads();
    for (int b = tid; b < kBins; b += blockDim.x)
      if (kf_blk[b] != kNoKey)
        atomicMin(&kf[(size_t)blockIdx.z * kBins + b], kf_blk[b]);
  }
}

// Threads per K9 / K12 block: enough for the ring's slots at kSlots each,
// a whole number of warps, at most kThreads.
int labeled_threads(int p) {
  const int quads = (p + kSlots - 1) / kSlots;
  return max(32, min(kThreads, (quads + 31) / 32 * 32));
}

}  // namespace

// blocked_f / blocked_b: (wedges * rings, 362) bool, row w * rings + k
// for ring k of wedge w (a wedge or a lane of a batch: one layout each).
// alpha (wedges * rings, p) f32, label int32, counts (wedges * rings,)
// int32, w (wedges, rings) f32 with lane stride w_stride (0: one (rings,)
// row shared by the wedges); the special starts apply to rings k >= 1 of
// each wedge.  One launch.
// bz (here and in K9, K12): the beam zone, one float32 in device memory,
// read by each block as it starts.
extern "C" int urf_flood_blocked(const float* alpha, const int* label,
                                 const int* counts, const float* w,
                                 long long w_stride, int wedges, int rings,
                                 int p,
                                 const float* bz, bool* blocked_f,
                                 bool* blocked_b,
                                 void* stream) {
  const long long rows = (long long)wedges * rings;
  if (wedges < 0 || rings < 0 || p < 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  auto is16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  // 128 threads for rows of up to 1024 slots, else 384.
  BlockedArgs a{alpha,     label, counts,    w, w_stride, blocked_f,
                blocked_b, rings, (int)rows, p, bz,
                is16(alpha) && is16(label)};
  if (p <= 1024)
    blocked_kernel<128><<<(int)rows, 128, 0, (cudaStream_t)stream>>>(a);
  else
    blocked_kernel<384><<<(int)rows, 384, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Over lanes scans of rings rings: alpha, label_in, label_out (lanes *
// rings, p), counts and w (lanes * rings,), reach_f / reach_b (lanes *
// rings, 362), num_rings (lanes,) int32.  label_out: LABEL_ROAD where the
// flood reaches a non-curb slot, else label_in.  kf (lanes, 361) uint64,
// written whole (no pre-fill): per lane and bin, the smallest marker key
// (its ring counted within the lane) of a non-road slot of a ring <
// num_rings[lane], kNoKey where there is none.  One launch; rings, p and
// lanes must be positive.
extern "C" int urf_flood_labeled(const float* alpha, const int* label_in,
                                 const int* counts, const float* w,
                                 const bool* reach_f, const bool* reach_b,
                                 const int* num_rings, int rings, int p,
                                 int lanes, const float* bz, int* label_out,
                                 unsigned long long* kf, void* stream) {
  if (rings <= 0 || p <= 0 || lanes <= 0 || rings > 65535 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = labeled_threads(p);
  const dim3 grid((p + threads * kSlots - 1) / (threads * kSlots), rings,
                  lanes);
  labeled_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
      alpha, label_in, counts, w, reach_f, reach_b, num_rings, p, bz,
      label_out, kf, nullptr);
  return (int)cudaGetLastError();
}

// road (rings, p) bool: a slot with a valid azimuth (slot < counts, alpha
// in [0, 360]) inside a reached window of either sweep (K12).
extern "C" int urf_flood_road(const float* alpha, const int* counts,
                              const float* w, const bool* reach_f,
                              const bool* reach_b, int rings, int p,
                              const float* bz, bool* road, void* stream) {
  if (rings <= 0 || p <= 0) return (int)cudaGetLastError();
  const int threads = labeled_threads(p);
  const dim3 grid((p + threads * kSlots - 1) / (threads * kSlots), rings);
  labeled_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
      alpha, nullptr, counts, w, reach_f, reach_b, nullptr, p, bz, nullptr,
      nullptr, road);
  return (int)cudaGetLastError();
}
