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
// with --fmad=false; the adds below are __fadd_rn / __fsub_rn anyway), the
// exact-equality specials i == 360 - bz (forward hi -> 360) and i == bz
// (backward lo -> 0) for rings k >= 1 only, and NaN azimuths that never
// block and never become road (every compare with NaN is false).
//
// K8 is bounded by the number of curb slots per ring, which is small: one
// block per ring compacts the ring's curb azimuths into shared memory
// (order does not matter to "any"), then one thread per start scans that
// short list.
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
// Layout of the work: one block per (ring, tile of 4 x blockDim slots);
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
// itself, so a call is one device op: as it starts, each block takes a
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

// Grid: (slot tiles of kSlots * blockDim, rings), blockDim a multiple of
// 32.  kMarker (K9): label_out and kf; without it (K12): road_out only, and
// label_in, num_rings, label_out, kf are unused.
template <bool kMarker>
__global__ void __launch_bounds__(kThreads)
    labeled_kernel(const float* __restrict__ alpha,
                   const int* __restrict__ label_in,
                   const int* __restrict__ counts,
                   const float* __restrict__ w,
                   const bool* __restrict__ reach_f,
                   const bool* __restrict__ reach_b,
                   const int* __restrict__ num_rings, int p, float bz,
                   int* __restrict__ label_out,
                   unsigned long long* __restrict__ kf,
                   bool* __restrict__ road_out) {
  __shared__ RingReach rr;
  __shared__ unsigned long long kf_blk[kMarker ? kBins : 1];
  __shared__ bool first;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = blockIdx.y;
  const size_t row = (size_t)r * p;
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
  const int cnt = counts[r];
  const float wk = w[r];
  const int nr = kMarker ? *num_rings : 0;

  for (int v = tid >> 5; v < 2 * kWords; v += blockDim.x >> 5) {
    const int sw = v / kWords, i = (v % kWords) * 32 + lane;
    const bool* reach = sw ? reach_b : reach_f;
    const bool bit = i < kStarts && reach[(size_t)r * kStarts + i];
    const unsigned int bits = __ballot_sync(~0u, bit);
    if (lane == 0) rr.word[sw][v % kWords] = bits;
  }
  if constexpr (kMarker) {
    for (int b = tid; b < kBins; b += blockDim.x) kf_blk[b] = kNoKey;
    if (tid == 0) first = ticket == first_ticket;
  }
  __syncthreads();
  if (kMarker && first) {  // kf's initial value, before any block's minima
    for (int b = tid; b < kBins; b += blockDim.x) kf[b] = kNoKey;
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
    store_release(&g_kf_first, ticket + gridDim.x * gridDim.y);

  // The special starts, each an integer start or none (-1), rings >= 1.
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
      if (kf_blk[b] != kNoKey) atomicMin(&kf[b], kf_blk[b]);
  }
}

// Threads per K9 / K12 block: enough for the ring's slots at kSlots each,
// a whole number of warps, at most kThreads.
int labeled_threads(int p) {
  const int quads = (p + kSlots - 1) / kSlots;
  return max(32, min(kThreads, (quads + 31) / 32 * 32));
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
// slot, else label_in.  kf (361,) uint64, written whole (no pre-fill): per
// bin, the smallest marker key of a non-road slot of a ring < num_rings,
// kNoKey where there is none.  One launch; rings and p must be positive.
extern "C" int urf_flood_labeled(const float* alpha, const int* label_in,
                                 const int* counts, const float* w,
                                 const bool* reach_f, const bool* reach_b,
                                 const int* num_rings, int rings, int p,
                                 float bz, int* label_out,
                                 unsigned long long* kf, void* stream) {
  if (rings <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  const int threads = labeled_threads(p);
  const dim3 grid((p + threads * kSlots - 1) / (threads * kSlots), rings);
  labeled_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
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
  if (rings <= 0 || p <= 0) return (int)cudaGetLastError();
  const int threads = labeled_threads(p);
  const dim3 grid((p + threads * kSlots - 1) / (threads * kSlots), rings);
  labeled_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
      alpha, nullptr, counts, w, reach_f, reach_b, nullptr, p, bz, nullptr,
      nullptr, road);
  return (int)cudaGetLastError();
}
