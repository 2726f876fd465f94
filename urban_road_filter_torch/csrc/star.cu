// Star-shaped roadside search: partition by beam, order each beam by radius,
// and the per-beam edge walk, in one launch from the unsorted keys.
//
// Replaces urban_road_filter_tpu/ops/star_scan.py:star_scan_pallas (K4)
// together with the stable 2-key lax.sort before it (ops/star.py:_star_sort
// of the JAX package).  The reference walks each of 360 radial beams
// outward (star_shaped_search.cpp:111-151): per step i >= 1 it forms the
// slope between consecutive points, folds it into a running mean and mean
// absolute deviation (NaN slopes are counted and skipped), and marks the
// first point whose slope exceeds a constant or an adaptive threshold,
// then breaks.  The TPU kernel turned the recurrences into segmented prefix
// sums over the (beam, radius)-sorted stream, because its grid has no
// cheap sequential walk.
//
// Input: per point its beam fk (0..359; 360 is the sink of points outside
// the ROI or the beam rectangle, skipped, as is anything outside 0..359),
// its radius r and z (any element stride).  Output: hp[b] = 1 + index of
// beam b's first triggering point, 0 where the beam has none.  Each beam
// is walked in the order of a stable ascending sort by radius: ties in
// input order, -0.0 equal to +0.0, NaN after +inf (torch.sort's order; the
// plain version in ops/star.py sorts with torch.sort).  Radii from the
// ingest kernel K1 are finite and >= +0 inside a beam.
//
// Design: one cooperative launch over a batch of lanes (one scan each; in
// the code below a lane of a warp keeps the name lane, a lane of the batch
// is a scan), grid
// min(lanes * 360, co-resident blocks) of 256 threads, two phases split by
// one grid barrier, no global atomics and no state kept between launches.
// Each lane is cut into P parts (P = min(360, co-resident blocks / lanes),
// at least 1), and a partition unit is one (lane, part) pair.
//   1. Partition.  Block g takes the units g, g + grid, ...; for unit u
//      (lane l, part j) it takes lane l's points j, j + P, ... (256 at a
//      time) and owns the region [u * cap, (u + 1) * cap) of the scratch,
//      cap >= its point count.  It counts its points per beam in shared
//      memory (warp-aggregated with __match_any_sync), lays its beams out
//      one after the other in its region (an exclusive prefix of the
//      counts), publishes each beam's run (start, count) in row u of the
//      (units, 360) run table, and scatters each beam point's 64-bit key
//      (order(r) << 32 | index within the lane) and its (r, z) to its run
//      (a shared cursor per beam).  The order inside a run is arbitrary;
//      the keys are unique within a lane, and sorting them gives exactly
//      the stable (radius, input order) order.  order() maps the float's
//      bits to an unsigned int that orders like torch.sort.
//   2. Walk.  One block per (lane, beam) pair (grid-stride over the lanes *
//      360 pairs) reads its lane's P runs of the beam (one load per run, a
//      block scan of the counts), so
//      element e of the beam is found by a bisection over the runs.  It
//      selects up to kChunk of the beam's smallest keys above the last one
//      walked (all of them when the rest of the beam fits; otherwise the
//      kChunk-th smallest is found by bisection over the key range, each
//      probe a count over the beam), compacts them with their (r, z) into
//      shared memory, sorts them (a rank count when at most 256, else a
//      bitonic sort), and walks them.  The walk usually trips in its first
//      few steps, so later chunks are rarely needed; no beam length is
//      capped and nothing is read back by the host.
// The result does not depend on the partition (the walk sees each beam's
// keys sorted), so a lane's hits equal those of a launch over that lane
// alone; at one lane the plan is the single-scan one (P = grid).
// Buckets that are contiguous per beam would need the beam lengths of all
// blocks first: global counters that every block reads back, and a second
// grid barrier.  Per-block regions need neither; a beam's walk pays for
// them with one bisection over its runs per element it reads.
//
// The walk, per chunk of 32 sorted points (warp 0, lane j at step i):
// every value off the loop-carried chain is computed by all lanes at once:
//   slp = (b_z - a_z) / (b_r - a_r), its NaN flag and the NaN prefix count
//   (a ballot), m = (float)i - NaNs so far, m - 1, inv_m = 1 / m,
//   (b_r - a_r) * kdist, slp * slp, and the constant test slp > slope_param
//   (the first step where it holds ends the walk).
// Only the two recurrences stay serial, each step's values staged in
// shared memory and read by every lane without a branch (a step past the
// chunk or past the first constant trip leaves the state as it is):
//   avg = (avg * (m - 1) + slp) * inv_m
//   dev = (dev * (m - 1) + |slp - avg|) * inv_m
//   trip: i > dmin and ((slp*slp - avg*avg) * kdev) * ((b_r - a_r) * kdist)
//         > dev
// every operation rounded to f32 in the reference's order (built with
// --fmad=false, so no multiply-add is contracted), which the plain walk in
// ops/star.py and the numpy oracle's _beam_walk repeat op for op; NaN
// steps leave avg and dev as they are and never trip.  The steps are
// counted as int and converted, equal to the reference's f32 count below
// 2^24 points (the wrapper's limit).
//
// What bounds it on Hopper.  Bytes: fk, r read once and z for the beam
// points (~1.1 MB at one OS1-64 scan of 131072 points, 0.3 us at 3.35
// TB/s).  The chain: per step two dependent f32 operations on avg then two
// on dev (~4 cycles each), ~16 cycles, times the longest walk (77 points on
// the OS1-64 drive scan: ~1.2K cycles, 0.6 us at 1.98 GHz; 354 on a bench
// lane: 2.9 us); the selection and sort of the longest beam beside it.  In
// practice the barrier and each beam's dependent loads (run column, keys)
// and its sort add several us.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBeams = 360;
constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // keys selected, sorted and walked per pass
constexpr int kRankMax = kThreads;  // rank-count sort up to this many keys
constexpr int kBeamsPerLane = (kBeams + 31) / 32;  // beams per lane, prefix
constexpr int kRunsPerThread = (kBeams + kThreads - 1) / kThreads;

struct StarArgs {
  const int* fk;  // (lanes, n), contiguous
  const float* r;  // (lanes, n), contiguous
  const float* z;
  long long z_stride, z_lane_stride;
  int n, lanes;
  int parts;  // partition units per lane
  int units;  // lanes * parts
  // The walk's thresholds in device memory (float32; dmin int32), read by
  // each block as it starts.
  const float *slope_param, *kdev, *kdist;
  const int* dmin;
  int cap;                   // scratch entries per unit
  unsigned long long* keys;  // (units * cap,) scratch
  float2* rz;                // (units * cap,) scratch
  int2* runs;                // (units, 360) scratch: (start, count)
  int* hp;                   // (lanes, 360)
};

// Unsigned image of a float that orders like torch.sort's ascending order:
// negative < -0.0 == +0.0 < positive < +inf < NaN (every NaN equal).
__device__ __forceinline__ unsigned order_bits(float v) {
  if (isnan(v)) return 0xffffffffu;
  unsigned u = __float_as_uint(v);
  if (v == 0.0f) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct WalkParams {
  float slope_param, kdev, kdist;
  int dmin;
};

struct WalkState {
  float avg, dev, px, pz;  // running mean / deviation, previous point
  int nan;                 // NaN slopes so far
};

// Warp 0 walks rz[0, m) (sorted (r, z)), the points of steps walked ..
// walked + m - 1.  Returns 1 + index of the triggering point, or 0 (state
// carried on).
__device__ int walk_chunk(const WalkParams& a, const unsigned long long* srt,
                          const float2* rz, int m, int walked, WalkState& st,
                          float4* s_w4, float* s_w1) {
  const int lane = threadIdx.x & 31;
  const unsigned le = (lane == 31) ? ~0u : ((2u << lane) - 1u);
  for (int c0 = 0; c0 < m; c0 += 32) {
    const int e = c0 + lane;
    const int i = walked + e;
    const bool have = e < m;
    const float2 b = have ? rz[e] : make_float2(0.0f, 0.0f);
    float ax = __shfl_up_sync(~0u, b.x, 1);
    float az = __shfl_up_sync(~0u, b.y, 1);
    if (lane == 0) {
      ax = st.px;
      az = st.pz;
    }
    const bool step = have && i >= 1;
    const float slp = (b.y - az) / (b.x - ax);
    const bool isn = step && isnan(slp);
    const unsigned nan_mask = __ballot_sync(~0u, isn);
    const int nan_incl = st.nan + __popc(nan_mask & le);
    const float mf = (float)i - (float)nan_incl;
    s_w4[lane] = make_float4(slp, mf - 1.0f, 1.0f / mf, slp * slp);
    s_w1[lane] = (b.x - ax) * a.kdist;
    const unsigned cmask = __ballot_sync(~0u, step && slp > a.slope_param);
    const int kend = min(32, m - c0);
    const int kmax = cmask ? min(kend, __ffs(cmask)) : kend;
    const unsigned live = kmax == 32 ? ~0u : ((1u << kmax) - 1u);
    const unsigned upd = __ballot_sync(~0u, step && !isn) & live;
    const unsigned amask = __ballot_sync(~0u, step && !isn && i > a.dmin) &
                           live;
    __syncwarp();
    float avg = st.avg, dev = st.dev;
    unsigned tmask = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float4 w = s_w4[k];  // slp, m - 1, 1 / m, slp * slp
      const float t1 = s_w1[k];
      const bool u = (upd >> k) & 1u;
      float na = avg * w.y;
      na = na + w.x;
      na = na * w.z;
      float nd = dev * w.y;
      nd = nd + fabsf(w.x - na);
      nd = nd * w.z;
      avg = u ? na : avg;
      dev = u ? nd : dev;
      const bool adaptive = (w.w - avg * avg) * a.kdev * t1 > dev;
      tmask |= (((amask >> k) & 1u) && adaptive) ? (1u << k) : 0u;
    }
    __syncwarp();
    const unsigned trips = (tmask | cmask) & live;
    if (trips) {
      const int k = __ffs(trips) - 1;
      return (int)(unsigned)(srt[c0 + k] & 0xffffffffu) + 1;
    }
    st.avg = avg;
    st.dev = dev;
    st.nan += __popc(nan_mask);
    st.px = __shfl_sync(~0u, b.x, kend - 1);
    st.pz = __shfl_sync(~0u, b.y, kend - 1);
  }
  return 0;
}

// The scratch index of element e of the beam whose runs are s_run (start,
// count) with exclusive offsets s_roff, nruns of them: the last run whose
// offset is <= e (empty runs share their successor's offset).
__device__ __forceinline__ int run_pos(const int2* s_run, const int* s_roff,
                                       int nruns, int e) {
  int lo = 0, hi = nruns - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_roff[mid] <= e)
      lo = mid;
    else
      hi = mid - 1;
  }
  return s_run[lo].x + (e - s_roff[lo]);
}

// Block sum of v, returned to every thread; s_red is kThreads / 32 ints.
__device__ int block_sum(int v, int* s_red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += s_red[w];
  return t;
}

__global__ void __launch_bounds__(kThreads) star_search_kernel(StarArgs a) {
  __shared__ int s_cnt[kBeams];
  __shared__ int s_loc[kBeams];
  __shared__ int s_cur[kBeams];
  __shared__ int2 s_run[kBeams];
  __shared__ int s_roff[kBeams];
  __shared__ unsigned long long s_src[kChunk];
  __shared__ float2 s_rzsrc[kChunk];
  __shared__ unsigned long long s_dst[kRankMax];
  __shared__ float2 s_rzdst[kRankMax];
  __shared__ float4 s_w4[32];
  __shared__ float s_w1[32];
  __shared__ int s_red[kThreads / 32];
  __shared__ int s_n;
  __shared__ int s_hit;
  __shared__ WalkParams s_wp;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int stride = a.parts * kThreads;

  if (tid == 0)
    s_wp = {__ldg(a.slope_param), __ldg(a.kdev), __ldg(a.kdist),
            __ldg(a.dmin)};
  // 1. Partition each unit's points into its region, beam after beam.
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int part = u % a.parts;
    const size_t scan = (size_t)(u / a.parts);  // the unit's lane
    const int* fk = a.fk + scan * a.n;
    const float* rr = a.r + scan * a.n;
    const float* zz = a.z + scan * a.z_lane_stride;
    const int region = u * a.cap;
    __syncthreads();  // the previous unit's s_loc and s_cur are consumed
    for (int b = tid; b < kBeams; b += kThreads) {
      s_cnt[b] = 0;
      s_cur[b] = 0;
    }
    __syncthreads();
    for (int base = part * kThreads; base < a.n; base += stride) {
      const int i = base + tid;
      const int f = i < a.n ? fk[i] : -1;
      const bool in = f >= 0 && f < kBeams;
      const unsigned same = __match_any_sync(~0u, in ? f : -1);
      if (in && (same & lt) == 0) atomicAdd(&s_cnt[f], __popc(same));
    }
    __syncthreads();
    if (warp == 0) {
      int c[kBeamsPerLane];
      int sum = 0;
#pragma unroll
      for (int k = 0; k < kBeamsPerLane; ++k) {
        const int b = lane * kBeamsPerLane + k;
        c[k] = b < kBeams ? s_cnt[b] : 0;
        sum += c[k];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(~0u, incl, o);
        if (lane >= o) incl += v;
      }
      int run = incl - sum;
#pragma unroll
      for (int k = 0; k < kBeamsPerLane; ++k) {
        const int b = lane * kBeamsPerLane + k;
        if (b < kBeams) s_loc[b] = run;
        run += c[k];
      }
    }
    __syncthreads();
    for (int b = tid; b < kBeams; b += kThreads)
      a.runs[(size_t)u * kBeams + b] = make_int2(region + s_loc[b], s_cnt[b]);
    for (int base = part * kThreads; base < a.n; base += stride) {
      const int i = base + tid;
      const int f = i < a.n ? fk[i] : -1;
      const bool in = f >= 0 && f < kBeams;
      const unsigned same = __match_any_sync(~0u, in ? f : -1);
      const int leader = __ffs(same) - 1;
      int slot = 0;
      if (in && lane == leader) slot = atomicAdd(&s_cur[f], __popc(same));
      slot = __shfl_sync(~0u, slot, leader);
      if (in) {
        const size_t at = (size_t)region + s_loc[f] + slot + __popc(same & lt);
        const float r = rr[i];
        a.keys[at] = ((unsigned long long)order_bits(r) << 32) | (unsigned)i;
        a.rz[at] = make_float2(r, zz[(size_t)i * a.z_stride]);
      }
    }
  }
  __syncthreads();  // s_wp is written (a block without a unit)
  const WalkParams wp = s_wp;
  cooperative_groups::this_grid().sync();

  // 2. Walk each (lane, beam) pair.
  const int nruns = a.parts;
  for (int q = blockIdx.x; q < a.lanes * kBeams; q += gridDim.x) {
    const int b = q % kBeams;
    const size_t run0 = (size_t)(q / kBeams) * a.parts;  // the lane's units
    // The beam's runs (column b of the lane's rows) and their offsets.
    int cnt[kRunsPerThread];
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kRunsPerThread; ++k) {
      const int j = tid * kRunsPerThread + k;
      const int2 run = j < nruns ? __ldcg(&a.runs[(run0 + j) * kBeams + b])
                                 : make_int2(0, 0);
      if (j < nruns) s_run[j] = run;
      cnt[k] = run.y;
      mine += run.y;
    }
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += u;
    }
    __syncthreads();  // s_red of the previous beam is consumed
    if (lane == 31) s_red[warp] = incl;
    __syncthreads();
    int before = incl - mine;
    for (int w = 0; w < warp; ++w) before += s_red[w];
    int len = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) len += s_red[w];
#pragma unroll
    for (int k = 0; k < kRunsPerThread; ++k) {
      const int j = tid * kRunsPerThread + k;
      if (j < nruns) s_roff[j] = before;
      before += cnt[k];
    }
    __syncthreads();

    WalkState st{0.0f, 0.0f, 0.0f, 0.0f, 0};
    int walked = 0, hit = 0;
    unsigned long long lo = 0ULL;
    while (len >= 2 && walked < len && hit == 0) {
      const int rem = len - walked;
      unsigned long long hi = ~0ULL;
      if (rem > kChunk) {
        // The kChunk-th smallest key >= lo: the least hi with kChunk keys
        // in [lo, hi] (keys are unique).
        unsigned long long l2 = lo, h2 = ~0ULL;
        while (l2 < h2) {
          const unsigned long long mid = l2 + (h2 - l2) / 2;
          int c = 0;
          for (int e = tid; e < len; e += kThreads) {
            const unsigned long long k =
                __ldcg(&a.keys[run_pos(s_run, s_roff, nruns, e)]);
            c += (k >= lo && k <= mid);
          }
          if (block_sum(c, s_red) >= kChunk)
            h2 = mid;
          else
            l2 = mid + 1;
        }
        hi = h2;
      }
      __syncthreads();
      if (tid == 0) s_n = 0;
      __syncthreads();
      for (int e = tid; e < len; e += kThreads) {
        const int at = run_pos(s_run, s_roff, nruns, e);
        const unsigned long long k = __ldcg(&a.keys[at]);
        const float2 v = __ldcg(&a.rz[at]);
        if (k >= lo && k <= hi) {
          const int slot = atomicAdd(&s_n, 1);
          s_src[slot] = k;
          s_rzsrc[slot] = v;
        }
      }
      __syncthreads();
      const int m = s_n;
      const unsigned long long* srt;
      const float2* srz;
      if (m <= kRankMax) {
        if (tid < m) {
          const unsigned long long k = s_src[tid];
          int rank = 0;
          for (int j = 0; j < m; ++j) rank += s_src[j] < k;
          s_dst[rank] = k;
          s_rzdst[rank] = s_rzsrc[tid];
        }
        srt = s_dst;
        srz = s_rzdst;
      } else {
        int sz = kRankMax;
        while (sz < m) sz <<= 1;
        for (int j = m + tid; j < sz; j += kThreads) s_src[j] = ~0ULL;
        __syncthreads();
        for (int k = 2; k <= sz; k <<= 1) {
          for (int j = k >> 1; j > 0; j >>= 1) {
            for (int t = tid; t < sz / 2; t += kThreads) {
              const int p = 2 * t - (t & (j - 1));
              const int q = p + j;
              const unsigned long long u = s_src[p], v = s_src[q];
              if ((u > v) == ((p & k) == 0)) {
                s_src[p] = v;
                s_src[q] = u;
                const float2 w = s_rzsrc[p];
                s_rzsrc[p] = s_rzsrc[q];
                s_rzsrc[q] = w;
              }
            }
            __syncthreads();
          }
        }
        srt = s_src;
        srz = s_rzsrc;
      }
      __syncthreads();
      if (warp == 0) {
        const int h = walk_chunk(wp, srt, srz, m, walked, st, s_w4, s_w1);
        if (lane == 0) s_hit = h;
      }
      __syncthreads();
      hit = s_hit;
      lo = srt[m - 1] + 1;
      walked += m;
      __syncthreads();  // srt is rewritten by the next pass
    }
    if (tid == 0) a.hp[q] = hit;
  }
}

// Co-resident blocks of the kernel on the current device, cached.
int resident_blocks(int* out) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, star_search_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * sms;
  }
  *out = resident[dev];
  return 0;
}

// The launch's plan for lanes x n points: grid, parts per lane, scratch
// entries per unit, and the scratch bytes (keys and (r, z) of every unit's
// region, then the (units, 360) run table).
struct StarPlan {
  int grid, parts, cap;
  long long units, bytes;
};

int star_plan(int lanes, int n, StarPlan* out) {
  if (n < 0 || n >= (1 << 24) || lanes < 1) return (int)cudaErrorInvalidValue;
  int resident = 0;
  const int err = resident_blocks(&resident);
  if (err != 0) return err;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int parts = resident >= lanes ? min(kBeams, resident / lanes) : 1;
  const long long units = (long long)lanes * parts;
  const int per = (n + parts * kThreads - 1) / (parts * kThreads);
  const int cap = per * kThreads;
  // Run starts are int: every region must start below 2^31.
  if (units * cap >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)min((long long)lanes * kBeams, (long long)resident);
  *out = {grid, parts, cap, units,
          units * cap * 16 + units * kBeams * (long long)sizeof(int2)};
  return 0;
}

}  // namespace

// The scratch bytes urf_star_search needs for lanes x n points on the
// current device.
extern "C" int urf_star_scratch_bytes(int lanes, int n, long long* bytes) {
  StarPlan plan;
  const int err = star_plan(lanes, n, &plan);
  if (err != 0) return err;
  *bytes = plan.bytes;
  return 0;
}

// fk (lanes, n) int32 and r (lanes, n) f32, contiguous; z (lanes, n) f32
// with element stride z_stride and lane stride z_lane_stride; scratch:
// urf_star_scratch_bytes(lanes, n) bytes, 16-byte aligned, uninitialised;
// hp (lanes, 360) int32, written in full; slope_param, kdev, kdist
// (float32) and dmin (int32): one value each in device memory.  n < 2^24.
// One cooperative launch; a refused launch returns its error.
extern "C" int urf_star_search(const int* fk, const float* r, const float* z,
                               long long z_stride, long long z_lane_stride,
                               int n, int lanes, const float* slope_param,
                               const float* kdev, const float* kdist,
                               const int* dmin, void* scratch, int* hp,
                               void* stream) {
  StarPlan plan;
  const int err0 = star_plan(lanes, n, &plan);
  if (err0 != 0) return err0;
  const long long entries = plan.units * plan.cap;
  unsigned long long* keys = static_cast<unsigned long long*>(scratch);
  float2* rz = reinterpret_cast<float2*>(keys + entries);
  int2* runs = reinterpret_cast<int2*>(rz + entries);
  StarArgs a{fk, r, z, z_stride, z_lane_stride, n, lanes, plan.parts,
             (int)plan.units, slope_param, kdev, kdist, dmin, plan.cap,
             keys, rz, runs, hp};
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)star_search_kernel, dim3(plan.grid), dim3(kThreads), args,
      0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
