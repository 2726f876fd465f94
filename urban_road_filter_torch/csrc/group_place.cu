// Stable group ranking (points -> slot within their ring) and placement of
// x/y/z into the padded (rings, capacity) layout.
//
// Replaces two TPU kernels:
//   * urban_road_filter_tpu/ops/rank.py:_pallas_rank (K5).  On the TPU a
//     sequential grid carried per-group running counts in VMEM and ranked
//     inside a block with one-hot MXU prefix products.
//   * urban_road_filter_tpu/ops/place.py:group_place_pallas (K6).  On the
//     TPU placement was a one-hot s8 matmul over byte limbs, because the
//     TPU's element scatter is slow.
//
// What bounds them on Hopper: launch latency and the wrapper's host time,
// not bytes.  At one OS1-64 scan (131072 points, 64 rings x 4096 slots)
// K5 reads and writes ~1.6 MB and K6 ~5.8 MB (each x/y/z read once, the
// three (R, P) planes written once): 0.5 and 1.7 us of HBM time.
//
// K5 design: one cooperative launch of 1024-thread blocks over tiles of
// 1024 points (grid: the larger of tiles and groups / 32, capped at the
// co-resident block count), three phases split by two grid barriers:
//   1. per tile, the group histogram in shared memory (warp-aggregated:
//      __match_any_sync, one shared atomicAdd per group and warp), written
//      to its row of the (tiles, groups) scratch;
//   2. the exclusive scan of each group's column over the tiles, in
//      place, and the group totals: a block takes 32 groups, each of its
//      warps a slice of the tiles (lane l group g0 + l, so every load is
//      one 128-byte piece of a tile's row), sums its slice, and rescans it
//      from the slices before it; the threads' loads are independent, so
//      a column costs two load latencies, not one dependent step per tile
//      (a thread per group walking its column in series took ~0.013 ms at
//      128 tiles on an H100);
//   3. per tile, the rank STABLE in input order (the x/z-zero stencils
//      read slot order, so atomics alone would be wrong):
//      __match_any_sync + __popc(mask & lanemask_lt) inside a warp, then
//      the warps in order, one per step of a 32-step pass over a shared
//      array of running counts that starts at the tile's exclusive column
//      prefix: warp w's first lane of each group reads the count and adds
//      its group's size.
// A batch of scans (lanes) is one launch with the same three phases: a
// tile belongs to one lane, histograms and column scans are per lane (the
// scratch is lanes x tiles x groups, linear in the lanes; lanes folded into
// the group ids would make it grow with their square), and the outputs are
// (lanes, n) pos and (lanes, groups) counts.  The ranks do not depend on
// the grid, so a lane's equal a launch over that lane alone.
// Shared memory is one int per group (8 KB at 2049 groups), not one per
// warp and group (32 x groups would be 131 KB at 1025 groups, and group
// counts above ~1800 could not launch).  Each point is read twice (ids) and
// written once (pos), each histogram entry written, read and rewritten
// once.  What bounds it on Hopper: the two grid barriers and the 32-step
// ordered pass (~32 block barriers), not bytes (~1.6 MB at 131072 points,
// 0.5 us of HBM time).
//
// K6 design: one launch, nothing pre-filled, every slot written once, over
// a batch of lanes at once (points, zero units and overflows of every
// lane; the output (fields, lanes, rings, cap)).  It
// takes K5's group totals (``counts``, the dump group last) under the
// dense-ranked contract of group_place_pallas(counts=...): pos comes from
// group_positions over the same ids, so ring r holds exactly slots
// 0 .. min(counts[r], cap) - 1.  Then the layout needs no fill:
//   * point blocks: each point with ids < rings and pos < cap stores its
//     1-3 fields (read through their element stride, so row-major (N, 4)
//     coordinate views need no copy) at (field, ring, pos);
//   * zero blocks: one warp per (field, ring, 1024-slot segment) stores
//     0.0 to every slot s >= min(counts[r], cap), 16 bytes at a time where
//     a whole aligned quad of the flat output is empty, 4 bytes where a
//     quad straddles the occupied part or a row edge (P % 4 != 0);
//   * warp 0 of block 0 writes overflow = sum over r < rings of
//     max(counts[r] - cap, 0) (the dump group counts[rings] is not in a
//     ring), with no atomic and no zeroed scalar.
// Together these write every slot of the (fields, R, P) output once and
// read none: one device op per call, where a zero-filled output costs
// four fills (three planes and the overflow scalar) before the scatter.
// Firing-order input sends neighbouring points to different rings, so the
// point stores scatter 4-byte sectors; at 64 x 4096 the 3 MB output sits
// in the 50 MB L2, where those partial sectors merge before HBM.
// The sector waste shows, modestly: on an H100 (tools/profile_ring_kernels.py)
// the launch takes 3.1 us at one OS1-64 scan (65536 returns, 64 x 4096,
// bound 1.7 us) but 4.5 us on a bench lane of 131072 returns into a
// layout half that size (64 x 2048): the point stores, not the zero
// stores, set the time beyond the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;  // points per rank tile and block: 32 warps
constexpr int kWarps = kBlock / 32;
constexpr int kStatic = 48 * 1024;  // dynamic shared memory without opt-in

struct RankArgs {
  const int* ids;  // (lanes, n), contiguous
  int n, groups, tiles;  // tiles per lane
  int lanes;
  int* pos;     // (lanes, n)
  int* counts;  // (lanes, groups)
  int* hist;  // (lanes * tiles, groups) scratch, every entry written in phase 1
};

__global__ void __launch_bounds__(kBlock) group_rank_kernel(RankArgs a) {
  extern __shared__ int s_cnt[];  // [groups]
  __shared__ int s_part[kWarps][33];  // phase 2: per slice, per group
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int all_tiles = a.lanes * a.tiles;

  // 1. Tile histograms; tile T is tile T % tiles of scan T / tiles.
  for (int T = blockIdx.x; T < all_tiles; T += gridDim.x) {
    for (int g = threadIdx.x; g < a.groups; g += kBlock) s_cnt[g] = 0;
    __syncthreads();
    const int i = (T % a.tiles) * kBlock + threadIdx.x;
    const int g = i < a.n ? a.ids[(size_t)(T / a.tiles) * a.n + i] : -1;
    const bool in = g >= 0 && g < a.groups;
    const unsigned same = __match_any_sync(~0u, in ? g : -1);
    if (in && (same & lt) == 0) atomicAdd(&s_cnt[g], __popc(same));
    __syncthreads();
    int* row = a.hist + (size_t)T * a.groups;
    for (int g2 = threadIdx.x; g2 < a.groups; g2 += kBlock) row[g2] = s_cnt[g2];
    __syncthreads();
  }
  cooperative_groups::this_grid().sync();

  // 2. Per (scan, group), the exclusive scan of its column over the scan's
  // tiles: a block takes 32 groups of one scan at a time, warp w the w-th
  // slice of the tiles, lane l group g0 + l, so each load of a warp is 32
  // adjacent entries of one tile's row.
  const int per = (a.tiles + kWarps - 1) / kWarps;  // tiles per slice
  const int chunks = (a.groups + 31) / 32;  // 32-group chunks per scan
  for (int u = blockIdx.x; u < a.lanes * chunks; u += gridDim.x) {
    const int scan = u / chunks;
    const int g = (u % chunks) * 32 + lane;
    int* col = a.hist + (size_t)scan * a.tiles * a.groups + g;
    const int t0 = warp * per;
    const int t1 = min(t0 + per, a.tiles);
    int sum = 0;
    if (g < a.groups)
      for (int t = t0; t < t1; ++t)
        sum += __ldcg(col + (size_t)t * a.groups);
    s_part[warp][lane] = sum;
    __syncthreads();
    int run = 0;
    for (int w = 0; w < warp; ++w) run += s_part[w][lane];
    if (g < a.groups) {
      for (int t = t0; t < t1; ++t) {
        int* h = col + (size_t)t * a.groups;
        const int v = __ldcg(h);
        *h = run;
        run += v;
      }
      if (warp == kWarps - 1) a.counts[(size_t)scan * a.groups + g] = run;
    }
    __syncthreads();
  }
  cooperative_groups::this_grid().sync();

  // 3. Stable ranks: the warps of a tile in order.
  for (int T = blockIdx.x; T < all_tiles; T += gridDim.x) {
    const int* row = a.hist + (size_t)T * a.groups;
    for (int g = threadIdx.x; g < a.groups; g += kBlock)
      s_cnt[g] = __ldcg(row + g);
    __syncthreads();
    const int i = (T % a.tiles) * kBlock + threadIdx.x;
    const size_t at = (size_t)(T / a.tiles) * a.n + i;
    const int g = i < a.n ? a.ids[at] : -1;
    const bool in = g >= 0 && g < a.groups;
    const unsigned same = __match_any_sync(~0u, in ? g : -1);
    const int leader = __ffs(same) - 1;
    int base = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w && in && lane == leader) {
        base = s_cnt[g];
        s_cnt[g] = base + __popc(same);
      }
      __syncthreads();
    }
    base = __shfl_sync(~0u, base, leader);
    if (i < a.n) a.pos[at] = in ? base + __popc(same & lt) : -1;
    __syncthreads();
  }
}

constexpr int kPlaceThreads = 256;
constexpr int kZeroQuads = 256;  // 4-slot quads per zero unit (one warp)

struct PlaceArgs {
  const int* ids;     // (lanes, n), contiguous
  const int* pos;     // (lanes, n), contiguous
  const int* counts;  // (lanes, >= rings) K5's group totals, lane stride cstride
  const float* field[3];
  long long stride[3];  // element stride of each field
  long long lstride[3];  // lane stride of each field
  float* out;           // (nf, lanes, rings, cap)
  int* overflow;        // (lanes,)
  int n, nf, rings, cap, lanes, cstride;
  int point_blocks;   // blocks [0, point_blocks) store points
  int units_per_row;  // zero units of kZeroQuads quads per (field, ring)
};

__global__ void __launch_bounds__(kPlaceThreads) place_kernel(PlaceArgs a) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0) {  // a warp per scan: its overflow
    for (int sc = threadIdx.x >> 5; sc < a.lanes; sc += kPlaceThreads / 32) {
      const int* cnt = a.counts + (size_t)sc * a.cstride;
      int over = 0;
      for (int r = lane; r < a.rings; r += 32) over += max(cnt[r] - a.cap, 0);
      for (int o = 16; o > 0; o >>= 1) over += __shfl_xor_sync(~0u, over, o);
      if (lane == 0) a.overflow[sc] = over;
    }
  }
  const size_t plane = (size_t)a.rings * a.cap;
  if ((int)blockIdx.x < a.point_blocks) {
    const long long i = (long long)blockIdx.x * kPlaceThreads + threadIdx.x;
    if (i >= (long long)a.lanes * a.n) return;
    const int r = a.ids[i];
    const int s = a.pos[i];
    if (r < 0 || r >= a.rings || s < 0 || s >= a.cap) return;
    const long long sc = i / a.n, k = i - sc * a.n;
    const size_t o = (size_t)sc * plane + (size_t)r * a.cap + s;
    const size_t all = plane * a.lanes;
#pragma unroll
    for (int f = 0; f < 3; ++f)
      if (f < a.nf)
        a.out[f * all + o] = a.field[f][sc * a.lstride[f] + k * a.stride[f]];
    return;
  }
  const int unit = (blockIdx.x - a.point_blocks) * (kPlaceThreads / 32) +
                   (threadIdx.x >> 5);
  // row = (field * lanes + scan) * rings + ring
  const int row = unit / a.units_per_row;
  const int scan_rows = a.lanes * a.rings;
  if (row >= a.nf * scan_rows) return;
  const int sr = row % scan_rows;
  const int lim = min(max(a.counts[(size_t)(sr / a.rings) * a.cstride +
                                   sr % a.rings], 0), a.cap);
  const size_t lo = (size_t)row * a.cap + lim;     // zero flat [lo, hi)
  const size_t hi = (size_t)row * a.cap + a.cap;
  const size_t q_first =
      lo / 4 + (size_t)(unit % a.units_per_row) * kZeroQuads;
  const size_t q_stop = q_first + kZeroQuads;
  const size_t q_end = (hi + 3) / 4 < q_stop ? (hi + 3) / 4 : q_stop;
  for (size_t q = q_first + lane; q < q_end; q += 32) {
    const size_t e = 4 * q;
    if (e >= lo && e + 4 <= hi) {
      reinterpret_cast<float4*>(a.out)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j >= lo && e + j < hi) a.out[e + j] = 0.0f;
    }
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= kStatic) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" const char* urf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Per scan b of lanes: pos[b, i] = # of j < i with ids[b, j] == ids[b, i];
// counts[b, g] = size of group g in scan b.  ids, pos (lanes, n) and counts
// (lanes, groups) contiguous; hist is caller-allocated scratch of lanes *
// ceil(n / 1024) * groups ints (not initialised).  ids outside [0, groups)
// get pos -1 and are not counted.  One cooperative launch; a refused launch
// returns its error.
extern "C" int urf_group_rank(const int* ids, int n, int groups, int lanes,
                              int* pos, int* counts, int* hist, void* stream) {
  if (n < 0 || groups < 1 || lanes < 1) return (int)cudaErrorInvalidValue;
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices];
  static size_t occ_smem[kMaxDevices];
  static int occ_per_sm[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const size_t smem = (size_t)groups * sizeof(int);
  err = set_smem((const void*)group_rank_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (occ_per_sm[dev] == 0 || occ_smem[dev] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ_per_sm[dev], group_rank_kernel, kBlock, smem);
    if (err != cudaSuccess) return (int)err;
    occ_smem[dev] = smem;
  }
  const int tiles = (n + kBlock - 1) / kBlock;
  const long long want = max(max((long long)lanes * tiles,
                                 (long long)lanes * ((groups + 31) / 32)),
                             1LL);
  if (want > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)min(want, (long long)occ_per_sm[dev] * sms[dev]);
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  RankArgs a{ids, n, groups, tiles, lanes, pos, counts, hist};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)group_rank_kernel,
                                    dim3(grid), dim3(kBlock), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K6.  out (nf, lanes, rings, cap) f32 and overflow (lanes,) int32 are
// written in full (allocated, not filled, by the caller; out 16-byte
// aligned).  counts (lanes rows of >= rings entries, lane stride cstride)
// and pos come from urf_group_rank over the same ids (lanes, n); fields
// f0..f2 (the first nf used) are (lanes, n) f32 with element strides s0..s2
// and lane strides l0..l2.  One launch.
extern "C" int urf_group_place(const int* ids, const int* pos,
                               const int* counts, int cstride, int n,
                               int lanes, int nf, const float* f0,
                               const float* f1, const float* f2, long long s0,
                               long long s1, long long s2, long long l0,
                               long long l1, long long l2, int rings, int cap,
                               float* out, int* overflow, void* stream) {
  if (nf < 1 || nf > 3 || n < 0 || lanes < 1 || rings < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  const long long points = (long long)lanes * n;
  PlaceArgs a{ids, pos, counts, {f0, f1, f2}, {s0, s1, s2}, {l0, l1, l2},
              out, overflow, n, nf, rings, cap, lanes, cstride,
              (int)((points + kPlaceThreads - 1) / kPlaceThreads),
              (cap / 4 + 2 + kZeroQuads - 1) / kZeroQuads};
  const long long units = (long long)nf * lanes * rings * a.units_per_row;
  const long long zero_blocks = (units + kPlaceThreads / 32 - 1) /
                                (kPlaceThreads / 32);
  const long long grid = (points + kPlaceThreads - 1) / kPlaceThreads +
                         zero_blocks;
  if (grid > 0x7fffffffLL || (long long)nf * lanes * rings > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  place_kernel<<<grid > 0 ? (unsigned)grid : 1u, kPlaceThreads, 0,
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
