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
// K5 design.  Blocks run in no order, so the TPU's carried counter becomes
// three passes:
//   1. hist_kernel: per-block group histograms (shared-memory atomics;
//      counts do not depend on order);
//   2. scan_kernel: an exclusive scan over blocks, one thread per group,
//      giving every block its per-group base and the group totals;
//   3. rank_kernel: the rank inside the block, STABLE in input order
//      (the x/z-zero stencils read slot order, so atomics would be wrong):
//      __match_any_sync + __popc(mask & lanemask_lt) inside a warp, then an
//      exclusive scan of per-warp group counts across the block's warps.
//
// K6 design: one launch, nothing pre-filled, every slot written once.  It
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

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;  // points per rank block: 32 warps
constexpr int kWarps = kBlock / 32;
constexpr int kStatic = 48 * 1024;  // dynamic shared memory without opt-in

__global__ void hist_kernel(const int* __restrict__ ids, int n, int groups,
                            int* __restrict__ hist) {
  extern __shared__ int cnt[];  // [groups]
  for (int g = threadIdx.x; g < groups; g += blockDim.x) cnt[g] = 0;
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < n) {
    const int g = ids[i];
    if (g >= 0 && g < groups) atomicAdd(&cnt[g], 1);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += blockDim.x)
    hist[(size_t)blockIdx.x * groups + g] = cnt[g];
}

// In place: hist[b, g] becomes the number of group-g points in blocks < b.
__global__ void scan_kernel(int* __restrict__ hist, int nblocks, int groups,
                            int* __restrict__ counts) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  int run = 0;
  for (int b = 0; b < nblocks; ++b) {
    const int c = hist[(size_t)b * groups + g];
    hist[(size_t)b * groups + g] = run;
    run += c;
  }
  counts[g] = run;
}

__global__ void rank_kernel(const int* __restrict__ ids, int n, int groups,
                            const int* __restrict__ base,
                            int* __restrict__ pos) {
  extern __shared__ int warp_cnt[];  // [kWarps][groups]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kWarps * groups; k += blockDim.x)
    warp_cnt[k] = 0;
  __syncthreads();

  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int g = i < n ? ids[i] : -1;
  const bool in_range = g >= 0 && g < groups;
  const int key = in_range ? g : -1;
  const unsigned same = __match_any_sync(0xffffffffu, key);
  const int in_warp = __popc(same & ((1u << lane) - 1u));
  if (in_range && in_warp == 0) warp_cnt[warp * groups + g] = __popc(same);
  __syncthreads();

  for (int gg = threadIdx.x; gg < groups; gg += blockDim.x) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_cnt[w * groups + gg];
      warp_cnt[w * groups + gg] = run;
      run += c;
    }
  }
  __syncthreads();

  if (i < n)
    pos[i] = in_range ? base[(size_t)blockIdx.x * groups + g] +
                            warp_cnt[warp * groups + g] + in_warp
                      : -1;
}

constexpr int kPlaceThreads = 256;
constexpr int kZeroQuads = 256;  // 4-slot quads per zero unit (one warp)

struct PlaceArgs {
  const int* ids;
  const int* pos;
  const int* counts;  // (>= rings,) K5's group totals
  const float* field[3];
  long long stride[3];  // element stride of each field
  float* out;           // (nf, rings, cap)
  int* overflow;
  int n, nf, rings, cap;
  int point_blocks;   // blocks [0, point_blocks) store points
  int units_per_row;  // zero units of kZeroQuads quads per (field, ring)
};

__global__ void __launch_bounds__(kPlaceThreads) place_kernel(PlaceArgs a) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    int over = 0;
    for (int r = lane; r < a.rings; r += 32)
      over += max(a.counts[r] - a.cap, 0);
    for (int o = 16; o > 0; o >>= 1) over += __shfl_xor_sync(~0u, over, o);
    if (lane == 0) *a.overflow = over;
  }
  const size_t plane = (size_t)a.rings * a.cap;
  if ((int)blockIdx.x < a.point_blocks) {
    const int i = blockIdx.x * kPlaceThreads + threadIdx.x;
    if (i >= a.n) return;
    const int r = a.ids[i];
    const int s = a.pos[i];
    if (r < 0 || r >= a.rings || s < 0 || s >= a.cap) return;
    const size_t o = (size_t)r * a.cap + s;
#pragma unroll
    for (int f = 0; f < 3; ++f)
      if (f < a.nf) a.out[f * plane + o] = a.field[f][(size_t)i * a.stride[f]];
    return;
  }
  const int unit = (blockIdx.x - a.point_blocks) * (kPlaceThreads / 32) +
                   (threadIdx.x >> 5);
  const int row = unit / a.units_per_row;  // field * rings + ring
  if (row >= a.nf * a.rings) return;
  const int lim = min(max(a.counts[row % a.rings], 0), a.cap);
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

// pos[i] = # of j < i with ids[j] == ids[i]; counts[g] = size of group g.
// hist is caller-allocated scratch of ceil(n / 1024) * groups ints.
// ids outside [0, groups) get pos -1 and are not counted.
extern "C" int urf_group_rank(const int* ids, int n, int groups, int* pos,
                              int* counts, int* hist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nblocks = (n + kBlock - 1) / kBlock;
  const size_t rank_smem = (size_t)kWarps * groups * sizeof(int);
  const size_t hist_smem = (size_t)groups * sizeof(int);
  cudaError_t err = set_smem((const void*)rank_kernel, rank_smem);
  if (err == cudaSuccess) err = set_smem((const void*)hist_kernel, hist_smem);
  if (err != cudaSuccess) return (int)err;
  if (nblocks > 0)
    hist_kernel<<<nblocks, kBlock, hist_smem, s>>>(ids, n, groups, hist);
  scan_kernel<<<(groups + 127) / 128, 128, 0, s>>>(hist, nblocks, groups,
                                                    counts);
  if (nblocks > 0)
    rank_kernel<<<nblocks, kBlock, rank_smem, s>>>(ids, n, groups, hist, pos);
  return (int)cudaGetLastError();
}

// K6.  out (nf, rings, cap) f32 and overflow (one int) are written in full
// (allocated, not filled, by the caller; out 16-byte aligned).  counts
// (>= rings entries) and pos come from urf_group_rank over the same ids;
// fields f0..f2 (the first nf used) are (n,) f32 with element strides
// s0..s2.  One launch.
extern "C" int urf_group_place(const int* ids, const int* pos,
                               const int* counts, int n, int nf,
                               const float* f0, const float* f1,
                               const float* f2, long long s0, long long s1,
                               long long s2, int rings, int cap, float* out,
                               int* overflow, void* stream) {
  if (nf < 1 || nf > 3 || n < 0 || rings < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  PlaceArgs a{ids, pos, counts, {f0, f1, f2}, {s0, s1, s2}, out, overflow,
              n, nf, rings, cap, (n + kPlaceThreads - 1) / kPlaceThreads,
              (cap / 4 + 2 + kZeroQuads - 1) / kZeroQuads};
  const long long units = (long long)nf * rings * a.units_per_row;
  const long long zero_blocks = (units + kPlaceThreads / 32 - 1) /
                                (kPlaceThreads / 32);
  const long long grid = a.point_blocks + zero_blocks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  place_kernel<<<grid > 0 ? (unsigned)grid : 1u, kPlaceThreads, 0,
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
