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
// What bounds it on Hopper: memory traffic and launch latency.  At one
// OS1-64 scan (131072 points, 65 groups) every pass reads or writes a few
// bytes per point (~3 MB in all), far below a millisecond of HBM time, so
// the four launches and the short serial scan over blocks dominate.
//
// Design.  Blocks run in no order, so the TPU's carried counter becomes
// three passes:
//   1. hist_kernel: per-block group histograms (shared-memory atomics;
//      counts do not depend on order);
//   2. scan_kernel: an exclusive scan over blocks, one thread per group,
//      giving every block its per-group base and the group totals;
//   3. rank_kernel: the rank inside the block, STABLE in input order
//      (the x/z-zero stencils read slot order, so atomics would be wrong):
//      __match_any_sync + __popc(mask & lanemask_lt) inside a warp, then an
//      exclusive scan of per-warp group counts across the block's warps.
// place_kernel is a plain indexed store: one thread per point writes its
// x/y/z to (ring, pos) when it fits, and counts the points that do not.
// Empty slots keep the zeros the caller allocated.

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

__global__ void place_kernel(const int* __restrict__ ids,
                             const int* __restrict__ pos, int n,
                             const float* __restrict__ x,
                             const float* __restrict__ y,
                             const float* __restrict__ z, int rings, int cap,
                             float* __restrict__ ox, float* __restrict__ oy,
                             float* __restrict__ oz,
                             int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int dropped = 0;
  if (i < n) {
    const int r = ids[i];
    const int s = pos[i];
    if (r >= 0 && r < rings && s >= 0) {
      if (s < cap) {
        const size_t o = (size_t)r * cap + s;
        ox[o] = x[i];
        oy[o] = y[i];
        oz[o] = z[i];
      } else {
        dropped = 1;
      }
    }
  }
  const int block_dropped = __syncthreads_count(dropped);
  if (threadIdx.x == 0 && block_dropped) atomicAdd(overflow, block_dropped);
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

// ox/oy/oz: (rings, cap) zero-filled by the caller; overflow: one int,
// zeroed by the caller, gains the in-ring points with pos >= cap.
extern "C" int urf_group_place(const int* ids, const int* pos, int n,
                               const float* x, const float* y, const float* z,
                               int rings, int cap, float* ox, float* oy,
                               float* oz, int* overflow, void* stream) {
  if (n > 0)
    place_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        ids, pos, n, x, y, z, rings, cap, ox, oy, oz, overflow);
  return (int)cudaGetLastError();
}
