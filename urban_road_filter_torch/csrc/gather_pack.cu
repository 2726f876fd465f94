// Labels back to input-point order, gated and packed for the wire, for a
// batch of scans in one launch.
//
// Replaces urban_road_filter_tpu/ops/gather.py:gather_by_group_pos (K11)
// and the plane packing of urban_road_filter_tpu/pipeline.py:_packed_scan_dyn,
// which the JAX package's batch path runs once under vmap.  On the TPU the
// table lookup was two one-hot MXU contractions over 2-bit labels packed
// four to an s8 word, because the TPU's element gather is slow; its +128
// word correction had no lower bound, so a negative index decoded to a
// spurious label.
//
// What bounds it on Hopper: memory, and at one scan the launch.  Per point
// it reads ring id, slot and ROI flag (9 bytes) and one table word, and
// writes four bytes.  A lane's (rings, cap) int32 table (<= 1 MB) stays in
// the 50 MB L2 while that lane's tiles run; the lookup is a plain indexed
// load through the read-only path.
//
// Design.  Grid (point tiles, lanes), one launch for up to kLanes lanes.
// The lanes' tables and slot vectors are separate tensors (the per-lane
// stages leave them so); their pointers travel by value in a
// __grid_constant__ parameter (2 x 128 x 8 bytes for a batch, inside the
// 4 KB parameter space; 16 bytes for one scan), so nothing is stacked or
// copied to the card first.  In a batch each thread takes 4 points at a
// time (16-byte loads of ids and pos, 32-bit loads and stores of the byte
// streams); one scan takes one point a thread (below).
//
// Semantics.  An index outside [0, rings) x [0, cap), negative ones
// included, reads as label 0.  The lane's >= 30-point gate `ok` (a device
// flag, so the host never waits for it) zeroes everything of a scan that is
// not evaluated; the packed byte is label | roi << 2 | probably_road << 3.
// A point is probably road when its ring id is prr and a ring of the
// table: the id `rings` means "no ring".

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // lanes per launch
constexpr int kThreads = 256;

// The lanes' table and slot pointers, passed by value: 16 bytes for one
// lane, 2 KB for kLanes (inside the 4 KB parameter space).
template <int kCap>
struct Lanes {
  const int* table[kCap];
  const int* pos[kCap];
};

struct Point {
  int8_t label;
  bool roi, pr;
};

__device__ __forceinline__ Point gather_one(const int* __restrict__ table,
                                            int rings, int cap, bool gate,
                                            int prr, int r, int s, bool v) {
  int lab = 0;
  if (gate && r >= 0 && r < rings && s >= 0 && s < cap)
    lab = __ldg(table + (size_t)r * cap + s);
  return {(int8_t)lab, gate && v, gate && r == prr && r < rings};
}

__device__ __forceinline__ uint8_t pack_one(Point p) {
  return (uint8_t)p.label | (p.roi ? 4 : 0) | (p.pr ? 8 : 0);
}

// The first index from which every stream of a lane sits on a 4-point
// boundary (16 bytes for the int32 streams, 4 for the byte streams), or
// n when they share none.
__device__ __forceinline__ int common_head(const void* ids, const void* pos,
                                           const void* valid,
                                           const void* labels, const void* roi,
                                           const void* pr, const void* packed,
                                           int n) {
  const uintptr_t pi = (uintptr_t)ids, pp = (uintptr_t)pos;
  if ((pi & 3u) || (pp & 3u)) return n;
  const unsigned h = ((16u - (pi & 15u)) & 15u) >> 2;
  if (h != (((16u - (pp & 15u)) & 15u) >> 2)) return n;
  const uintptr_t bytes[5] = {(uintptr_t)valid, (uintptr_t)labels,
                              (uintptr_t)roi, (uintptr_t)pr,
                              (uintptr_t)packed};
#pragma unroll
  for (int k = 0; k < 5; ++k)
    if (((4u - (bytes[k] & 3u)) & 3u) != h) return n;
  return (int)h < n ? (int)h : n;
}

// Grid (point tiles, lanes).  One lane (kCap 1, one scan: latency bounds
// it, a dependent table load after the index loads): thread t takes point
// t.  More (batches: bytes bound them): each thread takes 4 points, one
// 16-byte load each of ids and pos, one 32-bit load of the valid bytes
// and one 32-bit store of each output; points before the lane's first
// common 4-point boundary of the streams, and the tail (N % 4), go point
// by point (the whole lane when the streams share no boundary).
template <int kCap>
__global__ void __launch_bounds__(kThreads)
    gather_pack_kernel(const __grid_constant__ Lanes<kCap> lanes, int rings,
                       int cap, const int* __restrict__ ids_all,
                       const bool* __restrict__ valid_all,
                       const bool* __restrict__ ok, int prr, int n,
                       int8_t* __restrict__ labels_all,
                       bool* __restrict__ roi_all,
                       bool* __restrict__ pr_all,
                       uint8_t* __restrict__ packed_all) {
  const int b = kCap == 1 ? 0 : blockIdx.y;
  const size_t row = (size_t)b * n;
  const int* __restrict__ table = lanes.table[b];
  const int* __restrict__ pos = lanes.pos[b];
  const int* __restrict__ ids = ids_all + row;
  const bool* __restrict__ valid = valid_all + row;
  int8_t* __restrict__ labels = labels_all + row;
  bool* __restrict__ roi = roi_all + row;
  bool* __restrict__ pr = pr_all + row;
  uint8_t* __restrict__ packed = packed_all + row;
  const bool gate = ok[b];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kCap == 1) {
    if (tid < n) {
      const Point p = gather_one(table, rings, cap, gate, prr, ids[tid],
                                 pos[tid], valid[tid]);
      labels[tid] = p.label;
      roi[tid] = p.roi;
      pr[tid] = p.pr;
      packed[tid] = pack_one(p);
    }
    return;
  }
  const int stride = gridDim.x * blockDim.x;
  const int head = common_head(ids, pos, valid, labels, roi, pr, packed, n);
  const int nvec = (n - head) >> 2;
  for (int q = tid; q < nvec; q += stride) {
    const int i = head + 4 * q;
    const int4 r4 = *reinterpret_cast<const int4*>(ids + i);
    const int4 s4 = *reinterpret_cast<const int4*>(pos + i);
    const unsigned v4 = *reinterpret_cast<const unsigned*>(valid + i);
    const int r[4] = {r4.x, r4.y, r4.z, r4.w};
    const int s[4] = {s4.x, s4.y, s4.z, s4.w};
    unsigned lab = 0u, ro = 0u, prb = 0u, pk = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Point p = gather_one(table, rings, cap, gate, prr, r[e], s[e],
                                 (v4 >> (8 * e)) & 0xffu);
      lab |= (unsigned)(uint8_t)p.label << (8 * e);
      ro |= (unsigned)p.roi << (8 * e);
      prb |= (unsigned)p.pr << (8 * e);
      pk |= (unsigned)pack_one(p) << (8 * e);
    }
    *reinterpret_cast<unsigned*>(labels + i) = lab;
    *reinterpret_cast<unsigned*>(roi + i) = ro;
    *reinterpret_cast<unsigned*>(pr + i) = prb;
    *reinterpret_cast<unsigned*>(packed + i) = pk;
  }
  // Point by point: [0, head), then [head + 4 nvec, n).
  for (int t = tid; t < n - 4 * nvec; t += stride) {
    const int i = t < head ? t : t + 4 * nvec;
    const Point p = gather_one(table, rings, cap, gate, prr, ids[i], pos[i],
                               valid[i]);
    labels[i] = p.label;
    roi[i] = p.roi;
    pr[i] = p.pr;
    packed[i] = pack_one(p);
  }
}

template <int kCap>
void launch(const int* const* tables, const int* const* pos, int lanes,
            int rings, int cap, const int* ids, const bool* valid,
            const bool* ok, int prr, int n, int8_t* labels, bool* roi,
            bool* probably_road, uint8_t* packed, cudaStream_t stream) {
  Lanes<kCap> l = {};
  for (int b = 0; b < lanes; ++b) {
    l.table[b] = tables[b];
    l.pos[b] = pos[b];
  }
  const int per_block = kThreads * (kCap == 1 ? 1 : 4);
  const dim3 grid((n + per_block - 1) / per_block, lanes);
  gather_pack_kernel<kCap><<<grid, kThreads, 0, stream>>>(
      l, rings, cap, ids, valid, ok, prr, n, labels, roi, probably_road,
      packed);
}

}  // namespace

// lanes <= kLanes lanes of (n,) points: tables[b] is lane b's (rings, cap)
// int32 table, pos[b] its (n,) int32 slots; ids, valid and the outputs are
// (lanes, n), ok (lanes,).  One lane (a single scan) takes one point a
// thread, more lanes 4.
extern "C" int urf_gather_pack(const int* const* tables,
                               const int* const* pos, int lanes, int rings,
                               int cap, const int* ids, const bool* valid,
                               const bool* ok, int prr, int n, int8_t* labels,
                               bool* roi, bool* probably_road,
                               uint8_t* packed, void* stream) {
  if (lanes < 0 || lanes > kLanes) return (int)cudaErrorInvalidValue;
  if (lanes == 0 || n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 1)
    launch<1>(tables, pos, lanes, rings, cap, ids, valid, ok, prr, n,
              labels, roi, probably_road, packed, s);
  else
    launch<kLanes>(tables, pos, lanes, rings, cap, ids, valid, ok, prr, n,
                   labels, roi, probably_road, packed, s);
  return (int)cudaGetLastError();
}
