// Labels back to input-point order, gated and packed for the wire.
//
// Replaces urban_road_filter_tpu/ops/gather.py:gather_by_group_pos (K11)
// and the plane packing of urban_road_filter_tpu/pipeline.py:_packed_scan_dyn.
// On the TPU the table lookup was two one-hot MXU contractions over 2-bit
// labels packed four to an s8 word, because the TPU's element gather is
// slow; its +128 word correction had no lower bound, so a negative index
// decoded to a spurious label.
//
// What bounds it on Hopper: memory.  Per point it reads ring id, slot,
// ROI flag and one table word, and writes four bytes: ~2.5 MB per
// 131072-point scan against a 64 x 4096 int32 table (1 MB) that stays in
// L2.  The lookup is a plain indexed load.
//
// Design.  One thread per point: an index outside [0, rings) x [0, cap),
// negative ones included, reads as label 0.  In the same pass the
// >= 30-point gate `ok` (a device scalar, so the host never waits for it)
// zeroes everything of a scan that is not evaluated, and the thread writes
// the int8 label, the ROI and probably-road flags, and the packed byte
// label | roi << 2 | probably_road << 3.  A point is probably road when its
// ring id is prr and a ring of the table: the id `rings` means "no ring".

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_pack_kernel(const int* __restrict__ table, int rings,
                                   int cap, const int* __restrict__ ids,
                                   const int* __restrict__ pos,
                                   const bool* __restrict__ valid,
                                   const bool* __restrict__ ok, int prr, int n,
                                   int8_t* __restrict__ labels,
                                   bool* __restrict__ roi,
                                   bool* __restrict__ probably_road,
                                   uint8_t* __restrict__ packed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool gate = *ok;
  const int r = ids[i];
  const int s = pos[i];
  int lab = 0;
  if (gate && r >= 0 && r < rings && s >= 0 && s < cap)
    lab = table[(size_t)r * cap + s];
  const bool v = gate && valid[i];
  const bool pr = gate && r == prr && r < rings;
  const int8_t lab8 = (int8_t)lab;
  labels[i] = lab8;
  roi[i] = v;
  probably_road[i] = pr;
  packed[i] = (uint8_t)lab8 | (v ? 4 : 0) | (pr ? 8 : 0);
}

}  // namespace

extern "C" int urf_gather_pack(const int* table, int rings, int cap,
                               const int* ids, const int* pos,
                               const bool* valid, const bool* ok, int prr,
                               int n, int8_t* labels, bool* roi,
                               bool* probably_road, uint8_t* packed,
                               void* stream) {
  if (n > 0)
    gather_pack_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        table, rings, cap, ids, pos, valid, ok, prr, n, labels, roi,
        probably_road, packed);
  return (int)cudaGetLastError();
}
