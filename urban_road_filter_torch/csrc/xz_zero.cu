// x-zero and z-zero curb stencils in one pass over the (rings, P) layout,
// marks written in place.
//
// Replaces urban_road_filter_tpu/ops/pallas_kernels.py:fused_xz_zero (K7),
// which loaded one ring row into VMEM and formed every shifted window with
// pltpu.roll, and, in urf_xz_zero_halo, the azimuth-sharded path's halo
// stencils (urban_road_filter_tpu/parallel/azimuth_parallel.py:_x_zero_halo
// and _z_zero_halo, XLA there).  Its plain twins, ops/xzero.py:x_zero and
// ops/zzero.py:z_zero (and ops/stencil_kernels.py:xz_zero_halo_plain),
// define the arithmetic; this kernel repeats it operation for operation,
// in the same order, so that the labels are bit-equal.  It is compiled
// with --fmad=false: a fused multiply-add would round differently from the
// separate multiply and add that XLA and eager PyTorch perform.
//
// What bounds it on Hopper: neither bytes nor operations, but latency.
// Only a ring's points can be marked (~150 of 4096 slots a ring on an
// OS1-64 scan), so the bytes it must move are the points' x/y/z and the
// few marks: tens of KB.  A launch is one round of dependent loads.
//
// Design.  A block owns a tile of TILE slots of one row, a thread a slot,
// and reads the row's count first: a tile that holds no slot a stencil
// can mark exits before any other load, so the grid covers P but only the
// tiles with points load anything.  The others copy the tile's points
// plus a halo of cp slots each side into shared memory, two coalesced
// 4-byte loads a thread a field, all issued before the first store; no
// slot at or past the count is read.  Then each thread tests the windows
// of its own slot from shared memory: x-zero in gather form (the mark of
// window j lands on slot j + cp/2, so thread m tests window j = m - cp/2)
// and z-zero at m, with its sums taken over k = 1..cp in order.  A thread
// writes LABEL_CURB to its own slot where either stencil marks it and
// nothing else: the label is never read, so a launch is idempotent, and
// no table is copied.  Of the forms tools/ab_xz_zero.py timed (PERF.md),
// these were the fastest: 4-byte loads (16-byte loads from the first
// 16-byte boundary, a scalar head and tail around them, took 19-25 %
// longer; a 1-D bulk copy needs 16-byte-aligned ends, which a count and a
// halo start are not), TILE = 128 (64 and 256 were slower at 64 x 4096
// and on the SP rows) and the one-instruction NaN maximum.
//
// The gates.  A window is tested where its global ring positions pass the
// reference's range, cp <= g <= total - 1 - cp, with g the slot plus the
// row's prefix, and where every slot it spans holds a point.  Without a
// halo (one scan) prefix is 0 and total the row's count: the single-scan
// j-range cp <= j <= n - 1 - cp.  With a halo (the azimuth-sharded path,
// a row per (wedge, ring)) slot s < 0 holds left-halo point cp + s (the
// halo's last ln are valid) and slot s >= n right-halo point s - n (its
// first rn), so a row reads as the ring's points around the wedge's own;
// only local slots are marked.  These are the gates the sharded path
// applied to its halo-extended rows [cp dummy | left | local | right],
// whose rolls reach no wrapped column once in_row holds.
//
// The newY ladder is indexed by slot plus a per-row offset (the sharded
// path's prefix: the ring's global position), clipped to [0, ladder_len),
// so the halo rows' differences match the single-scan path bit for bit.
// No state survives a launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;  // slots a block owns, a thread each
constexpr int CP_MAX = 30;  // FilterConfig's curb_points range
constexpr int SPAN = TILE + 2 * CP_MAX;
static_assert(SPAN <= 2 * TILE, "a tile takes two loads a thread a field");

// The azimuth-sharded path's halo (read by xz_zero_kernel<true> only).
struct Halo {
  const float *lx, *ly, *lz;  // (rows, cp) left blocks, right-aligned
  const float *rx, *ry, *rz;  // (rows, cp) right blocks, left-aligned
  const int *ln, *rn;         // (rows,) valid points in each block
  const int* prefix;          // (rows,) global position of slot 0
  const int* total;           // (rings,) points of the ring over all rows
  int rings;                  // row b is ring b % rings
};

// newY[k] = k * 0.01 in float64, rounded to float32
// (urban_road_filter_tpu/ops/xzero.py:_new_y_table), at k = clip(j + off,
// 0, len - 1).
__device__ __forceinline__ float new_y(int j, int off, int len) {
  const int k = min(max(j + off, 0), len - 1);
  return (float)((double)k * 0.01);
}

// jnp.maximum / torch.maximum: NaN if either operand is NaN (one
// instruction since sm_80; the stencils compare the result, so its NaN's
// payload does not matter, and their operands are |z|, never -0).
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// HALO: the azimuth-sharded rows, whose windows reach into halo blocks;
// the single-scan kernel is compiled without that code.
template <bool HALO>
__global__ void __launch_bounds__(TILE)
xz_zero_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ z, const int* __restrict__ counts,
               int* __restrict__ label, const int* __restrict__ ladder_off,
               int ladder_len, Halo halo, int p, int cp, int do_x, int do_z,
               const float* __restrict__ cos_x_p,
               const float* __restrict__ cos_z_p,
               const float* __restrict__ ch_p) {
  __shared__ float sx[SPAN], sy[SPAN], sz[SPAN];
  __shared__ float s_prm[3];  // cos_x, cos_z, curb_height
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int n = min(counts[b], p);
  if (t0 >= n) return;  // no local point in this tile
  const int h = cp / 2;
  const int ln = HALO ? halo.ln[b] : 0;
  const int rn = HALO ? halo.rn[b] : 0;
  // The last slot a stencil can mark: x-zero's window must end on a point.
  if (t0 > n + rn - 1 - cp + h) return;

  // The tile's slots and a cp halo each side, coalesced, every load issued
  // before the first store to shared memory (one round trip, not one per
  // field).
  const int t = threadIdx.x;
  const size_t row = (size_t)b * p;
  const int base = t0 - cp;  // slot of shared index 0
  const int lo = max(base, 0), hi = min(t0 + TILE + cp, n);
  const float* src[3] = {x + row, y + row, z + row};
  float* dst[3] = {sx - base, sy - base, sz - base};  // dst[f][s]: slot s
  float v[3][2];  // slots lo + t and lo + TILE + t of each field
  // Threads 0-2 load cos_x, cos_z and curb_height with the tile.
  const float prm =
      t < 3 ? __ldg(t == 0 ? cos_x_p : t == 1 ? cos_z_p : ch_p) : 0.0f;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    v[f][0] = lo + t < hi ? __ldg(src[f] + lo + t) : 0.0f;
    v[f][1] = lo + TILE + t < hi ? __ldg(src[f] + lo + TILE + t) : 0.0f;
  }
  // The halo: left slots [max(base, -ln), 0) and right slots
  // [max(base, n), min(t0 + TILE + cp, n + rn)), a thread each.
  const float* hsrc[3] = {halo.lx, halo.ly, halo.lz};
  const float* rsrc[3] = {halo.rx, halo.ry, halo.rz};
  const int s_left = max(base, -ln) + t;
  const int s_right = max(base, n) + t;
  const bool left = HALO && s_left < 0;
  const bool right = HALO && s_right < min(t0 + TILE + cp, n + rn);
  float hl[3], hr[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    hl[f] = left ? __ldg(hsrc[f] + (size_t)b * cp + cp + s_left) : 0.0f;
    hr[f] = right ? __ldg(rsrc[f] + (size_t)b * cp + s_right - n) : 0.0f;
  }
  const int pre = HALO ? halo.prefix[b] : 0;
  const int total = HALO ? halo.total[b % halo.rings] : n;
  const int off = ladder_off ? ladder_off[b] : 0;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    if (lo + t < hi) dst[f][lo + t] = v[f][0];
    if (lo + TILE + t < hi) dst[f][lo + TILE + t] = v[f][1];
    if (left) dst[f][s_left] = hl[f];
    if (right) dst[f][s_right] = hr[f];
  }
  if (t < 3) s_prm[t] = prm;
  __syncthreads();
  const float cos_x = s_prm[0], cos_z = s_prm[1], ch = s_prm[2];

  const int m = t0 + t;
  if (m >= n) return;
  const float* xs = dst[0];  // xs[s]: slot s of the row
  const float* ys = dst[1];
  const float* zs = dst[2];
  bool mark = false;

  const int j = m - h;  // x-zero's window [j, j + cp] marks slot m
  if (do_x && pre + j >= cp && pre + j <= total - 1 - cp && j >= -ln &&
      j + cp < n + rn) {
    const float ddx = xs[j + cp] - xs[j];
    const float ddy = ys[j + cp] - ys[j];
    const float d = sqrtf(ddx * ddx + ddy * ddy);
    const float dny1 =
        new_y(j + h, off, ladder_len) - new_y(j, off, ladder_len);
    const float dny2 =
        new_y(j + cp, off, ladder_len) - new_y(j + h, off, ladder_len);
    const float dny3 =
        new_y(j + cp, off, ladder_len) - new_y(j, off, ladder_len);
    const float zj = zs[j];
    const float zh = zs[j + h];
    const float zc = zs[j + cp];
    const float a1 = zh - zj;
    const float a2 = zc - zh;
    const float a3 = zc - zj;
    const float x1 = sqrtf(dny1 * dny1 + a1 * a1);
    const float x2 = sqrtf(dny2 * dny2 + a2 * a2);
    const float x3 = sqrtf(dny3 * dny3 + a3 * a3);
    const float bracket = (x3 * x3 - x1 * x1 - x2 * x2) / (-2.0f * x1 * x2);
    mark = (d < 5.0f) && (bracket >= cos_x) &&
           ((fabsf(zj - zh) >= ch) || (fabsf(zc - zh) >= ch)) &&
           (fabsf(zj - zc) >= 0.05f);
  }

  if (do_z && pre + m >= cp && pre + m <= total - 1 - cp && m - cp >= -ln &&
      m + cp < n + rn) {
    const float ddx = xs[m + cp] - xs[m - cp];
    const float ddy = ys[m + cp] - ys[m - cp];
    const float d = sqrtf(ddx * ddx + ddy * ddy);
    const float xm = xs[m];
    const float ym = ys[m];
    const float absz = fabsf(zs[m]);
    float va1 = 0.0f, va2 = 0.0f, vb1 = 0.0f, vb2 = 0.0f;
    float max1 = absz, max2 = absz;
    for (int k = 1; k <= cp; ++k) {
      va1 += xs[m - k] - xm;
      va2 += ys[m - k] - ym;
      vb1 += xs[m + k] - xm;
      vb2 += ys[m + k] - ym;
      max1 = nan_max(max1, fabsf(zs[m - k]));
      max2 = nan_max(max2, fabsf(zs[m + k]));
    }
    const float inv = 1.0f / (float)cp;
    va1 = va1 * inv;
    va2 = va2 * inv;
    vb1 = vb1 * inv;
    vb2 = vb2 * inv;
    const float bracket = (va1 * vb1 + va2 * vb2) /
                          (sqrtf(va1 * va1 + va2 * va2) *
                           sqrtf(vb1 * vb1 + vb2 * vb2));
    mark = mark || ((d < 5.0f) && (bracket >= cos_z) &&
                    ((max1 - absz >= ch) || (max2 - absz >= ch)) &&
                    (fabsf(max1 - max2) >= 0.05f));
  }

  if (mark) label[row + m] = 2;  // LABEL_CURB
}

int launch(const float* x, const float* y, const float* z, const int* counts,
           int* label, const int* ladder_off, int ladder_len, const Halo& halo,
           int rows, int p, int cp, int do_x, int do_z, const float* cos_x,
           const float* cos_z, const float* ch, void* stream) {
  if (cp < 1 || cp > CP_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((p + TILE - 1) / TILE, rows);
  if (rows > 0 && p > 0 && halo.lx)
    xz_zero_kernel<true><<<grid, TILE, 0, (cudaStream_t)stream>>>(
        x, y, z, counts, label, ladder_off, ladder_len, halo, p, cp, do_x,
        do_z, cos_x, cos_z, ch);
  else if (rows > 0 && p > 0)
    xz_zero_kernel<false><<<grid, TILE, 0, (cudaStream_t)stream>>>(
        x, y, z, counts, label, ladder_off, ladder_len, halo, p, cp, do_x,
        do_z, cos_x, cos_z, ch);
  return (int)cudaGetLastError();
}

}  // namespace

// label[r, m] = LABEL_CURB where either stencil marks slot m of ring r; no
// other slot is written.  All (rings, p) arrays are contiguous row-major,
// counts <= p.  ladder_off: (rings,) int32 newY offsets, or NULL for none
// (then ladder_len must be >= p).  cos_x, cos_z and ch (curb_height): one
// float32 each in device memory, read by each block that has points.
extern "C" int urf_xz_zero(const float* x, const float* y, const float* z,
                           const int* counts, int* label,
                           const int* ladder_off, int ladder_len, int rings,
                           int p, int cp, int do_x, int do_z,
                           const float* cos_x, const float* cos_z,
                           const float* ch, void* stream) {
  const Halo none = {};
  return launch(x, y, z, counts, label, ladder_off, ladder_len, none, rings,
                p, cp, do_x, do_z, cos_x, cos_z, ch, stream);
}

// The same over the azimuth-sharded path's stacked (rows = wedges * rings,
// p) layout, a row's window reaching into the halo blocks around it: left
// and right (rows, cp) x/y/z blocks with their valid counts ln and rn
// (rows,), the row's global ring position of slot 0 (prefix, (rows,)) and
// each ring's point total ((rings,)); newY at clip(prefix + slot, 0,
// ladder_len - 1).
extern "C" int urf_xz_zero_halo(
    const float* x, const float* y, const float* z, const int* counts,
    int* label, const float* lx, const float* ly, const float* lz,
    const int* ln, const float* rx, const float* ry, const float* rz,
    const int* rn, const int* prefix, const int* total, int rings,
    int ladder_len, int rows, int p, int cp, int do_x, int do_z,
    const float* cos_x, const float* cos_z, const float* ch, void* stream) {
  if (rings < 1) return (int)cudaErrorInvalidValue;
  const Halo halo = {lx, ly, lz, rx, ry, rz, ln, rn, prefix, total, rings};
  return launch(x, y, z, counts, label, prefix, ladder_len, halo, rows, p,
                cp, do_x, do_z, cos_x, cos_z, ch, stream);
}
