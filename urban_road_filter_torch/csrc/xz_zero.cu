// x-zero and z-zero curb stencils in one pass over the (rings, P) layout.
//
// Replaces urban_road_filter_tpu/ops/pallas_kernels.py:fused_xz_zero (K7),
// which loaded one ring row into VMEM and formed every shifted window with
// pltpu.roll.  Its XLA twins, ops/xzero.py:x_zero and ops/zzero.py:z_zero,
// define the arithmetic; this kernel repeats it operation for operation,
// in the same order, so that the labels are bit-equal.  It is compiled
// with --fmad=false: a fused multiply-add would round differently from the
// separate multiply and add that XLA and eager PyTorch perform.
//
// What bounds it on Hopper: memory.  Each slot reads its 2*cp+1 window of
// x, y and z (cp <= 30), but neighbouring threads read overlapping windows
// of one row, so after L1 the traffic is about one read of x/y/z/label and
// one write of label per slot: ~5 MB for a 64 x 4096 layout.
//
// Design.  One thread per (ring, slot), a 256-wide tile of one ring per
// block; loads go through the read-only cache.  The x-zero mark of window
// j lands on slot j + cp/2, so it is computed in gather form: thread m
// tests window j = m - cp/2 and no two threads write one slot.  Only
// windows with cp <= j <= counts-1-cp are valid; they never reach past the
// ring's points, so the roll wrap-around of the TPU version never matters.
//
// The newY ladder is indexed by slot, or, with a per-ring ladder offset,
// by (offset + slot) clipped to [0, ladder_len): the azimuth-sharded path
// runs the stencils on halo-extended wedge rows whose column c holds the
// ring's global position prefix + c - 2cp, and takes newY there
// (urban_road_filter_tpu/parallel/azimuth_parallel.py:_x_zero_halo), so its
// differences match the single-scan path bit for bit.

#include <cuda_runtime.h>

namespace {

// newY[k] = k * 0.01 in float64, rounded to float32
// (urban_road_filter_tpu/ops/xzero.py:_new_y_table), at k = clip(j + off,
// 0, len - 1).
__device__ __forceinline__ float new_y(int j, int off, int len) {
  const int k = min(max(j + off, 0), len - 1);
  return (float)((double)k * 0.01);
}

// jnp.maximum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a > b ? a : b;
}

__global__ void xz_zero_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               const float* __restrict__ z,
                               const int* __restrict__ counts,
                               const int* __restrict__ label_in,
                               const int* __restrict__ ladder_off,
                               int ladder_len, int* __restrict__ label_out,
                               int p, int cp, int do_x, int do_z, float cos_x,
                               float cos_z, float ch) {
  const int r = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= p) return;
  const size_t row = (size_t)r * p;
  const float* xr = x + row;
  const float* yr = y + row;
  const float* zr = z + row;
  const int n = counts[r];
  const int h = cp / 2;
  bool mark = false;

  if (do_x) {
    const int j = m - h;
    if (j >= cp && j <= n - 1 - cp) {
      const float ddx = __ldg(xr + j + cp) - __ldg(xr + j);
      const float ddy = __ldg(yr + j + cp) - __ldg(yr + j);
      const float d = sqrtf(ddx * ddx + ddy * ddy);
      const int off = ladder_off ? ladder_off[r] : 0;
      const float dny1 =
          new_y(j + h, off, ladder_len) - new_y(j, off, ladder_len);
      const float dny2 =
          new_y(j + cp, off, ladder_len) - new_y(j + h, off, ladder_len);
      const float dny3 =
          new_y(j + cp, off, ladder_len) - new_y(j, off, ladder_len);
      const float zj = __ldg(zr + j);
      const float zh = __ldg(zr + j + h);
      const float zc = __ldg(zr + j + cp);
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
  }

  if (do_z && m >= cp && m <= n - 1 - cp) {
    const float ddx = __ldg(xr + m + cp) - __ldg(xr + m - cp);
    const float ddy = __ldg(yr + m + cp) - __ldg(yr + m - cp);
    const float d = sqrtf(ddx * ddx + ddy * ddy);
    const float xm = __ldg(xr + m);
    const float ym = __ldg(yr + m);
    const float absz = fabsf(__ldg(zr + m));
    float va1 = 0.0f, va2 = 0.0f, vb1 = 0.0f, vb2 = 0.0f;
    float max1 = absz, max2 = absz;
    for (int k = 1; k <= cp; ++k) {
      va1 += __ldg(xr + m - k) - xm;
      va2 += __ldg(yr + m - k) - ym;
      vb1 += __ldg(xr + m + k) - xm;
      vb2 += __ldg(yr + m + k) - ym;
      max1 = nan_max(max1, fabsf(__ldg(zr + m - k)));
      max2 = nan_max(max2, fabsf(__ldg(zr + m + k)));
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

  label_out[row + m] = mark ? 2 : label_in[row + m];  // 2 = LABEL_CURB
}

}  // namespace

// label_out[r, m] = LABEL_CURB where either stencil marks slot m of ring r,
// else label_in[r, m].  All (rings, p) arrays are contiguous row-major.
// ladder_off: (rings,) int32 newY offsets, or NULL for none (then
// ladder_len must be >= p).
extern "C" int urf_xz_zero(const float* x, const float* y, const float* z,
                           const int* counts, const int* label_in,
                           const int* ladder_off, int ladder_len,
                           int* label_out, int rings, int p, int cp, int do_x,
                           int do_z, float cos_x, float cos_z, float ch,
                           void* stream) {
  const dim3 grid((p + 255) / 256, rings);
  if (rings > 0 && p > 0)
    xz_zero_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, y, z, counts, label_in, ladder_off, ladder_len, label_out, p, cp,
        do_x, do_z, cos_x, cos_z, ch);
  return (int)cudaGetLastError();
}
