// The ring layout's geometry planes after the placement (K6): each slot's
// 2-D radius d2 and azimuth alpha, the label (0) and pid (-1) planes, and
// each row's largest radius, in one launch over the stacked (rows, P)
// planes (a row is one ring of one scan, or of one azimuth wedge).
//
// Replaces no TPU kernel.  It replaces the PyTorch glue of the tensorize
// stage (ops/geometry.py: azimuth_2d, the label and pid fills and
// max_distance), about 40 elementwise ops that each read and write whole
// (rows, P) planes, half of them in float64, over every slot although
// most are empty (85 % of a 128-scan OS1-64 batch's 16.8 M slots).
//
// What bounds it on Hopper: bytes.  d2, alpha, label and pid written (16 B
// a slot), x and y read only below counts (8 B a placed slot), counts read
// and the max written (8 B a row): about 0.29 GB for a batch of 128 OS1-64
// scans, whose slots are 85 % empty, 0.086 ms at 3.35 TB/s.  Design:
//   * one block a row; its threads walk the row in 16-byte pieces (4 slots
//     a thread and step, neighbouring threads on neighbouring pieces), so
//     every load and store is a float4 / int4 where P is a multiple of 4
//     and the planes are 16-byte aligned (else one slot a thread and step);
//   * x and y are read only for pieces below counts[row]; slots at or past
//     it get their constants (d2 0, alpha NaN, label 0, pid -1) with no
//     arithmetic.  That is the glue's result there, because K6 stores +0.0
//     in every slot past a ring's count: the glue's 0/0 bracket is NaN;
//   * the float64 steps (the oracle's azimuth recipe) run only on the
//     slots below counts[row], where the points are;
//   * the row's maximum is a block reduction (warp shuffles, then one
//     shared word a warp), not atomics, so it is deterministic.  It
//     propagates NaN, as torch.amax does.
// Every multiply, add, divide and root is an _rn intrinsic, separately
// rounded as PyTorch's one-op-per-kernel glue rounds it (and never
// contracted into a fused multiply-add, whatever --fmad says); float64
// stays float64 (asin of a double, no asinf).
//
// Per slot below counts[row], the glue's steps in its precisions:
//   d2    = sqrt_f32(x*x + y*y)                       (f32)
//   r     = f32(sqrt_f64(double(x)^2 + double(y)^2))
//   b     = clamp(|x| / r, -1, 1)                     (f32; NaN stays NaN)
//   a     = asin_f64(double(b)) * (180 / pi)          (f64)
//   alpha = f32(a, 180 - a, 180 + a or 360 - a by quadrant, in f64)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr double kDeg64 = 57.29577951308232;  // 180 / pi in float64

struct GeometryArgs {
  const float* x;
  const float* y;
  const int* counts;  // (rows,): points in each row
  int rows;
  int p;              // slots a row
  float* d2;
  float* alpha;
  int* label;         // null: not written
  int* pid;           // null: not written
  float* maxd;        // (rows,)
};

// The larger of a and b, NaN if either is NaN (torch.amax).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float nan_f32() {
  return __int_as_float(0x7fffffff);
}

// One placed slot: its d2 and alpha, the glue's steps in its precisions.
__device__ __forceinline__ void geometry(float x, float y, float& d2,
                                         float& alpha) {
  d2 = __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
  const double x64 = (double)x, y64 = (double)y;
  const float r = __double2float_rn(
      __dsqrt_rn(__dadd_rn(__dmul_rn(x64, x64), __dmul_rn(y64, y64))));
  float b = __fdiv_rn(fabsf(x), r);
  if (!isnan(b)) b = fminf(fmaxf(b, -1.0f), 1.0f);
  const double a = __dmul_rn(asin((double)b), kDeg64);
  double q;
  if (x >= 0.0f && y <= 0.0f) {
    q = a;
  } else if (x >= 0.0f && y > 0.0f) {
    q = __dsub_rn(180.0, a);
  } else if (x < 0.0f && y >= 0.0f) {
    q = __dadd_rn(a, 180.0);
  } else {
    q = __dsub_rn(360.0, a);
  }
  alpha = __double2float_rn(q);
}

// V = 4: 16-byte pieces (p % 4 == 0, planes 16-byte aligned); V = 1: slots.
template <int V>
__global__ void __launch_bounds__(kThreads)
    ring_geometry_kernel(GeometryArgs a) {
  const int row = blockIdx.x;
  const int cnt = min(max(a.counts[row], 0), a.p);
  const size_t base = (size_t)row * a.p;
  const int pieces = a.p / V;
  float m = 0.0f;
  for (int q = threadIdx.x; q < pieces; q += kThreads) {
    const int s0 = q * V;
    const size_t o = base + s0;
    float d[V], al[V];
    if (s0 < cnt) {
      float xs[V], ys[V];
      if constexpr (V == 4) {
        const float4 xv = *reinterpret_cast<const float4*>(a.x + o);
        const float4 yv = *reinterpret_cast<const float4*>(a.y + o);
        xs[0] = xv.x; xs[1] = xv.y; xs[2] = xv.z; xs[3] = xv.w;
        ys[0] = yv.x; ys[1] = yv.y; ys[2] = yv.z; ys[3] = yv.w;
      } else {
        xs[0] = a.x[o];
        ys[0] = a.y[o];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (s0 + j < cnt) {
          geometry(xs[j], ys[j], d[j], al[j]);
          m = nan_max(m, d[j]);
        } else {
          d[j] = 0.0f;
          al[j] = nan_f32();
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        d[j] = 0.0f;
        al[j] = nan_f32();
      }
    }
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(a.d2 + o) =
          make_float4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<float4*>(a.alpha + o) =
          make_float4(al[0], al[1], al[2], al[3]);
      if (a.label != nullptr) {
        *reinterpret_cast<int4*>(a.label + o) = make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(a.pid + o) = make_int4(-1, -1, -1, -1);
      }
    } else {
      a.d2[o] = d[0];
      a.alpha[o] = al[0];
      if (a.label != nullptr) {
        a.label[o] = 0;
        a.pid[o] = -1;
      }
    }
  }
  __shared__ float warp_max[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1)
    m = nan_max(m, __shfl_xor_sync(~0u, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
    a.maxd[row] = m;
  }
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// x, y, d2, alpha (rows, p) f32 and, when given, label, pid (rows, p) int32
// contiguous; counts (rows,) int32; maxd (rows,) f32.  label and pid are
// written together or not at all (both null).  One launch of one block a
// row.
extern "C" int urf_ring_geometry(const float* x, const float* y,
                                 const int* counts, int rows, int p, float* d2,
                                 float* alpha, int* label, int* pid,
                                 float* maxd, void* stream) {
  if (rows < 0 || p < 1 || maxd == nullptr ||
      (label == nullptr) != (pid == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  GeometryArgs a{x, y, counts, rows, p, d2, alpha, label, pid, maxd};
  const bool wide = p % 4 == 0 && aligned16(x) && aligned16(y) &&
                    aligned16(d2) && aligned16(alpha) && aligned16(label) &&
                    aligned16(pid);
  if (wide) {
    ring_geometry_kernel<4><<<rows, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    ring_geometry_kernel<1><<<rows, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
