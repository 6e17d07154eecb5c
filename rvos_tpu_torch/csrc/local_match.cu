// Windowed multi-radius local matching (kernel 2).
//
// Replaces rvos_tpu/ops/pallas_local.py::_kernel (wrapper
// local_matching_pallas).  For a query x [h, w, C], S previous-frame
// embeddings ys [S, h, w, C] sharing one label map, and every offset
// (dy, dx) of the K x K window (K = 2 a_max + 1, step `atrous`):
//
//   d_o = ||x||^2 + ||y'||^2 - 2 x . y' + (1 - onehot'_o) * 5e4
//
// where ' is the shifted previous frame; out-of-frame offsets read
// ||y'||^2 = 5e4 and a 5e4 penalty, i.e. x2 + 1e5, which never beats the
// 1e5 start value.  out[s, ch, o, p] is the min of d_o over the offsets
// with max(|dy|, |dx|) <= order[ch], started at 1e5 (the Pallas kernel's
// init), raw (unsquashed).
//
// The labels are one-hot, so the penalty term needs no per-object loop:
// min_o = min(1e5, B_o, A + 5e4) with A the min of d over all in-frame
// offsets and B_o the min over offsets whose label is o (fl(a + 5e4) is
// monotonic in a, so this equals the min of the rounded sums exactly).
// The caller passes each previous pixel's object id (-1 for none).
//
// What bounds it on the H100: operations, 2*K^2*S*h*w*C = 1.63 GFLOP at
// the main path's shapes (h x w = 61 x 107, K = 25, S = 2, C = 100)
// against ~12 MB in and out; in practice the loads of the shifted
// embedding rows (served from L1/L2) and the per-offset reductions.
// Design: one warp per (s, pixel).  Lane l keeps channels l, l+32, l+64,
// l+96 of x in registers and reads the same channels of y' (one coalesced
// 400-byte row per offset), reduces the dot product with shuffles, and
// owns object l's running min B; A is kept by every lane.  The window is
// walked in Chebyshev rings of growing radius, so after the ring of each
// radius in the ascending list the running mins are that radius' result
// and are written once — the nested radii cost one pass over K^2 offsets.
// Both previous embeddings (S = 2) go in one launch.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CPL = 4;  // channels per lane: C <= 128
constexpr int THREADS = 128;
constexpr float PEN = 5e4f;
constexpr float EMPTY_DIST = 1e5f;

__device__ __forceinline__ void ring_offset(int cd, int e, int* dy, int* dx) {
  if (cd == 0) {
    *dy = 0;
    *dx = 0;
    return;
  }
  const int side = 2 * cd + 1;
  if (e < side) {
    *dy = -cd;
    *dx = -cd + e;
  } else if (e < 2 * side) {
    *dy = cd;
    *dx = -cd + (e - side);
  } else {
    const int e2 = e - 2 * side;
    *dy = -cd + 1 + (e2 >> 1);
    *dx = (e2 & 1) ? cd : -cd;
  }
}

__global__ void __launch_bounds__(THREADS)
local_match_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                   const float* __restrict__ ys, const float* __restrict__ y2,
                   const int* __restrict__ lab, const int* __restrict__ asc,
                   const int* __restrict__ order, float* __restrict__ out,
                   int S, int h, int w, int C, int O, int n_asc, int n_r,
                   int atrous) {
  const int hw = h * w;
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= S * hw) return;  // whole warps exit together
  const int s = warp / hw;
  const int p = warp - s * hw;
  const int i = p / w;
  const int j = p - i * w;

  float xr[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    xr[k] = (c < C) ? x[(size_t)p * C + c] : 0.f;
  }
  const float xn = x2[p];
  const float* yb = ys + (size_t)s * hw * C;
  const float* y2b = y2 + (size_t)s * hw;

  float A = INFINITY;  // min of d over all in-frame offsets so far
  float B = INFINITY;  // min of d over offsets labelled `lane`
  int done = -1;       // largest ring already walked
  for (int b = 0; b < n_asc; ++b) {
    const int R = asc[b];
    for (int cd = done + 1; cd <= R; ++cd) {
      const int n_off = cd == 0 ? 1 : 8 * cd;
      for (int e = 0; e < n_off; ++e) {
        int dy, dx;
        ring_offset(cd, e, &dy, &dx);
        const int yi = i + dy * atrous, yj = j + dx * atrous;
        if (yi < 0 || yi >= h || yj < 0 || yj >= w) continue;
        const int q = yi * w + yj;
        const float* yp = yb + (size_t)q * C;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = lane + 32 * k;
          if (c < C) acc = fmaf(xr[k], yp[c], acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 16);
        acc += __shfl_xor_sync(0xffffffffu, acc, 8);
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        const float d = xn + y2b[q] - 2.f * acc;
        A = fminf(A, d);
        if (lab[q] == lane) B = fminf(B, d);
      }
    }
    done = R > done ? R : done;
    if (lane < O) {
      const float v = fminf(EMPTY_DIST, fminf(B, A + PEN));
      for (int ch = 0; ch < n_r; ++ch)
        if (order[ch] == R)
          out[(((size_t)s * n_r + ch) * O + lane) * hw + p] = v;
    }
  }
}

}  // namespace

extern "C" int local_match_launch(const float* x, const float* x2,
                                  const float* ys, const float* y2,
                                  const int* lab, const int* asc,
                                  const int* order, float* out, int S, int h,
                                  int w, int C, int O, int n_asc, int n_r,
                                  int atrous, void* stream) {
  const long long warps = (long long)S * h * w;
  const dim3 grid((unsigned)((warps * 32 + THREADS - 1) / THREADS));
  local_match_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, x2, ys, y2, lab, asc, order, out, S, h, w, C, O, n_asc, n_r, atrous);
  return (int)cudaGetLastError();
}
