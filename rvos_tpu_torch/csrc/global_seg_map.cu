// Global matching over an occupancy-segmented reference bank (kernel 1).
//
// Replaces rvos_tpu/ops/pallas_matching.py::_kernel_seg_map (wrapper
// global_matching_pallas_segmented_mapped).  For query rows q [M, C] and a
// bank r [P, C] cut into n_tiles label-pure tiles of tile_rows rows, with
// tile t owned by object tile_obj[t]:
//
//   out[m, o] = min over rows p of the tiles owned by o of
//               (||q_m||^2 + ||r_p||^2 + bias_p - 2 q_m . r_p)
//
// and 1e5 for a channel that owns no tile.  The caller passes the operands
// transposed (qT [C, M], rT [C, P], float32, already rounded through bf16 in
// mixed mode) and the row terms q2 [M] and r2b [P] = ||r||^2 + bias in
// float32, so the kernel does only the O(M*P*C) work: the cross term and
// the min routing.
//
// What bounds it on the H100: operations.  2*M*P*C = 84.5 GFLOP at the
// main path's shapes (M = 25,773, P = 16,384, C = 100) against ~18 MB of
// inputs and outputs.  Design: one CTA per 64 query rows keeps its query
// tile in shared memory for the whole bank walk and streams 64-row bank
// steps through shared memory; each of 256 threads owns a 4x4 micro-tile of
// the 64x64 distance block in registers (16 FMAs per two 16-byte shared
// loads), keeps a running min per query row over the current label-pure
// bank tile, and at the tile's end reduces across the 16 threads of its
// row group with warp shuffles and min-updates the row of tile_obj[t] in a
// shared [64, O] block.  The [M, P] distance matrix never exists.  The
// cross term runs in float32 FMA in both modes (never TF32); in mixed mode
// the operands arrive rounded to bf16, so the products are exact and the
// arithmetic equals a bf16 product with float32 accumulation.  Using the
// tensor cores (mma/wgmma on bf16 operands) is the next step for speed.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // bank rows per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr float EMPTY_DIST = 1e5f;

__global__ void __launch_bounds__(THREADS)
seg_map_kernel(const float* __restrict__ qT, const float* __restrict__ q2,
               const float* __restrict__ rT, const float* __restrict__ r2b,
               const int* __restrict__ tile_obj, float* __restrict__ out,
               int M, int P, int C, int O, int n_tiles, int tile_rows) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [C][BM]
  float* rs = qs + C * BM;     // [C][BN]
  float* rb = rs + C * BN;     // [BN]
  float* os = rb + BN;         // [BM][O]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BM;

  for (int i = tid; i < C * BM; i += THREADS) {
    const int c = i / BM, j = i - c * BM, m = m0 + j;
    qs[i] = (m < M) ? qT[(size_t)c * M + m] : 0.f;
  }
  for (int i = tid; i < BM * O; i += THREADS) os[i] = EMPTY_DIST;
  float qn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    qn[i] = (m < M) ? q2[m] : 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int obj = tile_obj[t];
    float run[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
    const int n_end = (t + 1) * tile_rows;
    for (int n0 = t * tile_rows; n0 < n_end; n0 += BN) {
      __syncthreads();  // the previous step's readers are done with rs
      for (int i = tid; i < C * BN; i += THREADS) {
        const int c = i / BN, j = i - c * BN;
        rs[i] = rT[(size_t)c * P + n0 + j];
      }
      if (tid < BN) rb[tid] = r2b[n0 + tid];
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(qs + c * BM + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(rs + c * BN + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      const float4 r4 = *reinterpret_cast<const float4*>(rb + tx * 4);
      const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          run[i] = fminf(run[i], qn[i] + rv[j] - 2.f * acc[i][j]);
    }
    // the 16 threads of a row group are one half-warp: reduce by shuffles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = run[i];
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      if (tx == 0 && obj >= 0 && obj < O) {
        float* slot = os + (ty * 4 + i) * O + obj;
        *slot = fminf(*slot, v);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BM * O; i += THREADS) {
    const int j = i / O, m = m0 + j;
    if (m < M) out[(size_t)m * O + (i - j * O)] = os[i];
  }
}

}  // namespace

extern "C" int global_seg_map_launch(const float* qT, const float* q2,
                                     const float* rT, const float* r2b,
                                     const int* tile_obj, float* out, int M,
                                     int P, int C, int O, int n_tiles,
                                     int tile_rows, void* stream) {
  const size_t smem = (size_t)(C * BM + C * BN + BN + BM * O) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      seg_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM);
  seg_map_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      qT, q2, rT, r2b, tile_obj, out, M, P, C, O, n_tiles, tile_rows);
  return (int)cudaGetLastError();
}
