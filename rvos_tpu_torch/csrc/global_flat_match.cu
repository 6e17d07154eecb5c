// Global matching over a flat reference bank with a per-object penalty.
//
// Replaces rvos_tpu/ops/pallas_matching.py::_kernel (wrapper
// global_matching_pallas).  For query rows q [M, C], any bank r [R, C] and
// labels lab [R, O] (not necessarily one-hot):
//
//   out[m, o] = min over r of (||q_m||^2 + ||r||^2 - 2 q_m . r
//                              + (1 - lab[r, o]) * 5e4)
//
// The caller passes the operands transposed (qT [C, M], rT [C, R], float32,
// already rounded through bf16 in mixed mode), the float32 row norms q2 [M]
// and r2 [R] of the unrounded values, and the penalty transposed,
// penT [O, R] = (1 - lab^T) * 5e4.  The kernel does the O(M*R*C) cross term
// and the O(M*R*O) penalised min.  Rows past R are skipped (their penalty
// reads +inf), where the Pallas wrapper pads R to 1024 with zero rows that
// carry 5e4 for every object; those can only win in an all-penalty channel.
//
// What bounds it on the H100: operations.  At the cap-off shapes (M = 25,773,
// R = 206,184, C = 100, O = 11) the cross term is 1.06 TFLOP and the
// penalised min 0.12 T operations, against ~100 MB of inputs.  Design,
// after kernel 1 (global_seg_map.cu): one CTA per 64 query rows keeps its
// query tile in shared memory for the whole bank walk; 64-row bank steps
// stream through shared memory with their [OB, 64] penalty slice; each of
// 256 threads owns a 4x4 micro-tile of the 64x64 distance block in
// registers (16 FMAs per two 16-byte shared loads) and adds each distance
// to the O penalties of its column, min-updating running mins
// run[4][OB] per (row, object).  OB, the object count rounded up to 16 or
// 32, is a template parameter, so every index into run is a compile-time
// constant after unrolling and the 4*OB running mins stay in registers
// (ptxas -v, kept in _build/global_flat_match.log, reports the registers
// and spills of both instantiations); objects past O read a +inf penalty
// and are never written.  The 16 threads of a row group, one half-warp,
// combine their mins with shuffles once, at the end of the walk.  The
// [M, R] distance matrix never exists.  The cross term runs in float32 FMA
// in both modes (never TF32); in mixed mode the operands arrive rounded to
// bf16, so the products are exact and the arithmetic equals a bf16 product
// with float32 accumulation.  The Pallas kernel also rounds the distance
// and the penalty to bf16 and takes the min in bf16; this kernel keeps the
// min in float32, as kernel 1 does.  Tensor cores, and the min(B_o, A+5e4)
// shortcut for one-hot labels, are later steps for speed.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // bank rows per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 distances each

template <int OB>
__global__ void __launch_bounds__(THREADS)
flat_match_kernel(const float* __restrict__ qT, const float* __restrict__ q2,
                  const float* __restrict__ rT, const float* __restrict__ r2,
                  const float* __restrict__ penT, float* __restrict__ out,
                  int M, int R, int C, int O) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [C][BM]
  float* rs = qs + C * BM;     // [C][BN]
  float* rn = rs + C * BN;     // [BN]
  float* ps = rn + BN;         // [OB][BN]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BM;

  for (int i = tid; i < C * BM; i += THREADS) {
    const int c = i / BM, j = i - c * BM, m = m0 + j;
    qs[i] = (m < M) ? qT[(size_t)c * M + m] : 0.f;
  }
  float qn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    qn[i] = (m < M) ? q2[m] : 0.f;
  }
  float run[4][OB];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 0; o < OB; ++o) run[i][o] = INFINITY;

  for (int n0 = 0; n0 < R; n0 += BN) {
    __syncthreads();  // the previous step's readers are done with rs, ps
    for (int i = tid; i < C * BN; i += THREADS) {
      const int c = i / BN, j = i - c * BN, n = n0 + j;
      rs[i] = (n < R) ? rT[(size_t)c * R + n] : 0.f;
    }
    if (tid < BN) rn[tid] = (n0 + tid < R) ? r2[n0 + tid] : 0.f;
    for (int i = tid; i < OB * BN; i += THREADS) {
      const int o = i / BN, j = i - o * BN, n = n0 + j;
      ps[i] = (o < O && n < R) ? penT[(size_t)o * R + n] : INFINITY;
    }
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
    const float4 r4 = *reinterpret_cast<const float4*>(rn + tx * 4);
    const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = qn[i] + rv[j] - 2.f * acc[i][j];
#pragma unroll
    for (int o = 0; o < OB; ++o) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + o * BN + tx * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          run[i][o] = fminf(run[i][o], acc[i][j] + pv[j]);
    }
  }

  // the 16 threads of a row group are one half-warp: after the butterfly
  // every lane holds the min, and lane o % 16 writes object o
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int o = 0; o < OB; ++o) {
      float v = run[i][o];
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      if ((o & 15) == tx && o < O && m < M) out[(size_t)m * O + o] = v;
    }
  }
}

template <int OB>
int launch(const float* qT, const float* q2, const float* rT, const float* r2,
           const float* penT, float* out, int M, int R, int C, int O,
           cudaStream_t stream) {
  const size_t smem = (size_t)(C * BM + C * BN + BN + OB * BN) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flat_match_kernel<OB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM);
  flat_match_kernel<OB><<<grid, THREADS, smem, stream>>>(qT, q2, rT, r2, penT,
                                                         out, M, R, C, O);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int global_flat_match_launch(const float* qT, const float* q2,
                                        const float* rT, const float* r2,
                                        const float* penT, float* out, int M,
                                        int R, int C, int O, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (O <= 16) return launch<16>(qT, q2, rT, r2, penT, out, M, R, C, O, s);
  if (O <= 32) return launch<32>(qT, q2, rT, r2, penT, out, M, R, C, O, s);
  return (int)cudaErrorInvalidValue;
}
