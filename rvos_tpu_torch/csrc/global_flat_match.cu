// Global matching over a flat reference bank with a per-object penalty
// (kernel 3).
//
// Replaces rvos_tpu/ops/pallas_matching.py::_kernel (wrapper
// global_matching_pallas).  For query rows q [M, C], any bank r [R, C] and
// labels lab [R, O] (not necessarily one-hot):
//
//   out[m, o] = min over r of (||q_m||^2 + ||r||^2 - 2 q_m . r
//                              + (1 - lab[r, o]) * 5e4)
//
// with the float32 row norms q2 [M] and r2 [R] of the unrounded values
// passed in.  Rows past R never win, where the Pallas wrapper pads R to
// 1024 with zero rows that carry 5e4 for every object; those can only win
// in an all-penalty channel.
//
// What bounds it on the H100: operations.  At the cap-off shapes (M =
// 25,773, R = 206,184, C = 100, O = 11) the cross term is 1.06 TFLOP
// against ~100 MB of inputs; the penalised min adds 2*M*R*O = 0.12 T
// float32 operations for general labels and 2*M*R for one-hot-or-zero
// ones.
//
// Mixed mode (flat_match_mma_kernel): the one-hot route over a
// label-sorted bank.  For one-hot-or-zero labels the per-object min is
// exactly min(B_o, A + 5e4), A the min of d over every row and B_o the min
// over the rows labelled o (rounding is monotone, so fl(min d + 5e4) =
// min fl(d + 5e4)).  The caller sorts the bank by a key per row
// (flat_keys_kernel: o when one-hot at o, -1 when all zero, O "general"
// otherwise; a stable torch.sort) and tags each 64-row step
// (flat_tags_kernel): pure object o, pure zero (-1), or mixed (-2: more
// than one key, or a general row).  The cross term runs on the bf16
// tensor cores through dist_tile.cuh's mainloop.  A pure step costs what a
// kernel 1 step costs: one running min of d' per query row while the tag
// stays the same, folded at a change of tag (with ||q||^2 added) into A
// (registers) and into column o of a shared [128, O] block B.  A mixed
// step takes the general penalised min over its own 64 rows, with
// penalties (1 - lab) * 5e4 from the sorted labels, into B directly; at
// most O + 2 steps are mixed when the labels are one-hot or zero.  Every
// route computes a pair's value as (||q||^2 + d') + penalty, so the
// result, min(B_o, A + 5e4), is the general formula's for any labels and
// does not depend on the bank's row order.  The bank axis is split over
// several CTAs per query tile, combined by an atomic min.
//
// Float32 (parity) mode (flat_match_kernel): the SIMT float32 FMA path of
// dist_tile.cuh (never TF32) with the general penalised min: each
// 64-row step brings its [OB, 64] penalty slice (penT = (1 - lab^T) * 5e4)
// into shared memory and each thread keeps run[4][OB] per (row, object)
// in registers, OB the object count rounded up to 16 or 32 as a template
// parameter so that every index into run is a compile-time constant;
// objects past O read a +inf penalty and are never written.
#include "dist_tile.cuh"

namespace {

using namespace dist_tile;
constexpr float PEN = 5e4f;
constexpr int MIXED = -2;   // step tag of a mixed or general step
constexpr int NONE = -3;    // no step folded yet

template <int OB>
__global__ void __launch_bounds__(simt::THREADS)
flat_match_kernel(const float* __restrict__ qT, const float* __restrict__ q2,
                  const float* __restrict__ rT, const float* __restrict__ r2,
                  const float* __restrict__ penT, float* __restrict__ out,
                  int M, int R, int C, int O) {
  using namespace simt;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [C][BM]
  float* rs = qs + C * BM;     // [C][BN]
  float* rn = rs + C * BN;     // [BN]
  float* ps = rn + BN;         // [OB][BN]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BM;

  load_query(qs, qT, M, C, m0, tid);
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
    load_rows(rs, rT, R, C, n0, tid);
    if (tid < BN) rn[tid] = (n0 + tid < R) ? r2[n0 + tid] : 0.f;
    for (int i = tid; i < OB * BN; i += THREADS) {
      const int o = i / BN, j = i - o * BN, n = n0 + j;
      ps[i] = (o < O && n < R) ? penT[(size_t)o * R + n] : INFINITY;
    }
    __syncthreads();

    float acc[4][4];
    cross(qs, rs, C, tx, ty, acc);
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

  // after the half-warp butterfly every lane of a row group holds the min,
  // and lane o % 16 writes object o
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int o = 0; o < OB; ++o) {
      const float v = half_warp_min(run[i][o]);
      if ((o & 15) == tx && o < O && m < M) out[(size_t)m * O + o] = v;
    }
  }
}

template <int OB>
int launch(const float* qT, const float* q2, const float* rT, const float* r2,
           const float* penT, float* out, int M, int R, int C, int O,
           cudaStream_t stream) {
  using namespace simt;
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

template <int KS>
__global__ void __launch_bounds__(tc::THREADS, tc::MIN_CTAS)
flat_match_mma_kernel(const uint16_t* __restrict__ q,
                      const float* __restrict__ q2,
                      const uint16_t* __restrict__ rb,
                      const float* __restrict__ r2,
                      const float* __restrict__ lab,
                      const int* __restrict__ step_tag,
                      float* __restrict__ out, int M, int R, int n_steps,
                      int O, int steps_per_split) {
  using namespace tc;
  extern __shared__ __align__(128) char smem_tc[];
  char* ring = smem_tc;
  float* bs = reinterpret_cast<float*>(smem_tc + ring_bytes(16 * KS));
  float* pen = bs + BM * O;  // bs [BM][O], pen [O][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  for (int i = tid; i < BM * O; i += THREADS) bs[i] = INFINITY;
  AFrag<KS> a;
  load_query<KS>(a, q, M, tid);
  // Every route takes d = ||q||^2 + d' per pair, then adds the penalty,
  // so that each pair's value is the same whichever step its row lands
  // in: the result does not depend on the bank's row order.
  float qn[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = blockIdx.x * BM + local_row(warp, lane, i, h);
      qn[i][h] = m < M ? q2[m] : 0.f;
    }

  // running mins of d' over a run of pure steps; A (with ||q||^2)
  float run[MT][2], amin[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) amin[i][0] = amin[i][1] = INFINITY;
  int cur = NONE;
  auto reset = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i) run[i][0] = run[i][1] = INFINITY;
  };
  // fold the running mins of a pure run of steps into A and B[cur];
  // fl(||q||^2 + min d') = min fl(||q||^2 + d'), rounding being monotone
  auto flush = [&]() {
    if (cur >= -1 && cur < O) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = qn[i][h] + quad_min(run[i][h]);
          amin[i][h] = fminf(amin[i][h], v);
          if (cur >= 0 && t == 0) {
            float* slot = bs + local_row(warp, lane, i, h) * O + cur;
            *slot = fminf(*slot, v);
          }
        }
    }
    reset();
  };
  // a mixed step: the general penalised min over its 64 rows, into B
  auto mixed = [&](int s, Block& d) {
    __syncthreads();  // the previous mixed step's readers are done with pen
    for (int i = tid; i < O * BN; i += THREADS) {
      const int o = i / BN, j = i - o * BN, n = s * BN + j;
      pen[i] = (n < R) ? (1.f - lab[(size_t)n * O + o]) * PEN : 0.f;
    }
    __syncthreads();
    for (int o = 0; o < O; ++o) {
      const float* po = pen + o * BN + 2 * t;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = INFINITY;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            v = fminf(v, (qn[i][h] + d[i][j][2 * h]) + po[j * 8]);
            v = fminf(v, (qn[i][h] + d[i][j][2 * h + 1]) + po[j * 8 + 1]);
          }
          v = quad_min(v);
          if (t == 0) {
            float* slot = bs + local_row(warp, lane, i, h) * O + o;
            *slot = fminf(*slot, v);
          }
        }
    }
  };
  reset();
  int s_begin, s_end;
  split_range(n_steps, steps_per_split, &s_begin, &s_end);
  walk<KS>(ring, rb, r2, step_tag, 1, s_begin, s_end, a, tid,
           [&](int s, int k, Block& d) {
         const bool pure = k >= -1 && k < O;
         if (k != cur) {
           flush();
           cur = pure ? k : MIXED;
         }
         if (pure)
           row_min(run, d);
         else
           mixed(s, d);
       });
  flush();
  // every lane of a quad holds A of its rows after the quad reductions
  write_out(out, q2, M, O, tid, [&](int i, int h, int lr, int o, float) {
    return fminf(bs[lr * O + o], amin[i][h] + PEN);
  });
}

// key[n] of bank row n: o when lab[n] is exactly one-hot at o, -1 when it
// is all zero, O (general) otherwise
__global__ void flat_keys_kernel(const float* __restrict__ lab, int R, int O,
                                 int* __restrict__ key) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= R) return;
  int ones = 0, obj = -1;
  bool clean = true;
  for (int o = 0; o < O; ++o) {
    const float v = lab[(size_t)n * O + o];
    if (v == 1.f) {
      ++ones;
      obj = o;
    } else if (!(v == 0.f)) {
      clean = false;
    }
  }
  key[n] = (clean && ones <= 1) ? obj : O;
}

// tag[s] of 64-row step s of the sorted keys: its key when every row of it
// (rows past R do not count) has that key and the key is not general,
// MIXED otherwise; one warp per step
__global__ void flat_tags_kernel(const int* __restrict__ skey, int R,
                                 int n_steps, int O, int* __restrict__ tag) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= n_steps) return;
  const int n0 = s * tc::BN, k0 = skey[n0];
  bool same = true;
  for (int i = lane; i < tc::BN; i += 32)
    if (n0 + i < R && skey[n0 + i] != k0) same = false;
  same = __all_sync(FULL_MASK, same);
  if (lane == 0) tag[s] = (same && k0 < O) ? k0 : MIXED;
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

// The one-hot route's keys of lab [R, O] (float32) into key [R].
extern "C" int global_flat_keys_launch(const float* lab, int R, int O,
                                       int* key, void* stream) {
  flat_keys_kernel<<<(R + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      lab, R, O, key);
  return (int)cudaGetLastError();
}

// The step tags [ceil(R / 64)] of the sorted keys skey [R].
extern "C" int global_flat_tags_launch(const int* skey, int R, int O,
                                       int* tag, void* stream) {
  const int n_steps = (R + tc::BN - 1) / tc::BN;
  flat_tags_kernel<<<(n_steps + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      skey, R, n_steps, O, tag);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_mma(const void* q, const float* q2, const void* rb, const float* r2,
               const float* lab, const int* step_tag, float* out, int M, int R,
               int n_steps, int O, int steps_per_split, cudaStream_t stream) {
  using namespace tc;
  const size_t smem = (size_t)ring_bytes(16 * KS) +
                      (size_t)(BM * O + O * BN) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flat_match_mma_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM,
                  (n_steps + steps_per_split - 1) / steps_per_split);
  flat_match_mma_kernel<KS><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), q2, static_cast<const uint16_t*>(rb),
      r2, lab, step_tag, out, M, R, n_steps, O, steps_per_split);
  return (int)cudaGetLastError();
}

// Mixed mode over the label-sorted bank: q [M, cp] and rb [n_steps * 64,
// cp] bf16 from dist_prep_query / dist_prep_bank (rb = -2 r in sorted
// order, cp % 16 == 0, cp <= 128), q2 [M], r2 [n_steps * 64] (+inf past
// R), lab [R, O] float32 in the sorted order, step_tag [n_steps]; the bank
// is split into runs of steps_per_split steps, one CTA each per query tile
// (out must hold +inf when there is more than one run).
extern "C" int global_flat_match_mma_launch(const void* q, const float* q2,
                                            const void* rb, const float* r2,
                                            const float* lab,
                                            const int* step_tag, float* out,
                                            int M, int R, int n_steps, int cp,
                                            int O, int steps_per_split,
                                            void* stream) {
  if (cp % 16 || steps_per_split < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(KS)                                                        \
  case KS:                                                                \
    return launch_mma<KS>(q, q2, rb, r2, lab, step_tag, out, M, R,        \
                          n_steps, O, steps_per_split, s)
  switch (cp / 16) {
    LAUNCH(1); LAUNCH(2); LAUNCH(3); LAUNCH(4);
    LAUNCH(5); LAUNCH(6); LAUNCH(7); LAUNCH(8);
  }
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}
