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
// Float32 (parity) mode (flat_match_kernel): the same one-hot route over
// the same sorted bank and step tags, on the float32 FMA units through
// dist_tile.cuh's ffma:: mainloop (never TF32; 8 x 8 register tiles,
// accumulators seeded with ||r||^2), so a pure step costs one min per pair
// there too, and the result is order-independent and the general
// formula's as in mixed mode.  The bank axis is split the same way.
#include "dist_tile.cuh"

namespace {

using namespace dist_tile;
constexpr float PEN = 5e4f;
constexpr int MIXED = -2;   // step tag of a mixed or general step
constexpr int NONE = -3;    // no step folded yet

// Float32 mode: the one-hot route of flat_match_mma_kernel on the FMA
// units (dist_tile.cuh's ffma::), over the same sorted bank and step tags.
// A and B live in shared memory ([128] and [128, O]); a thread's running
// mins fold across the 8 lanes of a row.
__global__ void __launch_bounds__(ffma::THREADS, ffma::MIN_CTAS)
flat_match_kernel(const float* __restrict__ qT, const float* __restrict__ q2,
                  const float* __restrict__ rb, const float* __restrict__ r2,
                  const float* __restrict__ lab,
                  const int* __restrict__ step_tag, float* __restrict__ out,
                  int M, int R, int cp, int n_steps, int O,
                  int steps_per_split) {
  using namespace ffma;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                       // [cp][BM]
  float* q2s = qs + cp * BM;                // [BM]
  float* ring = q2s + BM;                   // STAGES stages
  float* bs = smem_f + main_floats(cp);     // [BM][O]: B
  float* as = bs + BM * O;                  // [BM]: A
  float* pen = as + BM;                     // [O][BN]: a mixed step's

  const int tid = threadIdx.x, warp = tid >> 5;
  const int tm = (tid & 31) >> 3, tn = tid & 7;
  for (int i = tid; i < BM * O + BM; i += THREADS) bs[i] = INFINITY;
  load_query(qs, q2s, qT, q2, cp, tid);

  float run[TM];  // running mins of d' over a run of pure steps
  int cur = NONE;
  auto reset = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i) run[i] = INFINITY;
  };
  // fold the running mins of a pure run of steps into A and B[cur] (lane
  // tn writes register row tn); fl(||q||^2 + min d') = min fl(||q||^2 +
  // d'), rounding being monotone
  auto flush = [&]() {
    if (cur >= -1 && cur < O) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int lr = local_row(warp, tm, i);
        const float v = q2s[lr] + oct_min(run[i]);
        if (tn == i) {
          as[lr] = fminf(as[lr], v);
          if (cur >= 0) bs[lr * O + cur] = fminf(bs[lr * O + cur], v);
        }
      }
    }
    reset();
  };
  // a mixed step: the general penalised min over its 64 rows, into B; as
  // in the tensor-core kernel, (||q||^2 + d') + penalty per pair
  auto mixed = [&](int s, Block& d) {
    __syncthreads();  // the previous mixed step's readers are done with pen
    for (int i = tid; i < O * BN; i += THREADS) {
      const int o = i / BN, j = i - o * BN, n = s * BN + j;
      pen[i] = (n < R) ? (1.f - lab[(size_t)n * O + o]) * PEN : 0.f;
    }
    __syncthreads();
    float qn[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) qn[i] = q2s[local_row(warp, tm, i)];
    for (int o = 0; o < O; ++o) {
      const float4 p0 = *reinterpret_cast<const float4*>(pen + o * BN + tn * 4);
      const float4 p1 =
          *reinterpret_cast<const float4*>(pen + o * BN + 32 + tn * 4);
      const float pv[TN] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float v = INFINITY;
#pragma unroll
        for (int j = 0; j < TN; ++j) v = fminf(v, (qn[i] + d[i][j]) + pv[j]);
        v = oct_min(v);
        if (tn == i) {
          float* slot = bs + local_row(warp, tm, i) * O + o;
          *slot = fminf(*slot, v);
        }
      }
    }
  };
  reset();
  const int s_begin = blockIdx.y * steps_per_split;
  const int s_end = min(n_steps, s_begin + steps_per_split);
  walk(ring, qs, rb, r2, step_tag, 1, cp, s_begin, s_end, tid,
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
  __syncthreads();
  write_out(out, M, O, tid, [&](int lr, int o) {
    return fminf(bs[lr * O + o], as[lr] + PEN);
  });
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

static size_t f32_smem(int cp, int O) {
  using namespace ffma;
  return (size_t)(main_floats(cp) + BM * O + BM + O * BN) * sizeof(float);
}

// Float32 mode over the label-sorted bank: qT [tiles][cp][128] with q2
// [tiles * 128] and rb [n_steps][cp][64] (-2 r in sorted order) with r2
// [n_steps * 64] (+inf past R), from dist_prep_f32; lab [R, O] float32 in
// the sorted order, step_tag [n_steps]; the bank is split into runs of
// steps_per_split steps, one CTA each per query tile (out must hold +inf
// when there is more than one run).
extern "C" int global_flat_match_f32_launch(const float* qT, const float* q2,
                                            const float* rb, const float* r2,
                                            const float* lab,
                                            const int* step_tag, float* out,
                                            int M, int R, int cp, int n_steps,
                                            int O, int steps_per_split,
                                            void* stream) {
  using namespace ffma;
  if (cp % 4 || steps_per_split < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = f32_smem(cp, O);
  cudaError_t e = allow_smem(flat_match_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM,
                  (n_steps + steps_per_split - 1) / steps_per_split);
  flat_match_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      qT, q2, rb, r2, lab, step_tag, out, M, R, cp, n_steps, O,
      steps_per_split);
  return (int)cudaGetLastError();
}

// CTAs of the float32 kernel resident per SM at depth cp and O objects.
extern "C" int global_flat_match_f32_residency(int cp, int O) {
  return ffma::residency(flat_match_kernel, f32_smem(cp, O));
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
