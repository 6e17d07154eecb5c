// Global matching over a label-segmented bank (kernel 1).
//
// Replaces rvos_tpu/ops/pallas_matching.py::_kernel_seg_map (wrapper
// global_matching_pallas_segmented_mapped) and, routed by equal quotas,
// _kernel_seg (wrapper global_matching_pallas_segmented).  For query rows
// q [M, C] and a bank r [P, C] cut into n_tiles label-pure tiles of
// tile_rows rows, with tile t owned by object tile_obj[t]:
//
//   out[m, o] = min over rows p of the tiles owned by o of
//               (||q_m||^2 + ||r_p||^2 + bias_p - 2 q_m . r_p)
//
// and 1e5 for a channel that owns no tile.  The caller passes the row
// terms q2 [M] and r2b [P] = ||r||^2 + bias in float32 (norms of the
// unrounded values), so the kernel does only the O(M*P*C) work: the cross
// term and the min routing.
//
// What bounds it on the H100: operations.  2*M*P*C = 84.5 GFLOP at the
// main path's shapes (M = 25,773, P = 16,384, C = 100) against ~18 MB of
// inputs and outputs.
//
// Mixed mode (seg_map_mma_kernel): the cross term on the bf16 tensor
// cores through dist_tile.cuh's mainloop (128 query rows per CTA, 64-row
// bank steps through a cp.async ring, wgmma with float32
// accumulation).  A tile holds a whole number of steps, so step s belongs
// to object tile_obj[s / steps_per_tile].  The epilogue keeps a running
// min of d' per query row while the steps' object stays the same, and when
// it changes (or the walk ends) reduces across the quad of lanes that
// share a row and min-updates column tile_obj of a shared [128, O] block.
// The result is min(1e5, ||q||^2 + that block).  The bank axis is split
// over several CTAs per query tile, combined by an atomic min.
//
// Float32 (parity) mode (seg_map_kernel): the same route on the float32
// FMA units through dist_tile.cuh's ffma:: mainloop (never TF32): 128
// query rows per CTA held in shared memory, 64-row bank steps of -2 r
// through a cp.async ring, 8 x 8 register tiles per thread, accumulators
// seeded with ||r||^2 + bias; the epilogue keeps one running min per
// register row and folds it at a change of object, as above.  Its bound
// is 2*M*P*C operations at the float32 FMA rate; the min adds one
// operation per pair (1 %).
#include "dist_tile.cuh"

namespace {

using namespace dist_tile;
constexpr float EMPTY_DIST = 1e5f;

// Float32 mode: the same walk and fold on the FMA units (dist_tile.cuh's
// ffma::), one running min of d' per register row while the steps' object
// stays the same, folded across the 8 lanes of a row into the shared
// [128, O] block at a change.
__global__ void __launch_bounds__(ffma::THREADS, ffma::MIN_CTAS)
seg_map_kernel(const float* __restrict__ qT, const float* __restrict__ q2,
               const float* __restrict__ rb, const float* __restrict__ r2b,
               const int* __restrict__ tile_obj, float* __restrict__ out,
               int M, int cp, int n_steps, int O, int steps_per_tile,
               int steps_per_split) {
  using namespace ffma;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                       // [cp][BM]
  float* q2s = qs + cp * BM;                // [BM]
  float* ring = q2s + BM;                   // STAGES stages
  float* bs = smem_f + main_floats(cp);     // [BM][O]: min of d' per object

  const int tid = threadIdx.x, warp = tid >> 5;
  const int tm = (tid & 31) >> 3, tn = tid & 7;
  for (int i = tid; i < BM * O; i += THREADS) bs[i] = INFINITY;
  load_query(qs, q2s, qT, q2, cp, tid);

  float run[TM];
  int cur = -1;
  auto reset = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i) run[i] = INFINITY;
  };
  // fold the running mins into column cur of the shared block; lane tn
  // writes register row tn
  auto flush = [&]() {
    if (cur >= 0 && cur < O) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float v = oct_min(run[i]);
        if (tn == i) {
          float* slot = bs + local_row(warp, tm, i) * O + cur;
          *slot = fminf(*slot, v);
        }
      }
    }
    reset();
  };
  reset();
  const int s_begin = blockIdx.y * steps_per_split;
  const int s_end = min(n_steps, s_begin + steps_per_split);
  walk(ring, qs, rb, r2b, tile_obj, steps_per_tile, cp, s_begin, s_end, tid,
       [&](int, int k, Block& d) {
         if (k != cur) {
           flush();
           cur = k;
         }
         row_min(run, d);
       });
  flush();
  __syncthreads();
  // a channel with no tile reads EMPTY_DIST (min(1e5, +inf))
  write_out(out, M, O, tid, [&](int lr, int o) {
    return fminf(EMPTY_DIST, q2s[lr] + bs[lr * O + o]);
  });
}

template <int KS>
__global__ void __launch_bounds__(tc::THREADS, tc::MIN_CTAS)
seg_map_mma_kernel(const uint16_t* __restrict__ q,
                   const float* __restrict__ q2,
                   const uint16_t* __restrict__ rb,
                   const float* __restrict__ r2b,
                   const int* __restrict__ tile_obj, float* __restrict__ out,
                   int M, int n_steps, int O, int steps_per_tile,
                   int steps_per_split) {
  using namespace tc;
  extern __shared__ __align__(128) char smem_tc[];
  char* ring = smem_tc;
  float* bs = reinterpret_cast<float*>(smem_tc + ring_bytes(16 * KS));
  // bs [BM][O]: per (query row, object) min of d'

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < BM * O; i += THREADS) bs[i] = INFINITY;
  AFrag<KS> a;
  load_query<KS>(a, q, M, tid);

  float run[MT][2];
  int cur = -1;
  auto reset = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i) run[i][0] = run[i][1] = INFINITY;
  };
  // fold the running mins into column cur of the shared block
  auto flush = [&]() {
    if (cur >= 0 && cur < O) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = quad_min(run[i][h]);
          if ((lane & 3) == 0) {
            float* slot = bs + local_row(warp, lane, i, h) * O + cur;
            *slot = fminf(*slot, v);
          }
        }
    }
    reset();
  };
  reset();
  int s_begin, s_end;
  split_range(n_steps, steps_per_split, &s_begin, &s_end);
  walk<KS>(ring, rb, r2b, tile_obj, steps_per_tile, s_begin, s_end, a, tid,
           [&](int, int k, Block& d) {
         if (k != cur) {
           flush();
           cur = k;
         }
         row_min(run, d);
       });
  flush();
  // a channel with no tile reads EMPTY_DIST (min(1e5, +inf))
  write_out(out, q2, M, O, tid, [&](int, int, int lr, int o, float qm) {
    return fminf(EMPTY_DIST, qm + bs[lr * O + o]);
  });
}

}  // namespace

static size_t f32_smem(int cp, int O) {
  using namespace ffma;
  return (size_t)(main_floats(cp) + BM * O) * sizeof(float);
}

// Float32 mode: qT [tiles][cp][128] with q2 [tiles * 128] and rb
// [n_steps][cp][64] (-2 r) with r2b [n_steps * 64] = ||r||^2 + bias, from
// dist_prep_f32; tile_obj [n_steps / steps_per_tile]; the bank is split into
// runs of steps_per_split steps, one CTA each per query tile (out must hold
// +inf when there is more than one run).
extern "C" int global_seg_map_f32_launch(const float* qT, const float* q2,
                                         const float* rb, const float* r2b,
                                         const int* tile_obj, float* out,
                                         int M, int cp, int n_steps, int O,
                                         int steps_per_tile,
                                         int steps_per_split, void* stream) {
  using namespace ffma;
  if (cp % 4 || steps_per_split < 1 || steps_per_tile < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = f32_smem(cp, O);
  cudaError_t e = allow_smem(seg_map_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM,
                  (n_steps + steps_per_split - 1) / steps_per_split);
  seg_map_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      qT, q2, rb, r2b, tile_obj, out, M, cp, n_steps, O, steps_per_tile,
      steps_per_split);
  return (int)cudaGetLastError();
}

// CTAs of the float32 kernel resident per SM at depth cp and O objects.
extern "C" int global_seg_map_f32_residency(int cp, int O) {
  return ffma::residency(seg_map_kernel, f32_smem(cp, O));
}

template <int KS>
int launch_mma(const void* q, const float* q2, const void* rb,
               const float* r2b, const int* tile_obj, float* out, int M,
               int n_steps, int O, int steps_per_tile, int steps_per_split,
               cudaStream_t stream) {
  using namespace tc;
  const size_t smem =
      (size_t)ring_bytes(16 * KS) + (size_t)BM * O * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      seg_map_mma_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM,
                  (n_steps + steps_per_split - 1) / steps_per_split);
  seg_map_mma_kernel<KS><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), q2, static_cast<const uint16_t*>(rb),
      r2b, tile_obj, out, M, n_steps, O, steps_per_tile, steps_per_split);
  return (int)cudaGetLastError();
}

// Mixed mode: q [M, cp] and rb [n_steps * 64, cp] bf16 from
// dist_prep_query / dist_prep_bank (rb = -2 r, cp % 16 == 0, cp <= 128),
// q2 [M], r2b [n_steps * 64] = ||r||^2 + bias, tile_obj [n_steps /
// steps_per_tile]; the bank is split into runs of steps_per_split steps,
// one CTA each per query tile (out must hold +inf when there is more than
// one run).
extern "C" int global_seg_map_mma_launch(const void* q, const float* q2,
                                         const void* rb, const float* r2b,
                                         const int* tile_obj, float* out,
                                         int M, int n_steps, int cp, int O,
                                         int steps_per_tile,
                                         int steps_per_split, void* stream) {
  if (cp % 16 || steps_per_split < 1 || steps_per_tile < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(KS)                                                       \
  case KS:                                                               \
    return launch_mma<KS>(q, q2, rb, r2b, tile_obj, out, M, n_steps, O,  \
                          steps_per_tile, steps_per_split, s)
  switch (cp / 16) {
    LAUNCH(1); LAUNCH(2); LAUNCH(3); LAUNCH(4);
    LAUNCH(5); LAUNCH(6); LAUNCH(7); LAUNCH(8);
  }
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}
