// Shared tile machinery of the two global-matching kernels: kernel 1
// (global_seg_map.cu, B.1 and B.2) and kernel 3 (global_flat_match.cu,
// B.3).  Both walk a bank of reference rows against a tile of query rows,
// form d = ||q||^2 + ||r||^2 - 2 q.r per (query, bank row) pair without
// ever writing the [M, R] matrix, and differ only in how they take the
// min of d (their epilogues).
//
// tc::   mixed mode, on the bf16 tensor cores (wgmma, float32
//        accumulation).  The prep:: kernels below bring the operands in,
//        one launch each: q [M, Cp] and the bank as -2 r [rows, Cp] in
//        bf16, zero-padded from C to Cp = 16 KS (KS <= 8 slices of the
//        16-deep MMA), with the float32 norms q2 [M] and r2 [rows] of the
//        unrounded values (+inf on padding rows, so those never win).  A
//        CTA is one warpgroup (4 warps) and holds 128 query rows as two
//        64-row halves; each warp keeps the A fragments of its 2 x 16 rows
//        in registers for the whole walk.  Bank steps of 64 rows, with
//        their norms and one int key per step, stream through a 3-stage
//        shared-memory ring filled by cp.async in the 8 x 8 core-matrix
//        layout that wgmma reads without swizzle, so the loads of steps
//        s+1 and s+2 overlap the MMAs and epilogue of step s.  Each 16-deep
//        slice is two wgmma.m64n64k16 (A from registers, B by shared-memory
//        descriptor).  The accumulators start at r2, so a warp's 64
//        accumulators end as d' = ||r||^2 - 2 q.r, the distance less
//        ||q||^2, with no float32 arithmetic per pair: the epilogue is one
//        min per pair, and ||q||^2 is added once per row.  The kernels are
//        templates on KS, so fragment indices and shared-memory offsets
//        are compile-time constants; at KS = 7 (C = 100) they fit 3 CTAs
//        per SM.  Grid: (query tiles, bank splits); a split covers a run of
//        bank steps and, when there is more than one, the CTAs combine
//        their results with an order-preserving float atomicMin.
//
// simt:: float32 (parity) mode, on the float32 FMA units, never TF32.
//        Operands arrive transposed (qT [C, M], rT [C, R]); a CTA of 256
//        threads keeps 64 query rows in shared memory and each thread owns
//        a 4x4 micro-tile of each 64x64 distance block (16 FMAs per two
//        16-byte shared loads).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dist_tile {

constexpr unsigned FULL_MASK = 0xffffffffu;

// v <- min(*p, v) for float32, exact and independent of the order of the
// callers: non-negative floats order as signed ints, negative ones in
// reverse as unsigned ints.  *p starts at +inf.
__device__ __forceinline__ void atomic_min_f32(float* p, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

// ------------------------------------------------------------------ SIMT
namespace simt {

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // bank rows per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 distances each

// qs[c][j] = qT[c][m0 + j], 0 past M
__device__ __forceinline__ void load_query(float* qs, const float* qT, int M,
                                           int C, int m0, int tid) {
  for (int i = tid; i < C * BM; i += THREADS) {
    const int c = i / BM, j = i - c * BM, m = m0 + j;
    qs[i] = (m < M) ? qT[(size_t)c * M + m] : 0.f;
  }
}

// rs[c][j] = rT[c][n0 + j], 0 past R
__device__ __forceinline__ void load_rows(float* rs, const float* rT, int R,
                                          int C, int n0, int tid) {
  for (int i = tid; i < C * BN; i += THREADS) {
    const int c = i / BN, j = i - c * BN, n = n0 + j;
    rs[i] = (n < R) ? rT[(size_t)c * R + n] : 0.f;
  }
}

// acc[i][j] = sum over c of qs[c][ty*4 + i] * rs[c][tx*4 + j]
__device__ __forceinline__ void cross(const float* qs, const float* rs, int C,
                                      int tx, int ty, float acc[4][4]) {
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
}

// min over the 16 threads of a row group, one half-warp: every lane ends
// with the min
__device__ __forceinline__ float half_warp_min(float v) {
  v = fminf(v, __shfl_xor_sync(FULL_MASK, v, 8));
  v = fminf(v, __shfl_xor_sync(FULL_MASK, v, 4));
  v = fminf(v, __shfl_xor_sync(FULL_MASK, v, 2));
  return fminf(v, __shfl_xor_sync(FULL_MASK, v, 1));
}

}  // namespace simt

// ---------------------------------------------------------- tensor cores
namespace tc {

constexpr int BM = 128;      // query rows per CTA
constexpr int BN = 64;       // bank rows per step
constexpr int WARPS = 4;     // 32 query rows each
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int MIN_CTAS = 3;  // resident CTAs per SM (<= 168 registers)
constexpr int MT = 2;        // 64-row halves of the CTA (one wgmma each)
constexpr int NT = BN / 8;   // n8 tiles per step

typedef float Block[MT][NT][4];   // a warp's 32 x 64 accumulators
// the A fragments of a warp's 32 query rows over KS 16-deep slices; the
// kernels are templates on KS, so every fragment index and every
// shared-memory offset is a compile-time constant
template <int KS>
using AFrag = uint32_t[MT][KS][4];

// one ring stage, 128-byte aligned: the bf16 tile (BN x cp, in 8 x 8 core
// matrices), r2 [BN], the step key (in a slot of 128 bytes)
__host__ __device__ constexpr int stage_bytes(int cp) {
  return BN * cp * 2 + BN * 4 + 128;
}

__host__ __device__ constexpr int ring_bytes(int cp) {
  return STAGES * stage_bytes(cp);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes through L1 (.ca): the CTAs resident on an SM often walk the
// same bank split at about the same pace, so a bank tile read by one is
// often still in L1 for the next; through L2 only (.cg) the walk is bound by L2
// bandwidth (64 MACs per byte of bank read per CTA step)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared-memory matrix descriptor of a K-major bf16 operand without
// swizzle: 8-row x 16-byte core matrices, lbo bytes apart along K and sbo
// bytes apart along the rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d += a . b for a warpgroup's 64 x 64 x 16 tile: a from registers (each
// warp's 16 rows in the mma.m16n8k16 A-fragment layout), b from shared
// memory by descriptor, float32 accumulators d[4 j + e] as in
// mma.m16n8k16's C fragment of n-tile j.
__device__ __forceinline__ void wgmma_64x64x16(float* d, const uint32_t a[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// keeps the compiler from moving accesses of v across the asynchronous
// wgmma that reads and writes it
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// the CTA-local row (0..127) of the thread's row (i, h): warp w of the
// warpgroup holds rows 16 w + [0, 16) of each 64-row half i
__device__ __forceinline__ int local_row(int warp, int lane, int i, int h) {
  return i * 64 + warp * 16 + (lane >> 2) + h * 8;
}

// A fragments of the warp's 32 query rows (zero past M): a[i][ks] covers
// the warp's 16 rows of half i and depths 16 ks + [0, 16).  Fragment
// layout: lane (g, t) = (lane / 4, lane % 4) holds in reg 0 row g at
// depths 2t, 2t + 1, in reg 1 row g + 8 at the same depths, and in regs
// 2, 3 the same two rows at depths 2t + 8, 2t + 9.
template <int KS>
__device__ __forceinline__ void load_query(AFrag<KS> a, const uint16_t* q,
                                           int M, int tid) {
  constexpr int cp = 16 * KS;
  const int lane = tid & 31, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = blockIdx.x * BM + local_row(tid >> 5, lane, i, h);
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(q + (size_t)(m < M ? m : 0) * cp);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        a[i][ks][h] = m < M ? src[ks * 8 + t] : 0u;
        a[i][ks][h + 2] = m < M ? src[ks * 8 + 4 + t] : 0u;
      }
    }
}

// Start the asynchronous copy of bank step s (rows 64 s ...) into a ring
// stage: the 2 KS 16-byte chunks of each bf16 row (two threads a row),
// each into its place in the 8 x 8 core matrix of rows 8 (n / 8) ... and
// depths 8 ch ... (core matrices 128 bytes apart along the depth, 2 KS x
// 128 along the rows), the 64 norms and the step key key[s / key_div].
template <int KS>
__device__ __forceinline__ void issue_step(char* stage, const uint16_t* rb,
                                           const float* r2, const int* key,
                                           int key_div, int s, int tid) {
  static_assert(THREADS == 2 * BN, "two threads per bank row");
  constexpr int cp = 16 * KS;
  const uint32_t base = smem_addr(stage);
  const int row = tid >> 1;
  const uint16_t* src = rb + ((size_t)s * BN + row) * cp;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int ch = 2 * k + (tid & 1);
    cp_async16(base + ((row >> 3) * 2 * KS + ch) * 128 + (row & 7) * 16,
               src + ch * 8);
  }
  const uint32_t tail = base + BN * cp * 2;
  if (tid < BN)
    cp_async4(tail + tid * 4, r2 + (size_t)s * BN + tid);
  else if (tid == BN)
    cp_async4(tail + BN * 4, key + s / key_div);
}

// d = r2 + the CTA's 128 query rows . the stage's 64 bank rows, on the
// tensor cores: two warpgroup MMAs (64 query rows each) per 16-deep slice.
// With the bank passed as -2 r, that is d' = ||r||^2 - 2 q.r, the distance
// less ||q||^2: the accumulators start at r2, so the epilogue gets d' with
// no float32 arithmetic per pair.  Layout: d[i][j][e] is the thread's row
// (i, e / 2) (local_row) and bank column 8 j + 2 t + e % 2 of the step.
template <int KS>
__device__ __forceinline__ void cross(Block d, AFrag<KS> a, uint32_t tile,
                                      const float* r2s, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 rr = *reinterpret_cast<const float2*>(r2s + j * 8 + 2 * t);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      d[i][j][0] = d[i][j][2] = rr.x;
      d[i][j][1] = d[i][j][3] = rr.y;
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(d[i][j][e]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t b = smem_desc(tile + ks * 256, 128, 2 * KS * 128);
#pragma unroll
    for (int i = 0; i < MT; ++i) wgmma_64x64x16(&d[i][0][0], a[i][ks], b);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(d[i][j][e]);
}

// run[i][h] = min(run[i][h], min of the thread's columns of that row)
__device__ __forceinline__ void row_min(float run[MT][2], Block d) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        run[i][e >> 1] = fminf(run[i][e >> 1], d[i][j][e]);
}

// min over the 4 lanes of a quad, the lanes that share a row: every lane
// ends with the min
__device__ __forceinline__ float quad_min(float v) {
  v = fminf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fminf(v, __shfl_xor_sync(FULL_MASK, v, 2));
}

// The walk of one CTA over bank steps [s_begin, s_end): for each step,
// after its tile has arrived, epi(s, key, d) gets the step's key and the
// warp's 32 x 64 block d' (see cross).  Every thread of the CTA calls it,
// so an epilogue may __syncthreads().  The ring starts at `ring`.
template <int KS, class Epi>
__device__ __forceinline__ void walk(char* ring, const uint16_t* rb,
                                     const float* r2, const int* key,
                                     int key_div, int s_begin, int s_end,
                                     AFrag<KS> a, int tid, Epi&& epi) {
  constexpr int cp = 16 * KS;
  constexpr int sb = stage_bytes(cp);
  const int lane = tid & 31;
  const int n = s_end - s_begin;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n)
      issue_step<KS>(ring + p * sb, rb, r2, key, key_div, s_begin + p, tid);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait<STAGES - 2>();  // step s has landed (this thread's part)
    // the copies were written through the generic proxy; wgmma reads
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();              // ... everyone's, and step s-1 is done
    const int nx = s + STAGES - 1;
    if (nx < n)
      issue_step<KS>(ring + (nx % STAGES) * sb, rb, r2, key, key_div,
                     s_begin + nx, tid);
    cp_async_commit();
    const char* st = ring + (s % STAGES) * sb;
    const float* r2s = reinterpret_cast<const float*>(st + BN * cp * 2);
    const int k = *reinterpret_cast<const int*>(r2s + BN);
    Block d;
    cross<KS>(d, a, smem_addr(st), r2s, lane);
    epi(s_begin + s, k, d);
  }
  cp_async_wait<0>();
}

// Write the CTA's [BM, O] result: val(i, h, local row, o, ||q_m||^2) for
// the thread's live rows (i, h); lane t of each quad writes objects t,
// t + 4, ...  A plain store when the grid has one bank split, an atomic
// min into +inf otherwise.
template <class Val>
__device__ __forceinline__ void write_out(float* out, const float* q2, int M,
                                          int O, int tid, Val&& val) {
  const int lane = tid & 31, warp = tid >> 5;
  const bool split = gridDim.y > 1;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = local_row(warp, lane, i, h);
      const int m = blockIdx.x * BM + lr;
      if (m >= M) continue;
      const float qm = q2[m];
      for (int o = lane & 3; o < O; o += 4) {
        const float v = val(i, h, lr, o, qm);
        if (split)
          atomic_min_f32(out + (size_t)m * O + o, v);
        else
          out[(size_t)m * O + o] = v;
      }
    }
}

// Steps [s_begin, s_end) of this CTA's bank split.
__device__ __forceinline__ void split_range(int n_steps, int steps_per_split,
                                            int* s_begin, int* s_end) {
  *s_begin = blockIdx.y * steps_per_split;
  *s_end = min(n_steps, *s_begin + steps_per_split);
}

}  // namespace tc

// --------------------------------------------- operand preparation (mixed)
// One warp per row: a float32 row of C values becomes a bf16 row of cp
// values (scaled, zero past C) and its float32 squared norm (of the
// unscaled, unrounded values).  One launch per operand replaces the
// several PyTorch passes (norms, rounding, padding, gathers) that would
// otherwise cost more host time per call than the kernel costs the card.
namespace prep {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int k = 16; k; k >>= 1) v += __shfl_xor_sync(FULL_MASK, v, k);
  return v;
}

__device__ __forceinline__ float row_to_bf16(const float* src, uint16_t* dst,
                                             int C, int cp, float scale,
                                             int lane) {
  float s = 0.f;
  for (int c = lane; c < cp; c += 32) {
    const float v = c < C ? src[c] : 0.f;
    s = fmaf(v, v, s);
    dst[c] = __bfloat16_as_ushort(__float2bfloat16_rn(scale * v));
  }
  return warp_sum(s);
}

// qb [M, cp] = bf16(q), q2 [M]; out [M, O] (when given) to +inf
__global__ void __launch_bounds__(THREADS)
query_kernel(const float* __restrict__ q, uint16_t* __restrict__ qb,
             float* __restrict__ q2, float* __restrict__ out, int M, int C,
             int cp, int O) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= M) return;
  const float s = row_to_bf16(q + (size_t)m * C, qb + (size_t)m * cp, C, cp,
                              1.f, lane);
  if (lane == 0) q2[m] = s;
  if (out)
    for (int o = lane; o < O; o += 32) out[(size_t)m * O + o] = INFINITY;
}

// Bank row n < R from source row perm[n] (n without perm): rb[n] =
// bf16(scale r), r2[n] = ||r||^2 (+ bias[src] when given), labs[n] =
// lab[src] (when given); rows R <= n < rows: rb zero, r2 = pad_norm.
__global__ void __launch_bounds__(THREADS)
bank_kernel(const float* __restrict__ r, const long long* __restrict__ perm,
            const float* __restrict__ bias, float scale,
            uint16_t* __restrict__ rb, float* __restrict__ r2,
            const float* __restrict__ lab, float* __restrict__ labs, int R,
            int rows, int C, int cp, int O, float pad_norm) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= rows) return;
  uint16_t* dst = rb + (size_t)n * cp;
  if (n >= R) {
    for (int c = lane; c < cp; c += 32) dst[c] = 0;
    if (lane == 0) r2[n] = pad_norm;
    return;
  }
  const size_t src = perm ? (size_t)perm[n] : (size_t)n;
  const float s = row_to_bf16(r + src * C, dst, C, cp, scale, lane);
  if (lane == 0) r2[n] = bias ? s + bias[src] : s;
  if (labs)
    for (int o = lane; o < O; o += 32) labs[(size_t)n * O + o] = lab[src * O + o];
}

}  // namespace prep
}  // namespace dist_tile

// The host entry points of the preparation kernels, exported by each
// library that includes this header.
extern "C" int dist_prep_query(const float* q, void* qb, float* q2,
                               float* out, int M, int C, int cp, int O,
                               void* stream) {
  using namespace dist_tile::prep;
  query_kernel<<<(M + WARPS - 1) / WARPS, THREADS, 0, (cudaStream_t)stream>>>(
      q, static_cast<uint16_t*>(qb), q2, out, M, C, cp, O);
  return (int)cudaGetLastError();
}

extern "C" int dist_prep_bank(const float* r, const long long* perm,
                              const float* bias, float scale, void* rb,
                              float* r2, const float* lab, float* labs, int R,
                              int rows, int C, int cp, int O, float pad_norm,
                              void* stream) {
  using namespace dist_tile::prep;
  bank_kernel<<<(rows + WARPS - 1) / WARPS, THREADS, 0,
                (cudaStream_t)stream>>>(r, perm, bias, scale,
                                        static_cast<uint16_t*>(rb), r2, lab,
                                        labs, R, rows, C, cp, O, pad_norm);
  return (int)cudaGetLastError();
}
