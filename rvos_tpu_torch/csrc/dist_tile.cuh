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
// ffma:: float32 (parity) mode, on the float32 FMA units, never TF32: the
//        arithmetic of the JAX package's Precision.HIGHEST.  What bounds
//        it is the FFMA rate (67 TFLOP/s on an H100 SXM), so the design
//        keeps every other unit below it.  One launch of prep::f32_kernel
//        per operand brings it in, in k-major tiles: the query as
//        [M / 128][Cp][128] and the bank as -2 r [rows / 64][Cp][64] (Cp =
//        C rounded up to 4, zero-filled; -2 r is exact), with the float32
//        norms q2 and r2 (+ bias, +inf on padding rows).  A CTA of 4 warps
//        holds 128 query rows in shared memory for the whole walk and
//        streams 64-row bank steps through a 2-stage cp.async ring of
//        16-byte copies, so step s+1 loads while step s computes.  Each
//        thread owns an 8 x 8 register tile (rows split 4 + 4 sixteen
//        apart, columns 4 + 4 thirty-two apart): per channel two float4
//        reads of the query tile and two of the bank tile feed 64 FMAs, and
//        a warp's reads of one float4 slot touch 4 or 8 adjacent slots, so
//        they broadcast without bank conflicts; the next channel's
//        fragments load while this one's FMAs run.  The accumulators start
//        at r2, so each pair ends as d' = ||r||^2 - 2 q.r, the chain of
//        FMAs running over the channels in order whatever the row's place:
//        a pair's value does not depend on the tile, split or shard its row
//        lands in.  The epilogues are the tensor-core ones: one min per
//        pair, ||q||^2 added once per row when a run is folded.  At C = 100
//        and O = 11 two CTAs fit an SM (about 110 KB of shared memory
//        each).  The grid splits the bank over CTAs as tc:: does.
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

// --------------------------------------------------- float32 FMA units
namespace ffma {

constexpr int BM = 128;       // query rows per CTA
constexpr int BN = 64;        // bank rows per step
constexpr int THREADS = 128;  // 4 warps of 4 x 8 threads, 8 x 8 pairs each
constexpr int STAGES = 2;     // cp.async ring depth
constexpr int MIN_CTAS = 2;   // resident CTAs per SM (<= 255 registers)
constexpr int TM = 8;         // query rows per thread
constexpr int TN = 8;         // bank rows per thread

typedef float Block[TM][TN];  // a thread's d' of one step

// one ring stage: the -2 r tile [cp][BN], r2 [BN] and the step key (in a
// slot of 16 bytes), in floats
__host__ __device__ constexpr int stage_floats(int cp) {
  return cp * BN + BN + 4;
}

// shared memory ahead of a kernel's own epilogue buffers: the query tile
// [cp][BM], its norms [BM] and the ring, in floats
__host__ __device__ constexpr int main_floats(int cp) {
  return cp * BM + BM + STAGES * stage_floats(cp);
}

// 16 bytes through L2 only: an SM's L1 is what its shared memory leaves
__device__ __forceinline__ void cp_async16_cg(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// The thread's place: warp w holds CTA rows 32 w + [0, 32); lane (tm, tn)
// = (lane / 8, lane % 8) holds rows 32 w + 16 h + 4 tm + [0, 4) (h = 0,
// 1) and step columns 32 h + 4 tn + [0, 4).  Register row i is h = i / 4.
__device__ __forceinline__ int local_row(int warp, int tm, int i) {
  return warp * 32 + (i >> 2) * 16 + tm * 4 + (i & 3);
}

// Start the copy of the CTA's query tile (qT [tiles][cp][BM], q2 padded to
// tiles * BM) into qs [cp][BM] and q2s [BM]; the walk's first commit
// covers it.
__device__ __forceinline__ void load_query(float* qs, float* q2s,
                                           const float* qT, const float* q2,
                                           int cp, int tid) {
  const float* src = qT + (size_t)blockIdx.x * cp * BM;
  const uint32_t base = smem_addr(qs);
  for (int i = tid; i < cp * BM / 4; i += THREADS)
    cp_async16_cg(base + i * 16, src + i * 4);
  if (tid < BM / 4)
    cp_async16_cg(smem_addr(q2s) + tid * 16,
                  q2 + (size_t)blockIdx.x * BM + tid * 4);
}

// Start the copy of bank step s (rb [n_steps][cp][BN], r2 [n_steps * BN])
// and its key key[s / key_div] into a ring stage.
__device__ __forceinline__ void issue_step(float* stage, const float* rb,
                                           const float* r2, const int* key,
                                           int key_div, int cp, int s,
                                           int tid) {
  const uint32_t base = smem_addr(stage);
  const float* src = rb + (size_t)s * cp * BN;
  for (int i = tid; i < cp * BN / 4; i += THREADS)
    cp_async16_cg(base + i * 16, src + i * 4);
  if (tid < BN / 4)
    cp_async16_cg(base + (cp * BN + tid * 4) * 4, r2 + (size_t)s * BN + tid * 4);
  else if (tid == BN / 4)
    cp_async4(base + (cp * BN + BN) * 4, key + s / key_div);
}

// the thread's fragments of one channel: query rows from qa, bank columns
// from rb (both already offset to the thread's first slot)
__device__ __forceinline__ void load_frag(float a[TM], float b[TN],
                                          const float* qa, const float* rb) {
  const float4 a0 = *reinterpret_cast<const float4*>(qa);
  const float4 a1 = *reinterpret_cast<const float4*>(qa + 16);
  const float4 b0 = *reinterpret_cast<const float4*>(rb);
  const float4 b1 = *reinterpret_cast<const float4*>(rb + 32);
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
  b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
}

// d[i][j] = r2 of column j, then + q . (-2 r) over the channels in order:
// d' = ||r||^2 - 2 q.r (see the header).  cp % 4 == 0; the fragments of
// channel c + 1 load while channel c's 64 FMAs run.
__device__ __forceinline__ void cross(Block d, const float* qs,
                                      const float* st, int cp, int warp,
                                      int tm, int tn) {
  const float* r2s = st + cp * BN;
  const float4 s0 = *reinterpret_cast<const float4*>(r2s + tn * 4);
  const float4 s1 = *reinterpret_cast<const float4*>(r2s + 32 + tn * 4);
  const float rv[TN] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) d[i][j] = rv[j];
  const float* qa = qs + warp * 32 + tm * 4;
  const float* rb = st + tn * 4;
  float a[2][TM], b[2][TN];
  load_frag(a[0], b[0], qa, rb);
  for (int c = 0; c < cp; c += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int nx = c + u + 1;
      if (u < 3 || nx < cp)
        load_frag(a[(u + 1) & 1], b[(u + 1) & 1], qa + nx * BM, rb + nx * BN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          d[i][j] = fmaf(a[u & 1][i], b[u & 1][j], d[i][j]);
    }
  }
}

// run[i] = min(run[i], min over the thread's columns of row i)
__device__ __forceinline__ void row_min(float run[TM], Block d) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) run[i] = fminf(run[i], d[i][j]);
}

// min over the 8 lanes that share a row (the same tm): every lane ends
// with the min
__device__ __forceinline__ float oct_min(float v) {
  v = fminf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  v = fminf(v, __shfl_xor_sync(FULL_MASK, v, 2));
  return fminf(v, __shfl_xor_sync(FULL_MASK, v, 4));
}

// The walk of one CTA over bank steps [s_begin, s_end) (at least one):
// for each step, once its tile has landed, epi(s, key, d) gets the step's
// key and the thread's 8 x 8 block d' (see cross).  Every thread of the
// CTA calls it, so an epilogue may __syncthreads().  The query tile's
// copies (load_query) must have been started.
template <class Epi>
__device__ __forceinline__ void walk(float* ring, const float* qs,
                                     const float* rb, const float* r2,
                                     const int* key, int key_div, int cp,
                                     int s_begin, int s_end, int tid,
                                     Epi&& epi) {
  const int sf = stage_floats(cp);
  const int warp = tid >> 5, tm = (tid & 31) >> 3, tn = tid & 7;
  const int n = s_end - s_begin;
  issue_step(ring, rb, r2, key, key_div, cp, s_begin, tid);
  cp_async_commit();
  for (int s = 0; s < n; ++s) {
    cp_async_wait<0>();  // step s (and the query tile) landed: this thread's
    __syncthreads();     // ... everyone's, and step s-1 is done
    if (s + 1 < n)
      issue_step(ring + ((s + 1) & 1) * sf, rb, r2, key, key_div, cp,
                 s_begin + s + 1, tid);
    cp_async_commit();
    const float* st = ring + (s & 1) * sf;
    const int k = *reinterpret_cast<const int*>(st + cp * BN + BN);
    Block d;
    cross(d, qs, st, cp, warp, tm, tn);
    epi(s_begin + s, k, d);
  }
  cp_async_wait<0>();
}

// Write the CTA's [BM, O] result val(local row, o) for rows m < M,
// coalesced: a plain store when the grid has one bank split, an atomic
// min into +inf otherwise.  The caller has synchronised the CTA.
template <class Val>
__device__ __forceinline__ void write_out(float* out, int M, int O, int tid,
                                          Val&& val) {
  const bool split = gridDim.y > 1;
  const int m0 = blockIdx.x * BM;
  for (int k = tid; k < BM * O; k += THREADS) {
    const int lr = k / O, o = k - lr * O, m = m0 + lr;
    if (m >= M) break;
    const float v = val(lr, o);
    if (split)
      atomic_min_f32(out + (size_t)m * O + o, v);
    else
      out[(size_t)m * O + o] = v;
  }
}

// Allow kernel smem bytes of dynamic shared memory; then, for residency,
// the CTAs of it resident per SM (a negative CUDA error on failure).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <class Kernel>
inline int residency(Kernel kernel, size_t smem) {
  int n = 0;
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                      smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace ffma

// --------------------------------------------- operand preparation
// Mixed mode, one warp per row: a float32 row of C values becomes a bf16
// row of cp values (scaled, zero past C) and its float32 squared norm (of
// the unscaled, unrounded values).  Float32 mode (f32_kernel): 64 rows per
// CTA, turned k-major through shared memory.  One launch per operand
// replaces the several PyTorch passes (norms, rounding, padding, gathers,
// transposes) that would otherwise cost more host time per call than the
// kernel costs the card.
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


// Float32 rows [64 b, 64 b + 64) of an operand into the k-major tiles of
// ffma::, tile rows to a tile (BM for the query, BN for the bank): row n <
// R, from source row perm[n] (n without perm), goes to dst[(n / tile) *
// cp * tile + c * tile + n % tile] = scale * src[c] (0 for C <= c < cp);
// norms[n] = ||src||^2 (+ bias[src] when given), labs[n] = lab[src] and
// out[n] = +inf (each when given); rows R <= n: zero, norm pad_norm.  A
// row's norm is the mixed kernels' (lane-strided sums, then a butterfly):
// it depends only on the row.
constexpr int F32_ROWS = 64;
constexpr int F32_MAX_CP = 128;

__global__ void __launch_bounds__(THREADS)
f32_kernel(const float* __restrict__ src, const long long* __restrict__ perm,
           const float* __restrict__ bias, float scale,
           float* __restrict__ dst, float* __restrict__ norms,
           const float* __restrict__ lab, float* __restrict__ labs,
           float* __restrict__ out, int R, int C, int cp, int tile, int O,
           float pad_norm) {
  __shared__ float t[F32_MAX_CP][F32_ROWS + 1];  // [c][row], padded: no
                                                 // bank conflicts either way
  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = blockIdx.x * F32_ROWS;
  for (int r = tid >> 5; r < F32_ROWS; r += WARPS) {
    const int n = n0 + r;
    if (n >= R) {
      for (int c = lane; c < cp; c += 32) t[c][r] = 0.f;
      if (lane == 0) norms[n] = pad_norm;
      continue;
    }
    const size_t sr = perm ? (size_t)perm[n] : (size_t)n;
    const float* row = src + sr * C;
    float s = 0.f;
    for (int c = lane; c < cp; c += 32) {
      const float v = c < C ? row[c] : 0.f;
      s = fmaf(v, v, s);
      t[c][r] = scale * v;
    }
    s = warp_sum(s);
    if (lane == 0) norms[n] = bias ? s + bias[sr] : s;
    for (int o = lane; o < O; o += 32) {
      if (labs) labs[(size_t)n * O + o] = lab[sr * O + o];
      if (out) out[(size_t)n * O + o] = INFINITY;
    }
  }
  __syncthreads();
  float* base = dst + (size_t)(n0 / tile) * cp * tile + n0 % tile;
  for (int i = tid; i < cp * F32_ROWS; i += THREADS) {
    const int c = i / F32_ROWS, j = i - c * F32_ROWS;
    base[(size_t)c * tile + j] = t[c][j];
  }
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

// Float32 mode: rows R (real) of rows (a multiple of 64) into ffma::'s
// k-major tiles of tile rows (128 query, 64 bank); see prep::f32_kernel.
extern "C" int dist_prep_f32(const float* src, const long long* perm,
                             const float* bias, float scale, float* dst,
                             float* norms, const float* lab, float* labs,
                             float* out, int R, int rows, int C, int cp,
                             int tile, int O, float pad_norm, void* stream) {
  using namespace dist_tile::prep;
  if (rows % F32_ROWS || tile % F32_ROWS || cp % 4 || cp > F32_MAX_CP ||
      cp < C)
    return (int)cudaErrorInvalidValue;
  f32_kernel<<<rows / F32_ROWS, THREADS, 0, (cudaStream_t)stream>>>(
      src, perm, bias, scale, dst, norms, lab, labs, out, R, C, cp, tile, O,
      pad_norm);
  return (int)cudaGetLastError();
}
