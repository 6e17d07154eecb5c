// Masked k-means of the adaptive-object-proxy (AOP) stream.
//
// Replaces no TPU kernel: the JAX package leaves its k-means
// (rvos_tpu/ops/kmeans.py, _masked_kmeans) to XLA's dots, and the port's
// plain version (rvos_tpu_torch/ops/kmeans.py, _masked_kmeans) runs it as
// batched torch.matmul over all O object channels: every Lloyd pass takes
// O x R x K distances and an [O, K, R] @ [R, C] sum, though a bank row
// carries at most one object's label, so O - 1 of every O products are
// multiplied by a zero weight.  On the H100 those are float32 SIMT GEMMs
// with a long reduction and a tiny output (a few 32 x 32 tiles for 132
// SMs), plus argmin, one-hot and where passes over [O, R, K], 21 times.
//
// What bounds it.  The work that counts is one object a row: per pass
// R K C multiply-adds of distance and R C of sums, about 1.2 GFLOP in all
// at the main path's shapes (R = 16,384, C = 100, K = 16, 20 + 1 passes),
// some 18 us on the FMA units; the points (6.6 MB in float32) stay in the
// 50 MB L2.  At that size each pass is a few microseconds of work, so what
// bounds the kernel is the chain of 21 dependent passes: each is a full
// grid whose centroids must be complete before the next pass starts, and
// each CTA's time is a chain of loads, a shared-memory product and an
// ordered sum.
//
// Design.  One host call enqueues everything; nothing synchronises with
// the host and no shape depends on the data, so it captures into a CUDA
// graph.
//   label_kernel   each row's object (the first of its weights that is not
//                  0; none: the row is left out) and weight, a per-block
//                  histogram of objects; and the initial centroids, the
//                  rows top_idx names (the wrapper's stable sort).
//   bucket_kernel  a stable counting sort of the rows by object: every
//                  block scans the histograms for its bases, then ranks its
//                  rows in row order (warp match, then a scan over warps),
//                  and writes perm (row of each sorted position), the
//                  weights in that order, and the objects' first positions.
//   then per pass:
//   assign_kernel  one CTA per tile of TILE sorted rows that never crosses
//                  an object's boundary (at most ceil(R / TILE) + O tiles;
//                  a CTA past the last tile exits).  It stages its object's
//                  K x C centroids and the tile's points in shared memory
//                  (all loads of a thread in flight at once, four values a
//                  load where the rows allow), and a thread takes one row
//                  against K / 4 centroids, so a warp's 32 rows read each
//                  centroid value at one address.  It computes
//                  d = (p2 + c2) - 2 dot in float32 (the plain version's
//                  order; dot over bf16-rounded operands in mixed mode, the
//                  norms from the float32 values), takes the argmin over K
//                  (invalid centroids at +inf; the lowest index wins a tie,
//                  as torch.argmin), and writes the tile's partial sums
//                  sum w p [K, C] and counts sum w [K], each in row order.
//   reduce_kernel  one CTA per (object, centroid): the object's partials
//                  in tile order (contiguous runs of tiles per thread
//                  group, the groups added in order), then
//                  sums / max(counts, 1) where counts > 0, else the old
//                  centroid.  The last pass writes the means and
//                  mean_valid = (counts > 0) & init_valid instead.
// No floating-point atomics: every sum is taken in a fixed order, so two
// runs, and an eager run and a graph replay, give the same bits.  The
// numbers differ from the plain version only by the order of float32 sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 128;
constexpr int MAX_K = 32;
constexpr int MAX_O = 32;
constexpr int LABEL_THREADS = 1024;  // rows per block of the two sort kernels
constexpr int TILE = 64;             // sorted rows per assign CTA
constexpr int THREADS = 256;         // assign CTA
constexpr int KGROUPS = THREADS / TILE;  // centroid groups of a tile row
constexpr int RED_THREADS = 1024;
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ float load_val(const void* p, int bf16,
                                          long long i) {
  if (bf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int tiles_of(int n) {
  return (n + TILE - 1) / TILE;
}

// Row stride (floats) of the shared point and centroid tiles: C rounded up
// to 4 (float4 loads), then to an odd multiple of 4, so that the rows four
// threads read at once fall in distinct banks.
__host__ __device__ inline int tile_stride(int C) {
  const int cv = (C + 3) / 4 * 4;
  return (cv / 4) % 2 ? cv : cv + 4;
}

__global__ void label_kernel(const void* pts, int pts_bf16, long long sp_r,
                             long long sp_c, const void* w, int w_bf16,
                             long long sw_o, long long sw_r,
                             const long long* top_idx, long long st_o, int R,
                             int C, int O, int K, int* obj, float* wr,
                             int* blk_cnt, float* cent) {
  __shared__ int cnt[MAX_O];
  if (threadIdx.x < MAX_O) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R) {
    int o_r = -1;
    float w_r = 0.f;
    for (int o = 0; o < O; ++o) {
      const float v = load_val(w, w_bf16, o * sw_o + r * sw_r);
      if (v != 0.f) {
        o_r = o;
        w_r = v;
        break;
      }
    }
    obj[r] = o_r;
    wr[r] = w_r;
    if (o_r >= 0) atomicAdd(&cnt[o_r], 1);
  }
  __syncthreads();
  if (threadIdx.x < O) blk_cnt[blockIdx.x * O + threadIdx.x] = cnt[threadIdx.x];
  // the initial centroids: cent[o, k] = points[top_idx[o, k]]
  const int n = O * K * C;
  for (int i = r; i < n; i += gridDim.x * blockDim.x) {
    const int c = i % C, ok = i / C, k = ok % K, o = ok / K;
    cent[i] = load_val(pts, pts_bf16, top_idx[o * st_o + k] * sp_r + c * sp_c);
  }
}

__global__ void bucket_kernel(const int* obj, const float* wr,
                              const int* blk_cnt, int n_blk, int R, int O,
                              int* perm, float* wsort, int* obj_off) {
  constexpr int WARPS = LABEL_THREADS / 32;
  __shared__ int base[MAX_O];
  __shared__ int total[MAX_O];
  __shared__ int wcnt[WARPS][MAX_O];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < WARPS * MAX_O; i += blockDim.x)
    wcnt[i / MAX_O][i % MAX_O] = 0;
  if (tid < O) {
    int before = 0, all = 0;
    for (int b = 0; b < n_blk; ++b) {
      const int v = blk_cnt[b * O + tid];
      all += v;
      if (b < blockIdx.x) before += v;
    }
    base[tid] = before;
    total[tid] = all;
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int o = 0; o < O; ++o) {
      base[o] += acc;
      if (blockIdx.x == 0) obj_off[o] = acc;
      acc += total[o];
    }
    if (blockIdx.x == 0) obj_off[O] = acc;
  }
  const int r = blockIdx.x * blockDim.x + tid;
  const int o_r = r < R ? obj[r] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, o_r);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  __syncthreads();
  if (o_r >= 0 && rank == 0) wcnt[warp][o_r] = __popc(peers);
  __syncthreads();
  if (tid < O) {
    int acc = 0;
    for (int v = 0; v < WARPS; ++v) {
      const int t = wcnt[v][tid];
      wcnt[v][tid] = acc;
      acc += t;
    }
  }
  __syncthreads();
  if (o_r >= 0) {
    const int dst = base[o_r] + wcnt[warp][o_r] + rank;
    perm[dst] = r;
    wsort[dst] = wr[r];
  }
}

// The objects' first sorted rows, read into shared memory at once (a
// loop over objects in device memory would wait on each in turn).
__device__ __forceinline__ void load_offsets(const int* obj_off, int O,
                                             int* off) {
  if (threadIdx.x <= O) off[threadIdx.x] = obj_off[threadIdx.x];
  __syncthreads();
}

// The object and sorted rows [begin, end) of tile t (o = -1 past the last
// tile), from the offsets in shared memory.
__device__ __forceinline__ void tile_at(const int* off, int O, int t, int& o,
                                        int& begin, int& end) {
  int acc = 0;
  o = -1;
  for (int q = 0; q < O; ++q) {
    const int nt = tiles_of(off[q + 1] - off[q]);
    if (t < acc + nt) {
      o = q;
      begin = off[q] + (t - acc) * TILE;
      end = min(begin + TILE, off[q + 1]);
      return;
    }
    acc += nt;
  }
}

// Shared memory of assign_kernel, in floats.
__host__ __device__ inline int assign_smem_floats(int C, int K, int kpt,
                                                  int mixed) {
  const int cs = tile_stride(C), ca = C + 1;
  const int groups = THREADS / ca;
  return (mixed ? 2 : 1) * (KGROUPS * kpt + TILE) * cs + 2 * KGROUPS * kpt +
         4 * TILE + 2 * KGROUPS * TILE + groups * K * ca;
}

template <int KPT, bool MIXED>
__global__ void __launch_bounds__(THREADS)
    assign_kernel(const void* pts, int pts_bf16, int vec, long long sp_r,
                  long long sp_c, const int* perm, const float* wsort,
                  const int* obj_off, const float* cent,
                  const uint8_t* valid, int O, int K, int C, float* part) {
  constexpr int KP = KGROUPS * KPT;  // centroid rows held, K padded
  constexpr int WARPS = THREADS / 32;
  constexpr int BATCH = 8;           // independent loads in flight a thread
  __shared__ int off[MAX_O + 1];
  load_offsets(obj_off, O, off);
  int o, begin, end;
  tile_at(off, O, blockIdx.x, o, begin, end);
  if (o < 0) return;
  const int n = end - begin;
  const int cs = tile_stride(C), cv = (C + 3) / 4 * 4, ca = C + 1;
  const int groups = THREADS / ca;
  extern __shared__ float4 smem4[];
  float* cd = reinterpret_cast<float*>(smem4);   // [KP][cs] dot operand
  float* c32 = MIXED ? cd + KP * cs : cd;        // [KP][cs] float32
  float* pd = c32 + KP * cs;                     // [TILE][cs] dot operand
  float* p32 = MIXED ? pd + TILE * cs : pd;      // [TILE][cs] float32
  float* c2 = p32 + TILE * cs;                   // [KP]
  float* cval = c2 + KP;                         // [KP] 1: valid
  float* p2 = cval + KP;                         // [TILE]
  float* wt = p2 + TILE;                         // [TILE]
  int* rid = reinterpret_cast<int*>(wt + TILE);  // [TILE] source rows
  int* lab = rid + TILE;                         // [TILE]
  float* gbest = reinterpret_cast<float*>(lab + TILE);  // [KGROUPS][TILE]
  int* gk = reinterpret_cast<int*>(gbest + KGROUPS * TILE);
  float* acc = reinterpret_cast<float*>(gk + KGROUPS * TILE);  // [groups][K][ca]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // 1. the object's centroids (float32, zero-padded to KP x cv), the
  // tile's source rows and weights, zeroed partial sums
  const float* co = cent + (size_t)o * K * C;
  for (int i0 = tid; i0 < KP * cv; i0 += BATCH * THREADS) {
    float v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * THREADS, k = i / cv, c = i % cv;
      v[b] = (i < KP * cv && k < K && c < C) ? co[k * C + c] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * THREADS;
      if (i < KP * cv) {
        c32[i / cv * cs + i % cv] = v[b];
        if (MIXED) cd[i / cv * cs + i % cv] = round_bf16(v[b]);
      }
    }
  }
  if (tid < TILE) {
    rid[tid] = tid < n ? perm[begin + tid] : 0;
    wt[tid] = tid < n ? wsort[begin + tid] : 0.f;
  }
  for (int i = tid; i < groups * K * ca; i += THREADS) acc[i] = 0.f;
  __syncthreads();
  // 2. the tile's points (zero past the tile's end and past C): four
  // values a load where the rows allow it (vec), else one
  if (vec) {
    const int c4n = C / 4;
    for (int e0 = tid; e0 < TILE * c4n; e0 += BATCH * THREADS) {
      float4 v[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int e = e0 + b * THREADS, i = e / c4n, c = e % c4n * 4;
        v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < TILE * c4n && i < n) {
          const long long at = rid[i] * sp_r + c;
          if (pts_bf16) {
            const uint2 u = *reinterpret_cast<const uint2*>(
                static_cast<const __nv_bfloat16*>(pts) + at);
            v[b] = make_float4(__uint_as_float(u.x << 16),
                               __uint_as_float(u.x & 0xffff0000u),
                               __uint_as_float(u.y << 16),
                               __uint_as_float(u.y & 0xffff0000u));
          } else {
            v[b] = *reinterpret_cast<const float4*>(
                static_cast<const float*>(pts) + at);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int e = e0 + b * THREADS;
        if (e < TILE * c4n) {
          const int at = e / c4n * cs + e % c4n * 4;
          *reinterpret_cast<float4*>(p32 + at) = v[b];
          if (MIXED)
            *reinterpret_cast<float4*>(pd + at) =
                make_float4(round_bf16(v[b].x), round_bf16(v[b].y),
                            round_bf16(v[b].z), round_bf16(v[b].w));
        }
      }
    }
  } else {
    for (int e0 = tid; e0 < TILE * cv; e0 += BATCH * THREADS) {
      float v[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int e = e0 + b * THREADS, i = e / cv, c = e % cv;
        v[b] = (e < TILE * cv && i < n && c < C)
                   ? load_val(pts, pts_bf16, rid[i] * sp_r + c * sp_c)
                   : 0.f;
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int e = e0 + b * THREADS;
        if (e < TILE * cv) {
          p32[e / cv * cs + e % cv] = v[b];
          if (MIXED) pd[e / cv * cs + e % cv] = round_bf16(v[b]);
        }
      }
    }
  }
  // the centroids' norms from the float32 values, one warp per centroid
  for (int k = warp; k < KP; k += WARPS) {
    float sq = 0.f;
    for (int c = lane; c < cv; c += 32)
      sq = fmaf(c32[k * cs + c], c32[k * cs + c], sq);
    for (int m = 16; m; m /= 2) sq += __shfl_xor_sync(0xffffffffu, sq, m);
    if (lane == 0) {
      c2[k] = sq;
      cval[k] = (k < K && valid[o * K + k]) ? 1.f : 0.f;
    }
  }
  __syncthreads();

  // 3. distances: thread (row i, centroid group kg) takes centroids
  // kg KPT ... kg KPT + KPT - 1; a warp's 32 rows read each centroid value
  // at one address (a broadcast), each its own row.  Group 0 also takes
  // the row's norm from the float32 values.
  {
    const int i = tid % TILE, kg = tid / TILE, k0 = kg * KPT;
    float dot[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) dot[j] = 0.f;
    float sq = 0.f;
    const float4* prow = reinterpret_cast<const float4*>(pd + i * cs);
    const float4* p32row = reinterpret_cast<const float4*>(p32 + i * cs);
    const float4* crow = reinterpret_cast<const float4*>(cd + k0 * cs);
    const int cs4 = cs / 4;
    for (int c4 = 0; c4 < cv / 4; ++c4) {
      const float4 p = prow[c4];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 q = crow[j * cs4 + c4];
        dot[j] = fmaf(p.x, q.x, dot[j]);
        dot[j] = fmaf(p.y, q.y, dot[j]);
        dot[j] = fmaf(p.z, q.z, dot[j]);
        dot[j] = fmaf(p.w, q.w, dot[j]);
      }
      if (kg == 0) {
        const float4 v = MIXED ? p32row[c4] : p;
        sq = fmaf(v.x, v.x, sq);
        sq = fmaf(v.y, v.y, sq);
        sq = fmaf(v.z, v.z, sq);
        sq = fmaf(v.w, v.w, sq);
      }
    }
    if (kg == 0) p2[i] = sq;
    __syncthreads();
    const float pn = p2[i];
    float best = __int_as_float(0x7f800000);
    int bk = k0;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int k = k0 + j;
      if (k < K && cval[k] != 0.f) {
        const float d = (pn + c2[k]) - 2.f * dot[j];
        if (d < best) {
          best = d;
          bk = k;
        }
      }
    }
    gbest[kg * TILE + i] = best;
    gk[kg * TILE + i] = bk;
  }
  __syncthreads();
  // the groups in order of k: a later group takes the row only if it is
  // strictly nearer, so a tie goes to the lowest index (torch.argmin)
  if (tid < TILE) {
    float best = gbest[tid];
    int bk = gk[tid];
    for (int g = 1; g < KGROUPS; ++g) {
      if (gbest[g * TILE + tid] < best) {
        best = gbest[g * TILE + tid];
        bk = gk[g * TILE + tid];
      }
    }
    lab[tid] = tid < n ? bk : -1;
  }
  __syncthreads();

  // 4. partial sums: `groups` groups of C + 1 threads, each over a
  // contiguous run of the tile's rows in order; column C sums the weights
  // (the counts)
  {
    const int g = tid / ca, col = tid % ca;
    if (g < groups) {
      const int rows = (TILE + groups - 1) / groups;
      const int lo = g * rows, hi = min(lo + rows, n);
      float* ag = acc + g * K * ca;
      for (int i = lo; i < hi; ++i) {
        const float v = col < C ? p32[i * cs + col] : 1.f;
        float* a = ag + lab[i] * ca + col;
        *a = fmaf(wt[i], v, *a);
      }
    }
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * K * ca;
  for (int e = tid; e < K * ca; e += THREADS) {
    float s = acc[e];
    for (int g = 1; g < groups; ++g) s += acc[g * K * ca + e];
    out[e] = s;
  }
}

// One CTA per (centroid k, object o): the object's tile partials in tile
// order, then the update.  dst may be cent itself (each CTA reads and
// writes only its own centroid).  mean_valid set: the last pass.
__global__ void __launch_bounds__(RED_THREADS)
    reduce_kernel(const float* part, const int* obj_off, int O, int K, int C,
                  const float* cent, float* dst, const uint8_t* valid,
                  uint8_t* mean_valid) {
  __shared__ int off[MAX_O + 1];
  __shared__ float red[RED_THREADS];
  __shared__ float tot[MAX_C + 1];
  load_offsets(obj_off, O, off);
  const int k = blockIdx.x, o = blockIdx.y, tid = threadIdx.x;
  const int ca = C + 1, groups = RED_THREADS / ca;
  int t0 = 0;
  for (int q = 0; q < o; ++q) t0 += tiles_of(off[q + 1] - off[q]);
  const int nt = tiles_of(off[o + 1] - off[o]);
  const int g = tid / ca, col = tid % ca;
  if (g < groups) {
    const int a = t0 + nt * g / groups, b = t0 + nt * (g + 1) / groups;
    const float* p = part + (size_t)k * ca + col;
    const size_t step = (size_t)K * ca;
    float s = 0.f;
#pragma unroll 4
    for (int t = a; t < b; ++t) s += p[t * step];
    red[g * ca + col] = s;
  }
  __syncthreads();
  if (tid < ca) {
    float s = red[tid];
    for (int v = 1; v < groups; ++v) s += red[v * ca + tid];
    tot[tid] = s;
  }
  __syncthreads();
  const float cnt = tot[C];
  const size_t at = ((size_t)o * K + k) * C;
  if (tid < C) {
    const float old = cent[at + tid];
    dst[at + tid] = cnt > 0.f ? tot[tid] / fmaxf(cnt, 1.f) : old;
  }
  if (mean_valid != nullptr && tid == 0)
    mean_valid[o * K + k] = (cnt > 0.f) && valid[o * K + k];
}

struct Scratch {
  int* obj;
  float* wr;
  int* perm;
  float* wsort;
  int* blk_cnt;
  int* obj_off;
  float* part;
};

long long carve(int R, int C, int O, int K, char* base, Scratch* s) {
  const long long n_blk = (R + LABEL_THREADS - 1) / LABEL_THREADS;
  const long long tiles = (R + TILE - 1) / TILE + O;
  const long long words[] = {R, R, R, R, n_blk * O, O + 1,
                             tiles * K * (C + 1)};
  long long off = 0;
  void* at[7];
  for (int i = 0; i < 7; ++i) {
    at[i] = base ? base + off : nullptr;
    off += (words[i] * 4 + 15) / 16 * 16;
  }
  if (s) {
    s->obj = static_cast<int*>(at[0]);
    s->wr = static_cast<float*>(at[1]);
    s->perm = static_cast<int*>(at[2]);
    s->wsort = static_cast<float*>(at[3]);
    s->blk_cnt = static_cast<int*>(at[4]);
    s->obj_off = static_cast<int*>(at[5]);
    s->part = static_cast<float*>(at[6]);
  }
  return off;
}

// The Lloyd passes: `iters` into cent, one more into means and mean_valid.
template <int KPT, bool MIXED>
int lloyd(const void* pts, int pts_bf16, int vec, long long sp_r,
          long long sp_c, const uint8_t* init_valid, int R, int C, int O,
          int K, int iters, const Scratch& s, float* cent, float* means,
          uint8_t* mean_valid, cudaStream_t st) {
  const size_t smem = (size_t)assign_smem_floats(C, K, KPT, MIXED) * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      assign_kernel<KPT, MIXED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (R + TILE - 1) / TILE + O;
  for (int p = 0; p <= iters; ++p) {
    assign_kernel<KPT, MIXED><<<tiles, THREADS, smem, st>>>(
        pts, pts_bf16, vec, sp_r, sp_c, s.perm, s.wsort, s.obj_off, cent,
        init_valid, O, K, C, s.part);
    const bool last = p == iters;
    reduce_kernel<<<dim3(K, O), RED_THREADS, 0, st>>>(
        s.part, s.obj_off, O, K, C, cent, last ? means : cent, init_valid,
        last ? mean_valid : nullptr);
  }
  return 0;
}

template <int KPT>
int lloyd_mode(int mixed, const void* pts, int pts_bf16, int vec,
               long long sp_r, long long sp_c, const uint8_t* init_valid,
               int R, int C, int O, int K, int iters, const Scratch& s,
               float* cent, float* means, uint8_t* mean_valid,
               cudaStream_t st) {
  return mixed ? lloyd<KPT, true>(pts, pts_bf16, vec, sp_r, sp_c, init_valid,
                                  R, C, O, K, iters, s, cent, means,
                                  mean_valid, st)
               : lloyd<KPT, false>(pts, pts_bf16, vec, sp_r, sp_c,
                                   init_valid, R, C, O, K, iters, s, cent,
                                   means, mean_valid, st);
}

}  // namespace

// Bytes of scratch that kmeans_launch needs.
extern "C" long long kmeans_scratch_bytes(int R, int C, int O, int K) {
  return carve(R, C, O, K, nullptr, nullptr);
}

// Masked k-means of points [R, C] (float32 or bf16, strides sp_*) under
// weights [O, R] (float32 or bf16, strides sw_*; at most one object a row)
// from the initial centroids top_idx [O, K] (int64, row stride st_o) with
// init_valid [O, K] (bool): `iters` Lloyd passes into cent [O, K, C]
// (float32), then one more into means [O, K, C] and mean_valid [O, K].
// Returns a CUDA error code (cudaErrorInvalidValue for shapes beyond the
// kernel's limits).
extern "C" int kmeans_launch(const void* pts, int pts_bf16, long long sp_r,
                             long long sp_c, const void* w, int w_bf16,
                             long long sw_o, long long sw_r,
                             const long long* top_idx, long long st_o,
                             const uint8_t* init_valid, int R, int C, int O,
                             int K, int iters, int mixed, void* scratch,
                             float* cent, float* means, uint8_t* mean_valid,
                             void* stream) {
  if (R < K || C < 1 || C > MAX_C || O < 1 || O > MAX_O || K < 1 ||
      K > MAX_K || iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Scratch s;
  carve(R, C, O, K, static_cast<char*>(scratch), &s);
  const int n_blk = (R + LABEL_THREADS - 1) / LABEL_THREADS;
  label_kernel<<<n_blk, LABEL_THREADS, 0, st>>>(
      pts, pts_bf16, sp_r, sp_c, w, w_bf16, sw_o, sw_r, top_idx, st_o, R, C,
      O, K, s.obj, s.wr, s.blk_cnt, cent);
  bucket_kernel<<<n_blk, LABEL_THREADS, 0, st>>>(s.obj, s.wr, s.blk_cnt,
                                                  n_blk, R, O, s.perm,
                                                  s.wsort, s.obj_off);
  // rows of four values each 16 (float32) or 8 (bf16) bytes aligned
  const int align = pts_bf16 ? 8 : 16;
  const int vec = sp_c == 1 && C % 4 == 0 && sp_r % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(pts) % align == 0;
  const int per = (K + KGROUPS - 1) / KGROUPS;  // centroids a thread
  const auto run = per <= 1   ? &lloyd_mode<1>
                   : per <= 2 ? &lloyd_mode<2>
                   : per <= 4 ? &lloyd_mode<4>
                              : &lloyd_mode<8>;
  const int err = run(mixed, pts, pts_bf16, vec, sp_r, sp_c, init_valid, R,
                      C, O, K, iters, s, cent, means, mean_valid, st);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
