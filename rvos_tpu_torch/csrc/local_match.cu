// Windowed multi-radius local matching (kernel 2).
//
// Replaces rvos_tpu/ops/pallas_local.py::_kernel (def at :39, pallas_call
// at :130; wrapper local_matching_pallas).  For a query x [h, w, C], S
// previous-frame embeddings ys [S, h, w, C] sharing one label map, and
// every in-frame offset (dy, dx) of the K x K window (K = 2 a_max + 1,
// step `atrous`, reach pad = a_max * atrous pixels):
//
//   d = ||x||^2 + ||y'||^2 - 2 x . y'
//
// where ' is the shifted previous frame.  out[s, ch, o, i, j] is
// min(1e5, B_o, A + 5e4) over the offsets with max(|dy|, |dx|) <= order[ch]
// (window steps): A the min of d over all of them, B_o over those whose
// previous pixel is labelled o.  That is the Pallas kernel's min of the
// penalised d + (1 - onehot'_o) 5e4 from a start of 1e5 (out-of-frame
// offsets read x2 + 1e5 there and never win): fl(a + 5e4) is monotonic in
// a, so A + 5e4 equals the min of the rounded penalised sums exactly.
//
// What bounds it on the H100.  The function moves ~4 MB (bf16 operands,
// the float32 result) and does 2 S K^2 h w C ~ 1.3 GFLOP of cross term at
// the main path's shapes (61 x 107 grid, C = 100, K = 25, S = 2) plus one
// float32 min per (offset, pixel): a few microseconds at the card's peaks.
// What costs time in practice is re-reading each previous-frame pixel for
// each of the K^2 query pixels whose window holds it, and taking each of
// the ~6.5 M mins one offset at a time.
//
// Design.  A CTA holds two query rows x 64 pixels (one warp per 16 pixels
// of a row; one row where the shared memory asks it) and walks the
// previous-frame rows that their windows reach, in order; each staged row
// (the 64 + 2 pad columns around the tile) serves every query row of the
// CTA whose window holds it, so rows + 2 a_max rows are read instead of
// rows x K.  `groups` CTAs may share a tile, each over a contiguous part of
// the window rows, for more warps per SM; they meet in an exact,
// order-preserving float atomic min of the output (min(1e5, B, A + 5e4)
// distributes over the parts), else each output is written once.  For one
// window row, the 16 pixels of a warp need the products of their x with
// the 16 + 2 pad staged columns around them: a band of the [16 x C] .
// [C x 48] product, whose entry (m, n) is offset dx = n - m - pad.
//
// mixed (bf16 operands): the band product on the tensor cores, per warp
// mma.sync.m16n8k16 over the <= 6 n8 tiles that the band touches (not the
// 64 x 112 rectangle), A fragments of the warp's 16 pixels in registers
// for the whole walk, B fragments by ldmatrix from the staged row, which
// streams through a two-stage cp.async ring.  The operand preparation
// passes the previous frames as -2 y (exact in bf16) and the accumulators
// start at ||y'||^2, so the MMA leaves ||y'||^2 - 2 x . y'; bf16 products
// are exact in float32, so this is the plain function up to summation
// order.
// float32 (parity): the same tiling, staging (one synchronous stage) and
// epilogue; the cross term is SIMT float32 FMA (never TF32), each lane a
// 4-pixel x 4-offset register tile read from the transposed query tile and
// staged row (three 16-byte shared loads per 16 FMAs at atrous 1).
// Epilogue (both): the band's distances go to a per-warp buffer by window
// offset; then two lanes per query pixel (one in each half-warp) walk
// half of its K offsets each.  Each offset belongs to one Chebyshev band,
// the smallest radius of the ascending list that holds max(|dy|, |dx|),
// and so to slot [pixel][band][label + 1] in shared memory (slot 0:
// unlabelled previous pixels).  A run of offsets with the same slot is
// reduced in a register first; the lane then merges the run's min into
// the slot by an exact, order-preserving shared-memory reduction
// (`red.shared.min`, float bits as integers).  The two lanes of a pixel
// may meet in one slot, as the CTAs of a split tile meet in the output
// (above); a min does not depend on the order of its operands, so the
// result is deterministic.  At the end the slots are prefix-minned across bands
// (the nested windows), A is the min over a band's slots, and each output
// channel is written once, coalesced along the row.
//
// Operand preparation (local_prep_launch, one launch): the query and the S
// previous frames, read through their strides, become rows of the compute
// type (bf16 zero-padded to a multiple of 16 channels, or float32), with
// their float32 squared norms and the previous frame's label ids (the first
// largest one-hot entry if above 0.5, else -1).  A call is two launches.
#include "dist_tile.cuh"

namespace {

using dist_tile::smem_addr;

constexpr float PEN = 5e4f;
constexpr float EMPTY_DIST = 1e5f;
constexpr int TW = 64;             // query pixels of a row per CTA
constexpr int WPR = TW / 16;       // warps per query row
constexpr int MAX_PAD = 15;        // window reach in pixels
constexpr int NT = 6;              // n8 tiles of a warp's band: 16 + 2 * 15
constexpr int SCOLS = TW + 8 * NT; // staged columns (112)
constexpr int MAX_KS = 8;          // 16-deep slices: C <= 128
constexpr int MAX_ASC = 8;         // distinct radii
constexpr int MAX_R = 8;           // output channels
constexpr int MAX_ROWS = 2;        // query rows per CTA (1 where the
                                   // shared memory asks it)

struct Window {
  int pad, atrous, a_max, n_asc, n_r;
  int band[MAX_PAD + 1];  // Chebyshev distance (window steps) -> band
  int ch_band[MAX_R];     // output channel -> band
  int groups;             // CTAs that share a query tile's window rows
};

// ------------------------------------------------------ operand preparation
constexpr int PREP_WARPS = 8;

template <class T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<uint16_t>(uint16_t v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// Row r < hw is query pixel r, row hw + s hw + p previous pixel p of
// frame s.  dst[r] = the row in the compute type (bf16 x or -2 y, zero
// past C; or float32), norms[r] = its float32 squared norm; lab[p] for the
// query rows; out [n_out] to +inf when given.
template <class T>
__global__ void __launch_bounds__(PREP_WARPS * 32)
prep_kernel(const T* __restrict__ x, const T* __restrict__ ys,
            const void* __restrict__ onehot, int lab_bf16, long long sx0,
            long long sx1, long long sx2, long long ss0, long long ss1,
            long long ss2, long long ss3, long long so0, long long so1,
            long long so2, T* __restrict__ dst, float* __restrict__ norms,
            int* __restrict__ lab, float* __restrict__ out, long long n_out,
            int S, int h, int w, int C, int cp, int O) {
  const int lane = threadIdx.x & 31;
  const int hw = h * w;
  // the output to +inf, when several CTA groups min into it
  if (out)
    for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         k < n_out; k += (long long)gridDim.x * blockDim.x)
      out[k] = INFINITY;
  const int r = blockIdx.x * PREP_WARPS + (threadIdx.x >> 5);
  if (r >= (1 + S) * hw) return;
  const bool query = r < hw;
  const int s = query ? 0 : (r - hw) / hw;
  const int p = query ? r : r - hw - s * hw;
  const int i = p / w, j = p - i * w;
  const T* src =
      query ? x + i * sx0 + j * sx1 : ys + s * ss0 + i * ss1 + j * ss2;
  const long long sc = query ? sx2 : ss3;
  const float scale = (sizeof(T) == 2 && !query) ? -2.f : 1.f;
  T* row = dst + (size_t)r * cp;
  float acc = 0.f;
  for (int c = lane; c < cp; c += 32) {
    const float v = c < C ? to_f32(src[c * sc]) : 0.f;
    acc = fmaf(v, v, acc);
    if constexpr (sizeof(T) == 2)
      row[c] = __bfloat16_as_ushort(__float2bfloat16_rn(scale * v));
    else
      row[c] = v;
  }
  acc = dist_tile::prep::warp_sum(acc);
  if (lane == 0) norms[r] = acc;
  if (!query) return;
  // label id: the first largest entry if it is above 0.5, else -1
  const long long k_oh = i * so0 + j * so1 + lane * so2;
  float v = -INFINITY;
  if (lane < O)
    v = lab_bf16 ? to_f32(static_cast<const uint16_t*>(onehot)[k_oh])
                 : static_cast<const float*>(onehot)[k_oh];
  int idx = lane;
#pragma unroll
  for (int k = 16; k; k >>= 1) {
    const float v2 = __shfl_xor_sync(dist_tile::FULL_MASK, v, k);
    const int i2 = __shfl_xor_sync(dist_tile::FULL_MASK, idx, k);
    if (v2 > v || (v2 == v && i2 < idx)) {
      v = v2;
      idx = i2;
    }
  }
  if (lane == 0) lab[p] = v > 0.5f ? idx : -1;
}

// ------------------------------------------------------------ shared state
constexpr int DS = 33;  // a pixel's row of window offsets in the warp's
                        // distance buffer (K <= 31; odd: no bank conflicts)

// The CTA's running mins, slot [pixel][band][label + 1] (+inf at start;
// slot 0: unlabelled previous pixels), pixels ps floats apart (odd), then
// A [pixel][band]; and each warp's distance buffer [16][DS] of one
// window row.
struct Mins {
  float* slot;
  float* amin;
  float* dist;
  int* band;     // Chebyshev distance (window steps) -> band
  int* ch_band;  // output channel -> band
  int n_asc, nl, ps;
};

__host__ __device__ constexpr int slot_stride(int n_asc, int O) {
  return (n_asc * (O + 1)) | 1;
}

__host__ __device__ constexpr size_t mins_bytes(int rows, int n_asc, int O) {
  return 128 + ((size_t)rows * TW * (slot_stride(n_asc, O) + n_asc) * 4 + 15)
         / 16 * 16 + (size_t)rows * WPR * 16 * DS * 4;
}

__device__ __forceinline__ Mins init_mins(char* base, const Window& win,
                                          int rows, int O, int tid,
                                          int nthreads) {
  Mins mi;
  mi.n_asc = win.n_asc;
  mi.nl = O + 1;
  mi.ps = slot_stride(win.n_asc, O);
  mi.band = reinterpret_cast<int*>(base);
  mi.ch_band = mi.band + MAX_PAD + 1;
  mi.slot = reinterpret_cast<float*>(base + 128);
  mi.amin = mi.slot + rows * TW * mi.ps;
  mi.dist = reinterpret_cast<float*>(
      base + 128 + ((size_t)rows * TW * (mi.ps + mi.n_asc) * 4 + 15) / 16 * 16);
  // static indices: the parameters stay in the constant bank
#pragma unroll
  for (int k = 0; k <= MAX_PAD; ++k)
    if (tid == k) mi.band[k] = win.band[k];
#pragma unroll
  for (int k = 0; k < MAX_R; ++k)
    if (tid == k) mi.ch_band[k] = win.ch_band[k];
  for (int k = tid; k < rows * TW * mi.ps; k += nthreads)
    mi.slot[k] = INFINITY;
  return mi;
}

// slot <- min(slot, v) in shared memory: dist_tile's exact, order-
// preserving float atomic min (non-negative floats order as signed ints,
// negative ones in reverse as unsigned ints) as a shared-memory reduction
__device__ __forceinline__ void red_min(float* slot, float v) {
  const uint32_t a = smem_addr(slot);
  if (__float_as_int(v) >= 0)
    asm volatile("red.shared.min.s32 [%0], %1;\n" ::"r"(a),
                 "r"(__float_as_int(v)) : "memory");
  else
    asm volatile("red.shared.max.u32 [%0], %1;\n" ::"r"(a),
                 "r"(__float_as_uint(v)) : "memory");
}

// The ring mins of the warp's 16 query pixels for one window row: lane
// (p, half) = (lane % 16, lane / 16) walks half of pixel p's window
// offsets, e in [0, a_max] or (a_max, k_n).  dr[e] (the warp's buffer row
// of pixel p) is the distance at offset e less `base` (+inf out of frame),
// labs[n0 + e atrous] the previous pixel's label.  Each offset belongs to
// slot [band of max(dys, |e - a_max|)][label + 1]; a run of offsets with
// the same slot is reduced in a register, then base + run goes into the
// slot by red_min (fl(base + d) is monotonic in d, so this is the min of
// the distances exactly).
__device__ __forceinline__ void ring_mins(const Mins& mi, int m, float base,
                                          const float* dr, const int* labs,
                                          int n0, int atrous, int k_n,
                                          int a_max, int dys, int half) {
  float* slot = mi.slot + m * mi.ps;
  const int e0 = half ? a_max + 1 : 0, e1 = half ? k_n : a_max + 1;
  float run = INFINITY;
  int key = -1;
#pragma unroll 4
  for (int e = e0; e < e1; ++e) {
    const float d = dr[e];
    const int k =
        mi.band[max(dys, abs(e - a_max))] * mi.nl + labs[n0 + e * atrous] + 1;
    if (k != key) {
      if (key >= 0) red_min(slot + key, base + run);
      key = k;
      run = d;
    } else {
      run = fminf(run, d);
    }
  }
  if (key >= 0) red_min(slot + key, base + run);
}

// Prefix mins across bands, A per band, and the output: out[s][ch][o][i][j]
// = min(1e5, B_o, A + 5e4) at the channel's band, for the CTA's pixels.
__device__ __forceinline__ void write_out(const Mins& mi, const Window& win,
                                          float* __restrict__ out, int s,
                                          int i0, int j0, int rows, int h,
                                          int w, int O, int tid,
                                          int nthreads) {
  const int npix = rows * TW, n_asc = mi.n_asc, nl = mi.nl, ps = mi.ps;
  __syncthreads();
  for (int k = tid; k < npix * nl; k += nthreads) {
    const int m = k / nl, l = k - m * nl;
    float run = INFINITY;
    for (int b = 0; b < n_asc; ++b) {
      float* p = mi.slot + m * ps + b * nl + l;
      run = fminf(run, *p);
      *p = run;
    }
  }
  __syncthreads();
  for (int k = tid; k < npix * n_asc; k += nthreads) {
    const int m = k / n_asc, b = k - m * n_asc;
    const float* p = mi.slot + m * ps + b * nl;
    float a = INFINITY;
    for (int l = 0; l < nl; ++l) a = fminf(a, p[l]);
    mi.amin[k] = a;
  }
  __syncthreads();
  const int total = win.n_r * O * npix;
  for (int k = tid; k < total; k += nthreads) {
    const int jj = k % TW;
    int rest = k / TW;
    const int r = rest % rows;
    rest /= rows;
    const int o = rest % O, ch = rest / O;
    const int i = i0 + r, j = j0 + jj;
    if (i >= h || j >= w) continue;
    const int m = r * TW + jj, b = mi.ch_band[ch];
    const float v = fminf(EMPTY_DIST, fminf(mi.slot[m * ps + b * nl + o + 1],
                                            mi.amin[m * n_asc + b] + PEN));
    float* dst = out + ((((size_t)s * win.n_r + ch) * O + o) * h + i) * w + j;
    // with several groups, the min over them (exact: A + 5e4 is monotonic)
    if (win.groups > 1)
      dist_tile::atomic_min_f32(dst, v);
    else
      *dst = v;
  }
}

// The previous-frame rows that the CTA's windows reach, and whether query
// row r of the CTA takes row yi (|dy| <= pad, dy a multiple of atrous);
// returns the window steps |dy| / atrous or -1.
__device__ __forceinline__ int row_steps(const Window& win, int yi, int i,
                                         int h, int lo, int hi) {
  const int dy = yi - i;
  if (i >= h || dy % win.atrous) return -1;
  const int q = dy / win.atrous;
  return q < lo || q > hi ? -1 : abs(q);
}

// The CTA's previous frame and its share of the window rows: group g of
// `groups` takes the signed window steps lo ... hi, a contiguous part of
// -a_max ... a_max.
struct Share {
  int s, lo, hi;
};

__device__ __forceinline__ Share cta_share(const Window& win) {
  const int k = 2 * win.a_max + 1, g = blockIdx.z % win.groups;
  return {(int)blockIdx.z / win.groups, -win.a_max + g * k / win.groups,
          -win.a_max + (g + 1) * k / win.groups - 1};
}

// ------------------------------------------------- mixed: tensor cores
// stage: bf16 [SCOLS][cp + 8] (rows 16-byte aligned, ldmatrix without
// bank conflicts), y2 [SCOLS], lab [SCOLS] (zeros out of frame)
__host__ __device__ constexpr int mma_stage_bytes(int cp) {
  return ((SCOLS * (cp + 8) * 2 + SCOLS * 8) + 127) / 128 * 128;
}

// cp.async of 16 or 4 bytes that reads `bytes` (0: fills zeros)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// Start the copy of previous row yi of frame s, columns jb0 ... jb0 +
// SCOLS - 1, into a stage; outside the frame the row is zero, its norm
// +inf (so are the accumulators seeded with it) and its label 0.
template <int KS>
__device__ __forceinline__ void stage_mma(char* st, const uint16_t* yb,
                                          const float* y2, const int* lab,
                                          int s, int yi, int jb0, int h,
                                          int w, int scols, int tid,
                                          int nthreads) {
  constexpr int cp = 16 * KS, rs = cp + 8, chunks = 2 * KS;
  const uint32_t base = smem_addr(st);
  float* y2s = reinterpret_cast<float*>(st + SCOLS * rs * 2);
  int* labs = reinterpret_cast<int*>(y2s + SCOLS);
  const size_t row = ((size_t)s * h + yi) * w;
  for (int k = tid; k < scols * chunks; k += nthreads) {
    const int n = k / chunks, ch = k - n * chunks, col = jb0 + n;
    const bool in = col >= 0 && col < w;
    cp_async16_zfill(base + (n * rs + ch * 8) * 2,
                     yb + (row + (in ? col : 0)) * cp + ch * 8, in ? 16 : 0);
  }
  for (int n = tid; n < 2 * scols; n += nthreads) {
    const int nn = n % scols, col = jb0 + nn;
    const bool in = col >= 0 && col < w;
    if (n < scols) {
      if (in)
        cp_async4_zfill(smem_addr(y2s + nn), y2 + row + col, 4);
      else
        y2s[nn] = INFINITY;
    } else {
      if (in)
        cp_async4_zfill(smem_addr(labs + nn), lab + yi * w + col, 4);
      else
        labs[nn] = 0;
    }
  }
}

__device__ __forceinline__ void mma_16816(float* d, const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& b0,
                                            uint32_t& b1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

template <int KS, bool UNIT>  // cp = 16 KS; UNIT: atrous == 1
__global__ void __launch_bounds__(MAX_ROWS * WPR * 32)
local_mma_kernel(const uint16_t* __restrict__ xb,
                 const uint16_t* __restrict__ yb,
                 const float* __restrict__ x2, const float* __restrict__ y2,
                 const int* __restrict__ lab, float* __restrict__ out,
                 const Window win, int h, int w, int O, int rows) {
  constexpr int cp = 16 * KS, sb = mma_stage_bytes(cp);
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Share sh = cta_share(win);
  const int s = sh.s, i0 = blockIdx.y * rows, j0 = blockIdx.x * TW;
  const Mins mi = init_mins(smem + 2 * sb, win, rows, O, tid, nthreads);
  const int pad = win.pad, atrous = win.atrous, a_max = win.a_max;
  const int k_n = 2 * a_max + 1, nt = (16 + 2 * pad + 7) / 8;
  const int scols = 3 * 16 + 8 * nt;  // the last warp's band ends there

  // this warp: query row i0 + r, pixels j0 + pw ... + 15; in the ring
  // mins, lane (p, half) walks half of pixel pw + p's window offsets
  const int r = warp / WPR, pw = (warp % WPR) * 16, i = i0 + r;
  const int p_own = lane & 15, half = lane >> 4;
  const bool own = i < h && j0 + pw + p_own < w;
  const float x2_own = own ? x2[(size_t)i * w + j0 + pw + p_own] : 0.f;
  float* dw = mi.dist + warp * 16 * DS;
  uint32_t a[KS][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = j0 + pw + g + 8 * hh;
    const bool in = i < h && j < w;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        xb + (in ? (size_t)i * w + j : 0) * cp);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      a[ks][hh] = in ? src[ks * 8 + t] : 0u;
      a[ks][hh + 2] = in ? src[ks * 8 + 4 + t] : 0u;
    }
  }
  // accumulator (jt, e) is pixel g + 8 (e / 2) of the warp, staged column
  // pw + 8 jt + 2 t + e % 2, offset dx = 8 jt + 2 t + e % 2 - pixel - pad;
  // live when |dx| <= pad (and atrous divides it).  At atrous 1 its slot in
  // the warp's buffer is base + a compile-time constant.
  uint32_t live = 0;
#pragma unroll
  for (int jt = 0; jt < NT; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dx = 8 * jt + 2 * t + (e & 1) - (g + 8 * (e >> 1)) - pad;
      if (dx >= -pad && dx <= pad && dx % atrous == 0)
        live |= 1u << (4 * jt + e);
    }
  const int base = g * (DS - 1) + 2 * t;

  const int y_lo = max(0, i0 + sh.lo * atrous);
  const int y_hi = min(h - 1, i0 + rows - 1 + sh.hi * atrous);
  const int jb0 = j0 - pad;
  if (y_lo <= y_hi)
    stage_mma<KS>(smem, yb, y2, lab, s, y_lo, jb0, h, w, scols, tid,
                  nthreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int yi = y_lo; yi <= y_hi; ++yi) {
    const int st_i = (yi - y_lo) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // row yi has landed; row yi - 1's readers are done
    if (yi < y_hi)
      stage_mma<KS>(smem + (st_i ^ 1) * sb, yb, y2, lab, s, yi + 1, jb0, h,
                    w, scols, tid, nthreads);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int dys = row_steps(win, yi, i, h, sh.lo, sh.hi);
    if (dys < 0) continue;  // warp-uniform
    const char* st = smem + st_i * sb;
    const float* y2s =
        reinterpret_cast<const float*>(st + SCOLS * (cp + 8) * 2);
    const int* labs = reinterpret_cast<const int*>(y2s + SCOLS);
    // d' = ||y'||^2 - 2 x . y' (the operand preparation passed -2 y)
    float acc[NT][4];
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      const float2 yy =
          *reinterpret_cast<const float2*>(y2s + pw + 8 * jt + 2 * t);
      acc[jt][0] = acc[jt][2] = yy.x;
      acc[jt][1] = acc[jt][3] = yy.y;
    }
    // ldmatrix rows: lanes 0-7 give depths 0-7 of columns pw + 8 jt + (0-7),
    // lanes 8-15 depths 8-15 (b0, b1 of mma.m16n8k16's B fragment)
    const uint32_t tile =
        smem_addr(st) +
        ((pw + (lane & 7)) * (cp + 8) + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        if (jt >= nt) break;
        uint32_t b0, b1;
        ldmatrix_x2(tile + (8 * jt * (cp + 8) + 16 * ks) * 2, b0, b1);
        mma_16816(acc[jt], a[ks], b0, b1);
      }
    // the live d' to the warp's buffer by window offset, then the ring mins
#pragma unroll
    for (int jt = 0; jt < NT; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((live >> (4 * jt + e)) & 1)) continue;
        if (UNIT) {
          dw[base + 8 * (e >> 1) * (DS - 1) + 8 * jt + (e & 1)] = acc[jt][e];
        } else {
          const int row = g + 8 * (e >> 1);
          const int dx = 8 * jt + 2 * t + (e & 1) - row - pad;
          dw[row * DS + dx / atrous + a_max] = acc[jt][e];
        }
      }
    __syncwarp();
    if (own)
      ring_mins(mi, r * TW + pw + p_own, x2_own, dw + p_own * DS, labs,
                pw + p_own, atrous, k_n, a_max, dys, half);
    __syncwarp();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  write_out(mi, win, out, s, i0, j0, rows, h, w, O, tid, nthreads);
}

// --------------------------------------------------- float32: SIMT FMA
// smem: xs [C][rows * TW] (the query tile, transposed), two stages of
// ysT [C][SCOLS] (the staged row, transposed), y2 [SCOLS], lab [SCOLS];
// then the mins
__host__ __device__ constexpr size_t f32_stage_bytes(int C) {
  return ((size_t)C * SCOLS * 4 + SCOLS * 8 + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t f32_tile_bytes(int C, int rows) {
  return ((size_t)C * rows * TW * 4 + 127) / 128 * 128 +
         2 * f32_stage_bytes(C);
}

// Start the copy of previous row yi of frame s, columns jb0 ... jb0 +
// SCOLS - 1, into a stage, transposed (zeros outside the frame).
__device__ __forceinline__ void stage_f32(char* st, const float* yf,
                                          const float* y2, const int* lab,
                                          int s, int yi, int jb0, int h,
                                          int w, int C, int scols, int warp,
                                          int lane, int nwarps, int tid,
                                          int nthreads) {
  const uint32_t base = smem_addr(st);
  const uint32_t y2s = base + C * SCOLS * 4, labs = y2s + SCOLS * 4;
  const size_t row = ((size_t)s * h + yi) * w;
  for (int n = warp; n < scols; n += nwarps) {
    const int col = jb0 + n;
    const int b = col >= 0 && col < w ? 4 : 0;
    const float* src = yf + (row + (b ? col : 0)) * C;
    for (int c = lane; c < C; c += 32)
      cp_async4_zfill(base + (c * SCOLS + n) * 4, src + c, b);
  }
  for (int n = tid; n < 2 * scols; n += nthreads) {
    const int nn = n % scols, col = jb0 + nn;
    const int b = col >= 0 && col < w ? 4 : 0, c = b ? col : 0;
    if (n < scols)
      cp_async4_zfill(y2s + nn * 4, y2 + row + c, b);
    else
      cp_async4_zfill(labs + nn * 4, lab + yi * w + c, b);
  }
}

template <bool UNIT>  // atrous == 1
__global__ void __launch_bounds__(MAX_ROWS * WPR * 32)
local_f32_kernel(const float* __restrict__ xf, const float* __restrict__ yf,
                 const float* __restrict__ x2, const float* __restrict__ y2,
                 const int* __restrict__ lab, float* __restrict__ out,
                 const Window win, int h, int w, int C, int O, int rows) {
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const Share sh = cta_share(win);
  const int s = sh.s, i0 = blockIdx.y * rows, j0 = blockIdx.x * TW;
  const int xw = rows * TW, sb = (int)f32_stage_bytes(C);
  float* xs = reinterpret_cast<float*>(smem);
  char* stages = smem + ((size_t)C * xw * 4 + 127) / 128 * 128;
  const Mins mi = init_mins(smem + f32_tile_bytes(C, rows), win, rows, O,
                            tid, nthreads);
  const int pad = win.pad, atrous = win.atrous, a_max = win.a_max;
  const int k_n = 2 * a_max + 1;
  const int scols = 3 * 16 + 8 * ((16 + 2 * pad + 7) / 8);
  const int y_lo = max(0, i0 + sh.lo * atrous);
  const int y_hi = min(h - 1, i0 + rows - 1 + sh.hi * atrous);
  const int jb0 = j0 - pad;
  for (int m = warp; m < xw; m += nwarps) {
    const int i = i0 + m / TW, j = j0 + m % TW;
    const int b = i < h && j < w ? 4 : 0;
    const float* src = xf + (b ? (size_t)i * w + j : 0) * C;
    for (int c = lane; c < C; c += 32)
      cp_async4_zfill(smem_addr(xs + c * xw + m), src + c, b);
  }
  if (y_lo <= y_hi)
    stage_f32(stages, yf, y2, lab, s, y_lo, jb0, h, w, C, scols, warp, lane,
              nwarps, tid, nthreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // this warp: query row i0 + r, pixels pw ... + 15; this lane: pixels
  // pw + 4 pg + [0, 4) and window offsets 4 eg + [0, 4) (dx = e atrous - pad)
  const int r = warp / WPR, pw = (warp % WPR) * 16, i = i0 + r;
  const int pg = lane & 3, eg = lane >> 2;
  float* dw = mi.dist + warp * 16 * DS;
  const bool own = i < h && j0 + pw + (lane & 15) < w;
  float xq[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int j = j0 + pw + 4 * pg + p;
    xq[p] = i < h && j < w ? x2[(size_t)i * w + j] : 0.f;
  }
  for (int yi = y_lo; yi <= y_hi; ++yi) {
    const int st_i = (yi - y_lo) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // row yi has landed; row yi - 1's readers are done
    if (yi < y_hi)
      stage_f32(stages + (st_i ^ 1) * sb, yf, y2, lab, s, yi + 1, jb0, h, w,
                C, scols, warp, lane, nwarps, tid, nthreads);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int dys = row_steps(win, yi, i, h, sh.lo, sh.hi);
    if (dys < 0) continue;  // warp-uniform
    const float* ysT = reinterpret_cast<const float*>(stages + st_i * sb);
    const float* y2s = ysT + C * SCOLS;
    const int* labs = reinterpret_cast<const int*>(y2s + SCOLS);
    // the cross term in blocks of 8 channels, each summed apart and then
    // added: a two-level sum, whose rounding error grows with 8 + C / 8
    // terms instead of C
    float acc[4][4], blk[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;
    const float* xc = xs + r * TW + pw + 4 * pg;
    // pixel p, offset e read column pw + 4 pg + p + e atrous
    const float* yc = ysT + pw + 4 * pg + (UNIT ? 4 * eg : 0);
    for (int c0 = 0; c0 < C; c0 += 8) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) blk[p][e] = 0.f;
#pragma unroll
      for (int c = c0; c < c0 + 8; ++c) {
        if (c >= C) break;
        const float4 av = *reinterpret_cast<const float4*>(xc + c * xw);
        const float x4[4] = {av.x, av.y, av.z, av.w};
        if (UNIT) {
          const float4 b0 = *reinterpret_cast<const float4*>(yc + c * SCOLS);
          const float4 b1 =
              *reinterpret_cast<const float4*>(yc + c * SCOLS + 4);
          const float y8[8] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              blk[p][e] = fmaf(x4[p], y8[p + e], blk[p][e]);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ee = 4 * eg + e;
              const float y = ee < k_n ? yc[c * SCOLS + p + ee * atrous] : 0.f;
              blk[p][e] = fmaf(x4[p], y, blk[p][e]);
            }
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][e] += blk[p][e];
    }
    // the distances to the warp's buffer by window offset, then the ring
    // mins of each pixel by the lane that owns it (as in the mixed kernel)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ee = 4 * eg + e;
        if (ee >= k_n) continue;
        const int n = pw + 4 * pg + p + ee * atrous;
        dw[(4 * pg + p) * DS + ee] =
            jb0 + n >= 0 && jb0 + n < w ? (xq[p] + y2s[n]) - 2.f * acc[p][e]
                                        : INFINITY;
      }
    __syncwarp();
    if (own)
      ring_mins(mi, r * TW + pw + (lane & 15), 0.f, dw + (lane & 15) * DS,
                labs, pw + (lane & 15), atrous, k_n, a_max, dys, lane >> 4);
    __syncwarp();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  write_out(mi, win, out, s, i0, j0, rows, h, w, O, tid, nthreads);
}

// the largest dynamic shared memory a block of `kernel` may take
constexpr size_t MAX_SMEM = 232448;

template <class K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
}

template <int KS, bool UNIT>
int launch_mma(const uint16_t* xb, int hw, const float* norms,
               const int* lab, float* out, const Window& wd, int h, int w,
               int O, int rows, dim3 grid, dim3 block, size_t smem,
               cudaStream_t st) {
  static const cudaError_t set = allow_smem(local_mma_kernel<KS, UNIT>);
  if (set != cudaSuccess) return (int)set;
  local_mma_kernel<KS, UNIT><<<grid, block, smem, st>>>(
      xb, xb + (size_t)hw * 16 * KS, norms, norms + hw, lab, out, wd, h, w,
      O, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Operand preparation: rows [(1 + S) h w][cp] of the compute type (bf16
// when bf16 != 0: x, then -2 ys, zero past C; else float32 with cp = C),
// norms [(1 + S) h w], lab [h w].  x, ys and onehot (float32, or bf16 when
// lab_bf16 != 0) are read through their element strides.
extern "C" int local_prep_launch(const void* x, const void* ys,
                                 const void* onehot, int lab_bf16,
                                 const long long* sx, const long long* ss,
                                 const long long* so, int bf16, void* rows,
                                 float* norms, int* lab, float* out,
                                 long long n_out, int S, int h, int w, int C,
                                 int cp, int O, void* stream) {
  const int n = (1 + S) * h * w;
  const dim3 grid((n + PREP_WARPS - 1) / PREP_WARPS);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    prep_kernel<uint16_t><<<grid, PREP_WARPS * 32, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(ys),
        onehot, lab_bf16, sx[0], sx[1], sx[2], ss[0], ss[1], ss[2], ss[3],
        so[0], so[1], so[2], static_cast<uint16_t*>(rows), norms, lab, out,
        n_out, S, h, w, C, cp, O);
  else
    prep_kernel<float><<<grid, PREP_WARPS * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ys), onehot,
        lab_bf16, sx[0], sx[1], sx[2], ss[0], ss[1], ss[2], ss[3], so[0],
        so[1], so[2], static_cast<float*>(rows), norms, lab, out, n_out, S,
        h, w, C, cp, O);
  return (int)cudaGetLastError();
}

// The matching, from local_prep_launch's buffers: out [S, n_r, O, h, w].
// win = {pad, atrous, a_max, n_asc, n_r, band[0 .. MAX_PAD], ch_band[0 ..
// MAX_R - 1]}; groups = CTAs per query tile, each over a part of the
// window rows (out must hold +inf when groups > 1).
extern "C" int local_match_launch(const void* rows_buf, const float* norms,
                                  const int* lab, float* out, const int* win,
                                  int S, int h, int w, int C, int cp, int O,
                                  int bf16, int groups, void* stream) {
  Window wd;
  wd.pad = win[0];
  wd.atrous = win[1];
  wd.a_max = win[2];
  wd.n_asc = win[3];
  wd.n_r = win[4];
  for (int k = 0; k <= MAX_PAD; ++k) wd.band[k] = win[5 + k];
  for (int k = 0; k < MAX_R; ++k) wd.ch_band[k] = win[6 + MAX_PAD + k];
  wd.groups = groups;
  if (wd.pad < 0 || wd.pad > MAX_PAD || wd.atrous < 1 || wd.n_asc < 1 ||
      wd.n_asc > MAX_ASC || wd.n_r < 1 || wd.n_r > MAX_R || O < 1 ||
      O > 32 || C > 16 * MAX_KS || groups < 1 ||
      groups > 2 * wd.a_max + 1)
    return (int)cudaErrorInvalidValue;
  // fewer query rows per CTA where the shared memory asks it (C and O
  // large together)
  auto smem_of = [&](int r) {
    return (bf16 ? 2 * (size_t)mma_stage_bytes(cp) : f32_tile_bytes(C, r)) +
           mins_bytes(r, wd.n_asc, O);
  };
  int rows = MAX_ROWS;
  while (rows > 1 && smem_of(rows) > MAX_SMEM) --rows;
  const size_t smem = smem_of(rows);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int hw = h * w;
  const dim3 grid((w + TW - 1) / TW, (h + rows - 1) / rows, S * groups);
  const dim3 block(rows * WPR * 32);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    if (cp % 16) return (int)cudaErrorInvalidValue;
    const uint16_t* xb = static_cast<const uint16_t*>(rows_buf);
    const bool unit = wd.atrous == 1;
#define LAUNCH(KS)                                                        \
  case KS:                                                                \
    return unit ? launch_mma<KS, true>(xb, hw, norms, lab, out, wd, h, w, \
                                       O, rows, grid, block, smem, st)    \
                : launch_mma<KS, false>(xb, hw, norms, lab, out, wd, h,   \
                                        w, O, rows, grid, block, smem, st)
    switch (cp / 16) {
      LAUNCH(1); LAUNCH(2); LAUNCH(3); LAUNCH(4);
      LAUNCH(5); LAUNCH(6); LAUNCH(7); LAUNCH(8);
    }
#undef LAUNCH
    return (int)cudaErrorInvalidValue;
  } else {
    const float* xf = static_cast<const float*>(rows_buf);
    if (wd.atrous == 1) {
      static const cudaError_t set = allow_smem(local_f32_kernel<true>);
      if (set != cudaSuccess) return (int)set;
      local_f32_kernel<true><<<grid, block, smem, st>>>(
          xf, xf + (size_t)hw * C, norms, norms + hw, lab, out, wd, h, w, C,
          O, rows);
    } else {
      static const cudaError_t set = allow_smem(local_f32_kernel<false>);
      if (set != cudaSuccess) return (int)set;
      local_f32_kernel<false><<<grid, block, smem, st>>>(
          xf, xf + (size_t)hw * C, norms, norms + hw, lab, out, wd, h, w, C,
          O, rows);
    }
  }
  return (int)cudaGetLastError();
}
