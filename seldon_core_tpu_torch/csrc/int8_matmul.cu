// K1: int8 weight matmul with per-row dynamic activation quantization.
//
// Replaces seldon_core_tpu/ops/quant.py `_int8_kernel` (pl.pallas_call in
// `_int8_matmul`, reached through `int8_matmul`).  Computes, for x (M, K)
// and an int8 weight w (K, N) with per-column scales ws (N,):
//   xs[m]  = absmax(x[m, :]) / 127   (1 when the row is all zero)
//   xq     = clip(rint(x / xs), -127, 127) as int8      (rint: half to even)
//   acc    = xq @ w in int32                             (exact)
//   out    = (float(acc) * xs[m]) * ws[n], cast to the output dtype
// which is bit for bit the plain version (ops/quant.py int8_matmul_ref):
// integer sums are exact in any order, so the tiling below cannot change a
// bit of the result.
//
// Layout: the weight is stored K-major on the card, a contiguous (N, K)
// buffer that Python sees as its (K, N) `.t()` view (ops/quant.py
// quantize_int8).  Each output column then has its K bytes contiguous, so
// both schedules load 16-byte vectors along K and hand them to the int8
// tensor cores as they are: mma.sync s8 takes K-major operands only, and
// the reference's (K, N) rows would need a byte transposition first.
//
// Two launches per call.  A quantize pass (one block per row, IEEE
// division, rintf) writes xq and xs to scratch the wrapper allocates; the
// product pass then reads xq (at most a few hundred KB, L2-resident).
// The wrapper (ops/quant.py int8_variant) picks the product's schedule
// from M:
//
// * "mma_gemv" (M <= 16: decode).  Bound by the weight's bytes at
//   3.35 TB/s.  A batched GEMV over the rows of w^T on mma.sync.m16n8k32
//   s8 with the operands swapped: 16 weight columns are the A operand and
//   the tokens the N side, 8 per mma (two mma for 9-16 rows), so a decode
//   batch of 8 fills the tensor-core tile instead of 8 of 16 rows.  A lane
//   loads 16 contiguous K bytes of each of its two weight rows (and of its
//   token's xq row) per 64-K chunk; since an int8 product's sum is exact
//   in any order, the 16 bytes are spread over two k-steps (bytes 0-7 the
//   first, 8-15 the second) for A and B alike, so no byte is moved between
//   registers.  A block is 16 warps: WN column tiles of 16 x WK K-slices,
//   summed in shared memory in int32.  WK is the most (up to 16) that
//   keeps the grid within about 32 warps per SM, so the short shapes (N
//   4096 and 1024) split K over 16 warps and every shape is one wave.
//   ptxas interleaves each chunk's loads with its mma (one chunk in flight
//   per warp), so the warps per SM are what keep bytes in flight: a
//   private cp.async ring of 8 chunks per lane was slower (PERF.md).
// * "mma_gemm" (M > 16: prefill buckets).  Tiles of BM x 128 outputs (BM
//   32, 64 or 128), 8 warps of BM/2 x 32, on mma.sync.m16n8k32 s8 from
//   ldmatrix; A (xq) and B (w^T) tiles of 128 K bytes go through a 3-stage
//   cp.async ring, rows XOR-swizzled in 16-byte chunks.  Where one row tile
//   covers M (BM = 128 at M = 128) the weight is read once and each A byte
//   N / 128 times, a quarter of the L2 traffic of 64 x 64 tiles.  Where the
//   tiles are too few to fill the SMs (N 1024 or 4096), K is split over up
//   to 16 blocks per tile: each adds its int32 sums with atomics into
//   scratch the quantize pass zeroed, and the last of a tile's blocks to
//   arrive reads the total and writes the epilogue.  The plan (tile rows,
//   splits) comes from ops/quant.py gemm_plan, fitted to a sweep of every
//   plan on the card (PERF.md).  mma.sync rather than wgmma keeps this
//   first tensor-core version small; wgmma with TMA is the next step.
#include "common.cuh"

namespace {

constexpr int QUANT_THREADS = 256;

// One block per row.  Both passes over the row read 16-byte vectors,
// QUANT_VPT of them in flight per thread, so a row of K = 16384 is one
// round trip per pass instead of K / 256 dependent loads.  The blocks also
// zero the product's split-K scratch (n_zero ints, a multiple of 4).
constexpr int QUANT_VPT = 8;

template <typename TI>
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows_kernel(const TI* __restrict__ x, int K, int8_t* __restrict__ xq,
                  float* __restrict__ xs, int* __restrict__ zero,
                  int n_zero) {
  constexpr int E = 16 / sizeof(TI);  // elements per 16-byte vector
  constexpr int STEP = QUANT_THREADS * QUANT_VPT;
  const int row = blockIdx.x;
  for (int i = row * QUANT_THREADS + threadIdx.x; i < n_zero / 4;
       i += gridDim.x * QUANT_THREADS)
    reinterpret_cast<int4*>(zero)[i] = make_int4(0, 0, 0, 0);
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  const int nv = K / E;  // K % 16 == 0 and rows start 16-byte aligned
  const uint4 z = make_uint4(0, 0, 0, 0);
  float amax = 0.f;
  for (int base = threadIdx.x; base < nv; base += STEP) {
    uint4 v[QUANT_VPT];
#pragma unroll
    for (int i = 0; i < QUANT_VPT; ++i) {
      const int idx = base + i * QUANT_THREADS;
      v[i] = idx < nv ? __ldg(xr + idx) : z;
    }
#pragma unroll
    for (int i = 0; i < QUANT_VPT; ++i) {
      const TI* e = reinterpret_cast<const TI*>(&v[i]);
#pragma unroll
      for (int j = 0; j < E; ++j) amax = fmaxf(amax, fabsf(to_f32(e[j])));
    }
  }
  __shared__ float red[QUANT_THREADS / 32];
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < QUANT_THREADS / 32 ? red[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  amax = red[0];
  // IEEE division (no fast-math): the same xs as jnp / torch
  const float s = (amax == 0.f) ? 1.f : amax / 127.f;
  if (threadIdx.x == 0) xs[row] = s;
  uint32_t* qr = reinterpret_cast<uint32_t*>(xq + (size_t)row * K);
  for (int base = threadIdx.x; base < nv; base += STEP) {
    uint4 v[QUANT_VPT];
#pragma unroll
    for (int i = 0; i < QUANT_VPT; ++i) {
      const int idx = base + i * QUANT_THREADS;
      v[i] = idx < nv ? __ldg(xr + idx) : z;
    }
#pragma unroll
    for (int i = 0; i < QUANT_VPT; ++i) {
      const int idx = base + i * QUANT_THREADS;
      if (idx >= nv) break;
      const TI* e = reinterpret_cast<const TI*>(&v[i]);
#pragma unroll
      for (int w = 0; w < E / 4; ++w) {  // 4 int8 per 32-bit store
        uint32_t packed = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float q = rintf(to_f32(e[4 * w + j]) / s);
          q = fminf(fmaxf(q, -127.f), 127.f);
          packed |= ((uint32_t)(int)q & 0xffu) << (8 * j);
        }
        qr[idx * (E / 4) + w] = packed;
      }
    }
  }
}

// ---- "mma_gemv": M <= 16 --------------------------------------------------

constexpr int GEMV_WARPS = 16;
constexpr int GEMV_THREADS = 32 * GEMV_WARPS;
constexpr int GEMV_U = 4;  // 64-K chunks per loop step

__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));  // read once: evict first
}

// MT: 8-token tiles (1 for M <= 8, 2 for M <= 16)
template <typename TO, int MT>
__global__ void __launch_bounds__(GEMV_THREADS)
int8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wt, const float* __restrict__ ws,
                 TO* __restrict__ out, int M, int K, int N, int WN) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int WK = GEMV_WARPS / WN;
  const int wn = warp % WN, kw = warp / WN;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x * WN + wn) * 16;
  const int na = n0 + g, nb = n0 + g + 8;  // this lane's two weight rows
  const bool va = na < N, vb = nb < N;
  const int8_t* wa = wt + (size_t)(va ? na : 0) * K + t * 16;
  const int8_t* wb = wt + (size_t)(vb ? nb : 0) * K + t * 16;
  const int nch = (K + 63) / 64;
  const uint4 z = make_uint4(0, 0, 0, 0);

  int acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0;

  for (int c0 = kw; c0 < nch; c0 += WK * GEMV_U) {
    uint4 ra[GEMV_U], rb[GEMV_U], rx[GEMV_U][MT];
#pragma unroll
    for (int u = 0; u < GEMV_U; ++u) {
      const int c = c0 + u * WK;
      const int k = c * 64 + t * 16;
      const bool ok = c < nch && k < K;
      ra[u] = (ok && va) ? ld_stream(wa + (size_t)c * 64) : z;
      rb[u] = (ok && vb) ? ld_stream(wb + (size_t)c * 64) : z;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = mt * 8 + g;
        rx[u][mt] = (ok && m < M) ? __ldg(reinterpret_cast<const uint4*>(
                                        xq + (size_t)m * K + k))
                                  : z;
      }
    }
#pragma unroll
    for (int u = 0; u < GEMV_U; ++u) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_s8_16832(acc[mt], ra[u].x, rb[u].x, ra[u].y, rb[u].y,
                     rx[u][mt].x, rx[u][mt].y);
        mma_s8_16832(acc[mt], ra[u].z, rb[u].z, ra[u].w, rb[u].w,
                     rx[u][mt].z, rx[u][mt].w);
      }
    }
  }

  // sum the K-slices of each column tile: exact in int32
  __shared__ int red[GEMV_WARPS][32][4 * MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][lane][mt * 4 + e] = acc[mt][e];
  __syncthreads();
  if (kw != 0) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int sum = 0;
      for (int j = 0; j < WK; ++j) sum += red[j * WN + wn][lane][mt * 4 + e];
      // C fragment: e 0/1 -> weight row g, e 2/3 -> g + 8; token 2t + (e&1)
      const int n = (e < 2) ? na : nb;
      const int m = mt * 8 + 2 * t + (e & 1);
      if (n < N && m < M) {
        // (float(acc) * xs) * ws, in that order, as the plain version
        const float vv = ((float)sum * xs[m]) * ws[n];
        out[(size_t)m * N + n] = from_f32<TO>(vv);
      }
    }
  }
}

// ---- "mma_gemm": M > 16 ---------------------------------------------------

constexpr int GEMM_BN = 128;  // output columns per tile
constexpr int GEMM_BK = 128;  // K bytes per stage: 8 chunks of 16
constexpr int GEMM_CH = GEMM_BK / 16;
constexpr int GEMM_STAGES = 3;  // 60-96 KB of ring: two blocks per SM
constexpr int GEMM_THREADS = 256;  // 8 warps, 2 x 4, each BM/2 x 32

__device__ __forceinline__ int gemm_swz(int r, int c) {
  return r * GEMM_CH + (c ^ (r & 7));
}

// rows [row0, row0 + ROWS) x K bytes [k0, k0 + GEMM_BK) of a (rows, K) int8
// matrix into a tile; out-of-range rows and K bytes are zero-filled
template <int ROWS>
__device__ __forceinline__ void gemm_load_tile(uint4* tile, const int8_t* src,
                                               int row0, int rows, int k0,
                                               int K) {
#pragma unroll
  for (int j = 0; j < ROWS * GEMM_CH / GEMM_THREADS; ++j) {
    const int i = threadIdx.x + j * GEMM_THREADS;
    const int r = i / GEMM_CH, c = i % GEMM_CH;
    const int gr = row0 + r, k = k0 + c * 16;
    const bool in = gr < rows && k < K;
    const int8_t* p = src + (in ? (size_t)gr * K + k : 0);
    cp_async16(smem_u32(tile + gemm_swz(r, c)), p, in ? 16 : 0);
  }
}

// two neighbouring outputs of one row; `pair` when both exist and the pair
// is aligned for one store (N even)
template <typename TO>
__device__ __forceinline__ void store2(TO* p, float v0, float v1, bool pair,
                                       bool has1) {
  if (pair) {
    if constexpr (sizeof(TO) == 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(p) = h;
    } else {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    }
  } else {
    p[0] = from_f32<TO>(v0);
    if (has1) p[1] = from_f32<TO>(v1);
  }
}

// grid (row tiles, column tiles, splits).  With splits > 1, block z sums
// the k-tiles [z * per, (z + 1) * per) of its output tile, adds its int32
// sums atomically into `sums` and counts itself in `arrivals` (both zeroed
// by the quantize pass); the block that arrives last reads the tile's total
// and writes the epilogue.  int32 sums are exact in any order.
template <typename TO, int BM>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wt, const float* __restrict__ ws,
                 TO* __restrict__ out, int M, int K, int N, int splits,
                 int* __restrict__ sums, int* __restrict__ arrivals) {
  constexpr int MI = BM / 32;  // m16 tiles per warp (BM / 2 rows)
  constexpr int NJ = 4;        // n8 tiles per warp (32 columns)
  constexpr int A_TILE = BM * GEMM_CH, STAGE = (BM + GEMM_BN) * GEMM_CH;
  extern __shared__ uint4 gemm_sm[];  // stages x (A tile, B tile)
  __shared__ int is_last;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * GEMM_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3;
  const int nk = (K + GEMM_BK - 1) / GEMM_BK;
  const int per = (nk + splits - 1) / splits;
  const int kt0 = blockIdx.z * per;
  const int n_kt = max(0, min(nk, kt0 + per) - kt0);

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto load_stage = [&](int s, int kt) {
    uint4* st = gemm_sm + s * STAGE;
    gemm_load_tile<BM>(st, xq, m0, M, kt * GEMM_BK, K);
    gemm_load_tile<GEMM_BN>(st + A_TILE, wt, n0, N, kt * GEMM_BK, K);
  };
#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < n_kt) load_stage(s, kt0 + s);
    cp_async_commit();
  }

  for (int i = 0; i < n_kt; ++i) {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();  // tile i is in; the stage of tile i - 1 is free
    const int pf = i + GEMM_STAGES - 1;
    if (pf < n_kt) load_stage(pf % GEMM_STAGES, kt0 + pf);
    cp_async_commit();
    const uint4* ta = gemm_sm + (i % GEMM_STAGES) * STAGE;
    const uint4* tb = ta + A_TILE;
#pragma unroll
    for (int ks = 0; ks < GEMM_BK / 32; ++ks) {
      uint32_t a[MI][4], b[NJ][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * (BM / 2) + mi * 16 + (mat & 1) * 8 + (lane & 7);
        ldmatrix_x4(a[mi], smem_u32(ta + gemm_swz(r, 2 * ks + (mat >> 1))));
      }
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        const int r = wn * 32 + jj * 16 + (mat >> 1) * 8 + (lane & 7);
        uint32_t bb[4];
        ldmatrix_x4(bb, smem_u32(tb + gemm_swz(r, 2 * ks + (mat & 1))));
        b[2 * jj][0] = bb[0];
        b[2 * jj][1] = bb[1];
        b[2 * jj + 1][0] = bb[2];
        b[2 * jj + 1][1] = bb[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
          mma_s8_16832(acc[mi][nj], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                       b[nj][0], b[nj][1]);
    }
  }
  cp_async_wait<0>();

  if (splits > 1) {
    // the tile's int32 sums, in fragment order so that a warp's atomics
    // and loads cover 128 contiguous bytes
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int* sum = sums + (size_t)tile * MI * NJ * 4 * GEMM_THREADS + threadIdx.x;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (acc[mi][nj][e])
            atomicAdd(sum + ((mi * NJ + nj) * 4 + e) * GEMM_THREADS,
                      acc[mi][nj][e]);
    __threadfence();  // the sums are complete before the arrival counts
    __syncthreads();
    if (threadIdx.x == 0)
      is_last = atomicAdd(arrivals + tile, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][nj][e] =
              __ldcg(sum + ((mi * NJ + nj) * 4 + e) * GEMM_THREADS);
  }

  // (float(acc) * xs) * ws, in that order, as the plain version
  const bool even_n = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * (BM / 2) + mi * 16 + g + half * 8;
      if (m >= M) continue;
      const float xm = xs[m];
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int n = n0 + wn * 32 + nj * 8 + 2 * t;
        if (n >= N) continue;
        const bool has1 = n + 1 < N;
        const float v0 = ((float)acc[mi][nj][2 * half] * xm) * ws[n];
        const float v1 =
            has1 ? ((float)acc[mi][nj][2 * half + 1] * xm) * ws[n + 1] : 0.f;
        store2<TO>(out + (size_t)m * N + n, v0, v1, even_n && has1, has1);
      }
    }
  }
}

// ---- launch ----------------------------------------------------------------

enum { MM_GEMV = 0, MM_GEMM = 1 };  // ops/quant.py int8_variant codes

template <typename TI>
cudaError_t launch_quant(const void* x, int M, int K, int8_t* xq, float* xs,
                         int* zero, int n_zero, cudaStream_t s) {
  quant_rows_kernel<TI><<<M, QUANT_THREADS, 0, s>>>(
      static_cast<const TI*>(x), K, xq, xs, zero, n_zero);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_gemv(const int8_t* xq, const float* xs, const int8_t* wt,
                        const float* ws, void* out, int M, int K, int N,
                        cudaStream_t s) {
  const int n_tiles = (N + 15) / 16;
  // K-slices per column tile: the most (up to a block's 16 warps) that keep
  // the grid within about 32 warps per SM, so one wave covers every shape
  int WK = GEMV_WARPS;
  while (WK > 1 && n_tiles * WK > 32 * 132) WK /= 2;
  const int WN = GEMV_WARPS / WK;
  const int grid = (n_tiles + WN - 1) / WN;
  if (M <= 8)
    int8_gemv_kernel<TO, 1><<<grid, GEMV_THREADS, 0, s>>>(
        xq, xs, wt, ws, static_cast<TO*>(out), M, K, N, WN);
  else
    int8_gemv_kernel<TO, 2><<<grid, GEMV_THREADS, 0, s>>>(
        xq, xs, wt, ws, static_cast<TO*>(out), M, K, N, WN);
  return cudaGetLastError();
}

// the product's plan for "mma_gemm" (ops/quant.py gemm_plan)
struct GemmPlan {
  int bm;        // tile rows: 32, 64 or 128
  int splits;    // K splits per output tile
  int* scratch;  // splits > 1: arrival counters, then the int32 sums
};

inline int gemm_tiles(int M, int N, int bm) {
  return ((M + bm - 1) / bm) * ((N + GEMM_BN - 1) / GEMM_BN);
}

// ints of scratch the quantize pass zeroes: the counters (rounded up to
// whole int4s), then the sums
inline int gemm_scratch_ints(const GemmPlan& p, int M, int N) {
  if (p.splits <= 1) return 0;
  const int tiles = gemm_tiles(M, N, p.bm);
  return (tiles + 3) / 4 * 4 + tiles * p.bm * GEMM_BN;
}

template <typename TO, int BM>
cudaError_t launch_gemm(const int8_t* xq, const float* xs, const int8_t* wt,
                        const float* ws, void* out, int M, int K, int N,
                        const GemmPlan& p, cudaStream_t s) {
  const size_t smem =
      sizeof(uint4) * (size_t)(BM + GEMM_BN) * GEMM_CH * GEMM_STAGES;
  cudaError_t e = sck_allow_smem(int8_gemm_kernel<TO, BM>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = gemm_tiles(M, N, BM);
  int* sums = p.scratch ? p.scratch + (tiles + 3) / 4 * 4 : nullptr;
  dim3 grid((M + BM - 1) / BM, (N + GEMM_BN - 1) / GEMM_BN, p.splits);
  int8_gemm_kernel<TO, BM><<<grid, GEMM_THREADS, smem, s>>>(
      xq, xs, wt, ws, static_cast<TO*>(out), M, K, N, p.splits, sums,
      p.scratch);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_mm(int variant, const GemmPlan& p, const int8_t* xq,
                      const float* xs, const int8_t* wt, const float* ws,
                      void* out, int M, int K, int N, cudaStream_t s) {
  if (variant == MM_GEMV) {
    if (M > 16) return cudaErrorInvalidValue;
    return launch_gemv<TO>(xq, xs, wt, ws, out, M, K, N, s);
  }
  switch (p.bm) {
    case 32:
      return launch_gemm<TO, 32>(xq, xs, wt, ws, out, M, K, N, p, s);
    case 64:
      return launch_gemm<TO, 64>(xq, xs, wt, ws, out, M, K, N, p, s);
    case 128:
      return launch_gemm<TO, 128>(xq, xs, wt, ws, out, M, K, N, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// wt: the (N, K) K-major weight buffer; K % 16 == 0 (16-byte rows).
// "mma_gemm" takes its plan from the caller (ops/quant.py gemm_plan): tile
// rows bm and K splits; with splits > 1, `scratch` (16-byte aligned) holds the tiles' arrival counters, rounded up to a multiple of 4
// ints, then the tiles' int32 sums (tiles x bm x 128).
extern "C" int sck_int8_matmul(const void* x, const void* wt, const void* ws,
                               void* xq, void* xs, void* out, int M, int K,
                               int N, int x_dtype, int out_dtype, int variant,
                               int bm, int splits, void* scratch,
                               void* stream) {
  if (K % 16 != 0) return (int)cudaErrorInvalidValue;
  if (variant != MM_GEMV && variant != MM_GEMM)
    return (int)cudaErrorInvalidValue;
  const GemmPlan plan{bm, splits, static_cast<int*>(scratch)};
  if (variant == MM_GEMM && (splits < 1 || (splits > 1 && !plan.scratch)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sc = static_cast<float*>(xs);
  const int n_zero = variant == MM_GEMM ? gemm_scratch_ints(plan, M, N) : 0;
  cudaError_t e =
      (x_dtype == SCK_BF16)
          ? launch_quant<bf16>(x, M, K, q, sc, plan.scratch, n_zero, s)
          : launch_quant<float>(x, M, K, q, sc, plan.scratch, n_zero, s);
  if (e != cudaSuccess) return (int)e;
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* wsc = static_cast<const float*>(ws);
  e = (out_dtype == SCK_BF16)
          ? launch_mm<bf16>(variant, plan, q, sc, w, wsc, out, M, K, N, s)
          : launch_mm<float>(variant, plan, q, sc, w, wsc, out, M, K, N, s);
  return (int)e;
}

extern "C" const char* sck_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
