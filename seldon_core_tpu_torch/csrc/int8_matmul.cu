// K1: int8 weight matmul with per-row dynamic activation quantization.
//
// Replaces seldon_core_tpu/ops/quant.py `_int8_kernel` (pl.pallas_call in
// `_int8_matmul`, reached through `int8_matmul`).  Computes, for x (M, K)
// and an int8 weight w (K, N) with per-column scales ws (N,):
//   xs[m]  = absmax(x[m, :]) / 127   (1 when the row is all zero)
//   xq     = clip(rint(x / xs), -127, 127) as int8      (rint: half to even)
//   acc    = xq @ w in int32                             (exact)
//   out    = (float(acc) * xs[m]) * ws[n], cast to the output dtype
// which is bit for bit the plain version (ops/quant.py int8_matmul_ref).
//
// Design: two launches.  A quantize pass (one block per row) writes xq and
// xs to scratch the wrapper allocates; the matmul pass then reads xq (a few
// KB, L2-resident) and streams w once per 8-row tile.  The fused prologue
// the TPU kernel has (quantize inside the tile) would need the whole
// 8 x K int8 row block in shared memory (128 KB at K = 16384), so this
// first version keeps the passes apart.
//
// Bound on the H100: at decode (M = 8) the weight bytes, K*N at 3.35 TB/s;
// the product itself is 2*M*N*K int8 operations, far under the int8 peak.
// The inner loop uses __dp4a (4 int8 products per instruction, int32
// accumulate); each thread owns 4 output columns x 8 rows and a 1/32 slice
// of K, and the 32 slices are summed in shared memory (integer sums are
// exact in any order).  Tensor-core mma/wgmma and split-K across blocks are
// later work.
#include "common.cuh"

namespace {

constexpr int QUANT_THREADS = 256;

template <typename TI>
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows_kernel(const TI* __restrict__ x, int K, int8_t* __restrict__ xq,
                  float* __restrict__ xs) {
  const int row = blockIdx.x;
  const TI* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += QUANT_THREADS)
    amax = fmaxf(amax, fabsf(to_f32(xr[k])));
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
  int8_t* qr = xq + (size_t)row * K;
  for (int k = threadIdx.x; k < K; k += QUANT_THREADS) {
    float q = rintf(to_f32(xr[k]) / s);
    q = fminf(fmaxf(q, -127.f), 127.f);
    qr[k] = (int8_t)q;
  }
}

constexpr int MM_BM = 8;    // rows per block
constexpr int MM_TX = 8;    // threads along N, 4 columns each
constexpr int MM_BN = 4 * MM_TX;
constexpr int MM_TY = 32;   // threads along K, 4 rows of K per step
constexpr int MM_THREADS = MM_TX * MM_TY;

template <typename TO>
__global__ void __launch_bounds__(MM_THREADS)
int8_mm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
               const int8_t* __restrict__ w, const float* __restrict__ ws,
               TO* __restrict__ out, int M, int K, int N) {
  const int tx = threadIdx.x % MM_TX;
  const int ty = threadIdx.x / MM_TX;
  const int m0 = blockIdx.x * MM_BM;
  const int n = blockIdx.y * MM_BN + tx * 4;
  const int mrows = min(MM_BM, M - m0);
  int acc[MM_BM][4];
#pragma unroll
  for (int m = 0; m < MM_BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

  if (n < N) {  // N % 4 == 0 (the wrapper checks), so n..n+3 are all valid
#pragma unroll 2
    for (int k = ty * 4; k < K; k += MM_TY * 4) {
      const int8_t* wp = w + (size_t)k * N + n;
      const int r0 = *reinterpret_cast<const int*>(wp);
      const int r1 = *reinterpret_cast<const int*>(wp + (size_t)N);
      const int r2 = *reinterpret_cast<const int*>(wp + 2 * (size_t)N);
      const int r3 = *reinterpret_cast<const int*>(wp + 3 * (size_t)N);
      // 4x4 byte transpose: c_j = (w[k][n+j], w[k+1][n+j], w[k+2][n+j],
      // w[k+3][n+j]) so that one __dp4a runs 4 steps of K for column n+j
      const int lo01 = __byte_perm(r0, r1, 0x5140);
      const int hi01 = __byte_perm(r0, r1, 0x7362);
      const int lo23 = __byte_perm(r2, r3, 0x5140);
      const int hi23 = __byte_perm(r2, r3, 0x7362);
      const int c0 = __byte_perm(lo01, lo23, 0x5410);
      const int c1 = __byte_perm(lo01, lo23, 0x7632);
      const int c2 = __byte_perm(hi01, hi23, 0x5410);
      const int c3 = __byte_perm(hi01, hi23, 0x7632);
#pragma unroll
      for (int m = 0; m < MM_BM; ++m) {
        if (m < mrows) {
          const int a =
              *reinterpret_cast<const int*>(xq + (size_t)(m0 + m) * K + k);
          acc[m][0] = __dp4a(a, c0, acc[m][0]);
          acc[m][1] = __dp4a(a, c1, acc[m][1]);
          acc[m][2] = __dp4a(a, c2, acc[m][2]);
          acc[m][3] = __dp4a(a, c3, acc[m][3]);
        }
      }
    }
  }

  // sum the 32 K-slices of each (row, column): exact in int32
  __shared__ int red[MM_TY][MM_BM * MM_BN];
#pragma unroll
  for (int m = 0; m < MM_BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][m * MM_BN + tx * 4 + j] = acc[m][j];
  __syncthreads();
  const int t = threadIdx.x;  // MM_THREADS == MM_BM * MM_BN outputs
  int sum = 0;
#pragma unroll 8
  for (int y = 0; y < MM_TY; ++y) sum += red[y][t];
  const int gm = m0 + t / MM_BN;
  const int gn = blockIdx.y * MM_BN + t % MM_BN;
  if (gm < M && gn < N) {
    // (float(acc) * xs) * ws, in that order, as the plain version
    const float v = ((float)sum * xs[gm]) * ws[gn];
    out[(size_t)gm * N + gn] = from_f32<TO>(v);
  }
}

template <typename TI>
cudaError_t launch_quant(const void* x, int M, int K, int8_t* xq, float* xs,
                         cudaStream_t s) {
  quant_rows_kernel<TI><<<M, QUANT_THREADS, 0, s>>>(
      static_cast<const TI*>(x), K, xq, xs);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_mm(const int8_t* xq, const float* xs, const int8_t* w,
                      const float* ws, void* out, int M, int K, int N,
                      cudaStream_t s) {
  dim3 grid((M + MM_BM - 1) / MM_BM, (N + MM_BN - 1) / MM_BN);
  int8_mm_kernel<TO><<<grid, MM_THREADS, 0, s>>>(
      xq, xs, w, ws, static_cast<TO*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sck_int8_matmul(const void* x, const void* w, const void* ws,
                               void* xq, void* xs, void* out, int M, int K,
                               int N, int x_dtype, int out_dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sc = static_cast<float*>(xs);
  cudaError_t e = (x_dtype == SCK_BF16)
                      ? launch_quant<bf16>(x, M, K, q, sc, s)
                      : launch_quant<float>(x, M, K, q, sc, s);
  if (e != cudaSuccess) return (int)e;
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* wsc = static_cast<const float*>(ws);
  e = (out_dtype == SCK_BF16)
          ? launch_mm<bf16>(q, sc, wq, wsc, out, M, K, N, s)
          : launch_mm<float>(q, sc, wq, wsc, out, M, K, N, s);
  return (int)e;
}

extern "C" const char* sck_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
