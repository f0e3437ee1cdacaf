// K2: paged decode attention (one query per slot, grouped-query heads).
//
// Replaces seldon_core_tpu/runtime/paged.py `_kernel_attn`, which calls the
// library Pallas kernel jax.experimental.pallas.ops.tpu.paged_attention.
// Computes, for slot s and query head h (KV head h / g, g = H / Hkv):
//   out[s, h] = softmax_t(q[s, h] . k[t] * scale) @ v[t],  t < lengths[s]
// where key t of slot s lives in page tables[s, t / ps] at row t % ps of
// the pool k_pages/v_pages (Hkv, n_pages, ps, D).  Scores, softmax and the
// P.V sum are float32 and the output is float32, as
// runtime/paged.py paged_attention_ref computes it; the scale is applied
// to the float32 scores (the reference does so at paged.py:129).
//
// Design: one block per (slot, KV head).  The block reads the slot's page
// ids from the table itself and walks its pages up to lengths[s]; the g
// query heads of the group share each K/V page read (staged in shared
// memory as float32), and an online softmax carries the running max and
// sum per head across pages.  A slot with lengths == 0 (inactive) walks no
// page and writes zeros (its value is unread).  Page 0 is the pool's trash
// page; the kernel reads whatever the table names and never writes.
//
// Bound on the H100: the K/V bytes of the live pages (plus q and out) at
// 3.35 TB/s; decode attention does ~4 flops per K/V element, far below the
// card's ratio.  At 8 slots this grid is small (S * Hkv blocks); splitting
// a slot's pages over several blocks (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr int PA_THREADS = 128;
constexpr int PA_GMAX = 8;  // largest query-group size g = H / Hkv

template <typename T, int D>
__global__ void __launch_bounds__(PA_THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ lengths,
                  const int* __restrict__ tables, float* __restrict__ out,
                  int H, int Hkv, int n_pages, int ps, int pp, float scale) {
  constexpr int DPT = (D + PA_THREADS - 1) / PA_THREADS;  // columns/thread
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = H / Hkv;
  const int tid = threadIdx.x;
  const int len = lengths[s];

  extern __shared__ float smem[];
  float* q_s = smem;             // g * D
  float* k_s = q_s + PA_GMAX * D;  // ps * D
  float* v_s = k_s + ps * D;     // ps * D
  float* p_s = v_s + ps * D;     // g * ps scores, then probabilities
  __shared__ float m_s[PA_GMAX], l_s[PA_GMAX], a_s[PA_GMAX];

  for (int i = tid; i < g * D; i += PA_THREADS) {
    const int h = i / D, d = i % D;
    q_s[i] = to_f32(q[((size_t)s * H + kvh * g + h) * D + d]);
  }
  if (tid < PA_GMAX) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[DPT][PA_GMAX];
#pragma unroll
  for (int j = 0; j < DPT; ++j)
#pragma unroll
    for (int h = 0; h < PA_GMAX; ++h) acc[j][h] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  const int n_pg = (len + ps - 1) / ps;
  for (int pg = 0; pg < n_pg; ++pg) {
    __syncthreads();  // q_s staged / previous page fully consumed
    const int page = tables[(size_t)s * pp + pg];
    const size_t base = ((size_t)kvh * n_pages + page) * ps * D;
    const int nt = min(ps, len - pg * ps);  // live tokens of this page
    for (int i = tid; i < nt * D; i += PA_THREADS) {
      k_s[i] = to_f32(kp[base + i]);
      v_s[i] = to_f32(vp[base + i]);
    }
    __syncthreads();
    // scores: warps take (head, token) pairs, lanes split D
    for (int pr = warp; pr < g * nt; pr += PA_THREADS / 32) {
      const int h = pr / nt, t = pr % nt;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += q_s[h * D + d] * k_s[t * D + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) p_s[h * ps + t] = dot * scale;
    }
    __syncthreads();
    // online softmax: thread h updates head h over this page's tokens
    if (tid < g) {
      const float m_prev = m_s[tid];
      float mx = m_prev;
      for (int t = 0; t < nt; ++t) mx = fmaxf(mx, p_s[tid * ps + t]);
      float sum = 0.f;
      for (int t = 0; t < nt; ++t) {
        const float p = expf(p_s[tid * ps + t] - mx);
        p_s[tid * ps + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - mx);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = mx;
      a_s[tid] = alpha;
    }
    __syncthreads();
    // P.V: thread owns columns d = tid + j * PA_THREADS for every head
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tid + j * PA_THREADS;
      if (d < D) {
#pragma unroll
        for (int h = 0; h < PA_GMAX; ++h) {
          if (h < g) {
            float a = acc[j][h] * a_s[h];
            for (int t = 0; t < nt; ++t) a += p_s[h * ps + t] * v_s[t * D + d];
            acc[j][h] = a;
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = tid + j * PA_THREADS;
    if (d < D) {
#pragma unroll
      for (int h = 0; h < PA_GMAX; ++h) {
        if (h < g) {
          const float l = l_s[h];
          out[((size_t)s * H + kvh * g + h) * D + d] =
              acc[j][h] / (l == 0.f ? 1.f : l);
        }
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* lengths, const int* tables, float* out, int S,
                   int H, int Hkv, int n_pages, int ps, int pp, float scale,
                   cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)PA_GMAX * D + 2 * (size_t)ps * D +
                       (size_t)PA_GMAX * ps);
  cudaError_t e = sck_allow_smem(paged_attn_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(S, Hkv);
  paged_attn_kernel<T, D><<<grid, PA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), lengths, tables, out, H, Hkv, n_pages, ps,
      pp, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp,
                       const int* lengths, const int* tables, float* out,
                       int S, int H, int Hkv, int n_pages, int ps, int pp,
                       float scale, cudaStream_t st) {
#define SCK_PA_CASE(DD)                                                     \
  case DD:                                                                  \
    return launch<T, DD>(q, kp, vp, lengths, tables, out, S, H, Hkv,        \
                         n_pages, ps, pp, scale, st);
  switch (D) {
    SCK_PA_CASE(8)
    SCK_PA_CASE(16)
    SCK_PA_CASE(32)
    SCK_PA_CASE(64)
    SCK_PA_CASE(128)
    SCK_PA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef SCK_PA_CASE
}

}  // namespace

extern "C" int sck_paged_attention(const void* q, const void* kp,
                                   const void* vp, const void* lengths,
                                   const void* tables, void* out, int S,
                                   int H, int Hkv, int n_pages, int ps, int D,
                                   int pp, float scale, int dtype,
                                   void* stream) {
  if (H % Hkv != 0 || H / Hkv > PA_GMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  float* o = static_cast<float*>(out);
  cudaError_t e =
      (dtype == SCK_BF16)
          ? dispatch_d<bf16>(D, q, kp, vp, len, tab, o, S, H, Hkv, n_pages,
                             ps, pp, scale, st)
          : dispatch_d<float>(D, q, kp, vp, len, tab, o, S, H, Hkv, n_pages,
                              ps, pp, scale, st);
  return (int)e;
}
