// K3: flash attention forward (causal or full) on (B, L, H, D) tensors.
//
// Replaces seldon_core_tpu/ops/attention.py `_flash_kernel` (pl.pallas_call
// in `_flash_bhld`, reached through `_flash_blhd` and `flash_attention`).
// Computes out = softmax(q k^T * scale, masked) v with an online softmax:
// scores, running max and sum, and the P.V accumulator all in float32;
// masked scores never count (the reference writes -1e30 and gets exp() = 0);
// a row whose sum is 0 divides by 1; the output is cast to q's dtype.
//
// Grouped-query attention: K/V come UN-expanded, (B, L, Hkv, D), and query
// head h reads KV head h / (H / Hkv).  That is the same arithmetic as the
// reference's jnp.repeat expansion (models/transformer.py:463) without the
// copy.
//
// Design: one block per (q-tile of 16 rows, head, batch), 128 threads.  The
// block loops over k-tiles of 32 keys from key 0 and, when causal, stops
// after the tile holding its last row's diagonal (tiles past it are fully
// masked; the reference skips them too).  Tiles are staged in shared memory
// as float32 (rows of q and k padded by one float against bank conflicts);
// each thread owns one query row (8 threads per row) and an eighth of its
// output columns, so the row max and sum are 3-step shuffles.
//
// Bound on the H100: at the slice's prefill shapes (L <= 256, D = 128) the
// work is 4*B*H*L*L*D/2 flops (causal) against q, k, v and out bytes; both
// are small, so it is latency-bound.  This version uses float32 FMA, not
// tensor cores (wgmma with a bf16 P is later work and a precision change).
#include "common.cuh"

namespace {

constexpr int FA_BQ = 16;
constexpr int FA_BK = 32;
constexpr int FA_THREADS = 128;  // 8 threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int L, int H,
                 int Hkv, float scale, int causal) {
  constexpr int DP = D + 1;              // padded row stride (q_s, k_s)
  constexpr int DPT = (D + 7) / 8;       // output columns per thread
  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid / 8;   // query row within the tile
  const int c8 = tid % 8;  // lane within the row's 8-thread group

  extern __shared__ float sm[];
  float* q_s = sm;                  // FA_BQ * DP
  float* k_s = q_s + FA_BQ * DP;    // FA_BK * DP
  float* v_s = k_s + FA_BK * DP;    // FA_BK * D
  float* p_s = v_s + FA_BK * D;     // FA_BQ * FA_BK

  for (int i = tid; i < FA_BQ * D; i += FA_THREADS) {
    const int rr = i / D, d = i % D;
    const int qi = q0 + rr;
    q_s[rr * DP + d] =
        qi < L ? to_f32(q[(((size_t)b * L + qi) * H + h) * D + d]) : 0.f;
  }

  const int qi = q0 + r;
  float m = -1e30f, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  const int q_last = min(q0 + FA_BQ, L) - 1;
  const int k_end = causal ? q_last + 1 : L;  // keys [0, k_end) can count
  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();  // q_s staged / previous tile fully consumed
    for (int i = tid; i < FA_BK * D; i += FA_THREADS) {
      const int rr = i / D, d = i % D;
      const int ki = k0 + rr;
      float kv = 0.f, vv = 0.f;
      if (ki < L) {
        const size_t off = (((size_t)b * L + ki) * Hkv + kvh) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[rr * DP + d] = kv;
      v_s[rr * D + d] = vv;
    }
    __syncthreads();

    float sc[FA_BK / 8];
    bool ok[FA_BK / 8];
    float mcur = -1e30f;
#pragma unroll
    for (int t = 0; t < FA_BK / 8; ++t) {
      const int j = c8 + 8 * t;
      const int ki = k0 + j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot += q_s[r * DP + d] * k_s[j * DP + d];
      sc[t] = dot * scale;
      ok[t] = ki < L && (!causal || ki <= qi);
      if (ok[t]) mcur = fmaxf(mcur, sc[t]);
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, o));
    const float m_new = fmaxf(m, mcur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < FA_BK / 8; ++t) {
      const float p = ok[t] ? expf(sc[t] - m_new) : 0.f;
      p_s[r * FA_BK + c8 + 8 * t] = p;
      psum += p;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's probabilities come from the same 8 lanes
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int d = c8 + 8 * jd;
      if (d < D) {
        float a = acc[jd] * alpha;
#pragma unroll 8
        for (int j = 0; j < FA_BK; ++j) a += p_s[r * FA_BK + j] * v_s[j * D + d];
        acc[jd] = a;
      }
    }
  }

  if (qi < L) {
    const float denom = (l == 0.f) ? 1.f : l;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int d = c8 + 8 * jd;
      if (d < D)
        out[(((size_t)b * L + qi) * H + h) * D + d] =
            from_f32<T>(acc[jd] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int L, int H, int Hkv, int causal, float scale,
                   cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)FA_BQ * (D + 1) + (size_t)FA_BK * (D + 1) +
                       (size_t)FA_BK * D + (size_t)FA_BQ * FA_BK);
  cudaError_t e = sck_allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((L + FA_BQ - 1) / FA_BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), L, H, Hkv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, int B, int L, int H, int Hkv, int causal,
                       float scale, cudaStream_t st) {
#define SCK_FA_CASE(DD) \
  case DD:              \
    return launch<T, DD>(q, k, v, out, B, L, H, Hkv, causal, scale, st);
  switch (D) {
    SCK_FA_CASE(8)
    SCK_FA_CASE(16)
    SCK_FA_CASE(32)
    SCK_FA_CASE(64)
    SCK_FA_CASE(128)
    SCK_FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef SCK_FA_CASE
}

}  // namespace

extern "C" int sck_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int B, int L,
                                   int H, int Hkv, int D, int causal,
                                   float scale, int dtype, void* stream) {
  if (H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      (dtype == SCK_BF16)
          ? dispatch_d<bf16>(D, q, k, v, out, B, L, H, Hkv, causal, scale, st)
          : dispatch_d<float>(D, q, k, v, out, B, L, H, Hkv, causal, scale,
                              st);
  return (int)e;
}
