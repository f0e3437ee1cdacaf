// K2: paged decode attention (one query per slot, grouped-query heads), as
// split-page flash-decoding.
//
// Replaces seldon_core_tpu/runtime/paged.py `_kernel_attn`, which calls the
// library Pallas kernel jax.experimental.pallas.ops.tpu.paged_attention.
// Computes, for slot s and query head h (KV head h / g, g = H / Hkv):
//   out[s, h] = softmax_t(q[s, h] . k[t] * scale) @ v[t],  t < lengths[s]
// where key t of slot s lives in page tables[s, t / ps] at row t % ps of
// the pool k_pages/v_pages (Hkv, n_pages, ps, D).  Scores, softmax and the
// P.V sum are float32 and the output is float32, as
// runtime/paged.py paged_attention_ref computes it; the scale is applied
// to the float32 scores.  Lengths above pp * ps count as pp * ps (the
// reference sees only the table's pages).
//
// Bound on the H100: the bytes of the live K/V rows at 3.35 TB/s (about 4
// flops per K/V element, far below the card's ratio), and at short
// contexts a latency floor: one launch, one dependent round trip to memory
// for the rows, one for the partial outputs.
//
// Design.  The TPU kernel walks a slot's pages in grid order; here the
// pages are split over blocks that run at once.
// - Grid (n_split, Hkv * head groups, S).  Block z of a (slot, KV head,
//   group of up to PA_GH query heads) takes the contiguous pages
//   [z * per, (z + 1) * per) of the slot's table.  n_split and per come
//   from static shapes and the SM count (runtime/paged.py
//   paged_split_plan), never from lengths: a block whose pages lie past
//   lengths[s] returns at once, and the number of live blocks is
//   recomputed on the card from lengths[s].  Any g is covered by more
//   head groups on the grid.
// - A block streams its rows in chunks (PA_CHUNK_BYTES of K rows, as many
//   of V) through a two-stage shared-memory ring: every row of a chunk is
//   issued as 16-byte cp.async copies (neighbouring threads on
//   neighbouring 16 bytes of a row) before any is used, and the next
//   chunk's copies are in flight while a chunk is computed.  Rows are
//   stored with an XOR swizzle of their 16-byte vectors so that both
//   reads below are free of bank conflicts.
// - bf16 (D >= 16) on the tensor cores, mma.sync m16n8k16 with float32
//   sums: scores as K . q^T, a warp per 16-token tile, the group's (up to
//   8) heads as the n8 columns and q in registers; P.V as V^T . P^T, a warp
//   per 16-column tile of D, V by ldmatrix.trans and P split into three
//   bf16 parts (residual 2^-24 of p), each tile's product added to the
//   registers in IEEE float32, so the sums keep float32 precision.
//   float32 (and D 8) on the FMA units: a thread per token for the scores,
//   a thread per (token group, 16-byte column vector) for P.V, the token
//   groups summed at the end.  Softmax: a warp per head, max and sum by
//   shuffles, carried online from chunk to chunk (the P.V sums are
//   rescaled in registers).
// - Merge: a block writes its unnormalised output with its max and sum to
//   float32 scratch, then counts itself in an int32 arrival counter (fence,
//   atomicAdd, as K1's split-K does).  The last of the live blocks to
//   arrive rescales and sums the partials (16-byte loads, many in flight),
//   writes the output and resets the counter to zero, so the counters need
//   no memset launch.  A slot whose rows fit one block (or an inactive
//   slot, lengths 0, which writes zeros) writes its output directly.  One
//   launch per call.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int PA_THREADS = 128;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_GH = 8;              // query heads per block (head group)
constexpr int PA_CHUNK_BYTES = 16384;  // K bytes of a chunk (V as many)
constexpr int PA_MAX_CHUNK = 128;      // tokens of a chunk
constexpr int PA_MERGE_TILE = 256;     // partials weighed per merge step
// runtime/paged.py mirrors PA_GH, PA_CHUNK_BYTES and PA_MAX_CHUNK

template <typename T, int D>
struct PaShape {
  static constexpr int VEC = 16 / (int)sizeof(T);  // values per 16 bytes
  static constexpr int NV = D / VEC;               // 16-byte vectors a row
  static constexpr int CT_BYTES = PA_CHUNK_BYTES / (D * (int)sizeof(T));
  static constexpr int CT = CT_BYTES < PA_MAX_CHUNK ? CT_BYTES : PA_MAX_CHUNK;
  static constexpr int TG = PA_THREADS / NV;  // token groups of the P.V step
  static constexpr int RING = 4 * CT * NV;     // uint4s: 2 stages x (K, V)
  static constexpr int RED = PA_GH * PA_THREADS * VEC / 4;  // uint4s
  static constexpr int SCRATCH = RING > RED ? RING : RED;
  // the tensor-core path: bf16 rows of at least one k16 step
  static constexpr bool MMA = std::is_same<T, bf16>::value && D >= 16;
  static_assert(NV >= 1 && NV <= PA_THREADS && (NV & (NV - 1)) == 0,
                "row of 16-byte vectors");
  static_assert(PA_GH * PA_MERGE_TILE <= 4 * SCRATCH, "merge weights");
};

// position of vector v of chunk row i: rows of 8 or more vectors XOR their
// vector index with the row's low bits; shorter rows, several to a
// 128-byte line, with the line's index
template <int NV>
__device__ __forceinline__ int pa_swz(int i, int v) {
  constexpr int R = NV >= 8 ? 1 : 8 / NV;
  return i * NV + (v ^ ((i / R) & (NV - 1)));
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dynamic shared memory of one block, in bytes
template <typename T, int D>
constexpr size_t pa_smem_bytes() {
  using Sh = PaShape<T, D>;
  return sizeof(uint4) * Sh::SCRATCH +
         sizeof(float) * ((size_t)PA_GH * D      // q_s
                          + (size_t)PA_GH * Sh::CT  // s_s
                          + 3 * PA_GH);             // alpha, m, l
}

// p as the sum of three bf16 parts (residual about 2^-24 of p), packed in
// pairs for an mma B operand: part[k] holds (lo, hi) of part k
__device__ __forceinline__ void split3(float lo, float hi, uint32_t (&part)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bf16 l = __float2bfloat16_rn(lo), h = __float2bfloat16_rn(hi);
    lo -= __bfloat162float(l);
    hi -= __bfloat162float(h);
    part[k] = (uint32_t)__bfloat16_as_ushort(l) |
              ((uint32_t)__bfloat16_as_ushort(h) << 16);
  }
}

// grid (n_split, Hkv * n_hg, S).  With n_split > 1: part holds the
// partial outputs (pairs, n_split, PA_GH, D) then their (max, sum)
// (pairs, n_split, PA_GH, 2), float32, and arrivals (pairs,) int32 at zero,
// where pairs = S * Hkv * n_hg
template <typename T, int D>
__global__ void __launch_bounds__(PA_THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ lengths,
                    const int* __restrict__ tables, float* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ arrivals,
                    int H, int Hkv, int n_pages, int ps, int pp, int per,
                    float scale) {
  using Sh = PaShape<T, D>;
  constexpr int VEC = Sh::VEC, NV = Sh::NV, CT = Sh::CT, TG = Sh::TG;
  constexpr bool MMA = Sh::MMA;
  const int z = blockIdx.x, s = blockIdx.z;
  const int g = H / Hkv;
  const int n_hg = (g + PA_GH - 1) / PA_GH;
  const int kvh = blockIdx.y / n_hg;
  const int gh0 = (blockIdx.y % n_hg) * PA_GH;  // first head of the group
  const int gh = min(PA_GH, g - gh0);
  const int h0 = kvh * g + gh0;                 // first query head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* table = tables + (size_t)s * pp;
  const int len = min(max(lengths[s], 0), pp * ps);
  const int n_pg = (len + ps - 1) / ps;
  const int n_live = max(1, (n_pg + per - 1) / per);
  if (z >= n_live) return;  // pages past the slot's length
  const int t0 = z * per * ps;
  const int t_end = min(len, t0 + per * ps);
  const int n_chunks = (t_end - t0 + CT - 1) / CT;  // 0 when inactive

  extern __shared__ uint4 pa_sm[];
  uint4* ring = pa_sm;  // stage st: K at ring + 2*st*CT*NV, V after it
  float* q_s = reinterpret_cast<float*>(pa_sm + Sh::SCRATCH);  // GH x D
  float* s_s = q_s + PA_GH * D;                                // GH x CT
  float* alpha_s = s_s + PA_GH * CT;
  float* m_s = alpha_s + PA_GH;
  float* l_s = m_s + PA_GH;
  __shared__ int is_last;

  const T* k_rows = kp + (size_t)kvh * n_pages * ps * D;
  const T* v_rows = vp + (size_t)kvh * n_pages * ps * D;
  // chunk c's K and V rows into stage c & 1, one cp.async group (empty
  // past the last chunk, so that every wait below counts alike); rows past
  // the chunk's tokens, up to a whole 16-row tile, are zero-filled
  auto issue = [&](int c) {
    const int c0 = t0 + c * CT;
    const int nt = c < n_chunks ? min(CT, t_end - c0) : 0;
    const int rows = (nt + 15) & ~15;
    uint4* ks = ring + 2 * (c & 1) * CT * NV;
    uint4* vs = ks + CT * NV;
    const int v = tid % NV;  // a thread keeps its column vector
    for (int i = tid / NV; i < rows; i += PA_THREADS / NV) {
      const int t = c0 + i;
      const bool live = i < nt;
      const size_t row =
          live ? (size_t)__ldg(table + t / ps) * ps + t % ps : 0;
      const int o = pa_swz<NV>(i, v);
      cp_async16(smem_u32(ks + o), k_rows + row * D + v * VEC, live ? 16 : 0);
      cp_async16(smem_u32(vs + o), v_rows + row * D + v * VEC, live ? 16 : 0);
    }
    cp_async_commit();
  };
  issue(0);  // rows in flight first
  issue(1);

  const int fg = lane >> 2, ft = lane & 3;  // mma fragment row, column pair
  // MMA: q of head fg as the B operand (k16 steps over D), in registers
  uint32_t qb[MMA ? D / 16 : 1][2];
  if constexpr (MMA) {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        q + ((size_t)s * H + h0 + min(fg, gh - 1)) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qb[kk][0] = fg < gh ? __ldg(qr + kk * 8 + ft) : 0u;
      qb[kk][1] = fg < gh ? __ldg(qr + kk * 8 + 4 + ft) : 0u;
    }
  } else {
    const T* qh = q + ((size_t)s * H + h0) * D;
    for (int i = tid; i < PA_GH * D; i += PA_THREADS)
      q_s[i] = i < gh * D ? to_f32(qh[i]) : 0.f;
  }
  if (tid < PA_GH) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // P.V sums, kept in registers across chunks.  MMA: warp w owns the
  // 16-column d tiles w, w + 4, ... (fragment rows d, columns heads).
  // SIMT: thread (token group tg, column vector v), summed at the end.
  constexpr int DTW = MMA ? (D / 16 + PA_WARPS - 1) / PA_WARPS : 1;
  float oacc[DTW][4];
  const int pv_v = tid % NV, pv_tg = tid / NV;
  float acc[MMA ? 1 : PA_GH][VEC];
#pragma unroll
  for (int j = 0; j < DTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
#pragma unroll
  for (int h = 0; h < (MMA ? 1 : PA_GH); ++h)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[h][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int nt = min(CT, t_end - t0 - c * CT);
    const int n_tiles = (nt + 15) / 16;
    const uint4* ks = ring + 2 * (c & 1) * CT * NV;
    const uint4* vs = ks + CT * NV;
    cp_async_wait<1>();  // chunk c's rows (chunk c + 1 may still fly)
    __syncthreads();
    if constexpr (MMA) {
      // scores: a warp per 16-token tile, tokens x heads = K . q^T
      for (int tile = warp; tile < n_tiles; tile += PA_WARPS) {
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
        const int mi = lane >> 3;
        const int i = tile * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, smem_u32(ks + pa_swz<NV>(i, 2 * kk + (mi >> 1))));
          mma_bf16_16816(sc, a, qb[kk][0], qb[kk][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ti = tile * 16 + fg + (e >> 1) * 8, h = 2 * ft + (e & 1);
          if (ti < nt && h < gh) s_s[h * CT + ti] = sc[e] * scale;
        }
      }
    } else {
      // scores: a thread per token
      for (int i = tid; i < nt; i += PA_THREADS) {
        float dot[PA_GH];
#pragma unroll
        for (int h = 0; h < PA_GH; ++h) dot[h] = 0.f;
#pragma unroll 4
        for (int v = 0; v < NV; ++v) {
          float kf[VEC];
          unpack(ks[pa_swz<NV>(i, v)], kf);
#pragma unroll
          for (int h = 0; h < PA_GH; ++h) {
            if (h < gh) {
              const float4* qv =
                  reinterpret_cast<const float4*>(q_s + h * D + v * VEC);
#pragma unroll
              for (int e = 0; e < VEC / 4; ++e) {
                const float4 qq = qv[e];
                dot[h] += qq.x * kf[4 * e] + qq.y * kf[4 * e + 1] +
                          qq.z * kf[4 * e + 2] + qq.w * kf[4 * e + 3];
              }
            }
          }
        }
#pragma unroll
        for (int h = 0; h < PA_GH; ++h)
          if (h < gh) s_s[h * CT + i] = dot[h] * scale;
      }
    }
    __syncthreads();
    // online softmax: a warp per head
    for (int h = warp; h < gh; h += PA_WARPS) {
      float mx = -INFINITY;
      for (int i = lane; i < nt; i += 32) mx = fmaxf(mx, s_s[h * CT + i]);
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int i = lane; i < nt; i += 32) {
        const float p = expf(s_s[h * CT + i] - m_new);
        s_s[h * CT + i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);  // 0 on the first chunk
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
        alpha_s[h] = alpha;
      }
    }
    __syncthreads();
    if constexpr (MMA) {
      // P.V as V^T . P^T: A = V rows by ldmatrix.trans, B = P in three
      // bf16 parts; each tile's product is summed in IEEE float32
      const float a0 = 2 * ft < gh ? alpha_s[2 * ft] : 0.f;
      const float a1 = 2 * ft + 1 < gh ? alpha_s[2 * ft + 1] : 0.f;
#pragma unroll
      for (int j = 0; j < DTW; ++j) {
        oacc[j][0] *= a0;
        oacc[j][1] *= a1;
        oacc[j][2] *= a0;
        oacc[j][3] *= a1;
      }
      for (int tile = 0; tile < n_tiles; ++tile) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ti = tile * 16 + 2 * ft + (e & 1) + (e >> 1) * 8;
          p[e] = fg < gh && ti < nt ? s_s[fg * CT + ti] : 0.f;
        }
        uint32_t b0[3], b1[3];
        split3(p[0], p[1], b0);
        split3(p[2], p[3], b1);
        const int mi = lane >> 3;
        const int i = tile * 16 + (mi >> 1) * 8 + (lane & 7);
#pragma unroll
        for (int j = 0; j < DTW; ++j) {
          const int dt = warp + j * PA_WARPS;
          if (dt < D / 16) {
            uint32_t a[4];
            ldmatrix_x4_trans(a,
                              smem_u32(vs + pa_swz<NV>(i, 2 * dt + (mi & 1))));
            float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int k = 0; k < 3; ++k) mma_bf16_16816(f, a, b0[k], b1[k]);
#pragma unroll
            for (int e = 0; e < 4; ++e) oacc[j][e] += f[e];
          }
        }
      }
    } else {
      // P.V into the registers, rescaled by the heads' new max
#pragma unroll
      for (int h = 0; h < PA_GH; ++h) {
        const float alpha = h < gh ? alpha_s[h] : 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][e] *= alpha;
      }
      for (int i = pv_tg; i < nt; i += TG) {
        float vf[VEC];
        unpack(vs[pa_swz<NV>(i, pv_v)], vf);
#pragma unroll
        for (int h = 0; h < PA_GH; ++h) {
          if (h < gh) {
            const float p = s_s[h * CT + i];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[h][e] += p * vf[e];
          }
        }
      }
    }
    __syncthreads();  // the stage is read: chunk c + 2 may refill it
    issue(c + 2);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* o = out + ((size_t)s * H + h0) * D;
  const int n_split = gridDim.x;
  const size_t pairs = (size_t)gridDim.z * gridDim.y;
  const size_t pair = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  float* pacc = part + pair * n_split * PA_GH * D;
  float* pml = part + pairs * n_split * PA_GH * D + pair * n_split * PA_GH * 2;
  // this block's sum for (head h, column d): the output itself when the
  // slot's rows fit this block (or lengths == 0), else its partial
  auto put = [&](int h, int d, float val) {
    if (n_live == 1) {
      const float l = l_s[h];
      o[h * D + d] = val / (l == 0.f ? 1.f : l);
    } else {
      pacc[(size_t)z * PA_GH * D + h * D + d] = val;
    }
  };
  if constexpr (MMA) {
#pragma unroll
    for (int j = 0; j < DTW; ++j) {
      const int dt = warp + j * PA_WARPS;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 2 * ft + (e & 1);
        if (dt < D / 16 && h < gh) put(h, dt * 16 + fg + (e >> 1) * 8,
                                       oacc[j][e]);
      }
    }
  } else {
    // the token groups' sums, through the ring's memory
    float* red = reinterpret_cast<float*>(ring);  // TG x GH x D
#pragma unroll
    for (int h = 0; h < PA_GH; ++h) {
      if (h < gh) {
        float4* r = reinterpret_cast<float4*>(
            red + (pv_tg * PA_GH + h) * D + pv_v * VEC);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e)
          r[e] = make_float4(acc[h][4 * e], acc[h][4 * e + 1],
                             acc[h][4 * e + 2], acc[h][4 * e + 3]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < gh * D; idx += PA_THREADS) {
      float sum = 0.f;
      for (int tg = 0; tg < TG; ++tg) sum += red[tg * PA_GH * D + idx];
      put(idx / D, idx % D, sum);
    }
  }
  if (n_live == 1) return;
  if (tid < gh) {
    pml[(z * PA_GH + tid) * 2] = m_s[tid];
    pml[(z * PA_GH + tid) * 2 + 1] = l_s[tid];
  }
  __threadfence();  // the partial is visible before the arrival counts
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(arrivals + pair, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // merge: per head the largest max and the rescaled sum (a warp per head)
  for (int h = warp; h < gh; h += PA_WARPS) {
    float mx = -INFINITY;
    for (int zz = lane; zz < n_live; zz += 32)
      mx = fmaxf(mx, __ldcg(pml + (zz * PA_GH + h) * 2));
    mx = warp_max(mx);
    float l = 0.f;
    for (int zz = lane; zz < n_live; zz += 32)
      l += __ldcg(pml + (zz * PA_GH + h) * 2 + 1) *
           expf(__ldcg(pml + (zz * PA_GH + h) * 2) - mx);
    l = warp_sum(l);
    if (lane == 0) {
      m_s[h] = mx;
      l_s[h] = l;
    }
  }
  // then the weighed partials, PA_MERGE_TILE at a time: weights exp(max -
  // largest max) / sum in shared memory, each thread a 16-byte column group
  float* w_s = reinterpret_cast<float*>(ring);  // PA_MERGE_TILE x GH
  constexpr int D4 = D / 4;
  float4 o4[(PA_GH * D4 + PA_THREADS - 1) / PA_THREADS];
#pragma unroll
  for (int j = 0; j < (PA_GH * D4 + PA_THREADS - 1) / PA_THREADS; ++j)
    o4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z0 = 0; z0 < n_live; z0 += PA_MERGE_TILE) {
    const int nz = min(PA_MERGE_TILE, n_live - z0);
    __syncthreads();  // m_s, l_s ready; the previous tile's weights read
    for (int i = tid; i < nz * gh; i += PA_THREADS) {
      const int zz = i / gh, h = i % gh;
      w_s[zz * PA_GH + h] =
          expf(__ldcg(pml + ((z0 + zz) * PA_GH + h) * 2) - m_s[h]) / l_s[h];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < (PA_GH * D4 + PA_THREADS - 1) / PA_THREADS; ++j) {
      const int i4 = tid + j * PA_THREADS;  // float4 index in GH x D
      if (i4 < gh * D4) {
        const int h = i4 / D4;
        const float4* src = reinterpret_cast<const float4*>(
                                pacc + (size_t)z0 * PA_GH * D) + i4;
        float4 a = o4[j];
#pragma unroll 8
        for (int zz = 0; zz < nz; ++zz) {
          const float4 p = __ldcg(src + (size_t)zz * PA_GH * D4);
          const float w = w_s[zz * PA_GH + h];
          a.x += p.x * w;
          a.y += p.y * w;
          a.z += p.z * w;
          a.w += p.w * w;
        }
        o4[j] = a;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < (PA_GH * D4 + PA_THREADS - 1) / PA_THREADS; ++j) {
    const int i4 = tid + j * PA_THREADS;
    if (i4 < gh * D4) reinterpret_cast<float4*>(o)[i4] = o4[j];
  }
  if (tid == 0) arrivals[pair] = 0;  // ready for the next call
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* lengths, const int* tables, float* out,
                   float* part, int* arrivals, int S, int H, int Hkv,
                   int n_pages, int ps, int pp, int n_split, int per,
                   float scale, cudaStream_t st) {
  constexpr size_t smem = pa_smem_bytes<T, D>();
  cudaError_t e = sck_allow_smem(paged_decode_kernel<T, D>, smem);
  if (e == cudaSuccess)  // room for as many blocks per SM as fit
    e = cudaFuncSetAttribute(paged_decode_kernel<T, D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const int n_hg = (H / Hkv + PA_GH - 1) / PA_GH;
  dim3 grid(n_split, Hkv * n_hg, S);
  paged_decode_kernel<T, D><<<grid, PA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), lengths, tables, out, part, arrivals, H, Hkv,
      n_pages, ps, pp, per, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp,
                       const int* lengths, const int* tables, float* out,
                       float* part, int* arrivals, int S, int H, int Hkv,
                       int n_pages, int ps, int pp, int n_split, int per,
                       float scale, cudaStream_t st) {
#define SCK_PA_CASE(DD)                                                     \
  case DD:                                                                  \
    return launch<T, DD>(q, kp, vp, lengths, tables, out, part, arrivals,   \
                         S, H, Hkv, n_pages, ps, pp, n_split, per, scale,   \
                         st);
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

// n_split blocks of `per` pages each cover the table's pp pages; with
// n_split > 1, `part` and `arrivals` are as the kernel says
extern "C" int sck_paged_attention(const void* q, const void* kp,
                                   const void* vp, const void* lengths,
                                   const void* tables, void* out, void* part,
                                   void* arrivals, int S, int H, int Hkv,
                                   int n_pages, int ps, int D, int pp,
                                   int n_split, int per, float scale,
                                   int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || ps <= 0 || pp <= 0 || per <= 0 ||
      n_split <= 0 || (long long)n_split * per < pp ||
      (n_split > 1 && !(part && arrivals)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(part);
  int* arr = static_cast<int*>(arrivals);
  cudaError_t e =
      (dtype == SCK_BF16)
          ? dispatch_d<bf16>(D, q, kp, vp, len, tab, o, pa, arr, S, H, Hkv,
                             n_pages, ps, pp, n_split, per, scale, st)
          : dispatch_d<float>(D, q, kp, vp, len, tab, o, pa, arr, S, H, Hkv,
                              n_pages, ps, pp, n_split, per, scale, st);
  return (int)e;
}
