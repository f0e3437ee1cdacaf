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
// Two variants; the wrapper (ops/attention.py flash_variant) picks one from
// the dtype and D, never on failure:
//
// * "mma" (bfloat16, D in {64, 128}): tensor cores.  mma.sync m16n8k16 bf16
//   with ldmatrix, FlashAttention-2's register layout, rather than wgmma:
//   the main-path shape (L <= 256) gives a block too little work to fill
//   a 64-row warpgroup tile per warp and still have ~132 blocks, and
//   mma.sync keeps the per-row softmax state in the registers of one warp.
//   One block per (32-query tile, head, batch), so B1 L128 H32 is 128
//   blocks, about one per SM; 4 warps: two row groups of 16 queries times
//   two halves of each 64-key tile, so all 4 sub-partitions of an SM have
//   a warp and the chain of dependent steps per warp is half a tile long.
//   The two halves of a row group are merged at the end (max, sum and
//   accumulator, as the online softmax merges tiles).  K/V tiles are
//   copied in bf16 with 16-byte cp.async into a 2-stage ring (the next
//   tile loads while this one is used), rows XOR-swizzled in 16-byte chunks
//   so ldmatrix reads them without bank conflicts; Q is copied once and
//   kept as A fragments in registers; the running max and sum stay in
//   registers (per row, reduced over the 4 lanes of a quad).
//   Precision follows the reference's float32 arithmetic closely, since a
//   bf16 output that rounds the other way moves the next layer's int8
//   activations: each mma starts from a zero accumulator and is added to
//   S or O in IEEE float32 (the tensor cores sum only the 16 products of
//   one k-step); bf16 x bf16 products are exact in f32; exp is expf of the
//   scaled scores minus the running max, as in the reference; and P keeps
//   its float32 value: it is split into p1 = bf16(p), p2 = bf16(p - p1),
//   p3 = bf16(p - p1 - p2) (error about 2^-27 of p), the three go through
//   the tensor cores against the same V fragment and are summed smallest
//   first.  When causal, a block stops after the tile holding its last
//   row's diagonal and a warp skips the tiles past its own rows.
// * "simt" (float32, and any other D): float32 FMA.  One block per
//   (16-query tile, head, batch), 128 threads, float32 tiles of 32 keys in
//   shared memory, a float32 FMA dot product per score.
//
// Bound on the H100: at the slice's prefill shapes (L <= 256, D = 128) the
// work is 4*B*H*L*L*D/2 flops (causal) against q, k, v and out bytes; both
// are small (under a microsecond), so the kernel is bound by its own
// latency: one K/V tile load and the chain of mma, exp and shuffles.
#include "common.cuh"

namespace {

// ---- "simt" variant -------------------------------------------------------

constexpr int FA_BQ = 16;
constexpr int FA_BK = 32;
constexpr int FA_THREADS = 128;  // 8 threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int L,
                      int H, int Hkv, float scale, int causal) {
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

// ---- "mma" variant --------------------------------------------------------

constexpr int FM_BQ = 32;  // query rows per block: 2 row groups of 16
constexpr int FM_BK = 64;  // keys per tile: 2 halves of 32
constexpr int FM_KB = FM_BK / 2;
constexpr int FM_THREADS = 128;  // warp w: row group w & 1, key half w >> 1

// shared-memory index (in 16-byte chunks) of chunk c of row r in a tile of
// rows of D bf16 (D / 8 chunks): XOR-swizzled so that the 8 rows one
// ldmatrix matrix reads land in 8 different bank groups
template <int D>
__device__ __forceinline__ int fm_swz(int r, int c) {
  return r * (D / 8) + (c ^ (r & 7));
}

// copy rows [row0, row0 + R) of head `hd` of x (B, L, HX, D) into a tile;
// rows past L are zero-filled
template <int D, int R>
__device__ __forceinline__ void fm_load_tile(uint4* tile, const bf16* x,
                                             int b, int row0, int L, int HX,
                                             int hd) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < R * C; i += FM_THREADS) {
    const int r = i / C, c = i % C;
    const int gr = row0 + r;
    const bool in = gr < L;
    const bf16* src =
        x + (((size_t)b * L + (in ? gr : 0)) * HX + hd) * D + c * 8;
    cp_async16(smem_u32(tile + fm_swz<D>(r, c)), src, in ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(FM_THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int L, int H, int Hkv, float scale, int causal) {
  constexpr int C = D / 8;    // 16-byte chunks per row
  constexpr int KD = D / 16;  // k-steps of QK^T
  constexpr int NS = FM_KB / 8;   // 8-key column tiles of S per warp
  constexpr int NO = D / 8;       // 8-wide column tiles of O
  const int q0 = blockIdx.x * FM_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad_row = lane >> 2;  // row of c0/c1 within the warp's 16
  const int quad_col = (lane & 3) * 2;

  extern __shared__ uint4 fm_sm[];
  uint4* sq = fm_sm;                  // FM_BQ x C
  uint4* sk = sq + FM_BQ * C;         // 2 stages x FM_BK x C
  uint4* sv = sk + 2 * FM_BK * C;     // 2 stages x FM_BK x C

  const int q_last = min(q0 + FM_BQ, L) - 1;
  const int k_end = causal ? q_last + 1 : L;
  const int n_tiles = (k_end + FM_BK - 1) / FM_BK;
  const int rg = warp & 1, kh = warp >> 1;
  const int w_first = q0 + rg * 16;  // this warp's rows
  const int w_last = w_first + 15;
  const int kb = kh * FM_KB;         // and its keys within each tile

  fm_load_tile<D, FM_BQ>(sq, q, b, q0, L, H, h);
  fm_load_tile<D, FM_BK>(sk, k, b, 0, L, Hkv, kvh);
  fm_load_tile<D, FM_BK>(sv, v, b, 0, L, Hkv, kvh);
  cp_async_commit();

  uint32_t qf[KD][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows r and r + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the sums

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int st = (t + 1) & 1;
      fm_load_tile<D, FM_BK>(sk + st * FM_BK * C, k, b, (t + 1) * FM_BK, L,
                             Hkv, kvh);
      fm_load_tile<D, FM_BK>(sv + st * FM_BK * C, v, b, (t + 1) * FM_BK, L,
                             Hkv, kvh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      // A fragments of this warp's 16 query rows, one per k-step of 16
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int mat = lane >> 3;
        const int r = rg * 16 + (mat & 1) * 8 + (lane & 7);
        ldmatrix_x4(qf[kk], smem_u32(sq + fm_swz<D>(r, 2 * kk + (mat >> 1))));
      }
    }
    const int k0 = t * FM_BK + kb;  // this warp's first key
    if (!(causal && k0 > w_last)) {
      const uint4* tk = sk + (t & 1) * FM_BK * C;
      const uint4* tv = sv + (t & 1) * FM_BK * C;
      // S = Q K^T (16 x 32 per warp), float32
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          const int mat = lane >> 3;
          const int r = kb + j * 8 + (mat >> 1) * 8 + (lane & 7);
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_u32(tk + fm_swz<D>(r, 2 * kk + (mat & 1))));
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16_16816(t0, qf[kk], bk[0], bk[1]);
          mma_bf16_16816(t1, qf[kk], bk[2], bk[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] += t0[e];
            s[j + 1][e] += t1[e];
          }
        }
      }
      // mask, scale and the tile's row max
      const int qi0 = w_first + quad_row, qi1 = qi0 + 8;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ki = k0 + j * 8 + quad_col + e;
          const bool ok0 = ki < L && (!causal || ki <= qi0);
          const bool ok1 = ki < L && (!causal || ki <= qi1);
          s[j][e] = ok0 ? s[j][e] * scale : -INFINITY;
          s[j][e + 2] = ok1 ? s[j][e + 2] * scale : -INFINITY;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][e + 2]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with nothing unmasked yet keeps max -inf: use 0 as its base
      // so that exp gives 0 for the masked scores, not NaN
      const float b0 = mn0 == -INFINITY ? 0.f : mn0;
      const float b1 = mn1 == -INFINITY ? 0.f : mn1;
      const float a0 = expf(m0 - b0), a1 = expf(m1 - b1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][0] = expf(s[j][0] - b0);
        s[j][1] = expf(s[j][1] - b0);
        s[j][2] = expf(s[j][2] - b1);
        s[j][3] = expf(s[j][3] - b1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
      // O += P V: the C fragments of two S column tiles are the A fragment
      // of one 16-key k-step.  P = p1 + p2 + p3, each bf16, each exact
      // remainder of the last (error about 2^-27 of p); each part's
      // product goes through the tensor cores into a fresh accumulator and
      // the three are added to O in IEEE float32, smallest first
#pragma unroll
      for (int kk = 0; kk < FM_KB / 16; ++kk) {
        uint32_t pa[3][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* p = s[2 * kk + half];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float x0 = p[2 * rr], x1 = p[2 * rr + 1];
#pragma unroll
            for (int part = 0; part < 3; ++part) {
              const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
              pa[part][2 * half + rr] =
                  *reinterpret_cast<const uint32_t*>(&hb);
              x0 -= __low2float(hb);
              x1 -= __high2float(hb);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          const int mat = lane >> 3;
          const int r = kb + kk * 16 + (mat & 1) * 8 + (lane & 7);
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_u32(tv + fm_swz<D>(r, n + (mat >> 1))));
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float t[3][4];
#pragma unroll
            for (int part = 0; part < 3; ++part) {
#pragma unroll
              for (int e = 0; e < 4; ++e) t[part][e] = 0.f;
              mma_bf16_16816(t[part], pa[part], bv[2 * h2], bv[2 * h2 + 1]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[n + h2][e] += (t[2][e] + t[1][e]) + t[0][e];
          }
        }
      }
    }
    __syncthreads();  // this stage is read; the next load may overwrite it
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // merge the two key halves of each row group: warp (rg, 1) hands its
  // running max, sum and accumulator to warp (rg, 0), lane to lane,
  // through the K/V ring (free after the loop's last barrier)
  constexpr int XW = NO * 4 + 4;  // floats per lane
  float* xch = reinterpret_cast<float*>(sk) + rg * XW * 32 + lane;
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(n * 4 + e) * 32] = o[n][e];
    xch[(NO * 4 + 0) * 32] = m0;
    xch[(NO * 4 + 1) * 32] = m1;
    xch[(NO * 4 + 2) * 32] = l0;
    xch[(NO * 4 + 3) * 32] = l1;
  }
  __syncthreads();
  if (kh == 1) return;
  {
    const float p0 = xch[(NO * 4 + 0) * 32], p1 = xch[(NO * 4 + 1) * 32];
    const float mm0 = fmaxf(m0, p0), mm1 = fmaxf(m1, p1);
    const float b0 = mm0 == -INFINITY ? 0.f : mm0;
    const float b1 = mm1 == -INFINITY ? 0.f : mm1;
    const float sa0 = expf(m0 - b0), sb0 = expf(p0 - b0);
    const float sa1 = expf(m1 - b1), sb1 = expf(p1 - b1);
    l0 = l0 * sa0 + xch[(NO * 4 + 2) * 32] * sb0;
    l1 = l1 * sa1 + xch[(NO * 4 + 3) * 32] * sb1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] = o[n][0] * sa0 + xch[(n * 4 + 0) * 32] * sb0;
      o[n][1] = o[n][1] * sa0 + xch[(n * 4 + 1) * 32] * sb0;
      o[n][2] = o[n][2] * sa1 + xch[(n * 4 + 2) * 32] * sb1;
      o[n][3] = o[n][3] * sa1 + xch[(n * 4 + 3) * 32] * sb1;
    }
  }
  const float d0 = l0 == 0.f ? 1.f : l0;
  const float d1 = l1 == 0.f ? 1.f : l1;
  const int qi0 = w_first + quad_row, qi1 = qi0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + quad_col;
    if (qi0 < L)
      *reinterpret_cast<uint32_t*>(out + (((size_t)b * L + qi0) * H + h) * D +
                                   d) = pack_bf16(o[n][0] / d0, o[n][1] / d0);
    if (qi1 < L)
      *reinterpret_cast<uint32_t*>(out + (((size_t)b * L + qi1) * H + h) * D +
                                   d) = pack_bf16(o[n][2] / d1, o[n][3] / d1);
  }
}

// ---- launch ----------------------------------------------------------------

enum { FA_SIMT = 0, FA_MMA = 1 };  // ops/attention.py flash_variant codes

template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, int B, int L, int H, int Hkv, int causal,
                        float scale, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)FA_BQ * (D + 1) + (size_t)FA_BK * (D + 1) +
                       (size_t)FA_BK * D + (size_t)FA_BQ * FA_BK);
  cudaError_t e = sck_allow_smem(flash_fwd_simt_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((L + FA_BQ - 1) / FA_BQ, H, B);
  flash_fwd_simt_kernel<T, D><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), L, H, Hkv, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int B, int L, int H, int Hkv, int causal, float scale,
                       cudaStream_t st) {
  const size_t smem = sizeof(uint4) * (size_t)(FM_BQ + 4 * FM_BK) * (D / 8);
  cudaError_t e = sck_allow_smem(flash_fwd_mma_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((L + FM_BQ - 1) / FM_BQ, H, B);
  flash_fwd_mma_kernel<D><<<grid, FM_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), L, H, Hkv,
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_simt(int D, const void* q, const void* k, const void* v,
                          void* out, int B, int L, int H, int Hkv, int causal,
                          float scale, cudaStream_t st) {
#define SCK_FA_CASE(DD)                                                  \
  case DD:                                                               \
    return launch_simt<T, DD>(q, k, v, out, B, L, H, Hkv, causal, scale, \
                              st);
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
                                   float scale, int dtype, int variant,
                                   void* stream) {
  if (H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == FA_MMA) {
    if (dtype != SCK_BF16) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 64:
        return (int)launch_mma<64>(q, k, v, out, B, L, H, Hkv, causal, scale,
                                   st);
      case 128:
        return (int)launch_mma<128>(q, k, v, out, B, L, H, Hkv, causal,
                                    scale, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  cudaError_t e =
      (dtype == SCK_BF16)
          ? dispatch_simt<bf16>(D, q, k, v, out, B, L, H, Hkv, causal, scale,
                                st)
          : dispatch_simt<float>(D, q, k, v, out, B, L, H, Hkv, causal,
                                 scale, st);
  return (int)e;
}
