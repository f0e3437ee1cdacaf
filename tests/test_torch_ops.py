"""Port kernels' plain versions against the JAX reference on the CPU.

The same numpy inputs (fixed seeds) go through the reference function and
its counterpart in ``seldon_core_tpu_torch``.  Where the reference reaches a
Pallas kernel it runs in interpret mode, as the JAX package's own tests run
it on the CPU.  Tolerances are stated per check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.ops import attention as jattn
from seldon_core_tpu.ops import quant as jquant
from seldon_core_tpu.runtime import paged as jpaged
from seldon_core_tpu_torch.ops import _build
from seldon_core_tpu_torch.ops import attention as tattn
from seldon_core_tpu_torch.ops import quant as tquant
from seldon_core_tpu_torch.runtime import paged as tpaged


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestInt8:
    def test_quantize_int8_exact(self):
        w = np.random.default_rng(0).normal(size=(64, 48)).astype(np.float32)
        w[:, 3] = 0.0  # an all-zero column takes scale 1
        j = jquant.quantize_int8(jnp.asarray(w))
        t = tquant.quantize_int8(_t(w))
        np.testing.assert_array_equal(np.asarray(j.values), t.values.numpy())
        np.testing.assert_array_equal(np.asarray(j.scales), t.scales.numpy())

    # (M 8, N 128) and (M 16, N 256) tile into the reference's Pallas
    # kernel (interpret mode); (M 5, N 64) takes its shape fallback.  The
    # port's plain version equals the reference's fallback math EXACTLY in
    # float32 (the product is integer, xs a true division).  The reference's
    # interpret-mode kernel computes xs as absmax * (1/127) (XLA rewrites the
    # division), so against it the outputs may differ by up to 2 float32
    # ulps: one ulp of xs carried through two multiplies.
    @pytest.mark.parametrize("M,K,N", [(8, 64, 128), (5, 64, 64),
                                       (16, 128, 256)])
    def test_int8_matmul_f32(self, M, K, N):
        rng = np.random.default_rng(M * 1000 + N)
        x = rng.normal(size=(M, K)).astype(np.float32)
        x[1] = 0.0  # a zero row takes xs = 1
        w = rng.normal(size=(K, N)).astype(np.float32)
        jq = jquant.quantize_int8(jnp.asarray(w))
        # block_n=96 never tiles N, so this is the reference's fallback path
        fallback = jquant.int8_matmul(jnp.asarray(x), jq, block_n=96,
                                      interpret=True)
        kernel = jquant.int8_matmul(jnp.asarray(x), jq, interpret=True)
        tq = tquant.quantize_int8(_t(w))
        out = tquant.int8_matmul(_t(x), tq)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(fallback), out.numpy())
        np.testing.assert_array_max_ulp(np.asarray(kernel), out.numpy(),
                                        maxulp=2)

    def test_int8_matmul_bf16_exact(self):
        """bf16 activations in and out: the same float32 arithmetic, then
        one round-to-nearest-even cast on both sides (exact equality)."""
        rng = np.random.default_rng(3)
        x = rng.normal(size=(8, 64)).astype(np.float32)
        w = rng.normal(size=(64, 128)).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        ref = jquant.int8_matmul(xb, jquant.quantize_int8(jnp.asarray(w)),
                                 block_n=96, interpret=True)
        out = tquant.int8_matmul(_t(x).to(torch.bfloat16),
                                 tquant.quantize_int8(_t(w)))
        np.testing.assert_array_equal(
            np.asarray(ref.astype(jnp.float32)), out.float().numpy())

    def test_leading_dims_and_out_dtype(self):
        rng = np.random.default_rng(4)
        x = rng.normal(size=(2, 3, 32)).astype(np.float32)
        w = rng.normal(size=(32, 16)).astype(np.float32)
        ref = jquant.int8_matmul(jnp.asarray(x),
                                 jquant.quantize_int8(jnp.asarray(w)),
                                 interpret=True)  # M 6: the fallback path
        out = tquant.int8_matmul(_t(x), tquant.quantize_int8(_t(w)))
        assert tuple(out.shape) == (2, 3, 16)
        np.testing.assert_array_equal(np.asarray(ref), out.numpy())

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        q = tquant.quantize_int8(torch.ones(8, 8))
        with pytest.raises(ValueError, match="on the card"):
            tquant.int8_matmul_cuda(torch.ones(4, 8), q.values, q.scales,
                                    torch.float32)

    @pytest.mark.parametrize("K,N", [(64, 48), (16, 8), (128, 256)])
    def test_quantize_int8_is_k_major(self, K, N):
        """values keep the reference's (K, N) shape, stored K-major: the
        .t() view of a contiguous (N, K) buffer, strides (1, K)."""
        w = np.random.default_rng(K + N).normal(size=(K, N)).astype(
            np.float32)
        q = tquant.quantize_int8(_t(w))
        assert tuple(q.values.shape) == (K, N)
        assert q.values.stride() == (1, K)
        assert q.values.t().is_contiguous()
        assert tquant.is_k_major(q.values)
        np.testing.assert_array_equal(
            q.values.numpy(), np.asarray(jquant.quantize_int8(
                jnp.asarray(w)).values))

    def test_k_major_helpers(self):
        rowmajor = torch.arange(96, dtype=torch.int8).reshape(8, 12)
        assert not tquant.is_k_major(rowmajor)
        km = tquant.k_major(rowmajor)
        assert tquant.is_k_major(km) and torch.equal(km, rowmajor)

    # The port's plain version on the K-major view against the reference's
    # fallback (block_n=96 never tiles N): bit for bit, float32 and bf16
    # activations (bf16: the same float32 arithmetic, one rounding)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("M,K,N", [(8, 64, 128), (33, 128, 48)])
    def test_int8_matmul_ref_on_k_major_equals_fallback(self, dtype, M, K,
                                                        N):
        rng = np.random.default_rng(M + K + N)
        x = rng.normal(size=(M, K)).astype(np.float32)
        x[2] = 0.0
        w = rng.normal(size=(K, N)).astype(np.float32)
        tq = tquant.quantize_int8(_t(w))
        assert tq.values.stride() == (1, K)
        jx = jnp.asarray(x, getattr(jnp, dtype))
        ref = jquant.int8_matmul(jx, jquant.quantize_int8(jnp.asarray(w)),
                                 block_n=96, interpret=True)
        tdt = getattr(torch, dtype)
        out = tquant.int8_matmul_ref(_t(x).to(tdt), tq.values, tq.scales,
                                     tdt)
        assert out.dtype == tdt
        np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)),
                                      out.float().numpy())

    @pytest.mark.parametrize("M,variant", [(1, "mma_gemv"), (8, "mma_gemv"),
                                           (16, "mma_gemv"),
                                           (17, "mma_gemm"),
                                           (128, "mma_gemm")])
    def test_int8_variant_rule(self, M, variant):
        assert tquant.int8_variant(M) == variant

    # "mma_gemm" plan on a 132-SM card at the 7B prefill shapes and ragged
    # ones: (tile rows, K splits); splits fill at most one block per SM and
    # keep at least two 128-byte k-tiles each; fewer tile rows where the
    # tiles, split at most 4 ways, would leave half the SMs idle
    @pytest.mark.parametrize("M,K,N,plan", [
        (128, 4096, 16384, (128, 1)), (128, 16384, 4096, (128, 4)),
        (128, 4096, 4096, (128, 4)), (128, 4096, 1024, (32, 4)),
        (128, 4096, 32000, (128, 1)), (32, 4096, 1024, (32, 16)),
        (32, 16384, 4096, (32, 4)), (64, 1040, 4096, (64, 4)),
        (128, 1040, 4096, (128, 4)), (17, 4112, 1000, (32, 16)),
        (65, 2064, 999, (32, 4)), (200, 80, 48, (32, 1))])
    def test_gemm_plan(self, M, K, N, plan):
        got = tquant.gemm_plan(M, K, N, 132)
        assert (got.bm, got.splits) == plan
        bm, splits = plan
        tiles = -(-M // bm) * -(-N // 128)
        assert splits == 1 or tiles * splits <= 132


class TestFlash:
    # float32 end to end; the two differ only in summation order (online
    # softmax vs dense), so atol 1e-5 at unit-variance inputs
    @pytest.mark.parametrize("L", [16, 24])
    @pytest.mark.parametrize("causal", [True, False])
    def test_flash_ref_matches_reference_kernel(self, L, causal):
        rng = np.random.default_rng(L + causal)
        q, k, v = (rng.normal(size=(2, L, 4, 16)).astype(np.float32)
                   for _ in range(3))
        ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    block_q=8, block_k=8, interpret=True)
        out = tattn.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)

    def test_gqa_unexpanded_kv_equals_expanded(self):
        """The port passes K/V at kv_heads (the kernel reads head h // g);
        the reference repeats them first.  Same numbers (atol 1e-5)."""
        rng = np.random.default_rng(7)
        q = rng.normal(size=(1, 16, 4, 8)).astype(np.float32)
        k, v = (rng.normal(size=(1, 16, 2, 8)).astype(np.float32)
                for _ in range(2))
        ref = jattn.flash_attention(
            jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=2),
            jnp.repeat(jnp.asarray(v), 2, axis=2), causal=True, block_q=8,
            block_k=8, interpret=True)
        out = tattn.flash_attention(_t(q), _t(k), _t(v), causal=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)

    @pytest.mark.parametrize("dtype,D,variant", [
        (torch.bfloat16, 128, "mma"), (torch.bfloat16, 64, "mma"),
        (torch.bfloat16, 32, "simt"), (torch.bfloat16, 256, "simt"),
        (torch.float32, 128, "simt"), (torch.float32, 16, "simt")])
    def test_flash_variant_rule(self, dtype, D, variant):
        """The tensor-core variant takes bf16 at its head dims; every other
        case keeps the float32 kernel, which covers all of HEAD_DIMS."""
        assert tattn.flash_variant(dtype, D) == variant
        assert set(tattn.MMA_HEAD_DIMS) <= set(_build.HEAD_DIMS)

    @pytest.mark.parametrize("L,want", [(8320, 512), (24, 512), (7, 512),
                                        (256, 16)])
    def test_fit_block_matches_reference(self, L, want):
        assert tattn._fit_block(L, want) == jattn._fit_block(L, want)


class TestPagedRef:
    def test_paged_attention_ref_matches_reference(self):
        """Lengths include 0 (inactive slot), a partial page and exactly a
        full page.  Only active rows are compared (an inactive slot's value
        is unread); float32, atol 1e-6 (same contractions)."""
        rng = np.random.default_rng(11)
        S, H, Hkv, Dh, P, ps, pp = 4, 4, 2, 8, 9, 4, 3
        q = rng.normal(size=(S, H, Dh)).astype(np.float32)
        kp, vp = (rng.normal(size=(Hkv, P, ps, Dh)).astype(np.float32)
                  for _ in range(2))
        lengths = np.array([0, 3, 4, 11], np.int32)
        tables = np.array([[0, 0, 0], [5, 0, 0], [2, 0, 0], [1, 7, 3]],
                          np.int32)
        ref = jpaged.paged_attention_ref(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(lengths), jnp.asarray(tables))
        out = tpaged.paged_attention(_t(q), _t(kp), _t(vp), _t(lengths),
                                     _t(tables))
        assert out.dtype == torch.float32
        assert torch.isfinite(out).all()
        active = lengths > 0
        np.testing.assert_allclose(out.numpy()[active],
                                   np.asarray(ref)[active], atol=1e-6,
                                   rtol=0)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        z = torch.zeros(2, 2, 4, 8)
        with pytest.raises(ValueError, match="on the card"):
            tpaged.paged_attention_cuda(
                torch.zeros(1, 2, 8), z, z, torch.ones(1, dtype=torch.int32),
                torch.zeros(1, 1, dtype=torch.int32))

    def test_cuda_wrapper_shape_checks_accept_g16(self):
        """H 32 over Hkv 2 (g = 16, above the old cap of 8) passes every
        shape and dtype check and stops only at the device check."""
        z = torch.zeros(2, 3, 16, 128, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="on the card"):
            tpaged.paged_attention_cuda(
                torch.zeros(2, 32, 128, dtype=torch.bfloat16), z, z,
                torch.ones(2, dtype=torch.int32),
                torch.ones(2, 2, dtype=torch.int32))
        with pytest.raises(ValueError, match="vs pages"):  # H % Hkv != 0
            tpaged.paged_attention_cuda(
                torch.zeros(2, 31, 128, dtype=torch.bfloat16), z, z,
                torch.ones(2, dtype=torch.int32),
                torch.ones(2, 2, dtype=torch.int32))


def _split_merge_emulation(q, kp, vp, lengths, tables, plan):
    """K2's algorithm in float32, test-local: per (slot, KV head) and page
    partition of ``plan``, a partial (max, sum, unnormalised output) over
    the partition's live tokens; then the merge rescales each partial by
    exp(its max - the largest max) and divides by the rescaled sum.  A slot
    whose tokens fit one partition is normalised directly, and one with no
    token (inactive) gives zeros, as the kernel does."""
    S, H, D = q.shape
    Hkv, _, ps, _ = kp.shape
    pp = tables.shape[1]
    g = H // Hkv
    out = torch.zeros(S, H, D)
    for s in range(S):
        n = min(max(int(lengths[s]), 0), pp * ps)
        for kvh in range(Hkv):
            qh = q[s, kvh * g:(kvh + 1) * g].float()
            parts = []
            for first, end in plan.partitions(pp):
                if first * ps >= n:
                    continue  # the block returns at once
                t = torch.arange(first * ps, min(n, end * ps))
                rows = tables[s, t // ps].long() * ps + t % ps
                k = kp[kvh].reshape(-1, D)[rows].float()
                v = vp[kvh].reshape(-1, D)[rows].float()
                sc = (qh @ k.T) * D ** -0.5
                m = sc.max(-1).values
                p = torch.exp(sc - m[:, None])
                parts.append((m, p.sum(-1), p @ v))
            if not parts:
                continue
            if len(parts) == 1:
                m, l, acc = parts[0]
                o = acc / l[:, None]
            else:
                ms = torch.stack([p[0] for p in parts])  # (parts, g)
                w = torch.exp(ms - ms.max(0).values)
                l = (torch.stack([p[1] for p in parts]) * w).sum(0)
                acc = (torch.stack([p[2] for p in parts]) * w[..., None])
                o = acc.sum(0) / l[:, None]
            out[s, kvh * g:(kvh + 1) * g] = o
    return out


class TestPagedSplit:
    # S 5 slots of a 6-page table (page size 4), Hkv 2, D 8, float32: the
    # SM count is chosen so that the wrapper's plan has 1, 2 or 6 blocks per
    # (slot, KV head) (6 = every page, more than any slot's live pages)
    S, Hkv, D, ps, pp = 5, 2, 8, 4, 6

    @pytest.mark.parametrize("g", [1, 4, 16])
    @pytest.mark.parametrize("want,n_split", [(1, 1), (2, 2), (64, 6)])
    def test_emulation_matches_reference(self, g, want, n_split):
        """Lengths 0 (inactive), one token, a full page, a full partition
        and one token past it; float32, atol 1e-6 on active rows (the two
        sum the same terms in another order)."""
        S, Hkv, D, ps, pp = self.S, self.Hkv, self.D, self.ps, self.pp
        H = Hkv * g
        pairs = S * Hkv * -(-g // 8)
        sms = max(1, want * pairs // tpaged.SPLIT_BLOCKS_PER_SM)
        plan = tpaged.kernel_split_plan(S, H, Hkv, D, ps, pp, 4, sms)
        assert plan.n_split == n_split
        part = plan.pages * ps
        lengths = np.array([0, 1, ps, min(part, pp * ps),
                            min(part + 1, pp * ps)], np.int32)
        rng = np.random.default_rng(100 * g + n_split)
        n_pages = 1 + S * pp
        tables = rng.permutation(np.arange(1, n_pages)).reshape(S, pp)
        tables = tables.astype(np.int32)
        tables[0] = 0  # the inactive slot's row points at the trash page
        q = rng.normal(size=(S, H, D)).astype(np.float32)
        kp, vp = (rng.normal(size=(Hkv, n_pages, ps, D)).astype(np.float32)
                  for _ in range(2))
        ref = np.asarray(jpaged.paged_attention_ref(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(lengths), jnp.asarray(tables)))
        out = _split_merge_emulation(_t(q), _t(kp), _t(vp), _t(lengths),
                                     _t(tables), plan)
        assert torch.isfinite(out).all()
        assert (out[0] == 0).all()
        active = lengths > 0
        np.testing.assert_allclose(out.numpy()[active], ref[active],
                                   atol=1e-6, rtol=0)

    @pytest.mark.parametrize("pp,pairs,sms,max_pages", [
        (8, 64, 132, 8), (16, 64, 132, 8), (256, 64, 132, 8),
        (512, 8, 132, 8), (1, 1, 132, 8), (7, 3, 1, 100), (100, 1, 132, 3),
        (13, 8, 132, 64), (64, 64, 132, 8)])
    def test_paged_split_plan_covers_the_table(self, pp, pairs, sms,
                                               max_pages):
        """A function of static shapes only (ints in, the same plan out),
        whose partitions cover the table's pages exactly once, each at
        least one page and at most ``max_pages``."""
        plan = tpaged.paged_split_plan(pp, pairs, sms, max_pages)
        assert plan == tpaged.paged_split_plan(pp, pairs, sms, max_pages)
        parts = plan.partitions(pp)
        assert len(parts) == plan.n_split >= 1
        covered = [p for first, end in parts for p in range(first, end)]
        assert covered == list(range(pp))
        assert all(1 <= end - first <= min(plan.pages, max_pages)
                   for first, end in parts)

    # the plans of chip_smoke.py's K2 cases on a 132-SM card: (S, H, Hkv,
    # D, page size, pp, itemsize) -> (n_split, pages)
    @pytest.mark.parametrize("shape,plan", [
        ((8, 32, 8, 128, 16, 8, 2), (4, 2)),      # 7b_decode
        ((8, 32, 8, 128, 16, 16, 2), (4, 4)),     # serve_7b (max_len 256)
        ((8, 32, 8, 128, 16, 256, 2), (16, 16)),  # 7b_decode_long
        ((1, 32, 8, 128, 16, 512, 2), (32, 16)),  # 7b_decode_one_long
        ((8, 32, 8, 128, 16, 64, 2), (5, 13)),    # partition_edges
        ((8, 32, 2, 128, 16, 16, 2), (8, 2)),     # g16: two head groups
        ((8, 8, 8, 64, 16, 13, 2), (5, 3)),       # mha_g1_d64
        ((4, 4, 2, 16, 16, 3, 4), (3, 1)),        # llm_json_decode
        # d256_f32: 16-token chunks, so a 64-row page is four of them
        ((4, 8, 2, 256, 64, 5, 4), (5, 1))])
    def test_kernel_split_plan_at_the_chip_cases(self, shape, plan):
        assert tuple(tpaged.kernel_split_plan(*shape, 132)) == plan
