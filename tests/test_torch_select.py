"""Kernel K2 (`topk_rows`) and the T1 microbenchmark variants of the port
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

- `topk_rows` (its plain version on the CPU) equals
  `topk_rows_pallas(d2.T, k, interpret=True).T` exactly, forced ties
  included, at the shapes of `tests/test_knn_pallas.py:163-176`.
- Each T1 variant's plain version equals the variant that
  `tools/microbench_extract.py::make_kernel` builds, through
  `pl.pallas_call(..., interpret=True)` on a (64, 256) slab with k=8, in
  the transposed layout. The inputs are eighths below 128, so every
  partial sum is exact in f32 and the row sums agree in any order, and
  ties are plentiful; all variants but `sum_only` also take uniform
  floats, whose sums depend on the order (`sum_only` holds those to a
  float64 sum at f32 rounding).
- A numpy model of the CUDA selection's steps (`csrc/select.cu`: the
  order-preserving words, the binary search for the k-th word bounded by
  the row's least and greatest word, the tie cut by position, compaction
  in ballot order, then ranking) equals `topk_rows_plain` and the
  interpret-mode Pallas kernels on all-tie rows, +-0 rows and random rows
  with forced ties at kc in {1, 31, 32, 33, 100, 192, 256}, k in {1, 63,
  64, kc}, and at T1 `full`'s 1536 candidates with k = 64; rows with NaN,
  +-inf and 1e38 are held to `topk_rows_plain` alone, since the Pallas
  kernel masks chosen entries with 4e12 and needs finite inputs below
  2e12. A model that breaks ties to the higher position fails.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ppsurf_tpu.ops import knn_pallas as kp
from ppsurf_tpu_torch.ops.topk_rows import topk_rows, topk_rows_plain
from ppsurf_tpu_torch.tools import microbench_extract as mb


@pytest.mark.parametrize("c,kc,k", [(700, 192, 64), (512, 100, 50), (64, 192, 192)])
def test_topk_rows_matches_pallas_kernel(c, kc, k):
    rng = np.random.RandomState(7)
    d2 = rng.rand(c, kc).astype(np.float32) * 4.0
    d2[:, 1::7] = d2[:, 0::7][:, : d2[:, 1::7].shape[1]]  # exact ties
    want = np.asarray(kp.topk_rows_pallas(jnp.asarray(d2.T), k=k, tq=128,
                                          interpret=True)).T
    got = topk_rows(torch.from_numpy(d2), k)
    assert got.dtype == torch.int64 and got.shape == (c, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(topk_rows_plain(torch.from_numpy(d2), k).numpy(), want)


def test_topk_rows_orders_any_float_like_a_stable_sort():
    """No value range is reserved: huge values, infinities and NaN order
    as torch.sort orders them (NaN last), and -0 ties with +0."""
    row = torch.tensor([[np.inf, 1e30, np.nan, -0.0, 0.0, -1e38, 3e12, 1e30]])
    assert topk_rows(row, 8).tolist() == [[5, 3, 4, 6, 1, 7, 0, 2]]
    for kc, k in ((257, 1), (4, 5), (4, 0)):
        with pytest.raises(ValueError):
            topk_rows(torch.zeros(3, kc), k)


def _order_words(x: np.ndarray) -> np.ndarray:
    """`order_word` of csrc/select.cu: f32 -> u32 whose unsigned order is
    torch.sort's (negatives flipped, positives offset, -0 as +0, NaN
    last)."""
    u = x.astype(np.float32).view(np.uint32)
    w = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    w[x == 0] = 0x80000000
    w[np.isnan(x)] = 0xFFFFFFFF
    return w


def _select_model(d2: np.ndarray, k: int, ties_high: bool = False) -> np.ndarray:
    """The CUDA selection's steps, one row a warp, lane l holding the words
    of positions l + 32 j (all ones past the row) -> (C, k) positions.
    `ties_high` is a mutant that keeps the last tied words, not the first."""
    c, kc = d2.shape
    per = -(-kc // 32)
    w = np.full((c, per * 32), 0xFFFFFFFF, np.uint32)
    w[:, :kc] = _order_words(d2)
    w = w.astype(np.int64).reshape(c, per, 32)  # [row, j, lane]
    # 1. the least word W with >= k words at or below it, searched between
    # the row's least and greatest word; it stops where exactly k lie at or
    # below the midpoint
    lo, hi = w.min(axis=(1, 2)), w.max(axis=(1, 2))
    while (lo < hi).any():
        on = lo < hi
        mid = lo + ((hi - lo) >> 1)
        n = (w <= mid[:, None, None]).sum(axis=(1, 2))
        exact = on & (n == k)
        lo = np.where(exact | (on & (n < k)), np.where(exact, mid, mid + 1), lo)
        hi = np.where(exact, mid, np.where(on & (n > k), mid, hi))
    big = lo[:, None]
    # 2-3. keep the words below W and the first `need` words at W, by a
    # ballot prefix j by j (positions ascending); compact in ballot order
    need = k - (w < big[:, :, None]).sum(axis=(1, 2))
    if ties_high:
        need = (w == big[:, :, None]).sum(axis=(1, 2)) - need
    kept_pos, kept_word = [], []
    for j in range(per):
        at = w[:, j] == big
        prefix = np.cumsum(at, axis=1) - at  # tied lanes below
        keep = (w[:, j] < big) | (at & ((prefix >= need[:, None]) if ties_high
                                        else (prefix < need[:, None])))
        need = need - at.sum(axis=1)
        kept_pos.append(np.where(keep, 32 * j + np.arange(32), -1))
        kept_word.append(w[:, j])
    pos = np.concatenate(kept_pos, axis=1)
    word = np.concatenate(kept_word, axis=1)
    order = np.argsort(pos < 0, axis=1, kind="stable")[:, :k]  # ballot order
    assert ((pos >= 0).sum(axis=1) == k).all()
    bpos = np.take_along_axis(pos, order, axis=1)
    keys = (np.take_along_axis(word, order, axis=1).astype(np.uint64) << np.uint64(32)) \
        | bpos.astype(np.uint64)
    # 4. each kept key goes to the slot of its rank among the kept keys
    rank = (keys[:, None, :] < keys[:, :, None]).sum(axis=2)
    out = np.empty((c, k), np.int64)
    np.put_along_axis(out, rank, bpos, axis=1)
    return out


def test_order_words_sort_like_torch():
    x = np.array([np.inf, 1e30, np.nan, -0.0, 0.0, -1e38, 3e12, -np.inf, 1e-45, -1e-45,
                  np.float32(np.nan) * -1, 1.0, -1.0, 1e38, 0.0], np.float32)
    want = torch.sort(torch.from_numpy(x), stable=True)[1].numpy()
    np.testing.assert_array_equal(np.argsort(_order_words(x), kind="stable"), want)


def _tie_rows(rng, c: int, kc: int) -> np.ndarray:
    """Random rows with exact ties, all-tie rows and rows of +-0 only."""
    d2 = rng.rand(c, kc).astype(np.float32) * 4.0
    d2[::3, 1::2] = d2[::3, 0:kc - 1:2][:, : d2[::3, 1::2].shape[1]]
    d2[1::5] = 0.5
    d2[2::5, ::2] = -0.0
    d2[2::5, 1::2] = 0.0
    return d2


@pytest.mark.parametrize("kc", [1, 31, 32, 33, 100, 192, 256])
def test_selection_model_matches_plain_and_pallas(kc):
    rng = np.random.RandomState(kc)
    d2 = _tie_rows(rng, 128, kc)
    special = rng.rand(40, kc).astype(np.float32)
    vals = np.array([np.nan, np.inf, -np.inf, 1e38, -1e38, -0.0, 0.0], np.float32)
    special[:, :] = np.where(rng.rand(40, kc) < 0.3, rng.choice(vals, (40, kc)), special)
    special[0] = np.nan
    for k in sorted({1, 63, 64, kc}):
        if k > kc:
            continue
        got = _select_model(d2, k)
        np.testing.assert_array_equal(got, topk_rows_plain(torch.from_numpy(d2), k).numpy())
        want = np.asarray(kp.topk_rows_pallas(jnp.asarray(d2.T), k=k, tq=128,
                                              interpret=True)).T
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_select_model(special, k),
                                      topk_rows_plain(torch.from_numpy(special), k).numpy())


def test_selection_model_breaking_ties_high_fails():
    d2 = _tie_rows(np.random.RandomState(3), 64, 192)
    plain = topk_rows_plain(torch.from_numpy(d2), 64).numpy()
    np.testing.assert_array_equal(_select_model(d2, 64), plain)
    assert (_select_model(d2, 64, ties_high=True) != plain).any(axis=1).sum() >= 20


def _pallas_variant(make_kernel, cand: np.ndarray, variant: str, k: int,
                    tq: int = 128) -> np.ndarray:
    """The TPU tool's variant on cand (Q, ncand), in interpret mode ->
    (Q, k)."""
    q, n = cand.shape
    out = pl.pallas_call(
        make_kernel(variant, k, n, tq),
        grid=(q // tq,),
        in_specs=[pl.BlockSpec((n, tq), lambda i: (0, i), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((k, tq), lambda i: (0, i), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((k, q), jnp.float32),
        scratch_shapes=[pltpu.VMEM((n, tq), jnp.float32)],
        interpret=True,
    )(jnp.asarray(cand.T))
    return np.asarray(out).T


@pytest.mark.parametrize("variant", mb.VARIANTS)
def test_extract_variant_matches_pallas_variant(variant, monkeypatch, tmp_path):
    # importing the TPU tool sets JAX_COMPILATION_CACHE_DIR by setdefault:
    # set it here, so that monkeypatch puts the variable back as it was
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    from tools.microbench_extract import make_kernel

    rng = np.random.RandomState(11)
    eighths = (rng.randint(0, 1024, (256, 64)) / 8).astype(np.float32)
    uniform = rng.rand(256, 64).astype(np.float32)
    for cand in (eighths, uniform):
        ours = mb.extract(torch.from_numpy(cand), variant, 8).numpy()
        assert ours.shape == (256, 8) and ours.dtype == np.float32
        if variant == "sum_only" and cand is uniform:
            np.testing.assert_allclose(ours, np.repeat(cand.astype(np.float64).sum(1)[:, None], 8, 1),
                                       rtol=1e-6)
            continue
        np.testing.assert_array_equal(ours, _pallas_variant(make_kernel, cand, variant, 8))


def test_selection_model_matches_full_variant_at_1536(monkeypatch, tmp_path):
    """T1 `full` runs K2's selection over 48 words a lane."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    from tools.microbench_extract import make_kernel

    rng = np.random.RandomState(5)
    cand = (rng.randint(0, 4096, (128, 1536)) / 8).astype(np.float32)  # many ties
    want = mb.extract(torch.from_numpy(cand), "full", 64).numpy()
    np.testing.assert_array_equal(_select_model(cand, 64).astype(np.float32), want)
    np.testing.assert_array_equal(_pallas_variant(make_kernel, cand, "full", 64), want)
    with pytest.raises(ValueError):
        mb.extract(torch.from_numpy(cand), "full", 257)


_SASS = """
	code for sm_90a
		Function : _ZN41_GLOBAL__N__22698869_9_select_cu_870899e714extract_kernelILi3EEEvPKfPfiiii
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   YIELD ;
        /*0020*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R2+URZ], R3 ;
        /*0030*/              @!P0 BRA 0x10 ;
        /*0040*/                   VIMNMX3.U32 R4, R5, R6, R7 ;
        /*0050*/                   REDUX.MIN.U32 UR4, R4 ;
        /*0060*/               @P1 BRA 0x40 ;
        /*0070*/               @P2 BRA 0x10 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90;
		Function : _ZN41_GLOBAL__N__22698869_9_select_cu_870899e714extract_kernelILi6EEEvPKfPfiiii
        /*0000*/                   ISETP.GE.U32.AND P0, PT, R4, R5, PT ;
        /*0010*/                   IADD3 R6, R6, 0x1, RZ ;
        /*0020*/               @P0 BRA 0x0 ;
        /*0030*/              @P0 ELECT P1, URZ, PT ;
        /*0040*/                   UBLKCP.S.G [UR10], [UR4], UR6 ;
        /*0050*/               @P0 BRA.U.ANY 0x30 ;
        /*0060*/                   LDS.64 R8, [R9] ;
        /*0070*/                   ISETP.LT.U32.AND P1, PT, R8, R10, PT ;
        /*0080*/                   IADD3 R7, R7, 0x1, RZ ;
        /*0090*/               @P1 BRA 0x60 ;
        /*00a0*/                   EXIT ;
		Function : _ZN41_GLOBAL__N__22698869_9_select_cu_870899e716topk_rows_kernelILi6EEEvPKfPliii
        /*0000*/                   EXIT ;
"""


def test_sass_loops_reads_innermost_loops():
    """The SASS reader behind the T1 pass-loop counts: branches back to a
    lower address, mbarrier and bulk-copy loops and enclosing loops left
    out, only `extract_kernel` functions read."""
    assert mb.sass_loops(_SASS) == {"min_only": [3], "full": [3, 4]}
