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
