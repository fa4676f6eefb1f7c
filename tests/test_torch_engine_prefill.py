"""The region grower's speculative prefill, against the JAX package.

`ppsurf_tpu_torch.recon.engine.create_volume_region_growing` with
`prefill_radius` in (0, 4, 6), `prefill_start=2` and bands of at least
4096 (the default) or 64 voxels, on the native and on
the numpy path, fed the wavy-sphere field of `tests/test_recon.py:204-218`
at res 33: the volume equals the JAX package's bit for bit (NaN pattern
and values) and the ordered list of the field's batch sizes equals the
JAX package's; prefill on gives the volume of prefill off with at least
one band and no more field calls; `reconstruct_mesh(...,
prefill_radius=6)` gives the faces and vertices of prefill 0 and of the
JAX package.

The prefill keeps the volume only where a query's field value does not
depend on the call that holds it. On the card `FieldEvaluator` runs a
chunk's PyTorch products on a fixed row count (`fixed_rows`), which
`chip_smoke.py` phase 20 holds bit for bit; here (where the kernels' plain
versions are PyTorch products of their own) it is forced on at a small
chunk and must keep the field within f32 rounding in any batching.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import ppsurf_tpu.native as jax_native
from ppsurf_tpu.recon import engine as jax_engine
from ppsurf_tpu_torch import native
from ppsurf_tpu_torch.recon import engine

RES = 33
START = 2


def wavy_cloud() -> np.ndarray:
    rng = np.random.RandomState(0)
    u = rng.randn(1200, 3).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return 0.4 * u  # noisy sphere cloud


def wavy_field(calls: list):
    """A wavy sphere (growth goes beyond the seed crust); each call's
    batch size goes to `calls`."""

    def field(q):
        calls.append(q.shape[0])
        return (np.linalg.norm(q, axis=1) - 0.4 - 0.06 * np.sin(9.0 * q[:, 0])).astype(np.float32)

    return field


@pytest.fixture(params=["native", "numpy"])
def use_native(request, monkeypatch):
    """The grower's path: the native round walks or numpy (both packages'
    `native.available` patched to False)."""
    if request.param == "native":
        assert native.available() and jax_native.available()
        return True
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    return False


def _grow(module, radius: int, use_native: bool, **kw):
    calls = []
    vol, step, bmin = module.create_volume_region_growing(
        wavy_field(calls), wavy_cloud(), RES, use_native=use_native,
        prefill_radius=radius, prefill_start=START, **kw)
    return vol, (step, bmin), calls


def _assert_same_volume(a: np.ndarray, b: np.ndarray) -> None:
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(a[~np.isnan(a)], b[~np.isnan(b)])


@pytest.mark.parametrize("min_band", [4096, 64])
@pytest.mark.parametrize("radius", [0, 4, 6])
def test_grower_matches_jax(use_native, radius, min_band):
    vol, grid, calls = _grow(engine, radius, use_native, prefill_min_band=min_band)
    vol_j, grid_j, calls_j = _grow(jax_engine, radius, use_native, prefill_min_band=min_band)
    assert grid == grid_j
    _assert_same_volume(vol, vol_j)
    assert calls == calls_j


@pytest.mark.parametrize("radius", [4, 6])
def test_prefill_keeps_the_volume(use_native, radius):
    stats = {}
    vol, grid, calls = _grow(engine, radius, use_native, stats=stats)
    vol0, grid0, calls0 = _grow(engine, 0, use_native)
    assert grid == grid0
    _assert_same_volume(vol, vol0)
    assert stats["prefill_bands"] >= 1 and stats["prefill_voxels"] > 0
    assert len(calls) <= len(calls0)
    # no voxel is evaluated twice: the rounds' misses and the bands
    assert sum(calls0) <= sum(calls) <= sum(calls0) + stats["prefill_voxels"]


def test_reconstruct_mesh_with_prefill(use_native):
    meshes = {}
    for radius in (0, 6):
        meshes[radius] = engine.reconstruct_mesh(wavy_field([]), wavy_cloud(), RES,
                                                 refine_iter=2, prefill_radius=radius)
    ref = jax_engine.reconstruct_mesh(wavy_field([]), wavy_cloud(), RES, refine_iter=2,
                                      prefill_radius=6)
    for mesh in (meshes[6], ref):
        np.testing.assert_array_equal(mesh.faces, meshes[0].faces)
        np.testing.assert_array_equal(mesh.vertices, meshes[0].vertices)


def test_fixed_rows_keep_the_field():
    from ppsurf_tpu_torch.data.synthetic import torus_cloud
    from ppsurf_tpu_torch.recon.field import FieldEvaluator
    from ppsurf_tpu_torch.recon.predict import Predictor
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    spec = ppsurf_spec(gen_subsample_manifold_iter=1, rec_batch_size=1000)
    predictor = Predictor(spec, device="cpu", verbose=False)
    cloud = torus_cloud(2000, seed=0)
    latents = predictor.encoder(torch.from_numpy(cloud),
                                generator=torch.Generator().manual_seed(0))
    ev = FieldEvaluator(predictor.net, spec, cloud, latents)
    assert ev.fixed_rows is None  # the CPU's products: no padding
    rng = np.random.RandomState(1)
    q = (cloud[rng.randint(0, 2000, 2500)] + rng.randn(2500, 3) * 0.02).astype(np.float32)
    plain = ev(q)
    ev.fixed_rows = ev.chunk
    whole = ev(q)
    np.testing.assert_allclose(whole, plain, rtol=0, atol=1e-5)
    for sizes in ((7, 1000), (1, 999, 1), (333,)):
        bounds = np.cumsum((0,) + sizes)
        split = np.concatenate([ev(q[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
                               + [ev(q[bounds[-1]:])])
        np.testing.assert_allclose(split, plain, rtol=0, atol=1e-5)
