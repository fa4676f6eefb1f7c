"""The plain reference against the program at a tiny size in float32 on
the CPU: the encoder's latents on the same generator seed, the field at
random queries, and the bisection of vertices between grid points."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import weights as weights_mod
from benchmark.harness.reconstruct import spec_of, sphere_blend
from benchmark.reference import compare, plain
from benchmark.tests.conftest import tiny_cell
from benchmark.yardstick.synthetic import rng_for, torus_cloud


# each case: a configuration and the keys set on its tiny cell
CASES = {"pps50nn": ("pps50nn", {}), "poco": ("poco", {}),
         # a patch wider than the decoder's k=64: a search of its own
         "pps50nn.p100": ("pps50nn", {"num_pts_local": 100})}


@pytest.fixture(scope="module", params=list(CASES))
def sides(request):
    from ppsurf_tpu_torch.recon.field import FieldEvaluator
    from ppsurf_tpu_torch.recon.predict import Predictor

    name, keys = CASES[request.param]
    cell = tiny_cell(name)
    cell.config.update(keys)
    dev = torch.device("cpu")
    flat = weights_mod.load(cell.config, 77, dev)
    pred = Predictor(spec_of(cell.config, cell.mix), variables=weights_mod.nested(flat),
                     device=dev, verbose=False)
    cloud = torus_cloud(2500, rng_for(77, 1, 0))
    blend = cell.config["blend"] == "sphere"
    latents = pred.encoder(torch.from_numpy(cloud), generator=torch.Generator().manual_seed(5))
    ev = FieldEvaluator(pred.net, pred.spec, cloud, latents,
                        transform=sphere_blend(cloud) if blend else None)
    ref = compare.reference_side(cell.config, cell.mix, flat,
                                 dict(cloud=cloud, gen_seed=5), dev)
    return name, cloud, latents, ev, ref, blend


def test_latents_match(sides):
    _, _, latents, _, ref, _ = sides
    rms = float(ref.latents.pow(2).mean().sqrt())
    assert float((latents - ref.latents).abs().max()) <= 1e-4 * rms


def test_field_matches(sides):
    _, cloud, _, ev, ref, blend = sides
    q = (np.random.default_rng(3).random((3000, 3)) - 0.5).astype(np.float32)
    got = torch.from_numpy(ev(q))
    want = ref.blended(torch.from_numpy(q))
    assert float((got - want).abs().max()) <= 1e-4


def test_bisection_matches(sides):
    _, cloud, _, ev, ref, _ = sides
    rng = np.random.default_rng(4)
    # short edges through the cloud and through the blend's sphere
    d = rng.normal(size=(400, 3))
    sphere = d / np.linalg.norm(d, axis=1, keepdims=True) * np.abs(cloud).max()
    near = np.concatenate([cloud[rng.integers(0, len(cloud), 400)], sphere])
    v1 = (near + rng.normal(0, 0.01, near.shape)).astype(np.float32)
    v2 = (v1 + rng.normal(0, 0.01, near.shape)).astype(np.float32)
    p1, p2 = ev(v1), ev(v2)
    keep = (p1 * p2) < 0  # edges the surface crosses
    r = dict(v=0.5 * (v1 + v2)[keep], v1=v1[keep], v2=v2[keep], p1=p1[keep], p2=p2[keep],
             iters=6)
    got = ev.refine_bisection(r["v"], r["v1"], r["v2"], r["p1"], r["p2"], 6)
    want = ref.refine(r, torch.device("cpu")).numpy()
    assert keep.sum() > 20
    edge = np.linalg.norm(r["v2"] - r["v1"], axis=1)
    assert np.max(np.linalg.norm(got - want, axis=1) / edge) <= 1e-3


@pytest.mark.parametrize("cloud", ["random", "duplicated", "lattice"])
def test_knn_prefix_is_the_search_at_k(cloud):
    """The first k columns of a search at P > k are the search at k, ties
    to the lower id: what lets the field take the decoder's ids and a
    wider patch from one search."""
    rng = np.random.default_rng(9)
    pts = rng.random((3000, 3)).astype(np.float32)
    if cloud == "duplicated":  # every point twice: each distance tied
        pts[1500:] = pts[:1500]
    elif cloud == "lattice":  # a 15^3 grid: many points at one distance
        g = np.arange(15, dtype=np.float32)
        pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3) / 14
    pts = torch.from_numpy(pts)
    # queries at cloud points (distance 0, tied where duplicated) and off them
    q = torch.cat([pts[::37], torch.from_numpy(rng.random((200, 3)).astype(np.float32))])
    d2 = plain.dist2(pts, q)
    for k, p in ((64, 100), (64, 200), (16, 256)):
        wide = plain.knn(pts, q, p, block=97)
        assert torch.equal(wide[:, :k], plain.knn(pts, q, k))
        dw = torch.gather(d2, 1, wide)
        assert bool((dw[:, 1:] >= dw[:, :-1]).all())  # nearest first
        tied = dw[:, 1:] == dw[:, :-1]
        assert bool(tied.any()) == (cloud != "random")
        assert bool((wide[:, 1:] > wide[:, :-1])[tied].all())  # ties to the lower id


def test_fp8_rounding():
    x = torch.linspace(-3, 3, 1001)
    y = plain.fp8_e4m3(x)
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert float(rel.max()) <= 2 ** -4 + 1e-6 and float(rel.max()) > 2 ** -9
