"""The plain reference against the program at PPSurf 200NN's patch of
200 points (a search of its own, wider than the decoder's k=64), on the
tiny cell in float32 on the CPU: the latents, the field and the
bisection, as `test_harness_reference.py` holds the other
configurations, once on the configuration's committed weights and once
on weights seeded from `weights_seed`, which see no surface and so have
their field blended with a sphere as POCO's configuration does."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import weights as weights_mod
from benchmark.harness.reconstruct import spec_of, sphere_blend
from benchmark.reference import compare
from benchmark.tests.conftest import tiny_cell
from benchmark.tests.test_harness_reference import (  # noqa: F401  (run here on this module's sides)
    test_bisection_matches, test_field_matches, test_latents_match)
from benchmark.yardstick.synthetic import rng_for, torus_cloud

# each case: the keys set on the tiny cell of pps200nn
CASES = {"committed": {}, "seeded": {"weights": "seeded", "weights_seed": 3, "blend": "sphere"}}


@pytest.fixture(scope="module", params=list(CASES))
def sides(request):
    from ppsurf_tpu_torch.recon.field import FieldEvaluator
    from ppsurf_tpu_torch.recon.predict import Predictor

    cell = tiny_cell("pps200nn")
    cell.config.update(CASES[request.param])
    assert cell.config["num_pts_local"] == 200 and cell.config["k"] == 64
    dev = torch.device("cpu")
    flat = weights_mod.load(cell.config, 77, dev)
    pred = Predictor(spec_of(cell.config, cell.mix), variables=weights_mod.nested(flat),
                     device=dev, verbose=False)
    cloud = torus_cloud(2500, rng_for(77, 1, 0))
    latents = pred.encoder(torch.from_numpy(cloud), generator=torch.Generator().manual_seed(5))
    blend = cell.config["blend"] == "sphere"
    ev = FieldEvaluator(pred.net, pred.spec, cloud, latents,
                        transform=sphere_blend(cloud) if blend else None)
    assert (ev.k, ev.patch_k) == (64, 200)
    ref = compare.reference_side(cell.config, cell.mix, flat,
                                 dict(cloud=cloud, gen_seed=5), dev)
    return request.param, cloud, latents, ev, ref, blend


def test_seeded_weights_are_not_the_committed_ones():
    dev = torch.device("cpu")
    cell = tiny_cell("pps200nn")
    committed = weights_mod.load(cell.config, 77, dev)
    cell.config.update(CASES["seeded"])
    seeded = weights_mod.load(cell.config, 77, dev)
    assert set(seeded) == set(committed)
    assert all(seeded[k].shape == committed[k].shape for k in seeded)
    assert not np.allclose(seeded["params/mlp/fc_final/kernel"].numpy(),
                           committed["params/mlp/fc_final/kernel"].numpy())
