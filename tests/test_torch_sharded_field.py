"""The sharded field evaluator (`FieldEvaluator(devices=[...])`) against
the JAX package's (`FieldEvaluator(mesh=...)`, `ppsurf_tpu/recon/field.py:
187-224, 745-764`) and the single-device path, on the CPU (f32, committed
weights, chunks of 128 queries).

Over 5 full chunks and a tail of 37 queries, two replicas take two groups
of two chunks and the first device the fifth chunk and the tail, as in the
JAX package. The port's sharded field equals its single-device field
exactly (every chunk runs the same code on the same inputs) and the JAX
package's sharded and single-device fields within 1e-4 (the field limit)
wherever a query's 50- or 64-NN set holds no near-tie (the JAX CPU kNN
ranks by matmul distances, `tests/test_torch_patches.py`). A transform
sees the values in query order on the first device; `Predictor(devices=)`
clamps to the devices present.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from ppsurf_tpu.convert.infer_npz import load_infer_npz as jax_load_infer_npz
from ppsurf_tpu.parallel.mesh import get_data_mesh
from ppsurf_tpu.recon.field import FieldEvaluator as JFieldEvaluator
from ppsurf_tpu.train.model import ppsurf_spec as jax_spec
from ppsurf_tpu_torch.convert.infer_npz import load_infer_npz, load_network
from ppsurf_tpu_torch.recon.field import FieldEvaluator
from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS, Predictor
from ppsurf_tpu_torch.train.model import ppsurf_spec

from test_torch_recon import _exact_tie, sphere_cloud

SPEC = dict(rec_batch_size=128)
M = 5 * 128 + 37


@pytest.fixture(scope="module")
def fields():
    rng = np.random.RandomState(8)
    pts = sphere_cloud(600, seed=2)
    latents = (rng.randn(pts.shape[0], 256) * 0.5).astype(np.float32)
    queries = (rng.rand(M, 3) - 0.5).astype(np.float32)
    queries[::3] = pts[rng.randint(0, pts.shape[0], len(queries[::3]))] * 1.02

    spec = ppsurf_spec(**SPEC)
    net = load_network(spec, load_infer_npz(DEFAULT_WEIGHTS), torch.device("cpu"))
    lat = torch.from_numpy(latents.copy())
    calls = []

    def transform(vals, q):  # elementwise: the field of the queries it is given
        calls.append(q.device)
        return vals - 0.01 * q[:, 0]

    single = FieldEvaluator(net, spec, pts, lat, transform=transform)
    sharded = FieldEvaluator(net, spec, pts, lat, transform=transform, devices=["cpu", "cpu"])
    with torch.inference_mode():
        ours_single, ours_sharded = single(queries), sharded(queries)

    jspec = jax_spec(**SPEC)
    variables = jax_load_infer_npz(DEFAULT_WEIGHTS)

    def jtransform(vals, q):
        return vals - 0.01 * q[..., 0]

    theirs = {name: JFieldEvaluator(jspec.make_network(), jspec, variables, pts, latents,
                                    pts_raw=pts, transform=jtransform, mesh=mesh)(queries)
              for name, mesh in (("single", None), ("sharded", get_data_mesh(2)))}
    return dict(pts=pts, queries=queries, single=ours_single, sharded=ours_sharded,
                theirs=theirs, evaluator=sharded, calls=calls)


def test_sharded_field_equals_the_single_device_field(fields):
    ev = fields["evaluator"]
    assert ev.chunk == 128 and len(ev.replicas) == 2
    assert ev.replicas[1].net is not ev.net
    np.testing.assert_array_equal(fields["sharded"], fields["single"])
    # 6 chunks a call: the transform ran once a chunk, on the first device
    assert len(fields["calls"]) == 12 and set(fields["calls"]) == {torch.device("cpu")}


@pytest.mark.parametrize("which", ["single", "sharded"])
def test_sharded_field_matches_jax(fields, which):
    ok = ~_exact_tie(fields["pts"], fields["queries"])
    assert ok.sum() > 0.97 * M
    np.testing.assert_allclose(fields["sharded"][ok], fields["theirs"][which][ok], rtol=0,
                               atol=1e-4)


def test_predictor_devices_clamp_to_those_present():
    p = Predictor(ppsurf_spec(**SPEC), device="cpu", verbose=False, devices=2)
    assert p.devices is None and p.device == torch.device("cpu")
