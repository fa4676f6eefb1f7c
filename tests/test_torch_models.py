"""The port's network modules against the flax modules and the Pallas
kernels (interpret mode), in f32 on the CPU.

Weights are the flax modules' random init (or the committed npz), mapped
with `from_jax_variables`; eval BatchNorm statistics are randomized so the
folded affine is non-trivial. The port's decoder tail (K3) and PointNet
(K4/K5) run their plain versions here. Tolerances are 2e-5 (3e-5 for the
PointNet, as `tests/test_pointnet_pallas.py`): f32 with products summed in
another order by XLA and by PyTorch, nothing else. In bf16 the plain
versions are held to one bf16 step of the Pallas kernels.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsurf_tpu.models import norm as jnorm
from ppsurf_tpu.models.decoder import InterpAttentionKHeadsNet as JDecoder
from ppsurf_tpu.models.fkaconv import gather_neighbors as jgather
from ppsurf_tpu.models.pointnet import MLP as JMLP
from ppsurf_tpu.models.pointnet import PointNetfeat as JPointNetfeat
from ppsurf_tpu.ops.decoder_pallas import decoder_tail_pallas
from ppsurf_tpu.ops.pointnet_pallas import pointnet_att_pallas
from ppsurf_tpu_torch.convert.infer_npz import from_jax_variables
from ppsurf_tpu_torch.models import norm
from ppsurf_tpu_torch.models.decoder import InterpAttentionKHeadsNet
from ppsurf_tpu_torch.models.pointnet import MLP, PointNetfeat
from ppsurf_tpu_torch.ops.decoder_tail import decoder_tables, decoder_tail_plain
from ppsurf_tpu_torch.ops.pointnet_att import (
    pointnet_head_plain, pointnet_tables, pointnet_trunk_plain, stn_apply,
)


@functools.partial(jax.jit, static_argnums=0)
def _init(net, *args):
    return net.init(*args)


def _random_stats(variables, rng):
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.rand(*x.shape).astype(np.float32) * 0.5 + 0.5),
        variables["batch_stats"],
    )
    return {"params": variables["params"], "batch_stats": stats}


def _load(module, variables):
    module.load_state_dict(from_jax_variables(variables, module), strict=True)
    return module.eval().requires_grad_(False)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batchnorm_matches_flax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 30, 16).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    bn = jnorm.BatchNorm(dtype=jdt)
    variables = _random_stats(bn.init(jax.random.key(0), jnp.asarray(x), False), rng)
    variables["params"] = {"scale": rng.rand(16).astype(np.float32) + 0.5,
                           "bias": rng.randn(16).astype(np.float32)}
    ref = np.asarray(bn.apply(variables, jnp.asarray(x).astype(jdt), False).astype(jnp.float32))
    ours = _load(norm.BatchNorm(16, dtype=tdt), variables)(_t(x).to(tdt)).float().numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=2e-5)


def test_instance_norm_matches_flax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 40, 16, 8).astype(np.float32) * 3 + 1
    inn = jnorm.InstanceNorm()
    variables = inn.init(jax.random.key(0), jnp.asarray(x))
    variables = {"params": {"scale": rng.rand(8).astype(np.float32) + 0.5,
                            "bias": rng.randn(8).astype(np.float32)}}
    ref = np.asarray(inn.apply(variables, jnp.asarray(x)))
    ours = _load(norm.InstanceNorm(8), variables)(_t(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=2e-5)


def test_mlp_matches_flax():
    rng = np.random.RandomState(2)
    x = rng.randn(50, 256).astype(np.float32)
    mlp = JMLP(output_size=2, num_layers=3, halving_size=False, dropout=0.3)
    variables = _random_stats(mlp.init(jax.random.key(1), jnp.asarray(x)), rng)
    ref = np.asarray(mlp.apply(variables, jnp.asarray(x), train=False))
    ours = _load(MLP(256, 2, 3), variables)(_t(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=2e-5)


def _decoder_setup(latent=256, k=64, n=300, q=160, seed=0):
    rng = np.random.RandomState(seed)
    lat = rng.randn(1, n, latent).astype(np.float32)
    pts = rng.rand(1, n, 3).astype(np.float32) - 0.5
    queries = (rng.rand(1, q, 3).astype(np.float32) - 0.5) * 1.2
    ids = rng.randint(0, n, size=(1, q, k)).astype(np.int32)
    net = JDecoder(latent, latent, k=k, dtype=jnp.float32)
    variables = _init(net, jax.random.key(1), jnp.asarray(lat), jnp.asarray(pts),
                      jnp.asarray(queries), jnp.asarray(ids))
    ours = _load(InterpAttentionKHeadsNet(latent, latent, k), variables)
    return net, variables, ours, lat, pts, queries, ids


def test_decoder_plain_form_matches_flax():
    net, variables, ours, lat, pts, queries, ids = _decoder_setup()
    ref = np.asarray(net.apply(variables, jnp.asarray(lat), jnp.asarray(pts),
                               jnp.asarray(queries), jnp.asarray(ids)))
    out = ours(_t(lat), _t(pts), _t(queries), _t(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("latent", [256, 32])
def test_decoder_tail_matches_flax_and_pallas(latent):
    """Projected latents (fc1 folded per point): the port's decoder tail
    (K3's plain version) against the flax path and the interpret-mode
    Pallas kernel, at PPSurf's latent 256 and POCO's latent 32."""
    net, variables, ours, lat, pts, queries, ids = _decoder_setup(latent=latent, seed=3)
    p = variables["params"]
    k1 = np.asarray(p["fc1"]["kernel"])
    lat_p = lat @ k1[:latent] + np.asarray(p["fc1"]["bias"])
    var_p = {"params": dict(p, fc1={"kernel": jnp.asarray(k1[latent:])})}
    ref = np.asarray(net.apply(var_p, jnp.asarray(lat_p), jnp.asarray(pts),
                               jnp.asarray(queries), jnp.asarray(ids),
                               last_layer=False, latents_projected=True))[0]
    x = jgather(jnp.asarray(lat_p), jnp.asarray(ids))[0]
    rel = jnp.asarray(queries)[0][:, None, :] - jgather(jnp.asarray(pts), jnp.asarray(ids))[0]
    pp = var_p["params"]
    pallas = np.asarray(decoder_tail_pallas(
        x, rel, pp["fc1"]["kernel"], pp["fc2"]["kernel"], pp["fc2"]["bias"],
        pp["fc3"]["kernel"], pp["fc3"]["bias"], pp["fc_query"]["kernel"],
        pp["fc_query"]["bias"], pp["fc_value"]["kernel"], pp["fc_value"]["bias"],
        k=64, heads=64, tq=32, interpret=True,
    ))
    out = ours(_t(lat_p), _t(pts), _t(queries), _t(ids).long(), last_layer=False,
               latents_projected=True)[0].numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)


def test_decoder_tail_bf16_matches_pallas():
    """K3's plain version in bf16 against the interpret-mode Pallas kernel
    in bf16: the same rounding points, so outputs differ by at most one
    bf16 step (2^-8 relative) where an f32 sum taken in another order
    rounds to the neighbouring value."""
    net, variables, ours, lat, pts, queries, ids = _decoder_setup(seed=3)
    p = variables["params"]
    k1 = np.asarray(p["fc1"]["kernel"])
    lat_p = (lat @ k1[:256] + np.asarray(p["fc1"]["bias"]))[0]
    x = jgather(jnp.asarray(lat_p)[None], jnp.asarray(ids))[0].astype(jnp.bfloat16)
    rel = jnp.asarray(queries)[0][:, None, :] - jgather(jnp.asarray(pts), jnp.asarray(ids))[0]
    pallas = np.asarray(decoder_tail_pallas(
        x, rel, k1[256:], p["fc2"]["kernel"], p["fc2"]["bias"], p["fc3"]["kernel"],
        p["fc3"]["bias"], p["fc_query"]["kernel"], p["fc_query"]["bias"],
        p["fc_value"]["kernel"], p["fc_value"]["bias"], k=64, heads=64, tq=32,
        interpret=True,
    ).astype(jnp.float32))
    out = decoder_tail_plain(
        _t(lat_p).to(torch.bfloat16), _t(pts[0]), _t(queries[0]), _t(ids[0]).long(),
        decoder_tables(ours, torch.bfloat16),
    ).float().numpy()
    np.testing.assert_allclose(out, pallas, rtol=0,
                               atol=2.0 ** -8 * max(1.0, np.abs(pallas).max()))


def _pointnet_setup(c=32, p=50, seed=0):
    rng = np.random.RandomState(seed)
    patches = (rng.rand(c, p, 3).astype(np.float32) - 0.5) * 2.0
    net = JPointNetfeat(net_size_max=256, output_size=256, use_point_stn=False,
                        use_feat_stn=True, sym_op="att", dim=3)
    variables = _random_stats(_init(net, jax.random.key(1), jnp.asarray(patches[:4])), rng)
    return net, variables, _load(PointNetfeat(256, 256), variables), patches


@functools.partial(jax.jit, static_argnums=0)
def _pointnet_apply(net, variables, patches):
    return net.apply(variables, patches, train=False)[0]


def test_pointnet_matches_flax_and_pallas():
    net, variables, ours, patches = _pointnet_setup()
    ref = np.asarray(_pointnet_apply(net, variables, jnp.asarray(patches)))
    pallas = np.asarray(pointnet_att_pallas(
        jnp.asarray(patches), variables["params"], variables["batch_stats"],
        p_real=50, tq=32, interpret=True,
    ))
    out = ours(_t(patches)).numpy()
    np.testing.assert_allclose(out, ref, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(out, pallas, rtol=3e-5, atol=3e-5)


def test_pointnet_bf16_matches_pallas():
    """K4/STN/K5 plain versions in bf16 against the interpret-mode Pallas
    kernels in bf16: at most one bf16 step apart (as the decoder tail)."""
    net, variables, _, patches = _pointnet_setup(seed=2)
    pallas = np.asarray(pointnet_att_pallas(
        jnp.asarray(patches).astype(jnp.bfloat16), variables["params"],
        variables["batch_stats"], p_real=50, tq=32, interpret=True,
    ).astype(jnp.float32))
    ours = _load(PointNetfeat(256, 256, dtype=torch.bfloat16), variables)
    out = ours(_t(patches)).float().numpy()
    np.testing.assert_allclose(out, pallas, rtol=0,
                               atol=2.0 ** -8 * max(1.0, np.abs(pallas).max()))


def test_pointnet_stages_match_flax_layers():
    """K4's plain version (b, pooled) and the STN transform against the
    flax submodules applied layer by layer."""
    net, variables, ours, patches = _pointnet_setup(c=40, seed=5)
    t = pointnet_tables(ours)
    b, pooled = pointnet_trunk_plain(_t(patches), t)

    def stage(x, conv, bn):
        return jax.nn.relu(jnorm.BatchNorm().apply(
            {"params": variables["params"][bn], "batch_stats": variables["batch_stats"][bn]},
            x @ variables["params"][conv]["kernel"] + variables["params"][conv]["bias"], False))

    jb = stage(stage(jnp.asarray(patches), "conv0a", "bn0a"), "conv0b", "bn0b")
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=2e-5, atol=2e-5)
    x2 = stn_apply(pooled, b, t)
    out = pointnet_head_plain(x2, t)
    ref = np.asarray(_pointnet_apply(net, variables, jnp.asarray(patches)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=3e-5, atol=3e-5)


def test_from_latent_matches_flax_with_committed_weights():
    """`from_latent` on its unfused branches (plain decoder, PointNet
    module, sum fusion, MLP) against the flax network with the committed
    npz weights; 1e-4 as the field tests (deeper stack, trained scales)."""
    from ppsurf_tpu.convert.infer_npz import load_infer_npz as jax_load
    from ppsurf_tpu.train.model import ppsurf_spec as jax_spec
    from ppsurf_tpu_torch.convert.infer_npz import load_network
    from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    rng = np.random.RandomState(8)
    data = {
        "latents": rng.randn(1, 300, 256).astype(np.float32),
        "pts": (rng.rand(1, 300, 3) - 0.5).astype(np.float32),
        "pts_query": (rng.rand(1, 40, 3) - 0.5).astype(np.float32),
        "proj_ids": rng.randint(0, 300, size=(1, 40, 64)),
        "pts_local_ps": (rng.rand(1, 40, 50, 3) * 2 - 1).astype(np.float32),
    }
    variables = jax_load(DEFAULT_WEIGHTS)
    net = jax_spec().make_network()
    ref = np.asarray(jax.jit(lambda v, d: net.apply(v, d, method=net.from_latent))(
        variables, {k: jnp.asarray(v) for k, v in data.items()}))
    ours = load_network(ppsurf_spec(), variables, torch.device("cpu"))
    with torch.inference_mode():
        out = ours.from_latent({k: _t(v) for k, v in data.items()}).numpy()
    assert out.shape == ref.shape == (1, 40, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
