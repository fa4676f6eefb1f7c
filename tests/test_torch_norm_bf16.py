"""bf16 `Dense` rounding and the train-mode modules against flax, on the CPU.

- `dense` in bf16 rounds its input and kernel to bf16 before the product,
  as flax's `promote_dtype` does: `Dense` equals `nn.Dense(dtype=bf16)`
  bit for bit (products of bf16 values summed in f32, rounded once).
  Before this rounding the port multiplied by the f32 kernel and a third
  of the outputs moved by up to 0.02.
- `silu` in bf16 rounds each of jax.nn.silu's four operations, as XLA
  evaluates them: bit-identical to flax's.
- The bf16 MLP head against flax in eval mode, bit-identical; the bf16
  FKAConv encoder within the limits its docstring derives.
- Train mode, f32: `BatchNorm` with the batch's biased statistics and its
  updated running statistics, one FKAConv layer with its radius EMA
  (divided by the updated radius in the same pass), the feature STN and
  the whole `PointNetfeat` with its BatchNorm statistics, each against
  flax's `mutable=['batch_stats']` apply to 2e-5 (f32 sums reordered).
- The new differentiable `PointNetfeat.forward_plain` in eval mode
  against `ops.pointnet_att`'s plain version (K4, STN head, K5): f32 to
  3e-5 as `tests/test_torch_models.py`, bf16 to one bf16 step.
"""
from __future__ import annotations

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsurf_tpu.models import norm as jnorm
from ppsurf_tpu.models.fkaconv import FKAConvLayer as JFKAConvLayer
from ppsurf_tpu.models.fkaconv import FKAConvNetwork as JFKAConvNetwork
from ppsurf_tpu.models.pointnet import MLP as JMLP
from ppsurf_tpu.models.pointnet import STN as JSTN
from ppsurf_tpu.models.pointnet import PointNetfeat as JPointNetfeat
from ppsurf_tpu.ops.graph import build_fkaconv_graph as jbuild_graph
from ppsurf_tpu_torch.convert.infer_npz import from_jax_variables, to_jax_variables
from ppsurf_tpu_torch.models import norm
from ppsurf_tpu_torch.models.fkaconv import FKAConvLayer, FKAConvNetwork
from ppsurf_tpu_torch.models.pointnet import MLP, STN, PointNetfeat
from ppsurf_tpu_torch.ops.pointnet_att import (
    pointnet_head_plain, pointnet_tables, pointnet_trunk_plain, stn_apply,
)

BF16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load(module, variables):
    module.load_state_dict(from_jax_variables(variables, module), strict=True)
    return module


def _random_stats(variables, rng):
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.rand(*x.shape), np.float32) * 0.5 + 0.5,
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def _bf16_bits(x):
    return np.asarray(jnp.asarray(x, jnp.float32)).view(np.uint32)


@pytest.mark.parametrize("with_bias", [True, False])
def test_dense_bf16_equals_flax(with_bias):
    rng = np.random.RandomState(0)
    x = rng.randn(64, 256).astype(np.float32)
    kernel = (rng.randn(256, 256) * 0.05).astype(np.float32)
    bias = (rng.randn(256) * 0.1).astype(np.float32)
    dense = fnn.Dense(256, use_bias=with_bias, dtype=jnp.bfloat16)
    params = {"kernel": kernel, **({"bias": bias} if with_bias else {})}
    ref = dense.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    ours = norm.Dense(256, 256, use_bias=with_bias, dtype=BF16)
    with torch.no_grad():
        ours.kernel.copy_(_t(kernel))
        if with_bias:
            ours.bias.copy_(_t(bias))
        out = ours(_t(x).to(BF16))
    assert out.dtype == BF16
    np.testing.assert_array_equal(out.float().numpy().view(np.uint32), _bf16_bits(ref))
    # an f32 input is rounded to bf16 first, as promote_dtype does
    with torch.no_grad():
        np.testing.assert_array_equal(ours(_t(x)).float().numpy().view(np.uint32),
                                      _bf16_bits(ref))


def _encoder_case(n=400, seed=1):
    rng = np.random.RandomState(seed)
    pts = rng.rand(1, n, 3).astype(np.float32) - 0.5
    graph = jbuild_graph(jnp.asarray(pts), jax.random.key(seed), tile=64)
    data = {"pts": jnp.asarray(pts), **graph}
    return rng, data


def test_encoder_bf16_matches_flax():
    """Every Dense, SiLU and product rounds where flax's does, but a bf16
    product summed in f32 in another order rounds to the neighbouring
    value in about 1 output in 5000 (0.02% of fc2's in the first FKAConv
    layer), and 40-odd layers with eval BatchNorm spread those seeds: the
    limits are 0.3% of the output's largest |value| for the mean
    |difference| (measured 0.21%) and 2% for the largest (measured 1.0%)."""
    rng, data = _encoder_case()
    jnet = JFKAConvNetwork(3, 32, activation=fnn.silu, x4d_bug_fixed=True, dtype=jnp.bfloat16)
    variables = _random_stats(jax.jit(jnet.init)(jax.random.key(0), data), rng)
    ref = np.asarray(jax.jit(functools.partial(jnet.apply, train=False))(variables, data)
                     .astype(jnp.float32))
    ours_net = _load(FKAConvNetwork(3, 32, activation=norm.silu, dtype=BF16), variables)
    tdata = {k: torch.from_numpy(np.array(v)).long() if k.startswith("ids")
             else _t(v) for k, v in data.items()}
    with torch.no_grad():
        ours = ours_net(tdata).float().numpy()
    d = np.abs(ours - ref) / np.abs(ref).max()
    assert d.mean() <= 0.003 and d.max() <= 0.02, (d.mean(), d.max())


def test_silu_bf16_equals_jax():
    x = np.random.RandomState(7).randn(100000).astype(np.float32) * 4
    ref = np.asarray(jax.jit(fnn.silu)(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    ours = norm.silu(_t(x).to(BF16))
    assert ours.dtype == BF16
    np.testing.assert_array_equal(ours.float().numpy(), ref)
    ref32 = np.asarray(jax.jit(fnn.silu)(jnp.asarray(x)))
    np.testing.assert_allclose(norm.silu(_t(x)).numpy(), ref32, rtol=1e-6, atol=1e-7)


def test_mlp_bf16_equals_flax():
    """Three Dense layers of 256 with eval BatchNorm: bit-identical (the
    unrounded kernel made 80% of these outputs differ)."""
    rng = np.random.RandomState(2)
    x = rng.randn(200, 256).astype(np.float32)
    mlp = JMLP(output_size=2, num_layers=3, halving_size=False, dropout=0.3,
               dtype=jnp.bfloat16)
    variables = _random_stats(mlp.init(jax.random.key(1), jnp.asarray(x)), rng)
    ref = np.asarray(mlp.apply(variables, jnp.asarray(x, jnp.bfloat16), train=False)
                     .astype(jnp.float32))
    with torch.no_grad():
        ours = _load(MLP(256, 2, 3, dropout=0.3, dtype=BF16), variables)(
            _t(x).to(BF16)).float().numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batchnorm_train_matches_flax(dtype):
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 30, 16) * 2 + 1).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, BF16)}[dtype]
    bn = jnorm.BatchNorm(dtype=jdt)
    variables = _random_stats(bn.init(jax.random.key(0), jnp.asarray(x), False), rng)
    variables["params"] = {"scale": rng.rand(16).astype(np.float32) + 0.5,
                           "bias": rng.randn(16).astype(np.float32)}
    ref, mutated = bn.apply(variables, jnp.asarray(x).astype(jdt), True,
                            mutable=["batch_stats"])
    ours_bn = _load(norm.BatchNorm(16, dtype=tdt), variables)
    with torch.no_grad():
        ours = ours_bn(_t(x).to(tdt), train=True).float().numpy()
    np.testing.assert_allclose(ours, np.asarray(ref.astype(jnp.float32)), rtol=2e-5,
                               atol=2e-5 if dtype == "f32" else 2 ** -7)
    for name in ("mean", "var"):  # biased variance, momentum 0.1, in place
        np.testing.assert_allclose(getattr(ours_bn, name).numpy(),
                                   np.asarray(mutated["batch_stats"][name]), rtol=2e-5,
                                   atol=1e-6)


def test_fkaconv_layer_radius_ema_matches_flax():
    rng = np.random.RandomState(4)
    b, n, m, k, c = 2, 60, 20, 16, 8
    pts = rng.rand(b, n, 3).astype(np.float32)
    support = pts[:, :m]
    ids = np.stack([np.argsort(((support[i][:, None] - pts[i][None]) ** 2).sum(-1), axis=1)[:, :k]
                    for i in range(b)]).astype(np.int32)
    x = rng.randn(b, n, c).astype(np.float32)
    layer = JFKAConvLayer(12, k, activation=fnn.silu)
    args = [jnp.asarray(a) for a in (x, pts, support, ids)]
    variables = layer.init(jax.random.key(0), *args, False)
    variables = {"params": variables["params"],
                 "batch_stats": {"norm_radius": np.float32(0.7)}}
    ours = _load(FKAConvLayer(c, 12, k, activation=norm.silu), variables)
    targs = [_t(x), _t(pts), _t(support), torch.from_numpy(ids).long()]
    for _ in range(2):  # the second pass starts from the updated radius
        ref, mutated = layer.apply(variables, *args, True, mutable=["batch_stats"])
        with torch.no_grad():
            out = ours(*targs, train=True).numpy()
        np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(float(ours.norm_radius),
                                   float(mutated["batch_stats"]["norm_radius"]), rtol=1e-6)
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    # eval mode leaves the radius alone
    with torch.no_grad():
        ours(*targs, train=False)
    np.testing.assert_allclose(float(ours.norm_radius),
                               float(mutated["batch_stats"]["norm_radius"]), rtol=1e-6)


def _pointnet_case(c=24, p=50, seed=5):
    rng = np.random.RandomState(seed)
    patches = (rng.rand(c, p, 3).astype(np.float32) - 0.5) * 2
    net = JPointNetfeat(net_size_max=256, output_size=256, use_point_stn=False,
                        use_feat_stn=True, sym_op="att", dim=3)
    variables = _random_stats(jax.jit(net.init)(jax.random.key(seed), jnp.asarray(patches)), rng)
    return rng, patches, net, variables


def test_stn_and_pointnetfeat_train_match_flax():
    rng, patches, net, variables = _pointnet_case()
    ref, mutated = jax.jit(functools.partial(net.apply, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(patches))
    ours = _load(PointNetfeat(256, 256), variables)
    with torch.no_grad():
        out = ours(_t(patches), train=True).numpy()
    np.testing.assert_allclose(out, np.asarray(ref[0]), rtol=2e-5, atol=2e-5)
    mine = _flat(to_jax_variables(ours)["batch_stats"])
    theirs = _flat(jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))
    assert set(mine) == set(theirs)
    for name, v in theirs.items():
        np.testing.assert_allclose(mine[name], v, rtol=2e-5, atol=1e-6, err_msg=name)

    # the STN alone, train and eval
    stn = JSTN(256, dim=64)
    h = (rng.randn(16, 50, 64)).astype(np.float32)
    svars = _random_stats(stn.init(jax.random.key(1), jnp.asarray(h)), rng)
    ours_stn = _load(STN(256, 64), svars)
    for train in (True, False):
        ref_t = stn.apply(svars, jnp.asarray(h), train, mutable=["batch_stats"])[0]
        with torch.no_grad():
            np.testing.assert_allclose(ours_stn(_t(h), train).numpy(), np.asarray(ref_t),
                                       rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pointnetfeat_plain_forward_matches_pointnet_att(dtype):
    _, patches, _, variables = _pointnet_case(seed=6)
    tdt = {"f32": torch.float32, "bf16": BF16}[dtype]
    ours = _load(PointNetfeat(256, 256, dtype=tdt), variables)
    with torch.no_grad():
        plain = ours.forward_plain(_t(patches), train=False).float().numpy()
        t = pointnet_tables(ours)
        b, pooled = pointnet_trunk_plain(_t(patches).to(tdt), t)
        att = pointnet_head_plain(stn_apply(pooled, b, t), t).float().numpy()
        routed = ours(_t(patches)).float().numpy()  # eval: through pointnet_att
    np.testing.assert_array_equal(routed, att)
    if dtype == "f32":
        np.testing.assert_allclose(plain, att, rtol=3e-5, atol=3e-5)
    else:  # the same rounding points; a reordered f32 sum may round one step apart
        np.testing.assert_allclose(plain, att, rtol=2 ** -7, atol=2 ** -7 * np.abs(att).max())
