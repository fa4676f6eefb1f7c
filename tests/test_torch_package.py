"""Package rules of the PyTorch/CUDA port (ppsurf_tpu_torch).

- no file of the port imports jax, flax or the JAX package, nor pandas,
  PIL or openpyxl (the machine with the card has none of them),
  statically or at run time (package, chip_smoke.py,
  chip_rounding_control.py and bench_torch.py);
- entry points (the predictor, the trainer, the scoring: `points_inside`,
  `evaluate_reconstructions`, `make_evaluation`) default to CUDA and
  raise where there is none;
- the committed weights map onto the port's network key for key;
- on a card, each kernel wrapper launches its kernel and agrees with its
  plain version, K1 exactly also on duplicates, clusters with far queries,
  shuffled clouds and masks with fewer valid points than k, K2 also on
  all-tie rows at kc in {33, 192, 256} and T1 `full` at 1536 candidates,
  the bf16 tensor-core K3-K5 within the smoke's bf16 limits, K3 also at
  L=32 (POCO) and at k < 64 and K4/K5 at P in (64, 256] in both dtypes,
  and W1 (the metrics' winding number) within 1e-4 of its plain version,
  its inside masks equal outside |w - 0.5| <= 1e-3, on a closed mesh with
  queries on vertices and degenerate faces, a single face and 8 193 faces
  (marked `cuda`: skips on a machine without one).
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ppsurf_tpu_torch")
WEIGHTS = os.path.join(REPO, "models_pretrained", "ppsurf_mini_infer.npz")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ppsurf_tpu", "pandas", "PIL",
             "openpyxl")


def _port_files():
    files = [os.path.join(REPO, n)
             for n in ("chip_smoke.py", "chip_rounding_control.py", "bench_torch.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


# modules that must exist (their imports are checked with every other file)
MODULES = ("cli.py", "rec.py", "data/datasets.py", "models/poco.py", "convert/init.py",
           "convert/checkpoint.py", "ops/encoding.py", "recon/predict.py", "train/loop.py",
           "train/evaluate.py", "metrics/classification.py", "eval/reports.py",
           "eval/xlsx.py", "metrics/sampling.py", "metrics/proximity.py",
           "metrics/winding.py", "metrics/mesh_metrics.py", "ops/winding.py", "utils/fs.py",
           "eval/make_evaluation.py", "convert/torch_ckpt.py", "eval/make_comparison.py",
           "utils/mp.py", "utils/container.py", "utils/visualization.py", "utils/png.py",
           "utils/alloc.py", "figures/comp_base.py", "figures/prepare_figures.py",
           "figures/render_figures.py", "figures/fix_imls.py",
           "campaigns/full_run_pps.py", "campaigns/full_run_pps_mini.py",
           "campaigns/full_run_poco.py", "campaigns/full_run_poco_mini.py",
           "parallel/mesh.py", "utils/profiling.py", "tools/dryrun_multihost.py",
           "tools/bench.py", "ops/opcount.py", "data/synthetic.py", "utils/spans.py")


def test_no_file_of_the_port_imports_jax():
    files = {os.path.relpath(p, PKG) for p in _port_files()}
    assert set(MODULES) <= files
    bad = []
    for path in _port_files():
        for mod in _imported_roots(path):
            root = mod.split(".")[0]
            if root in FORBIDDEN:
                bad.append((os.path.relpath(path, REPO), mod))
    assert len(_port_files()) > 20
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import ppsurf_tpu_torch\n"
        "for m in pkgutil.walk_packages(ppsurf_tpu_torch.__path__, 'ppsurf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, chip_rounding_control, bench_torch\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len([m for m in sys.modules if m.startswith('ppsurf_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20


def test_predictor_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from ppsurf_tpu_torch.device import resolve_device
    from ppsurf_tpu_torch.recon.predict import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from ppsurf_tpu_torch.train.loop import TrainConfig, Trainer
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(ppsurf_spec(), TrainConfig(default_root_dir="unused"))
    assert Trainer(ppsurf_spec(), TrainConfig(default_root_dir="unused"),
                   device="cpu").device.type == "cpu"


def test_scoring_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from ppsurf_tpu_torch.eval import make_evaluation
    from ppsurf_tpu_torch.eval.reports import make_quantitative_comparison
    from ppsurf_tpu_torch.io.ply import Mesh
    from ppsurf_tpu_torch.metrics.winding import points_inside
    from ppsurf_tpu_torch.train.evaluate import evaluate_reconstructions
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tri = Mesh(np.eye(3, dtype=np.float32), np.array([[0, 1, 2]]))
    empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    for call in (lambda: points_inside(tri, np.zeros((2, 3))),
                 lambda: points_inside(empty, np.zeros((2, 3))),
                 lambda: evaluate_reconstructions(ppsurf_spec(), str(tmp_path / "testset.txt")),
                 lambda: make_evaluation.evaluate_method_on_dataset("m", "d"),
                 lambda: make_evaluation.main(["--model_names", "m", "--dataset_names", "d"]),
                 lambda: make_quantitative_comparison(["s"], ["gt.ply"], ["m"], ["{}.ply"],
                                                      str(tmp_path))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not points_inside(empty, np.zeros((2, 3)), device="cpu").any()


def test_committed_weights_fill_the_network_key_for_key():
    from ppsurf_tpu_torch.convert.infer_npz import from_jax_variables, load_infer_npz
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    with np.load(WEIGHTS) as z:
        n_keys = len(z.files)
    variables = load_infer_npz(WEIGHTS)
    net = ppsurf_spec().make_network()
    state = from_jax_variables(variables, net)
    assert len(state) == n_keys == len(net.state_dict())
    net.load_state_dict(state, strict=True)

    variables["params"]["projection"]["fc9"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="left over"):
        from_jax_variables(variables, net)
    del variables["params"]["projection"]["fc9"]
    del variables["batch_stats"]["point_net"]["bn1"]["var"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_variables(variables, net)


def test_kernel_wrappers_take_the_plain_version_only_on_cpu(monkeypatch):
    """A CPU tensor never builds or launches a kernel; the launch counts
    stay 0 and the build is never asked for."""
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.ops.knn import knn
    from ppsurf_tpu_torch.ops.topk_rows import topk_rows
    from ppsurf_tpu_torch.ops.winding import winding
    from ppsurf_tpu_torch.tools.microbench_extract import VARIANTS, extract

    def no_build():
        raise AssertionError("kernel build requested for a CPU tensor")

    monkeypatch.setattr(kernels, "build", no_build)
    kernels.reset_launches()
    pts = torch.rand(300, 3)
    ids = knn(pts, pts[:10], 8)
    assert ids.shape == (10, 8) and (ids[:, 0] == torch.arange(10)).all()
    assert (knn(pts, pts[:10], 192)[:, 0] == torch.arange(10)).all()
    assert (topk_rows(torch.rand(10, 192), 64) < 192).all()
    for variant in VARIANTS:
        assert extract(torch.rand(10, 64), variant, 8).shape == (10, 8)
    tri = torch.rand(3, 5, 3)
    assert winding(torch.rand(7, 3), *tri).shape == (7,)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ppsurf_tpu_torch.convert.infer_npz import load_infer_npz, load_network
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.ops.decoder_tail import decoder_tables, decoder_tail, decoder_tail_plain
    from ppsurf_tpu_torch.ops.knn import knn, knn_plain
    from ppsurf_tpu_torch.ops.patches import patch_space
    from ppsurf_tpu_torch.ops.pointnet_att import (
        pointnet_head, pointnet_head_plain, pointnet_tables, pointnet_trunk,
        pointnet_trunk_plain, stn_apply,
    )
    from ppsurf_tpu_torch.ops.topk_rows import topk_rows, topk_rows_plain
    from ppsurf_tpu_torch.ops.winding import winding, winding_plain
    from ppsurf_tpu_torch.tools.microbench_extract import VARIANTS, extract, extract_plain
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand(3000, 3, generator=g, device=dev)
    q = torch.rand(700, 3, generator=g, device=dev)
    kernels.reset_launches()
    ids = knn(pts, q, 64)
    assert torch.equal(ids, knn_plain(pts, q, 64))
    assert torch.equal(knn(pts, q, 192), knn_plain(pts, q, 192))
    d2 = torch.rand(700, 192, generator=g, device=dev)
    d2[:, 1::7] = d2[:, 0::7][:, :28]
    d2[0, :8] = torch.tensor([float("inf"), 1e30, float("nan"), -0.0, 0.0, -1e38, 3e12, 1e30])
    assert torch.equal(topk_rows(d2, 64), topk_rows_plain(d2, 64))
    cand = torch.rand(700, 300, generator=g, device=dev)
    for variant in VARIANTS:
        assert torch.equal(extract(cand, variant, 16), extract_plain(cand, variant, 16)), variant
    net = load_network(ppsurf_spec(), load_infer_npz(WEIGHTS), dev)
    lat = torch.randn(3000, 256, generator=g, device=dev)
    tabs = decoder_tables(net.projection, torch.float32)
    torch.testing.assert_close(decoder_tail(lat, pts, q, ids, tabs),
                               decoder_tail_plain(lat, pts, q, ids, tabs),
                               rtol=1e-4, atol=1e-4)
    pt = pointnet_tables(net.point_net)
    patches = pts[ids[:, :50]] - q[:, None]
    for a, b in zip(pointnet_trunk(patches, pt), pointnet_trunk_plain(patches, pt)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    x2 = torch.randn(700, 50, 64, generator=g, device=dev)
    torch.testing.assert_close(pointnet_head(x2, pt), pointnet_head_plain(x2, pt),
                               rtol=1e-4, atol=1e-4)
    # W1 on 2000 small triangles (its closed-mesh cases: the test below)
    a = pts[:2000]
    tri = (a, a + 0.01 * torch.rand(a.shape, generator=g, device=dev),
           a + 0.01 * torch.rand(a.shape, generator=g, device=dev))
    torch.testing.assert_close(winding(q, *tri), winding_plain(q, *tri), rtol=0, atol=1e-4)
    wider = ("decoder_tail_l32", "pointnet_trunk_wide", "pointnet_head_wide")
    assert all(v == (k not in wider) for k, v in kernels.LAUNCHES.items()), kernels.LAUNCHES

    def within_bf16_limits(pairs):
        """The smoke's bf16 limits: max and mean |kernel - plain| within
        1.6e-2 and 2e-6 x scale, scale = max(1, max |plain|)."""
        scale = max([1.0] + [float(b.float().abs().max()) for _, b in pairs])
        diffs = [(a.float() - b.float()).abs() for a, b in pairs]
        mean = sum(float(d.sum()) for d in diffs) / sum(d.numel() for d in diffs)
        err = max(float(d.max()) for d in diffs)
        return err <= 1.6e-2 * scale and mean <= 2e-6 * scale

    # K3, K4 and K5 in bf16 (the tensor-core builds), within the smoke's
    # bf16 limits; K4/K5 at C=701 (not a multiple of the patches a block
    # takes) and P in {17, 50, 64}, on patches in patch space (each scaled
    # to unit radius) as the field evaluator makes them
    net16 = load_network(ppsurf_spec(dtype=torch.bfloat16), load_infer_npz(WEIGHTS), dev)
    tabs16 = decoder_tables(net16.projection, torch.bfloat16)
    lat16 = lat.to(torch.bfloat16)
    assert within_bf16_limits([(decoder_tail(lat16, pts, q, ids, tabs16),
                                decoder_tail_plain(lat16, pts, q, ids, tabs16))])
    pt16 = pointnet_tables(net16.point_net)
    q701 = torch.rand(701, 3, generator=g, device=dev)
    ids701 = knn_plain(pts, q701, 64)
    for p in (17, 50, 64):
        patches = patch_space(pts[ids701[:, :p]], q701).to(torch.bfloat16)
        b_p, pool_p = pointnet_trunk_plain(patches, pt16)
        assert within_bf16_limits(list(zip(pointnet_trunk(patches, pt16), (b_p, pool_p)))), p
        x2 = stn_apply(pool_p, b_p, pt16)
        assert within_bf16_limits([(pointnet_head(x2, pt16), pointnet_head_plain(x2, pt16))]), p

    # K1 edge cases, each exact: k in {1, 16, 64, 192, 256} on a shuffled
    # cloud, exact duplicates, a cluster with outliers and far queries, and
    # fewer valid points than k
    dup = torch.rand(10, 3, generator=g, device=dev).repeat_interleave(200, dim=0)
    dup = torch.cat([dup, torch.rand(500, 3, generator=g, device=dev)])
    cluster = torch.cat([1e-3 * torch.randn(2000, 3, generator=g, device=dev),
                         10 * torch.randn(50, 3, generator=g, device=dev)])
    far = torch.cat([cluster[:200], 1e3 + torch.rand(20, 3, generator=g, device=dev)])
    valid = torch.zeros(3000, dtype=torch.bool, device=dev)
    valid[torch.randperm(3000, generator=g, device=dev)[:100]] = True
    cases = ((pts[torch.randperm(3000, generator=g, device=dev)], q, None),
             (dup, dup[::7], None), (cluster, far, None), (pts, q[:200], valid))
    for p, qq, v in cases:
        for k in (1, 16, 64, 192, 256):
            assert torch.equal(knn(p, qq, k, v), knn_plain(p, qq, k, v)), (k, p.shape)

    # K2 on rows that are all ties (every other row one value repeated,
    # the rest with pairs of equal entries), T1 `full` at 1536 candidates
    for kc in (33, 192, 256):
        d = torch.rand(701, kc, generator=g, device=dev)
        d[::2] = d[::2, :1]
        d[1::2, 1::2] = d[1::2, 0:kc - 1:2]
        for k in sorted({min(64, kc), kc}):
            assert torch.equal(topk_rows(d, k), topk_rows_plain(d, k)), (kc, k)
    cand = torch.rand(701, 1536, generator=g, device=dev)
    assert torch.equal(extract(cand, "full", 64), extract_plain(cand, "full", 64))

    # K3 at L=32 (POCO's seeded weights) and L=256, at k < 64; K4/K5 at
    # P > 64 (two to four 64-row tiles; the bf16 K5 a cluster of as many
    # CTAs), f32 to 1e-4 and bf16 within the smoke's limits
    from ppsurf_tpu_torch.convert.init import init_variables
    from ppsurf_tpu_torch.train.model import poco_spec

    ids256 = knn_plain(pts, q701, 256)
    for dt in (torch.float32, torch.bfloat16):
        def agree(a, b):
            if dt == torch.float32:
                return torch.allclose(a, b, rtol=1e-4, atol=1e-4)
            return within_bf16_limits([(a, b)])

        poco = load_network(poco_spec(dtype=dt), init_variables(poco_spec()), dev)
        ppsurf = net16 if dt == torch.bfloat16 else net
        for proj, width in ((poco.projection, 32), (ppsurf.projection, 256)):
            tabs = decoder_tables(proj, dt)
            lat_w = torch.randn(3000, width, generator=g, device=dev).to(dt)
            for k in (1, 33, 63):
                ids_k = ids256[:, :k].contiguous()
                assert agree(decoder_tail(lat_w, pts, q701, ids_k, tabs),
                             decoder_tail_plain(lat_w, pts, q701, ids_k, tabs)), (width, k, dt)
        pt_dt = pt16 if dt == torch.bfloat16 else pt
        for p in (65, 100, 129, 200, 256):
            patches = patch_space(pts[ids256[:, :p]], q701).to(dt)
            b_p, pool_p = pointnet_trunk_plain(patches, pt_dt)
            b_k, pool_k = pointnet_trunk(patches, pt_dt)
            assert agree(b_k, b_p) and agree(pool_k, pool_p), (p, dt)
            x2 = stn_apply(pool_p, b_p, pt_dt)
            assert agree(pointnet_head(x2, pt_dt), pointnet_head_plain(x2, pt_dt)), (p, dt)
    assert all(kernels.LAUNCHES[k] for k in wider), kernels.LAUNCHES


@pytest.mark.cuda
def test_winding_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.ops.winding import winding, winding_plain
    from ppsurf_tpu_torch.recon.marching_cubes import marching_cubes

    n = 65
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float64)
    vol = np.sqrt(((g - (n - 1) / 2) ** 2).sum(axis=0)) / ((n - 1) / 2) - 0.6
    verts, faces = marching_cubes(vol, 0.0)
    verts = (verts / (n - 1) - 0.5).astype(np.float32)
    rng = np.random.default_rng(2)
    # cube queries and queries on vertices; 40 faces with a repeated vertex
    # and 20 that are a point
    q = np.concatenate([(rng.random((1500, 3)) - 0.5).astype(np.float32),
                        verts[rng.choice(verts.shape[0], 64, replace=False)]])
    faces = np.concatenate([faces, faces[:40][:, [0, 0, 1]], faces[40:60][:, [0, 0, 0]]])
    dev = torch.device("cuda")
    v = torch.from_numpy(verts).to(dev)
    f = torch.from_numpy(faces.astype(np.int64)).to(dev)
    tri = [v[f[:, i]].contiguous() for i in range(3)]
    qq = torch.from_numpy(q).to(dev)
    for args in ((qq, *tri), (qq[:77], *(t[:1] for t in tri)),
                 (qq[:1001], *(t[:8193] for t in tri))):
        before = kernels.LAUNCHES["winding"]
        w = winding(*args)
        assert kernels.LAUNCHES["winding"] == before + 1
        p = winding_plain(*args)
        assert torch.isfinite(w).all() and float((w - p).abs().max()) <= 1e-4
        far = (p - 0.5).abs() > 1e-3
        assert torch.equal((w > 0.5)[far], (p > 0.5)[far])
        assert torch.equal(winding(*args), w)  # deterministic
