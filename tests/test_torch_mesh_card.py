"""Meshing on the card (`ops/mesh.py`, `csrc/mesh.cu`) against host
meshing: marching cubes through the native `mc_extract`, then
`clean_simple` and `remove_small_connected_components`.

On the CPU the plain PyTorch versions of the kernels' steps run, and must
give the JAX package's host meshing (`ppsurf_tpu/recon/marching_cubes.py`,
`ppsurf_tpu/recon/mesh_ops.py`, numpy and the shared native C++) bit for
bit: vertices (float32 bits, in order) and faces (in order), on a
region-grown res-65 torus-and-sphere volume with NaN outside its band, on
a volume with field values exactly 0.0 at grid corners (coincident
vertices), on one holding components of 6 faces or fewer (removed) and on
one whose finite values never cross the level (no mesh); then the
refined-vertex `clean` pass on vertices moved so that some coincide, and
past 2^21 vertices (two face keys); `reconstruct_mesh`'s card route run
with the plain versions against the JAX package's engine, and a replaced
`marching_cubes` taking the host route; `np.round`'s keys.

On the card (marked `cuda`; `python -m pytest --noconftest -m cuda
tests/test_torch_mesh_card.py`), where the JAX package does not run, the
reference is the port's own host route: the kernels against the plain
versions and the host route at res 257 on a benchmark cloud and on a grid
of more than 2^31 / 15 points (64-bit offsets), and the `mesh` and `clean`
spans' `faces` and `upload_bytes`.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from ppsurf_tpu_torch.io.ply import Mesh
from ppsurf_tpu_torch.ops import mesh as card_mesh
from ppsurf_tpu_torch.recon import engine
from ppsurf_tpu_torch.recon import marching_cubes as port_marching_cubes
from ppsurf_tpu_torch.recon import mesh_ops as port_mesh_ops


def torus_sphere_sdf(q: np.ndarray) -> np.ndarray:
    """Signed distance to the torus and sphere of the synthetic clouds."""
    x, y, z = (q[:, i].astype(np.float64) for i in range(3))
    torus = np.sqrt((np.sqrt((x + 0.1) ** 2 + y ** 2) - 0.28) ** 2 + z ** 2) - 0.1
    sphere = np.sqrt((x - 0.3) ** 2 + y ** 2 + (z - 0.25) ** 2) - 0.15
    return np.minimum(torus, sphere).astype(np.float32)


def torus_sphere_cloud(n: int, seed: int) -> np.ndarray:
    from ppsurf_tpu_torch.data.synthetic import torus_cloud

    return torus_cloud(n, seed)


class HostRoute:
    """Host meshing: `marching_cubes` and the mesh and clean phases."""

    def __init__(self, marching_cubes, mesh_ops, mesh_type):
        self.marching_cubes = marching_cubes
        self.mesh_ops = mesh_ops
        self.mesh_type = mesh_type

    def mesh(self, verts: np.ndarray, faces: np.ndarray):
        mesh = self.mesh_ops.clean_simple(self.mesh_type(vertices=verts, faces=faces))
        return self.mesh_ops.remove_small_connected_components(mesh, num_faces=6)

    def mesh_phase(self, volume: np.ndarray):
        finite = volume[np.isfinite(volume)]
        if not (finite.size and finite.max() > 0.0 > finite.min()):
            return None
        return self.mesh(*self.marching_cubes(volume, 0.0))


# the port's own host route: the reference on the card
PORT = HostRoute(port_marching_cubes.marching_cubes, port_mesh_ops, Mesh)


@pytest.fixture(scope="module")
def jax_host() -> HostRoute:
    """The JAX package's host meshing: the reference on the CPU."""
    from ppsurf_tpu.io.ply import Mesh as JMesh
    from ppsurf_tpu.recon import mesh_ops
    from ppsurf_tpu.recon.marching_cubes import marching_cubes

    return HostRoute(marching_cubes, mesh_ops, JMesh)


def assert_same(verts, faces, mesh: Mesh) -> None:
    verts, faces = np.asarray(verts), np.asarray(faces)
    assert verts.dtype == np.float32 and faces.dtype == np.int64
    assert verts.shape == mesh.vertices.shape and faces.shape == mesh.faces.shape
    assert np.array_equal(verts.view(np.int32), mesh.vertices.view(np.int32))
    assert np.array_equal(faces, mesh.faces)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain steps are many small tensor ops,
    which a busy host's spinning thread pool slows severalfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grown():
    """A region-grown res-65 volume of the analytic field (NaN outside
    the band, the border at 1.0), its step and origin."""
    return engine.create_volume_region_growing(torus_sphere_sdf, torus_sphere_cloud(3000, 1), 65)


def zero_corners():
    """A dense res-40 field snapped to 1/40: many grid values are exactly
    0.0, so neighbouring edges put vertices on one corner."""
    g = np.linspace(-0.5, 0.5, 41)
    q = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    vol = torus_sphere_sdf(q).astype(np.float64).reshape(41, 41, 41)
    vol = np.round(vol * 40) / 40
    assert (vol == 0.0).sum() > 500
    return vol


def small_components():
    """A sphere, plus single inside points whose cells are cut by NaN
    planes to 2 and 4 faces (removed), and one whole point (8 faces, kept)."""
    g = np.linspace(-1, 1, 30)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    vol = np.sqrt(x ** 2 + y ** 2 + (z + 0.4) ** 2) - 0.4
    for p in ((5, 5, 25), (12, 5, 25), (22, 22, 25)):
        vol[p[0] - 2:p[0] + 3, p[1] - 2:p[1] + 3, p[2] - 2:p[2] + 3] = 1.0
        vol[p] = -1.0
    vol[6, :, 23:] = np.nan  # the point at (5, 5, 25) keeps the cells below x = 5: 4 faces
    vol[13, :, 23:] = np.nan
    vol[:, 6, 23:28] = np.where(np.arange(30)[:, None] >= 10, np.nan, vol[:, 6, 23:28])  # 2 faces
    return vol


def no_crossing():
    vol = np.full((20, 20, 20), np.nan)
    vol[3:15, 3:15, 3:15] = np.linspace(0.1, 1.0, 12)[:, None, None]
    vol[5, 5, 5] = 0.0  # touches the level without crossing it
    return vol


VOLUMES = {"grown": None, "zero_corners": zero_corners, "small_components": small_components,
           "no_crossing": no_crossing}


@pytest.mark.parametrize("case", list(VOLUMES))
def test_plain_route_equals_host_route(case, grown, jax_host):
    vol = grown[0] if case == "grown" else VOLUMES[case]()
    vt = torch.from_numpy(vol)
    # marching cubes alone: mc_extract's vertices and faces, numbering included
    hv, hf = jax_host.marching_cubes(vol, 0.0)
    cv, cf = card_mesh.marching_cubes(vt, 0.0)
    assert np.array_equal(cv.numpy().view(np.int32), hv.view(np.int32))
    assert np.array_equal(cf.numpy(), hf)
    # the mesh phase: extraction, merge, dedup, small components
    host = jax_host.mesh_phase(vol)
    out = card_mesh.mesh_volume(vt, 0.0, 6)
    if host is None:
        assert case == "no_crossing" and out is None
        return
    assert_same(out[0], out[1], host)
    assert out[2] == hf.shape[0]
    if case == "zero_corners":
        assert host.vertices.shape[0] < hv.shape[0]  # coincident vertices were merged
    if case == "small_components":
        cut = jax_host.mesh_ops.clean_simple(jax_host.mesh_type(vertices=hv, faces=hf))
        assert 0 < host.faces.shape[0] < cut.faces.shape[0] - 5  # 2 + 4 faces went


def refined(grown, host: HostRoute):
    """The mesh phase's mesh at world positions, moved off the grid, with
    coincident vertices: both ends of 40 edges, and 10 vertices that round
    to one key at 10 digits while their bits differ (the leader's bits
    stand)."""
    volume, step, bmin_pad = grown
    mesh = host.mesh_phase(volume)
    world = (mesh.vertices.astype(np.float64) * step + bmin_pad).astype(np.float32)
    rng = np.random.default_rng(3)
    world += rng.normal(0, step * 1e-3, world.shape).astype(np.float32)
    f = mesh.faces[rng.choice(mesh.faces.shape[0], 40, replace=False)]
    world[f[:, 1]] = world[f[:, 0]]
    tiny = rng.choice(world.shape[0], 10, replace=False)
    world[tiny] = np.array([[1e-12, -1e-12, 0.0]]) * rng.integers(1, 4, (10, 1))
    return world, mesh.faces


def two_face_keys(grown, host: HostRoute):
    """2^21 + 4096 vertices, so faces key by two int64s: a strip over the
    last 3 000 with duplicate and rotated faces and 10 coincident pairs."""
    rng = np.random.default_rng(0)
    nv = card_mesh.ONE_KEY_VERTICES + 4096
    verts = rng.uniform(-1, 1, (nv, 3)).astype(np.float32)
    ids = np.arange(nv - 3000, nv)
    faces = np.stack([ids[:-2], ids[1:-1], ids[2:]], 1)
    faces = np.concatenate([faces, faces[::7], faces[::5, [1, 2, 0]]])
    verts[ids[10:20]] = verts[ids[0:10]]
    return verts, faces


@pytest.mark.parametrize("case", [refined, two_face_keys])
def test_clean_pass_equals_host_route(case, grown, jax_host):
    world, faces = case(grown, jax_host)
    host = jax_host.mesh(world, faces)
    verts, out = card_mesh.clean(torch.from_numpy(world), torch.from_numpy(faces), 6)
    assert_same(verts, out, host)
    assert 0 < host.faces.shape[0] < faces.shape[0]  # degenerate and duplicate faces went


def test_round_keys_equal_numpy():
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.normal(0, 1, 3000), rng.uniform(0, 260, 3000),
        [0.0, -0.0, 1e-12, -1e-12, 5e-11, -5e-11, 1.5e-10, 2.5e-10, 1e30, -1e30, 3.4e38],
    ]).astype(np.float32)
    v = np.concatenate([v, v[:1]])[: v.size // 3 * 3].reshape(-1, 3)
    want = np.round(v.astype(np.float64), 10) + 0.0
    got = card_mesh.round_keys(torch.from_numpy(v)).numpy()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_engine_card_route_with_plain_steps(monkeypatch):
    """`reconstruct_mesh`'s card route, run on the CPU with the plain
    steps: the JAX package's engine's mesh, spans counting `faces` and
    `upload_bytes`; a replaced `marching_cubes` takes the host route, and
    its mesh is what comes back."""
    from ppsurf_tpu.recon import engine as jax_engine
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.utils.spans import RECORDER

    cloud = torus_sphere_cloud(2000, 2)
    monkeypatch.setattr(engine, "card_device", lambda device=None: torch.device("cpu"))

    def run(module):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            mesh = module.reconstruct_mesh(torus_sphere_sdf, cloud, 33, refine_iter=2)
        counts = {s.name: s.counts for s in RECORDER.spans if s.name in ("mesh", "clean")}
        return mesh, counts

    want, _ = run(jax_engine)
    out, counts = run(engine)
    assert_same(out.vertices, out.faces, want)
    assert counts["mesh"]["faces"] >= out.faces.shape[0] > 0
    assert counts["mesh"]["upload_bytes"] == 35 ** 3 * 8
    # the refined vertices of the mesh phase go up, 12 bytes each
    assert counts["clean"]["upload_bytes"] >= 12 * out.vertices.shape[0] > 0
    assert counts["clean"]["upload_bytes"] % 12 == 0
    assert counts["clean"]["faces"] == out.faces.shape[0]

    def cubes(volume, level):  # benchmark/tests/drive_tiny.py's mc_faces fault
        verts, faces = port_marching_cubes.marching_cubes(volume, level)
        faces = faces.copy()
        rows = np.arange(0, faces.shape[0], 8)
        faces[rows, 2] = faces[(rows + faces.shape[0] // 2) % faces.shape[0], 2]
        return verts, faces

    monkeypatch.setattr(engine, "marching_cubes", cubes)
    monkeypatch.setattr(jax_engine, "marching_cubes", cubes)
    faulty_want, _ = run(jax_engine)
    kernels.reset_launches()
    faulty, counts = run(engine)
    assert_same(faulty.vertices, faulty.faces, faulty_want)
    assert faulty.faces.shape != want.faces.shape or not np.array_equal(faulty.faces, want.faces)
    assert counts == {"mesh": {}, "clean": {}}  # the host route counts nothing


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the meshing kernels have no CPU mode)")


def benchmark_volume(seed: int, resolution: int = 257):
    """The grown volume of the analytic field around a benchmark cloud
    (`benchmark/yardstick/synthetic.py`, the `rec_torus60k` mix)."""
    from benchmark.yardstick.synthetic import CLOUDS, rng_for

    cloud = CLOUDS["torus_sphere"](60031, rng_for(seed, 0))
    return engine.create_volume_region_growing(torus_sphere_sdf, cloud, resolution)


@pytest.mark.cuda
def test_kernels_equal_plain_and_host_at_res257():
    needs_card()
    from ppsurf_tpu_torch.ops import kernels

    volume, step, bmin_pad = benchmark_volume(2400000041)
    kernels.reset_launches()
    card = card_mesh.mesh_volume(torch.from_numpy(volume).cuda(), 0.0, 6)
    assert all(kernels.LAUNCHES[k] == 1 for k in kernels.MESH_KERNELS), kernels.LAUNCHES
    plain = card_mesh.mesh_volume(torch.from_numpy(volume), 0.0, 6)
    host = PORT.mesh_phase(volume)
    assert card[2] == plain[2] and host.faces.shape[0] > 200_000
    assert_same(card[0].cpu(), card[1].cpu(), host)
    assert_same(plain[0], plain[1], host)
    cv, cf = card_mesh.marching_cubes(torch.from_numpy(volume).cuda(), 0.0)
    hv, hf = PORT.marching_cubes(volume, 0.0)
    assert np.array_equal(cv.cpu().numpy().view(np.int32), hv.view(np.int32))
    assert np.array_equal(cf.cpu().numpy(), hf)
    # the clean pass on moved vertices, some coincident, and with two face keys
    for world, faces in (refined((volume, step, bmin_pad), PORT), two_face_keys(None, PORT)):
        want = PORT.mesh(world, faces)
        verts, out = card_mesh.clean(torch.from_numpy(world).cuda(),
                                     torch.from_numpy(faces).cuda(), 6)
        assert_same(verts.cpu(), out.cpu(), want)


@pytest.mark.cuda
def test_kernels_past_the_int32_grid_limit():
    """A dense 532^3 grid (150.6 M points, more than 2^31 / 15, where the
    face corners' offsets could pass int32 at 5 faces a cell): the card's
    mesh equals the host route's."""
    needs_card()
    g = torch.linspace(-0.5, 0.5, 532, dtype=torch.float64, device="cuda")
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    torus = torch.sqrt((torch.sqrt((x + 0.1) ** 2 + y ** 2) - 0.28) ** 2 + z ** 2) - 0.1
    sphere = torch.sqrt((x - 0.3) ** 2 + y ** 2 + (z - 0.25) ** 2) - 0.15
    vol = torch.minimum(torus, sphere)
    del x, y, z, torus, sphere
    assert vol.numel() * 15 >= 2**31
    card = card_mesh.mesh_volume(vol, 0.0, 6)
    host = PORT.mesh_phase(vol.cpu().numpy())
    assert host.faces.shape[0] > 1_000_000
    assert_same(card[0].cpu(), card[1].cpu(), host)


@pytest.mark.cuda
def test_card_route_spans_count_faces_and_upload():
    needs_card()
    from ppsurf_tpu_torch.utils.spans import RECORDER

    cloud = torus_sphere_cloud(20000, 3)
    host = engine.reconstruct_mesh(torus_sphere_sdf, cloud, 129, refine_iter=2, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        out = engine.reconstruct_mesh(torus_sphere_sdf, cloud, 129, refine_iter=2)
    assert_same(out.vertices, out.faces, host)
    counts = {s.name: s.counts for s in RECORDER.spans if s.name in ("mesh", "clean")}
    assert counts["mesh"]["upload_bytes"] == 131 ** 3 * 8
    assert counts["mesh"]["faces"] >= out.faces.shape[0] > 0
    assert counts["clean"]["upload_bytes"] >= 12 * out.vertices.shape[0] > 0
    assert counts["clean"]["upload_bytes"] % 12 == 0
    assert counts["clean"]["faces"] == out.faces.shape[0]
