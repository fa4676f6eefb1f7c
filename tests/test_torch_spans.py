"""The span recorder (`utils/spans.py`) and the device's time by span
(`utils/profiling.py::attribute`) on the CPU:

- with no profiler running, a reconstruction and a training step record
  nothing, read no clock and synchronise nothing;
- under a CPU torch.profiler, spans nest with their parents and counts,
  a new profiled window drops the last one's spans, and a span's start
  and end agree with its user annotation in the trace to within 100 us
  (one clock);
- a tiny traced `reconstruct_mesh` fills `timings` with its phases'
  span durations, the `field` and `field.refine` spans' queries sum to
  the evaluator's `stat_queries`, and every readback sits in a field call;
- at a patch wider than the decoder's k (P=200), a traced
  reconstruction records one `field.patch` span a chunk evaluation, under
  `field.chunk` in the grid and under `field.refine` in refinement (the
  failed certificates' plain rounds included), whose `queries` add up to
  every query the field evaluated; at P <= k and in POCO it records none;
- a tiny traced `train_step` records `step.forward`, `step.backward` and
  `step.optimizer` once each, and the loader's `data.wait`;
- on synthetic events, a device event goes to the innermost span open
  when its launch started, and an idle gap to the span open during it.
"""
from __future__ import annotations

import contextlib
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ppsurf_tpu_torch.convert.infer_npz import load_infer_npz, load_network
from ppsurf_tpu_torch.convert.init import init_variables
from ppsurf_tpu_torch.data.datasets import OccupancyDataModule
from ppsurf_tpu_torch.data.synthetic import torus_cloud
from ppsurf_tpu_torch.io.ply import save_ply
from ppsurf_tpu_torch.recon.engine import reconstruct_mesh
from ppsurf_tpu_torch.recon.field import FieldEvaluator
from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS, Predictor
from ppsurf_tpu_torch.train import loop
from ppsurf_tpu_torch.train import model as tmodel
from ppsurf_tpu_torch.utils import profiling, spans

TINY = dict(network_latent_size=16, pointnet_latent_size=16, num_pts_local=8, k=8)
PASSES, CHUNK_PTS, REFINE, RES = 2, 400, 3, 17


@contextlib.contextmanager
def cpu_profile():
    """A CPU profiler whose spans form a window of their own, as
    `torch_trace` starts one (two profiled regions with no span between
    them would otherwise share one)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.RECORDER.start_window()
        yield prof


def by_name(recorded, name):
    return [s for s in recorded if s.name == name]


def sphere(pts: np.ndarray):
    """A tenth of the field plus the distance to the sphere around the
    cloud: seeded weights then give a surface to grow."""
    radius = float(np.abs(pts).max())
    return lambda vals, q: 0.1 * vals + (torch.sqrt((q.float() ** 2).sum(-1)) - radius)


def reconstruct(timings=None, stats=None):
    """A tiny PPSurf reconstruction on the CPU (2 encoder passes of 3
    chunks, 256-query field chunks, the candidate refinement)."""
    spec = tmodel.ppsurf_spec(**TINY, gen_subsample_manifold=CHUNK_PTS,
                              gen_subsample_manifold_iter=PASSES, rec_batch_size=256,
                              gen_refine_iter=REFINE)
    predictor = Predictor(spec, variables=init_variables(spec, seed=0), device="cpu",
                          verbose=False)
    cloud = torus_cloud(1000, seed=3)
    latents = predictor.encoder(torch.from_numpy(cloud),
                                generator=torch.Generator().manual_seed(5))
    evaluator = FieldEvaluator(predictor.net, spec, cloud, latents, transform=sphere(cloud))
    mesh = reconstruct_mesh(evaluator, input_points=cloud, resolution=RES,
                            refine_iter=REFINE, refine_device=evaluator.refine_bisection,
                            timings=timings, stats=stats)
    return mesh, evaluator, predictor.encoder.layout(cloud.shape[0])


@pytest.fixture(scope="module")
def traced():
    timings, stats = {}, {}
    with cpu_profile():
        mesh, evaluator, layout = reconstruct(timings, stats)
    return types.SimpleNamespace(spans=list(spans.RECORDER.spans), timings=timings, stats=stats,
                                 mesh=mesh, evaluator=evaluator, layout=layout)


def patch_cloud():
    """The small cloud of `test_torch_patches.py`: 1 500 points on a bumpy
    sphere flattened to a third in z, with random latents of width 256."""
    rng = np.random.RandomState(0)
    d = rng.randn(1500, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bumps = 1.0 + 0.1 * np.sin(3 * d[:, 0]) * np.cos(2 * d[:, 1])
    pts = (d * 0.4 * bumps[:, None]).astype(np.float32) * np.float32([1.0, 1.0, 0.3])
    latents = (np.random.RandomState(4).randn(pts.shape[0], 256) * 0.5).astype(np.float32)
    return pts, latents


def traced_field(spec, variables):
    """A reconstruction of the small cloud (res 17, 1 024-query chunks,
    the candidate refinement) and a refinement of edges too long for any
    certificate, in one traced window: (the window's spans, the
    evaluator, the queries of each of its chunk evaluations)."""
    pts, latents = patch_cloud()
    net = load_network(spec, variables, torch.device("cpu"))
    lat = torch.from_numpy(latents[:, :spec.network_latent_size].copy())
    evaluator = FieldEvaluator(net, spec, pts, lat, transform=sphere(pts))
    calls = []
    field = evaluator._field

    def counted(rep, q, ids=None):
        calls.append(q.shape[0])
        return field(rep, q, ids)

    evaluator._field = counted
    rng = np.random.RandomState(6)
    v1 = pts[rng.randint(0, pts.shape[0], 200)] * 1.5
    v2 = v1 * 0.2
    with cpu_profile():
        mesh = reconstruct_mesh(evaluator, input_points=pts, resolution=RES,
                                refine_iter=REFINE, refine_device=evaluator.refine_bisection)
        p1, p2 = evaluator(v1), evaluator(v2)
        keep = (p1 * p2) < 0
        evaluator.refine_bisection(0.5 * (v1 + v2)[keep], v1[keep], v2[keep], p1[keep],
                                   p2[keep], REFINE)
    assert mesh is not None and keep.sum() > 20
    return list(spans.RECORDER.spans), evaluator, calls


def wide_spec(p: int, **kw):
    return tmodel.ppsurf_spec(num_pts_local=p, gen_subsample_manifold_iter=PASSES,
                              gen_refine_iter=REFINE, rec_batch_size=1024, **kw)


def test_wide_patch_search_has_a_span_a_chunk_evaluation():
    spec = wide_spec(200)
    recorded, evaluator, calls = traced_field(spec, load_infer_npz(DEFAULT_WEIGHTS))
    assert (evaluator.k, evaluator.patch_k) == (64, 200)
    patches = by_name(recorded, "field.patch")
    assert [s.counts["queries"] for s in patches] == calls and len(calls) > 2 * REFINE
    assert {s.parent.name for s in patches} == {"field.chunk", "field.refine"}
    for chunk in by_name(recorded, "field.chunk"):
        assert [s.name for s in recorded if s.parent is chunk] == ["field.patch"]
        assert chunk.parent.name == "field"
    # every grid query, every bisection iterate and, on the plain path,
    # every iterate of a vertex whose certificate failed
    assert evaluator.stat_cert_failed > 0
    total = sum(s.counts["queries"] for s in patches)
    assert total == evaluator.stat_queries + evaluator.stat_cert_failed * REFINE
    refine = by_name(recorded, "field.refine")
    assert len(refine) == 2
    assert sum(s.counts["queries"] for s in patches if s.parent.name == "field.refine") \
        == sum(s.counts["queries"] for s in refine) + evaluator.stat_cert_failed * REFINE


@pytest.mark.parametrize("kind", ["ppsurf_50nn", "poco"])
def test_no_patch_span_where_the_decoder_ids_hold_the_patch(kind):
    if kind == "poco":
        spec = tmodel.poco_spec(gen_subsample_manifold_iter=PASSES, gen_refine_iter=REFINE,
                                rec_batch_size=1024)
        variables = init_variables(spec, seed=0)
    else:
        spec, variables = wide_spec(50), load_infer_npz(DEFAULT_WEIGHTS)
    recorded, evaluator, calls = traced_field(spec, variables)
    assert evaluator.patch_k <= evaluator.k and len(calls) > 2 * REFINE
    assert by_name(recorded, "field.chunk") and by_name(recorded, "field.refine")
    assert not by_name(recorded, "field.patch")


def write_spheres(root: str, shapes: int = 4, n_pts: int = 200, n_query: int = 32) -> str:
    """Sphere clouds in the reference layout (`04_pts_vis`, `05_query_pts`,
    `05_query_dist`), each set file listing them all; the train list's path."""
    rng = np.random.RandomState(0)
    for d in ("04_pts_vis", "05_query_pts", "05_query_dist"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = [f"sphere_{i}" for i in range(shapes)]
    for name in names:
        radius = 0.2 + 0.15 * rng.rand()
        d = rng.randn(n_pts, 3)
        save_ply(os.path.join(root, "04_pts_vis", name + ".xyz.ply"),
                 (d / np.linalg.norm(d, axis=1, keepdims=True) * radius).astype(np.float32))
        q = (rng.rand(n_query, 3) - 0.5).astype(np.float32)
        np.save(os.path.join(root, "05_query_pts", name + ".ply.npy"), q)
        np.save(os.path.join(root, "05_query_dist", name + ".ply.npy"),
                (np.linalg.norm(q, axis=1) - radius).astype(np.float32))
    for split in ("trainset", "valset", "testset"):
        with open(os.path.join(root, split + ".txt"), "w") as fp:
            fp.write("\n".join(names) + "\n")
    return os.path.join(root, "trainset.txt")


def train_inputs(tmp_path):
    in_file = write_spheres(str(tmp_path / "ds"))
    spec = tmodel.ppsurf_spec(**TINY)
    config = loop.TrainConfig(batch_size=2, default_root_dir=str(tmp_path / "models"))
    state = loop.Trainer(spec, config, device="cpu").init_state()
    dm = OccupancyDataModule(in_file=in_file, batch_size=2, manifold_points=64,
                             patches_per_shape=16, seed=42, workers=1)
    batches = dm.epoch_batches(dm.train_dataset(), np.random.RandomState(0), shuffle=True)
    return spec, state, batches


def one_step(spec, state, batches):
    tb = loop.to_device(next(batches), torch.device("cpu"))
    b, n = tb["pts_ms"].shape[:2]
    gen = torch.Generator().manual_seed(1)
    draws = spec.draw_step(b, n, gen, torch.device("cpu"))
    return loop.train_step(state.net, spec, state.optimizer, tb, draws, 1e-3, generator=gen)


def test_no_profiler_records_nothing_reads_no_clock_and_no_sync(tmp_path, monkeypatch):
    calls = []

    def refuse(name):
        def call(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} called with no profiler running")
        return call

    spec, state, batches = train_inputs(tmp_path)
    before = spans.RECORDER.spans
    n_before = len(before)
    monkeypatch.setattr(spans, "clock", refuse("clock"))
    monkeypatch.setattr(spans, "time", types.SimpleNamespace(perf_counter=refuse("perf_counter")))
    monkeypatch.setattr(spans, "record_function", refuse("record_function"))
    monkeypatch.setattr(torch.cuda, "synchronize", refuse("synchronize"))
    mesh, _, _ = reconstruct()
    loss, _ = one_step(spec, state, batches)
    assert mesh is not None and np.isfinite(float(loss))
    assert calls == []
    assert spans.RECORDER.spans is before and len(before) == n_before


def test_spans_nest_with_parents_and_counts():
    with cpu_profile():
        with spans.span("outer") as a:
            a.add(items=2)
            with spans.span("inner") as b:
                b.add(items=3)
                b.add(items=4, bytes=8)
            with spans.span("inner"):
                pass
        with spans.span("second"):
            pass
    rec = spans.RECORDER.spans
    assert [s.name for s in rec] == ["outer", "inner", "inner", "second"]
    outer, in1, in2, second = rec
    assert outer.parent is None and second.parent is None
    assert in1.parent is outer and in2.parent is outer
    assert outer.counts == {"items": 2} and in1.counts == {"items": 7, "bytes": 8}
    assert outer.start_ns <= in1.start_ns <= in1.end_ns <= in2.start_ns <= in2.end_ns \
        <= outer.end_ns <= second.start_ns
    with spans.span("unrecorded"):
        pass
    assert spans.RECORDER.spans is rec
    # a span recorded after one that ran with no profiler starts a new
    # window, which drops the last one's spans
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("next"):
            pass
    assert [s.name for s in spans.RECORDER.spans] == ["next"]


def test_span_agrees_with_its_annotation():
    """One clock: a span's start and end and its annotation's in the
    trace differ by the annotation's own entry and exit, the median of
    ten under 100 us (the first annotation of a process, which looks its
    operator up, runs before them)."""
    with cpu_profile() as prof:
        for i in range(11):
            with spans.span(f"probe {i}"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe ")}
    starts, ends = [], []
    for s in spans.RECORDER.spans[1:]:
        e = events[s.name]
        assert e.is_user_annotation()
        starts.append(abs(s.start_ns - e.start_ns()))
        ends.append(abs(s.end_ns - e.end_ns()))
    assert np.median(starts) < 100_000 and np.median(ends) < 100_000, (starts, ends)


def test_timings_are_the_phases_span_durations(traced):
    assert traced.mesh is not None
    assert set(traced.timings) == {"grow", "mesh", "refine", "clean"}
    for name, seconds in traced.timings.items():
        (s,) = by_name(traced.spans, name)
        assert s.parent is None and seconds == s.seconds > 0
    (grow,) = by_name(traced.spans, "grow")
    assert grow.counts == {} and traced.stats["rounds"] > 0  # the grower's own count


def test_field_queries_sum_to_stat_queries(traced):
    grid = sum(s.counts["queries"] for s in by_name(traced.spans, "field"))
    refine = by_name(traced.spans, "field.refine")
    assert len(refine) == 1 and refine[0].parent.name == "refine"
    assert grid > 0 and refine[0].counts["queries"] % REFINE == 0
    assert grid + refine[0].counts["queries"] == traced.evaluator.stat_queries
    chunk = traced.evaluator.chunk
    for f in by_name(traced.spans, "field"):
        assert f.parent.name == "grow"
        kids = [s for s in traced.spans if s.parent is f]
        assert [s.name for s in kids].count("field.chunk") == -(-f.counts["queries"] // chunk)
        assert kids[0].name == "field.sort" and kids[-1].name == "readback"
        assert kids[-1].counts["bytes"] == 4 * f.counts["queries"]


def test_every_readback_sits_in_a_field_call(traced):
    backs = by_name(traced.spans, "readback")
    assert {s.parent.name for s in backs} == {"field", "field.refine"}
    assert sum(s.parent.name == "field.refine" for s in backs) == 2  # the count, the vertices


def test_encoder_spans(traced):
    _, _, chunks = traced.layout
    (enc,) = by_name(traced.spans, "encode")
    passes = by_name(traced.spans, "encode.pass")
    assert len(passes) == PASSES and all(p.parent is enc for p in passes)
    for name in ("encode.graph", "encode.net", "encode.accumulate"):
        found = by_name(traced.spans, name)
        assert len(found) == PASSES * chunks and {s.parent.name for s in found} == {"encode.pass"}
    assert all(s.counts == {} for s in by_name(traced.spans, "encode.graph"))


def test_train_step_records_its_three_phases(tmp_path):
    spec, state, batches = train_inputs(tmp_path)
    with cpu_profile():
        one_step(spec, state, batches)
    rec = spans.RECORDER.spans
    assert [s.name for s in rec] == ["data.wait", "step.forward", "step.backward",
                                     "step.optimizer"]
    assert all(s.parent is None for s in rec)
    assert all(a.end_ns <= b.start_ns for a, b in zip(rec, rec[1:]))


class Event:
    """What `attribute` reads of a `_KinetoEvent`; `kind` its activity
    type in kineto's words."""

    def __init__(self, name, kind, start, dur, corr, device=True):
        self._v = (name, kind, start, dur, corr, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[5] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[1] in ("user_annotation", "gpu_user_annotation")


def make_span(name, start, end, parent=None, **counts):
    s = spans.Span(name, parent)
    s.start_ns, s.end_ns = start, end
    s.counts.update(counts)
    return s


def test_attribute_kernels_by_launch_and_gaps_by_time():
    a = make_span("A", 0, 100, queries=5)
    b = make_span("B", 10, 50, a, bytes=8)
    events = [
        Event("cudaLaunchKernel", "cuda_runtime", 20, 2, 1, device=False),
        Event("k_in_b", "kernel", 60, 10, 1),  # launched in B, runs after B ends
        Event("cudaLaunchKernel", "cuda_runtime", 55, 2, 2, device=False),
        Event("k_in_a", "kernel", 80, 10, 2),
        Event("k_unlaunched", "kernel", 200, 10, 9),  # no launch: its own start
        Event("B", "gpu_user_annotation", 60, 30, 0),  # an annotation, not work
    ]
    t = profiling.attribute(events, [a, b])
    rows = t["spans"]
    assert t["device_events"] == 3 and t["launch_unmatched"] == 1
    assert rows["B"]["device_self_s"] == pytest.approx(10e-9)
    assert rows["A"]["device_self_s"] == pytest.approx(10e-9)
    assert rows["A"]["device_s"] == pytest.approx(20e-9)
    assert rows[profiling.OUTSIDE]["device_self_s"] == pytest.approx(10e-9)
    assert rows["B"]["top_kernels"] == [["k_in_b", pytest.approx(10e-9)]]
    # device busy [60, 70], [80, 90], [200, 210]: gaps (70, 80) and (90, 200)
    assert t["busy_s"] == pytest.approx(30e-9) and t["idle_s"] == pytest.approx(120e-9)
    assert rows["A"]["idle_self_s"] == pytest.approx(20e-9)  # 70-80 and 90-100
    assert rows["A"]["idle_s"] == pytest.approx(20e-9)
    assert rows["B"]["idle_s"] == 0 and rows["B"]["idle_self_s"] == 0
    assert rows[profiling.OUTSIDE]["idle_self_s"] == pytest.approx(100e-9)
    assert rows["A"]["host_s"] == pytest.approx(100e-9)
    assert rows["A"]["self_s"] == pytest.approx(60e-9) and rows["A"]["count"] == 1
    assert rows["A"]["counts"] == {"queries": 5} and rows["B"]["counts"] == {"bytes": 8}


def test_attribute_gap_goes_to_the_innermost_open_span():
    a = make_span("A", 0, 100)
    b = make_span("B", 20, 40, a, bytes=4)
    c = make_span("C", 60, 90, a)
    b2 = make_span("B", 92, 95, a, bytes=12)
    events = [Event("k", "kernel", 0, 30, 1), Event("k", "kernel", 70, 30, 2)]
    rows = profiling.attribute(events, [a, b, c, b2])["spans"]
    assert rows["B"]["count"] == 2 and rows["B"]["counts"] == {"bytes": 16}  # summed by name
    # one gap (30, 70): B holds 30-40, A 40-60, C 60-70
    assert rows["B"]["idle_self_s"] == pytest.approx(10e-9)
    assert rows["A"]["idle_self_s"] == pytest.approx(20e-9)
    assert rows["C"]["idle_self_s"] == pytest.approx(10e-9)
    assert rows["A"]["idle_s"] == pytest.approx(40e-9)
    assert rows["C"]["idle_s"] == pytest.approx(10e-9)
    # kernels with no launch event go by their start: one in A, one in C
    assert rows["A"]["device_self_s"] == pytest.approx(30e-9)
    assert rows["C"]["device_self_s"] == pytest.approx(30e-9)
    assert rows["A"]["device_s"] == pytest.approx(60e-9)


@pytest.mark.cuda
def test_span_holds_its_k1_launch_and_kernel_on_the_card():
    """A span around a K1 launch and a synchronise contains the launch's
    runtime call and the kernel's device interval, as the profiler
    reports them, with no offset between the clocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    from ppsurf_tpu_torch.ops.knn import knn

    gen = torch.Generator(device="cuda").manual_seed(0)
    pts = torch.rand(60_031, 3, device="cuda", generator=gen)
    q = torch.rand(50_048, 3, device="cuda", generator=gen)
    knn(pts, q, 64)  # builds and warms
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        spans.RECORDER.start_window()
        with spans.span("probe.k1"):
            knn(pts, q, 64)
            torch.cuda.synchronize()
    (s,) = spans.RECORDER.spans
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    k1 = [e for e in events if e.device_type() == cuda and "knn_kernel" in e.name()]
    launches = {e.correlation_id(): e for e in events
                if e.device_type() != cuda and profiling.is_launch(e)}
    assert k1
    for e in k1:
        launch = launches[e.correlation_id()]
        assert s.start_ns <= launch.start_ns() <= launch.end_ns() <= s.end_ns
        assert s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns
    row = profiling.attribute(events, [s])["spans"]["probe.k1"]
    assert row["device_self_s"] >= sum(e.duration_ns() for e in k1) * 1e-9


@pytest.mark.cuda
def test_spans_add_no_device_event_under_a_cuda_only_profiler():
    """The benchmark's profiler traces CUDA activity alone: there the
    spans are recorded but leave no event of their own on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    from ppsurf_tpu_torch.ops.knn import knn

    pts = torch.rand(60_031, 3, device="cuda")
    knn(pts, pts[:4096], 16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spans.RECORDER.start_window()
        with spans.span("probe.outer"):
            with spans.span("probe.inner"):
                knn(pts, pts[:4096], 16)
        torch.cuda.synchronize()
    assert [s.name for s in spans.RECORDER.spans] == ["probe.outer", "probe.inner"]
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    assert any("knn_kernel" in e.name() for e in device)
    assert not [e.name() for e in device if e.name().startswith("probe.")
                or e.is_user_annotation()]
