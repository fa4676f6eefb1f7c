"""The encoder's chunk replayed from CUDA graphs (`recon/field.py`,
`LatentEncoder`, `_CapturedChunk`).

On the CPU: CPU tensors take the op-by-op path and count no replay, with
the latents of the loop as it was written before the capture; the
capture's key and the bound of its cache.

On the card (marked `cuda`, skipped here): for PPSurf 50NN and POCO at
full width, every chunk's latents from the replays equal the op-by-op
loop's bit for bit, over the same draws, on a 60 031-point cloud, a
second cloud of another size of at least 10 000 points (which reuses the
first capture) and a 4 000-point cloud (its own capture); the counts
`chunks`, `replays`, `captures` and K1's launches read what the op-by-op
loop implies. A replayed graph's kernels belong to the span around its
`cudaGraphLaunch`, and a traced encoding shows the encoder's kernels as
the op-by-op one does, with less idle time.
"""
from __future__ import annotations

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ppsurf_tpu_torch.convert.init import init_variables
from ppsurf_tpu_torch.data.synthetic import torus_cloud
from ppsurf_tpu_torch.ops import kernels
from ppsurf_tpu_torch.ops.graph import build_fkaconv_graph
from ppsurf_tpu_torch.recon import field
from ppsurf_tpu_torch.recon.predict import Predictor
from ppsurf_tpu_torch.train import model as tmodel
from ppsurf_tpu_torch.utils import profiling, spans

TINY = dict(network_latent_size=16, pointnet_latent_size=16, num_pts_local=8, k=8)
K1_A_CHUNK = 13  # `ops/graph.py`: 9 kNN calls at k=16, 4 at k=1


class Recording:
    """A chunk runner that keeps a copy of every chunk's latents."""

    def __init__(self, run):
        self.run, self.lats = run, []
        self.replays = run.replays

    def graph(self, pts, chunk_ids, draws):
        return self.run.graph(pts, chunk_ids, draws)

    def latent(self, data):
        lat = self.run.latent(data)
        self.lats.append(lat.clone())
        return lat


class RecordedEncoder(field.LatentEncoder):
    """The encoder with its chunks recorded; `eager` runs them op by op
    on any device."""

    def __init__(self, net, spec, eager: bool):
        super().__init__(net, spec)
        self.eager = eager
        self.rec = None

    def _runner(self, pts, chunk_ids, draws):
        run, made = (field._EagerChunk(self), False) if self.eager \
            else super()._runner(pts, chunk_ids, draws)
        self.rec = Recording(run)
        return self.rec, made


def loop_before_capture(encoder, pts, draws):
    """The encoder's loop as written before the chunks were captured."""
    n = pts.shape[0]
    nb, s, num_chunks = encoder.layout(n)
    perms = draws.perms.to(pts.device) % n
    ids = torch.cat([perms, perms[:, : num_chunks * s - nb]], dim=1).reshape(-1, s)
    latent_sum = torch.zeros((n, encoder.spec.network_latent_size), device=pts.device)
    counts = torch.zeros((n,), device=pts.device)
    ones = torch.ones((s,), device=pts.device)
    for c in range(ids.shape[0]):
        chunk_pts = pts[ids[c]]
        data = {"pts": chunk_pts[None]}
        data.update(build_fkaconv_graph(chunk_pts, draws.graphs[c]))
        lat = encoder.net.get_latent(data)[0]
        latent_sum.index_add_(0, ids[c], lat.float())
        counts.index_add_(0, ids[c], ones)
    return latent_sum / torch.clamp(counts, min=1.0)[:, None]


def encode_span(recorded):
    (enc,) = [s for s in recorded if s.name == "encode"]
    return enc


@torch.inference_mode()
def test_cpu_encoder_runs_its_chunks_op_by_op():
    spec = tmodel.ppsurf_spec(**TINY, gen_subsample_manifold=400, gen_subsample_manifold_iter=2)
    predictor = Predictor(spec, variables=init_variables(spec, seed=0), device="cpu",
                          verbose=False)
    pts = torch.from_numpy(torus_cloud(1000, seed=3))
    draws = predictor.encoder.draw(1000, torch.Generator().manual_seed(5), pts.device)
    with profile(activities=[ProfilerActivity.CPU]):
        spans.RECORDER.start_window()
        latents = predictor.encoder(pts, draws=draws)
    _, _, chunks = predictor.encoder.layout(1000)
    assert encode_span(spans.RECORDER.spans).counts == dict(
        chunks=2 * chunks, replays=0, captures=0)
    assert not predictor.encoder._captures
    assert torch.equal(latents, loop_before_capture(predictor.encoder, pts, draws))


def test_capture_key_follows_what_a_replay_reads():
    spec = tmodel.ppsurf_spec(**TINY)
    net = spec.make_network()
    pts = torch.zeros(5, 3)
    key = field.capture_key(pts, 10_000, net, spec.dtype)
    assert field.capture_key(pts, 10_000, net, spec.dtype) == key
    param = next(net.parameters())
    with torch.no_grad():
        param.add_(1.0)  # in place: a replay reads the new values where it read the old
    assert field.capture_key(pts, 10_000, net, spec.dtype) == key
    param.data = param.data.clone()  # replaced: the capture would read freed memory
    replaced = field.capture_key(pts, 10_000, net, spec.dtype)
    assert replaced != key
    buf = next(net.buffers())
    buf.data = buf.data.clone()
    now = field.capture_key(pts, 10_000, net, spec.dtype)
    assert now not in (key, replaced)
    assert field.capture_key(pts, 4_000, net, spec.dtype)[1:] == now[1:]
    assert field.capture_key(pts, 4_000, net, spec.dtype) != now
    assert field.capture_key(pts, 10_000, net, torch.bfloat16) != now
    assert field.capture_key(pts.double(), 10_000, net, spec.dtype) != now


def test_capture_cache_keeps_the_most_recently_used():
    cache = collections.OrderedDict()
    made = []

    def get(key):
        return field.cached(cache, key, lambda: made.append(key) or f"v{key}", bound=3)

    assert get(1) == ("v1", True) and get(2) == ("v2", True) and get(3) == ("v3", True)
    assert get(1) == ("v1", False)  # a hit: 1 is now the most recent
    assert get(4) == ("v4", True)  # drops 2, the least recently used
    assert list(cache) == [3, 1, 4] and made == [1, 2, 3, 4]
    assert get(2) == ("v2", True) and list(cache) == [1, 4, 2]
    assert len(cache) == 3


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and K1 have no CPU mode)")


def card_encoders(spec):
    """(replaying, op-by-op) encoders of one bf16 network on the card."""
    net = Predictor(spec, variables=init_variables(spec, seed=0), device="cuda",
                    verbose=False).net
    return RecordedEncoder(net, spec, eager=False), RecordedEncoder(net, spec, eager=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ppsurf_50nn", "poco"])
def test_replayed_latents_equal_the_op_by_op_loop(kind):
    needs_card()
    spec = (tmodel.ppsurf_spec if kind == "ppsurf_50nn" else tmodel.poco_spec)(
        dtype=torch.bfloat16)
    replay, eager = card_encoders(spec)
    for n, captures in ((60_031, 1), (30_000, 0), (4_000, 1)):
        pts = torch.from_numpy(torus_cloud(n, seed=n)).cuda()
        draws = replay.draw(n, torch.Generator(device="cuda").manual_seed(n), pts.device)
        _, _, per_pass = replay.layout(n)
        chunks = spec.gen_subsample_manifold_iter * per_pass
        side = {}
        for enc in (replay, eager):
            kernels.reset_launches()
            with profile(activities=[ProfilerActivity.CUDA]):
                spans.RECORDER.start_window()
                latents = enc(pts, draws=draws)
                torch.cuda.synchronize()
            side[enc.eager] = (latents, enc.rec.lats, encode_span(spans.RECORDER.spans).counts,
                               dict(kernels.LAUNCHES))
        (lat_r, chunks_r, counts_r, launches_r), (lat_e, chunks_e, counts_e, launches_e) = \
            side[False], side[True]
        assert counts_r == dict(chunks=chunks, replays=chunks, captures=captures), n
        assert counts_e == dict(chunks=chunks, replays=0, captures=0), n
        assert launches_r == launches_e and launches_r["knn"] == K1_A_CHUNK * chunks, n
        assert len(chunks_r) == len(chunks_e) == chunks
        for c, (a, b) in enumerate(zip(chunks_r, chunks_e)):
            assert torch.equal(a, b), (n, c, float((a.float() - b.float()).abs().max()))
        # the scatter-add is the same code on both sides; where the size
        # is bucketed up (60 031 to 65 000) a chunk can hold a point twice,
        # and the atomics add its two latents in either order
        rms = float(lat_e.square().mean().sqrt())
        gap = float((lat_r - lat_e).abs().max())
        print(f"# {kind} n={n}: largest latent gap {gap!r} (rms {rms!r})")
        if replay.layout(n)[0] == n:
            assert torch.equal(lat_r, lat_e), (n, gap)
        else:
            torch.testing.assert_close(lat_r, lat_e, rtol=1e-6, atol=1e-6 * rms)
    assert len(replay._captures) == 2


@pytest.mark.cuda
def test_replayed_kernels_belong_to_the_span_of_their_graph_launch():
    needs_card()
    from ppsurf_tpu_torch.ops.knn import knn

    pts = torch.rand(20_000, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    q = pts[:4096].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        knn(pts, q, 16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ids = knn(pts, q * 2.0 - q, 16)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        spans.RECORDER.start_window()
        with spans.span("probe.replay"):
            graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(ids, knn(pts, q, 16))
    (s,) = spans.RECORDER.spans
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type() == cuda and not e.is_user_annotation()]
    graph_launches = {e.correlation_id(): e for e in events if e.device_type() != cuda
                      and "GraphLaunch" in e.name()}
    k1 = [e for e in device if "knn_kernel" in e.name()]
    assert k1 and len(device) >= 3  # the two element-wise kernels and K1
    for e in device:
        launch = graph_launches[e.correlation_id()]
        assert s.start_ns <= launch.start_ns() <= launch.end_ns() <= s.end_ns
    row = profiling.attribute(events, [s])["spans"]["probe.replay"]
    assert row["device_self_s"] == pytest.approx(sum(e.duration_ns() for e in device) * 1e-9)
    assert any("knn_kernel" in name for name, _ in row["top_kernels"])


@pytest.mark.cuda
def test_traced_encoding_keeps_its_kernels_and_loses_its_gaps():
    needs_card()
    spec = tmodel.ppsurf_spec(dtype=torch.bfloat16)
    replay, eager = card_encoders(spec)
    n = 60_031
    pts = torch.from_numpy(torus_cloud(n, seed=1)).cuda()
    draws = replay.draw(n, torch.Generator(device="cuda").manual_seed(1), pts.device)
    replay(pts, draws=draws)  # captures, untraced
    torch.cuda.synchronize()
    tables = {}
    for enc in (replay, eager):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            spans.RECORDER.start_window()
            enc(pts, draws=draws)
            torch.cuda.synchronize()
        tables[enc.eager] = profiling.attribute(prof.profiler.kineto_results.events(),
                                                spans.RECORDER.spans)
    rt, et = tables[False], tables[True]
    r, e = rt["spans"], et["spans"]
    print(f"# busy {rt['busy_s']!r} s of {rt['device_window_s']!r} replayed, "
          f"{et['busy_s']!r} s of {et['device_window_s']!r} op by op")
    for name in ("encode", "encode.graph", "encode.net"):
        print(f"# {name}: replayed device {r[name]['device_s']!r} s, idle {r[name]['idle_s']!r} s;"
              f" op by op device {e[name]['device_s']!r} s, idle {e[name]['idle_s']!r} s")
        assert 0.7 * e[name]["device_s"] <= r[name]["device_s"] <= 1.3 * e[name]["device_s"]
    assert any("knn_kernel" in k for k, _ in r["encode.graph"]["top_kernels"])
    assert 0.7 * et["busy_s"] <= rt["busy_s"] <= 1.3 * et["busy_s"]
    assert rt["device_window_s"] - rt["busy_s"] < 0.5 * (et["device_window_s"] - et["busy_s"])
