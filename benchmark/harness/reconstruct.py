"""The generator of `"kind": "reconstruct"` mixes: objects back to back.

One closed-loop client reconstructs one seeded cloud after another
through the program's inference path, set up as `cli.main` sets it up
(`tune_host_allocator`) and run as `Predictor.reconstruct_shape` runs
it: `LatentEncoder` on a generator seeded for the object,
`FieldEvaluator`, `freeze_gc`, then `recon.engine.reconstruct_mesh`
(region growing, marching cubes, the evaluator's bisection refinement,
cleanup), ending with the mesh on the host and a synchronise. The harness
keeps, around each call into the program, the spans and counts its
per-layer metrics read, and a sample of what the timed path produced for
the comparison with the reference (`reference/compare.py`):

- the latents of every object (the tensor the encoder returned);
- of every field call the engine makes, every `sample_every`-th query's
  point and value, at rows drawn from the seed;
- of the refinement, `refine_rows` vertices drawn from the seed, with
  their grid edges, the edges' field values and the refined points;
- of the volume the grower hands marching cubes, its value at `grid_rows`
  voxels drawn from the seed inside the padded border, where it holds one;
- of the mesh the engine returns, `face_rows` faces drawn from the seed
  (their corners) and the whole face list.

Mix keys: `cloud` (a generator of `yardstick/synthetic.py`), `points`,
`resolution`, `prefill_radius`, and for the check `sample_every`,
`refine_rows`, `grid_rows`, `face_rows`, `check_objects`. A configuration with `"blend": "sphere"`
(weights that see no surface) has its field blended with the signed
distance to the sphere of radius max |p|, as growth and refinement see it.
"""
from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from benchmark.harness import weights as weights_mod
from benchmark.harness.common import Trace, reduce_trace
from benchmark.yardstick.synthetic import CLOUDS, rng_for


@dataclasses.dataclass
class Run:
    """What a reconstruction run hands the metric readers."""

    config: dict
    mix: dict
    setup_s: float
    window_s: float
    objects: typing.List[dict]
    trace: typing.Optional[Trace] = None
    failed: int = 0
    weights: typing.Optional[dict] = None  # the flat weights both sides were given


def sphere_blend(pts: np.ndarray):
    """0.01 x the field plus the signed distance to the sphere of radius
    max |pts| (the same arithmetic serves both sides)."""
    radius = float(np.max(np.abs(pts)))

    def blend(vals: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return 0.01 * vals + (torch.sqrt((q.float() ** 2).sum(-1)) - radius)

    return blend


def spec_of(config: dict, mix: dict):
    """The program's `ModelSpec` for a configuration file."""
    from ppsurf_tpu_torch.train.model import ModelSpec

    keys = {f.name for f in dataclasses.fields(ModelSpec)}
    kw = {k: v for k, v in config.items() if k in keys}
    if "resolution" in mix:
        kw["gen_resolution_global"] = mix["resolution"]
    dtype = torch.bfloat16 if config["precision"] == "bf16" else torch.float32
    return ModelSpec(dtype=dtype, **kw)


class Recorder:
    """The spans and the sample of outputs of one object at a time."""

    def __init__(self, seed: int, mix: dict):
        self.rng = np.random.default_rng([int(seed) & (2**63 - 1), 7])
        self.every = int(mix["sample_every"])
        self.refine_rows = int(mix["refine_rows"])
        self.grid_rows = int(mix["grid_rows"])
        self.face_rows = int(mix["face_rows"])
        self.cur: dict = {}
        self.phases: typing.List[typing.Tuple[str, int, int]] = []  # monotonic ns

    def span(self, name: str, start_ns: int) -> int:
        now = time.monotonic_ns()
        self.phases.append((name, start_ns, now))
        return now

    def field(self, evaluator) -> typing.Callable[[np.ndarray], np.ndarray]:
        cur = self.cur

        def eval_field(q: np.ndarray) -> np.ndarray:
            t0 = time.monotonic_ns()
            v = evaluator(q)
            self.span("field", t0)
            m = q.shape[0]
            if m:
                idx = self.rng.integers(0, m, max(1, m // self.every))
                cur["field_q"].append(q[idx].copy())
                cur["field_v"].append(np.asarray(v[idx], np.float32).copy())
            return v

        return eval_field

    def refine(self, evaluator) -> typing.Callable:
        cur = self.cur

        def refine_device(v, v1, v2, p1, p2, iters, **kw):
            t0 = time.monotonic_ns()
            out = evaluator.refine_bisection(v, v1, v2, p1, p2, iters, **kw)
            self.span("refine", t0)
            m = v.shape[0]
            if m:
                idx = self.rng.choice(m, min(m, self.refine_rows), replace=False)
                cur["refine"] = dict(v=v[idx].copy(), v1=v1[idx].copy(), v2=v2[idx].copy(),
                                     p1=p1[idx].copy(), p2=p2[idx].copy(), iters=int(iters),
                                     out=np.asarray(out[idx], np.float32).copy())
            return out

        return refine_device

    def volume(self, grow) -> typing.Callable:
        cur = self.cur

        def grow_volume(*args, **kw):
            volume, step, bmin_pad = grow(*args, **kw)
            pad = int(kw.get("padding", 1))
            ijk = self.rng.integers(pad, np.array(volume.shape) - pad, (self.grid_rows, 3))
            vals = volume[ijk[:, 0], ijk[:, 1], ijk[:, 2]]
            keep = np.isfinite(vals)
            cur["grid"] = dict(ijk=ijk[keep].astype(np.int32),
                               values=vals[keep].astype(np.float32))
            return volume, step, bmin_pad

        return grow_volume

    def mesh(self, mesh) -> None:
        if mesh is None:
            return
        m = mesh.faces.shape[0]
        idx = self.rng.choice(m, min(m, self.face_rows), replace=False)
        self.cur.update(faces_tri=np.asarray(mesh.vertices[mesh.faces[idx]], np.float32),
                        mesh_faces=mesh.faces)


def engine_mesh(rec: Recorder, eval_field, refine_device, cloud: np.ndarray, resolution: int,
                refine_iter: int, prefill: int = 0, timings=None, stats=None):
    """`recon.engine.reconstruct_mesh` as `Predictor.reconstruct_shape`
    calls it, with the recorder's sample of the grower's volume and of the
    mesh."""
    from ppsurf_tpu_torch.recon import engine

    grow = engine.create_volume_region_growing
    engine.create_volume_region_growing = rec.volume(grow)
    try:
        mesh = engine.reconstruct_mesh(eval_field, input_points=cloud, resolution=resolution,
                                       padding=1, mc_value=0.0, refine_iter=refine_iter,
                                       out_value=1.0, refine_device=refine_device,
                                       timings=timings, prefill_radius=prefill, stats=stats)
    finally:
        engine.create_volume_region_growing = grow
    rec.mesh(mesh)
    return mesh


def control_mesh(side, obj: dict, mix: dict, refine_iter: int, seed: int) -> dict:
    """The engine run with a reference side (the control) in the
    program's place, on the object's cloud: its field in the grower, its
    bisection in the refinement; the same sample of the volume and the
    mesh as the program's (`compare.MESH_KEYS`)."""
    from benchmark.reference import plain

    device = side.cloud.device
    rec = Recorder(seed, mix)
    rec.cur = cur = dict(grid=None, faces_tri=None, mesh_faces=None)

    @torch.no_grad()
    def eval_field(q: np.ndarray) -> np.ndarray:
        return side.blended(torch.from_numpy(q).to(device)).cpu().numpy()

    @torch.no_grad()
    def refine_device(v, v1, v2, p1, p2, iters, **kw) -> np.ndarray:
        t = [torch.from_numpy(np.asarray(x, np.float32)).to(device) for x in (v, v1, v2, p1, p2)]
        return plain.bisect(side.blended, *t, iters).cpu().numpy()

    engine_mesh(rec, eval_field, refine_device, obj["cloud"], int(obj["resolution"]),
                refine_iter)
    return cur


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reconstruct_object(predictor, rec: Recorder, cloud: np.ndarray, gen_seed: int,
                       blend: bool, resolution: int, prefill: int) -> dict:
    """One object through the program; its record (seconds, phases,
    queries, launches, mesh size) with the recorder's sample in it."""
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.recon.field import FieldEvaluator
    from ppsurf_tpu_torch.utils.alloc import freeze_gc

    spec, device = predictor.spec, predictor.device
    rec.cur = cur = dict(gen_seed=gen_seed, cloud=cloud, resolution=resolution, field_q=[],
                         field_v=[], refine=None, grid=None, faces_tri=None, mesh_faces=None)
    kernels.reset_launches()
    timings: typing.Dict[str, float] = {}
    stats: typing.Dict[str, int] = {}
    t0 = time.perf_counter()
    m0 = time.monotonic_ns()
    generator = torch.Generator(device=device).manual_seed(gen_seed)
    latents = predictor.encoder(torch.from_numpy(cloud).to(device), generator=generator)
    sync(device)
    timings["encode"] = time.perf_counter() - t0
    m1 = rec.span("encode", m0)
    evaluator = FieldEvaluator(predictor.net, spec, cloud, latents,
                               transform=sphere_blend(cloud) if blend else None)
    freeze_gc()
    mesh = engine_mesh(rec, rec.field(evaluator), rec.refine(evaluator), cloud, resolution,
                       spec.gen_refine_iter, prefill, timings, stats)
    sync(device)
    seconds = time.perf_counter() - t0
    end = rec.span("field set-up", m1)  # what no engine phase below covers
    for name in ("clean", "refine", "mesh", "grow"):  # the engine's phases, back from its end
        if name in timings:
            start = end - int(timings[name] * 1e9)
            rec.phases.insert(len(rec.phases) - 1, (name + " host", start, end))
            end = start
    cur.update(
        latents=latents, seconds=seconds, timings=timings, rounds=stats.get("rounds"),
        # every query the field evaluated: the grid, the refinement's
        # iterates, and the iterates of vertices refined again on the plain path
        queries=evaluator.stat_queries + evaluator.stat_cert_failed * spec.gen_refine_iter,
        cert_failed=evaluator.stat_cert_failed,
        launches={k: v for k, v in kernels.LAUNCHES.items() if v},
        vertices=None if mesh is None else int(mesh.vertices.shape[0]),
        faces=None if mesh is None else int(mesh.faces.shape[0]),
        points=int(cloud.shape[0]))
    return cur


def prepare(cell, seed: int, device: torch.device) -> typing.Tuple[typing.Any, dict]:
    """(the program's predictor, the flat weights both sides are given)."""
    from ppsurf_tpu_torch.recon.predict import Predictor

    flat = weights_mod.load(cell.config, seed, device)
    return Predictor(spec_of(cell.config, cell.mix), variables=weights_mod.nested(flat),
                     device=device, verbose=False), flat


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, log, prepared: typing.Optional[tuple] = None
        ) -> typing.Tuple[Run, typing.Callable[[], dict]]:
    """Set up, warm up, run the window; return the run and a function
    that, called once the window's numbers are read, frees the program's
    state and compares the sample with the reference. `prepared`, what
    `prepare` gave for this cell, skips the set-up and the warm object
    (`control.py` reads many seeds in one process)."""
    from ppsurf_tpu_torch.utils.alloc import tune_host_allocator

    tune_host_allocator()  # as the program's entry (`cli.main`) starts
    config, mix = cell.config, cell.mix
    predictor, flat = prepared or prepare(cell, seed, device)
    make_cloud = CLOUDS[mix["cloud"]]
    blend = config.get("blend") == "sphere"
    rec = Recorder(seed, mix)

    def obj(i: int) -> dict:
        rng = rng_for(seed, 1, i)
        cloud = make_cloud(int(mix["points"]), rng)
        gen_seed = int(rng.randint(0, 2**31 - 1))
        return reconstruct_object(predictor, rec, cloud, gen_seed, blend,
                                  int(mix["resolution"]), int(mix["prefill_radius"]))

    if prepared is None:
        warm = obj(-1)  # builds the kernels at first use; every shape of the window
        log(f"# warm object: {warm['seconds']:.3f} s; phases "
            + " ".join(f"{k}={v:.3f}" for k, v in warm["timings"].items()))
        del warm
    rec.phases.clear()

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    sync(device)
    setup_s = time.perf_counter() - t_start
    objects, failed = [], 0
    w0 = time.perf_counter()
    m0 = time.monotonic_ns()
    while not objects or time.perf_counter() - w0 < seconds:
        o = obj(len(objects))
        failed += o["vertices"] is None
        objects.append(o)
    sync(device)
    window_s = time.perf_counter() - w0
    m1 = time.monotonic_ns()
    tr = None
    if prof is not None:
        prof.stop()
        t = time.perf_counter()
        tr = reduce_trace(prof, rec.phases, (m0, m1))
        del prof
        log(f"# trace reduced in {time.perf_counter() - t:.3f} s")
    for i, o in enumerate(objects):
        log(f"# object {i}: {o['seconds']:.3f} s; " + " ".join(
            f"{k}={v:.3f}" for k, v in o["timings"].items())
            + f" queries={o['queries']} verts={o['vertices']} faces={o['faces']} "
            f"rounds={o['rounds']} launches={o['launches']}")
    result = Run(config, mix, setup_s, window_s, objects, tr, failed, flat)

    def check() -> dict:
        from benchmark.reference import compare

        nonlocal predictor
        predictor = None  # the program's state goes first
        chosen = compare.choose_objects(seed, len(objects), int(mix["check_objects"]))
        for i, o in enumerate(objects):
            if i not in chosen:
                for k in ("latents", "mesh_faces"):
                    o.pop(k, None)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return compare.numbers(config, mix, flat, [objects[i] for i in chosen], device, log)

    return result, check
