"""Data-parallel dry run of the port, and the rank worker it spawns.

    python -m ppsurf_tpu_torch.tools.dryrun_multihost

runs one data-parallel training step on two gloo ranks on the CPU at a
narrow width and checks that both ranks hold the same parameters after
it (port of `tools/dryrun_multihost.py`; the JAX package's run joins two
processes of four virtual devices each). It prints `dryrun: OK` and
exits 0, or raises.

`run_job` is what the multi-process tests and `chip_smoke.py` use: it
writes a job (cases of one `train_step` each, see `rank_main`) beside the
outputs, starts `world` processes of this module with torchrun's
environment on a free port of localhost, joins each within a timeout
(a hung rank is killed and fails the job) and returns each rank's
results. This module imports no JAX, so the ranks it starts do not
either, wherever they are started from.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
import typing

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def run_job(job: dict, world: int, out_dir: str, backend: str = "gloo",
            timeout: float = 300.0, env: typing.Optional[typing.Dict[str, str]] = None
            ) -> typing.List[dict]:
    """Run `job` on `world` ranks (module docstring), with `env` added to
    their environment; returns the ranks' results in rank order. Raises
    with the ranks' logs when one fails or is still running after
    `timeout` seconds."""
    from ppsurf_tpu_torch.parallel.mesh import free_port

    os.makedirs(out_dir, exist_ok=True)
    job_path = os.path.join(out_dir, "job.pt")
    torch.save(job, job_path)
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        rank_env = dict(os.environ, **(env or {}), RANK=str(rank), LOCAL_RANK=str(rank),
                        WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ppsurf_tpu_torch.tools.dryrun_multihost", "--worker",
             job_path, out_dir, backend],
            env=rank_env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = []
    try:
        for rank, proc in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((rank, rc))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    if failed:
        tails = []
        for rank in range(world):
            with open(os.path.join(out_dir, f"rank{rank}.log")) as fp:
                tails.append(f"-- rank {rank}:\n{fp.read()[-3000:]}")
        raise RuntimeError(f"ranks failed {failed}\n" + "\n".join(tails))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
            for r in range(world)]


def _spec(case: dict, dtype: torch.dtype):
    from ppsurf_tpu_torch.train.model import poco_spec, ppsurf_spec

    kwargs = dict(case["spec"])
    kind = kwargs.pop("kind")
    return (ppsurf_spec if kind == "ppsurf" else poco_spec)(dtype=dtype, **kwargs)


def _fresh(spec, variables: dict, device: torch.device):
    from ppsurf_tpu_torch.convert.infer_npz import from_jax_variables
    from ppsurf_tpu_torch.train import loop

    net = spec.make_network()
    net.load_state_dict(from_jax_variables(_map_tree(variables, lambda t: t.numpy()), net),
                        strict=True)
    net = net.to(device)
    return net, loop.make_optimizer(net, loop.TrainConfig())


def _cpu(tensors) -> typing.Dict[str, torch.Tensor]:
    return {name: t.detach().float().cpu().clone() for name, t in tensors}


def run_case(case: dict, mesh, device: torch.device) -> dict:
    """One case of a job on this rank (`rank_main`)."""
    import types

    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.parallel.mesh import replicate, shard_batch
    from ppsurf_tpu_torch.train import loop

    dtype = getattr(torch, case.get("dtype", "float32"))
    spec = _spec(case, dtype)
    batch = {k: v.to(device) for k, v in shard_batch(case["batch"], mesh).items()}
    b, n = batch["pts_ms"].shape[:2]
    gen = torch.Generator(device=device).manual_seed(case["seed"] + mesh.rank)
    if case.get("draws") is not None:
        draws = [[(t.to(device), r.to(device)) for t, r in item]
                 for item in case["draws"][mesh.rank]]
    else:
        draws = spec.draw_step(b, n, gen, device)
    masks = None if case.get("masks") is None else [m.to(device)
                                                     for m in case["masks"][mesh.rank]]
    step_spec = spec
    if case.get("data") is not None:  # the caller's assembled inputs
        data = {k: v.to(device) for k, v in case["data"][mesh.rank].items()}
        step_spec = types.SimpleNamespace(assemble_step_data=lambda *_: data)
    gen_state = gen.get_state()
    lr = case.get("lr", 1e-3)
    out: dict = {"name": case["name"]}

    if case.get("local", True):
        # this rank's half without the group: the same draws and dropout
        net, opt = _fresh(spec, case["variables"], device)
        loss, conf = loop.train_step(net, step_spec, opt, batch, draws, lr, generator=gen,
                                     masks=masks)
        out["local_loss"] = float(loss)
        out["local_grads"] = _cpu((name, p.grad) for name, p in net.named_parameters())
        out["local_buffers"] = _cpu(net.named_buffers())
        del net, opt
        gen.set_state(gen_state)

    net, opt = _fresh(spec, case["variables"], device)
    replicate(net, mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss, conf = loop.train_step(net, step_spec, opt, batch, draws, lr, generator=gen,
                                 masks=masks, mesh=mesh,
                                 sync_batch_stats=case.get("sync_batch_stats", False))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    out["loss"] = float(loss)
    out["conf"] = {k: float(v) for k, v in conf.items()}
    out["grads"] = _cpu((name, p.grad) for name, p in net.named_parameters())
    out["params"] = _cpu(net.named_parameters())
    out["buffers"] = _cpu(net.named_buffers())

    if case.get("eval", False):
        eval_draws = spec.draw_step(b, n, gen, device)
        loss, conf, _ = loop.eval_step(net, step_spec, batch, eval_draws, mesh=mesh)
        out["eval_loss"], out["eval_conf"] = float(loss), {k: float(v) for k, v in conf.items()}
        loss, conf, _ = loop.eval_step(net, step_spec, batch, eval_draws)
        out["local_eval_loss"] = float(loss)
        out["local_eval_conf"] = {k: float(v) for k, v in conf.items()}
    return out


def rank_main(job_path: str, out_dir: str, backend: str) -> None:
    """A rank of `run_job`: join the group from torchrun's environment
    (`parallel.mesh.maybe_init_distributed`), run every case of the job and
    write `out_dir/rank{r}.pt`.

    A job is a dict: `device` ('cpu' or 'cuda'; a card is shared by gloo
    ranks, and NCCL ranks take card LOCAL_RANK), `build_dir` (optional:
    the kernels build there, at first use), `cases`. A case: `name`,
    `spec` (`kind` and the spec's keyword arguments), `dtype`,
    `variables` (the initial nested variables, tensors), `batch` (the
    global batch; each rank keeps its slice), `seed` (each rank draws
    from a generator seeded `seed + rank`), optional `draws`, `masks` or
    `data` (a list by rank: graph draws, PPSurf's dropout masks, or
    assembled inputs replacing the rank's own), `sync_batch_stats`, `lr`,
    `local` (default True: also step on the rank's slice without the
    group, same draws and masks) and `eval` (also `eval_step` with and
    without the group)."""
    import torch.distributed as dist

    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.parallel.mesh import get_data_mesh, maybe_init_distributed

    job = torch.load(job_path, weights_only=True)
    if job.get("build_dir"):
        kernels.BUILD_DIR = job["build_dir"]
    if not maybe_init_distributed(backend):
        raise RuntimeError("the rank found no torchrun environment")
    mesh = get_data_mesh(None, job["device"])
    result = {"rank": mesh.rank, "world": mesh.size, "device": str(mesh.device),
              "cases": [run_case(case, mesh, mesh.device) for case in job["cases"]]}
    if mesh.device.type == "cuda":
        lib = kernels.build()
        result.update(lib_path=lib.path, build_seconds=lib.build_seconds)
    tmp = os.path.join(out_dir, f"rank{mesh.rank}.pt.tmp")
    torch.save(result, tmp)
    os.replace(tmp, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def dryrun_job(world: int = 2) -> dict:
    """One PPSurf step at latent 32 on a seeded global batch of 2 clouds
    a rank (128 points, 32 queries, 256 raw points)."""
    import numpy as np

    from ppsurf_tpu_torch.convert.init import init_variables
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    widths = dict(network_latent_size=32, pointnet_latent_size=32, num_pts_local=8, k=8)
    rng = np.random.RandomState(0)
    b, n, q, raw = 2 * world, 128, 32, 256
    batch = {
        "pts_ms": rng.rand(b, n, 3).astype(np.float32) - 0.5,
        "pts_query_ms": rng.rand(b, q, 3).astype(np.float32) - 0.5,
        "occ": (rng.rand(b, q) > 0.5).astype(np.int64),
        "pts_raw_ms": rng.rand(b, raw, 3).astype(np.float32) - 0.5,
        "raw_valid": np.ones((b, raw), bool),
    }
    variables = init_variables(ppsurf_spec(**widths), seed=1)
    return {"device": "cpu", "cases": [{
        "name": "dryrun", "spec": dict(kind="ppsurf", **widths), "seed": 0, "local": False,
        "variables": _map_tree(variables, lambda a: torch.from_numpy(np.array(a))),
        "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
    }]}


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        rank_main(*sys.argv[2:])
        return 0
    import tempfile

    with tempfile.TemporaryDirectory(prefix="dryrun_multihost_") as tmp:
        results = run_job(dryrun_job(2), 2, tmp, backend="gloo", timeout=300)
    a, b = (r["cases"][0] for r in results)
    same = all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    for r in results:
        c = r["cases"][0]
        print(f"[rank {r['rank']}] data-parallel step ok: ranks={r['world']} "
              f"loss={c['loss']:.4f}", flush=True)
    if not same:
        raise RuntimeError("the ranks' parameters differ after the step")
    print("dryrun: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
