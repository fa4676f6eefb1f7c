#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ppsurf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--resolution N] [--passes N] [--refine N]
                          [--profile FILE] [--w1-baseline FILE] [--no-campaign]

(with --profile, the training phase's kernel table goes to FILE.train)

In order, it:
1. prints the toolchain (torch/CUDA, nvcc) and the card's name and power
   limit as nvidia-smi reports them;
2. builds the CUDA kernels from `ppsurf_tpu_torch/csrc` with nvcc for
   sm_90a, prints the build seconds and ptxas' register report, and fails
   unless every K1 instantiation has a 0-byte stack frame, the SASS of
   each bf16 tensor-core kernel (K3 decoder tail at latent 256 and at
   latent 32, K4 PointNet trunk, K5 PointNet head for one tile and, as a
   thread-block cluster, for two to four) and of each f32 3xTF32 kernel
   (K3 at latent 256 and at latent 32, K4, K5) holds HGMMA instructions,
   ptxas reports 0 spill bytes for the bf16 latent-32 K3, K4 and K5 ones,
   every f32 one (each also with a 0-byte stack frame) and every K2 and
   T1 kernel; prints the SASS instruction count of each T1 variant's pass
   loop;
3. runs every kernel of the reconstruction path (K1 kNN at k=64 and at
   the refinement's kc=192, K2 candidate selection, K3 decoder tail, K4/K5
   PointNet) at the production shapes, and the seven T1 selection
   microbenchmark variants at the TPU tool's shape; holds each against
   its plain PyTorch version on the same inputs with the stated
   tolerance, and times kernel, plain version and, where one PyTorch call
   computes the same function, that call with CUDA events; K1 also runs
   k in {1, 16, 64, 192, 256} on a shuffled cloud, exact duplicates, a
   cluster with outliers and far queries, and a mask with fewer valid
   points than k, each exact; K2 runs kc in {1, 31, 32, 33, 100, 192,
   256} with k in {1, 63, 64, kc} on rows with ties, all-equal rows, NaN
   rows, +-0 rows and rows of infinities and 1e38, over a row count no
   block size divides, and T1 every variant at ncand in {1, 300, 1536},
   each exact; K1 is timed with the cloud's blocking made
   once, as the field evaluator calls it, and the blocking's time is
   printed beside it; K1's bound counts the distances in the blocks its
   boxes cannot cull; the bf16 lines of K3, K4 and K5 are each followed
   by the time of the kernel's products alone as bf16 torch.matmul (a
   yardstick) and by a control: the plain version with those products on
   the tensor cores; the f32 lines are timed likewise, beside their
   bound by both figures (the f32 FMA peak, and 3xTF32: three TF32
   products a product at the TF32 peak) and their products as f32
   torch.matmul, TF32 off; every f32 check of K3-K5 runs on weights
   times (1 + 1e-3 seeded noise), whose 3xTF32 lo parts are not zero
   (the committed weights are f16 values, exact in tf32, so a kernel that
   misread its lo tiles would pass on them); then the builds of the other
   paths, bf16 and f32 under the same limits: K3 at latent 32 (POCO) at k
   in {1, 33, 50, 63, 64}, K3 at latent 256 at k in {1, 33, 40, 50, 63},
   K4/K5 at P in {65, 100, 128, 129, 192, 200, 256} (every cluster size
   of K5, and last tiles of one row), the ones on a path timed beside
   bound, plain version and yardstick (in f32: K3 at latent 32, K4/K5 at
   P=100 and 200), with the launch shape of the latent-32 K3 (bf16 and
   f32) and the cluster K5 (CTAs a cluster, clusters or blocks the card
   holds at once, the weight bytes a launch streams by design) and, for
   the latent-32 K3, the SFU floor of its softmax beside its bound, on
   comment lines; each f32 row of the kernels line names its CUDA kernel
   (`kernel`);
4. reconstructs a seeded synthetic 60k-point surface cloud end to end with
   the committed weights in bf16 through `Predictor.reconstruct_shape`,
   with every kernel's launch count reset just before and read just after
   (with --profile, under torch.profiler: kernel time by name goes to FILE
   and the device's busy share is printed); the refinement runs on the
   candidate path, and its K2 and kc=192 K1 launches must match its
   chunks and iterations;
5. evaluates the bf16 field near the mesh with K3 and with its plain
   version and prints where their signs differ (the mesh moves only
   there); refines the first refinement chunk of that run again on the
   plain path and on the candidate path: the vertices must be
   bit-identical except where an iterate's 64-NN set holds an exact
   distance tie (at most 0.1% of them); then times the refinement of
   every vertex on both paths;
5b. reconstructs the cloud in f32 (as `cli rec --trainer.precision 32`
   does) through `Predictor.reconstruct_shape` at phase 4's settings,
   prints its phase seconds, checks that K3, K4 and K5 launch once a
   field chunk and K1, K2 launch, and that no bf16 build of K3-K5 runs
   (each launch's dtype code), and prints how far its mesh lies from
   phase 4's bf16 mesh (vertex counts, the share of vertices within a
   voxel of the other mesh's: not a limit, the dtypes give different
   fields);
6. evaluates one query chunk of the field in f32 on the card and on the
   CPU plain path and compares the two;
7. the same for `ppsurf_100nn` and `ppsurf_200nn` (patch P=100 and 200
   from one K1 call at k=P, K4/K5 on two and four tiles), and the
   100NN chunk in bf16 on the card;
8. reconstructs the cloud with POCO (latent 32, k=64, bf16) on seeded
   weights with bench.py's analytic blend as `transform`: the mesh must
   be the blend's sphere, and K1, K3 at latent 32 and K2 must launch;
   then the same in f32 (as `cli rec --trainer.precision 32` runs it):
   its phase seconds, the blend's sphere again, K3 at latent 32 launched
   once a field chunk with the f32 dtype code only (no bf16 build, no
   PPSurf kernel), K1 and K2 launched; then one POCO f32 chunk on the
   card against the CPU plain path;
9. reconstructs it with `ppsurf_200nn` (bf16, committed weights; K1 at
   k=200, K4/K5 on four tiles);
10. reconstructs a 40-point cloud (K3 at k=40, patch P=40) at res 33;
11. runs `python -m ppsurf_tpu_torch.cli predict` with config stacking on
    a two-shape dataset written to a temporary directory, with ground truth
    in its `03_meshes` (the port's host marching cubes of the exact
    distance to the torus and sphere the clouds are drawn from, at res
    257), and checks the paths of the meshes it
    writes, its four score tables (one finite row a shape) and W1's 4
    launches a shape;
12. trains PPSurf 50NN at full width (batch 10, 10 000 manifold points,
    all 2 000 queries of a shape, P=50, k=64, bf16, AdamW) on 24 seeded
    analytic solids (spheres, tori, ellipsoids at random poses, 20k-60k
    surface points) written to a temporary directory in the reference
    layout: `cli fit` for 2 epochs (4 steps, every loss finite, `last.pt`
    and `config.yaml` written, K1 launched 15 times a cloud); 30 steps on
    one fixed batch (the mean loss of the last 5 at most 0.8 of the
    first); the median CUDA-event time of 10 bf16 steps (graph building
    included), peak memory and the host's share of a step (with
    --profile, the device's idle share over 3 steps); one f32 step of 2
    clouds and 500 queries on the card and on the CPU plain path from the
    same weights, inputs and dropout masks (K1's ids equal to the plain
    kNN's, the loss, gradients, parameters and statistics within the
    stated limits); `cli test` on the checkpoint (its CSV and xlsx report)
    and `cli rec` of a test shape from `last.pt`, through K1 and K3-K5;
13. scores: W1 (the winding number of the IoU and F1 metrics) against its
    plain version on the card at the metrics' shape (100 000 seed-42 cube
    samples against the 50NN mesh of phase 4: |w - plain| <= 1e-4, inside
    masks equal wherever |plain - 0.5| > 1e-3), then on faces no tile
    divides, a single face, degenerate faces, queries on vertices, odd
    query counts and queries 1e-2 to 1e-5 edges from a face's B or C
    (a closed icosphere, small random triangles) under the same limits; W1
    no further than twice its plain version (or 1e-5) from a float64
    winding number on 2048 of the samples, on the near-vertex queries, and
    on 48 soups of 200 000 large triangles (seeds 0-47, each its own numpy
    generator) where f32 cancels; W1 within 1e-4 of float64 alone at 4096
    f32 queries inside faces (`near_plane_cases`: within f32 rounding of
    the face's plane, where the plain version can lose a whole turn); W1's
    time (CUDA events, median of
    5) and the plain version's (one call), its bound, the SFU floor of its
    MUFU operations (3 square roots and a reciprocal a pair) and the SASS
    instructions its pair loop issues a pair (with --w1-baseline FILE,
    also those of an earlier W1 built from FILE, the two timed
    in turns at the production shape, and the earlier W1's float64 errors
    on the soups and the probe, with no limit); then scores the 50NN mesh against the ground truth
    (Chamfer, IoU, F1, normal error, seconds each; W1 must launch 4 times),
    the ground truth meshed at res 129 (IoU and F1 at least 0.99) and the
    ground truth against itself (Chamfer 0, IoU 1, F1 1 exactly, normal
    error under 0.05 rad);
14. runs the campaign: `python -m ppsurf_tpu_torch.campaigns.full_run_pps_mini`
    (in this process) on phase 11's dataset with 11 of phase 12's seeded
    solids added for training and exact signed distances for the test
    shapes' queries, cut to 2 epochs at full width (res 129 as
    `configs/ppsurf_mini.yaml`): `last.pt`, the test report and the score
    tables must be written (the few-epoch model may reconstruct nothing);
    then `python -m ppsurf_tpu_torch.eval.make_comparison --render` over
    its results and phase 11's committed-weights 50NN results, and
    `figures.comp_base.merge_comps`: the per-metric comparison CSVs (a
    finite cell where a method has the mesh, empty where not),
    `comp_mean` (a finite 50NN row), a `cd_vis` PLY and `.npz` a mesh,
    every PNG valid (signature, IHDR, 1024 x 1024, something drawn), the
    HTML report naming each shape and method, the merged CSV and `.tex`;
    K1 must launch in fit, K1 and K3-K5 in predict, W1 4 times a mesh
    scored, and nothing in the comparison;
15. trains PPSurf 50NN (bf16, full width, one epoch of 2 steps at batch
    10 on phase 12's solids) with `Trainer.fit` in a one-rank NCCL group
    that `parallel.mesh.maybe_init_distributed` joins from torchrun's
    environment, and twice without a group, under torch's deterministic
    algorithms: losses, parameters and buffers bit for bit, K1 15 times a
    cloud;
16. runs two gloo ranks on the card (`tools/dryrun_multihost.py`; each
    builds the kernels at first use into one empty directory, which must
    end holding one library), one step each of PPSurf 50NN at full width
    on a global batch of 10 (5 a rank), with sync_batch_stats False and
    True: parameters and buffers bit-identical on both ranks, the
    all-reduced gradients against the mean of the ranks' own gradients of
    their halves without the group (relative L2 1e-2, worst leaf 0.25),
    buffers rank 0's or the mean (1e-4 of a leaf's largest value), K1 15
    times a cloud on each rank, step time and peak memory a rank;
17. evaluates the 50NN bf16 field of phase 4's cloud over 4 full chunks
    and a tail with `FieldEvaluator(devices=[card, card])` (two replicas,
    one thread): bit-identical to one device, K1 and K3-K5 once a chunk,
    seconds of both; `Predictor(devices=2)` must clamp to the one card;
18. runs `cli fit` with `configs/profiler.yaml` stacked for 5 steps at
    batch 4: the Chrome trace of steps 2-4 must hold those step spans and
    K1's kernel;
19. trains POCO with `cli fit` at full width (latent 32, k=64, batch 10,
    bf16) for 2 epochs on phase 12's solids: finite losses, `last.pt`, K1
    14 times a cloud, the median step time and peak memory;
20. runs the benchmark twin as the driver runs it, `python3 bench_torch.py
    --reps 3` (the smoke's --resolution, --passes and --refine passed on
    where they differ from the defaults), in its own process: exit 0, a
    last line of exactly `bench.py`'s four keys with the metric
    `ppsurf50nn_e2e_reconstruction_res257` and a finite positive value,
    and K1 (k=64 and kc=192), K2 and K3-K5 in its detail line's launches
    of one pass; then grows phase 4's 50NN bf16 field without the
    speculative prefill and with it (radius 4 from round 2), in turns: the
    same volume bit for bit, at least one band, no more field calls, the
    grow seconds and calls of both printed; and `reconstruct_mesh` with
    prefill radius 0 and 4 gives the same mesh; and the field of 120 000
    queries near the cloud is the same in one call and in odd batches
    (with `FieldEvaluator.fixed_rows` off, the count that differs is
    printed) (phases 14-19 are skipped under --no-campaign; this one is
    not);
21. meshes the grown volume of the exact torus-and-sphere distance around
    phase 4's cloud on the card (`ops/mesh.py`, `csrc/mesh.cu`) and on the
    host, and cleans its host-refined vertices on both, in turns: the same
    meshes bit for bit, each route's seconds a phase, the meshing kernels'
    device milliseconds an object beside their bound (the bytes they read
    and write at 3.35 TB/s) and the volume's copy to the card apart
    (`mesh_phase`); their launches an object are phase 4's, checked there;
22. prints `{"kernels": [...]}`, the nvidia-smi line, and as its last line
   `{"ok": true, "device": {...}}`.

Phases 4, 5b, 7-11, each part of 12 and 14, each scoring of 13, phases
15-19 and the benchmark of 20 reset every kernel's launch count just
before they run and read it just after; each fails if a kernel of its
path did not launch.

Any failure exits non-zero before that last line. It needs one CUDA card
and the repository checkout around it; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
import typing

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# phase 4's cloud (also the benchmark's, `bench_torch.py`), the H100's
# peaks and the kernels' operation counts
from ppsurf_tpu_torch.data.synthetic import torus_cloud  # noqa: E402
from ppsurf_tpu_torch.ops.opcount import (  # noqa: E402
    HEAD_MACS, PEAK_BYTES, PEAK_OPS, TRUNK_MACS, tail_macs,
)

# the field chunk's production shapes: cloud points and queries per chunk
N_POINTS = 60031
N_QUERIES = 50048
# the candidate refinement's candidates per vertex and the T1 slab
KC = 192
T1_QUERIES, T1_NCAND, T1_K = 49152, 1536, 64

# the kernels of the reconstruction path, each launched on the main path
PATH_KERNELS = ("knn", "knn_k192", "decoder_tail", "pointnet_trunk", "pointnet_head",
                "topk_rows")
# the builds of the other paths (POCO, 100NN/200NN, clouds under 64 points)
NEW_BUILDS = ("decoder_tail_l32", "decoder_tail_k40", "pointnet_trunk_wide_p100",
              "pointnet_head_wide_p100", "pointnet_trunk_wide_p200", "pointnet_head_wide_p200")
# the f32 builds (`--trainer.precision 32`): K3 at latent 256 and 32, K4/K5
# at P=50, 100 and 200
F32_BUILDS = ("decoder_tail_f32", "decoder_tail_l32_f32", "pointnet_trunk_f32",
              "pointnet_head_f32", "pointnet_trunk_wide_p100_f32", "pointnet_head_wide_p100_f32",
              "pointnet_trunk_wide_p200_f32", "pointnet_head_wide_p200_f32")
# the CUDA kernel each f32 build launches, all 3xTF32 on the tensor cores
F32_KERNELS = {"decoder_tail": "tf32::decoder_tail_tf32_kernel",
               "decoder_tail_l32": "narrow_tc::decoder_tail_narrow_tf32_kernel",
               "pointnet_trunk": "tf32::trunk_tf32_kernel",
               "pointnet_head": "tf32::head_tf32_kernel"}


def fail(msg: str) -> typing.NoReturn:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run(cmd):
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def torus_sdf(x, y, z):
    """Signed distance to `torus_cloud`'s torus and sphere (negative inside)."""
    import numpy as np

    ring = np.sqrt((x + 0.1) ** 2 + y ** 2) - 0.28
    torus = np.sqrt(ring ** 2 + z ** 2) - 0.1
    sphere = np.sqrt((x - 0.3) ** 2 + y ** 2 + (z - 0.25) ** 2) - 0.15
    return np.minimum(torus, sphere)


def torus_gt_mesh(res: int):
    """Ground truth of `torus_cloud`: the port's host marching cubes of the
    exact distance to its torus and sphere (two disjoint closed surfaces,
    the torus 0.027 from the sphere) on a res^3 grid over the unit cube."""
    import numpy as np

    from ppsurf_tpu_torch.io.ply import Mesh
    from ppsurf_tpu_torch.recon.marching_cubes import marching_cubes

    x = np.linspace(-0.5, 0.5, res)
    verts, faces = marching_cubes(torus_sdf(*np.meshgrid(x, x, x, indexing="ij")), 0.0)
    return Mesh(vertices=(verts / (res - 1) - 0.5).astype(np.float32), faces=faces)


def cuda_ms(fn, reps: int = 5, warmup: int = 1, batch: int = 1) -> float:
    """Median milliseconds of fn() by CUDA events, each reading the mean
    over `batch` back-to-back calls (batch > 1 hides the host's time to
    enqueue a call behind the previous call's run)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def ptxas_report(log: str) -> typing.Dict[str, typing.Tuple[int, int]]:
    """Kernel (short name, with its integer template argument, e.g.
    knn_kernel<64>, head_wgmma_kernel) -> (stack-frame bytes, spill bytes
    stored and loaded), from ptxas' -v report."""
    import re

    def short_name(mangled: str) -> str:
        # _ZN..._knn_cu_afef58a010knn_kernelILi64EEv... -> knn_kernel<64>: the
        # innermost of the length-prefixed names, its integer template argument
        i = 3 if mangled.startswith("_ZN") else 2
        name = mangled
        while i < len(mangled) and mangled[i].isdigit():
            j = i
            while mangled[j].isdigit():
                j += 1
            name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        t = re.match(r"ILi(\d+)E", mangled[i:])
        return f"{name}<{t.group(1)}>" if t else name if name.endswith("kernel") else mangled

    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = short_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name is not None:
            report[name] = (int(m.group(1)), int(m.group(2)) + int(m.group(3)))
            name = None
    return report


def knn_needed_ops(pts, q, ids_plain) -> float:
    """The distance operations these inputs need of K1: 8 for every point
    of every Morton block whose box lower bound is not above the query's
    true k-th distance (from the plain version's ids)."""
    import torch

    from ppsurf_tpu_torch.ops.knn import KNN_BLOCK, box_lower_bound, dist2_rows, knn_blocks

    _, boxes = knn_blocks(pts)
    blocks = 0
    for s in range(0, q.shape[0], 4096):
        qs, last = q[s:s + 4096], ids_plain[s:s + 4096, -1]
        tau = torch.where(last >= 0, dist2_rows(qs, pts[last.clamp(min=0)][:, None])[:, 0],
                          float("inf"))
        blocks += int((box_lower_bound(qs, boxes) <= tau[:, None]).sum())
    return blocks * KNN_BLOCK * 8.0


def knn_edge_cases(check, gen, dev, pts, q) -> None:
    """K1 against its plain version, 0 ids differing, for k in {1, 16, 64,
    192, 256} on: the production cloud in random order; hundreds of exact
    duplicates (ties, buffer overflow); one dense cluster with sparse
    outliers and queries far outside; a mask with fewer valid points
    than k (the trailing ids are -1)."""
    import torch

    from ppsurf_tpu_torch.ops.knn import knn, knn_plain

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    qs = q[torch.randperm(q.shape[0], generator=gen, device=dev)[:4096]]
    shuffled = pts[torch.randperm(pts.shape[0], generator=gen, device=dev)]
    dup = torch.cat([rand(40, 3).repeat_interleave(300, dim=0), rand(8000, 3)])
    dup = dup[torch.randperm(dup.shape[0], generator=gen, device=dev)]
    cluster = torch.cat([0.5 + 1e-3 * torch.randn(20000, 3, generator=gen, device=dev),
                         10.0 * torch.randn(300, 3, generator=gen, device=dev)])
    far = torch.cat([cluster[:2048], 1e3 + rand(64, 3), -1e3 * rand(64, 3)])
    masked = rand(5000, 3)
    valid = torch.zeros(5000, dtype=torch.bool, device=dev)
    valid[torch.randperm(5000, generator=gen, device=dev)[:100]] = True
    cases = (("production cloud in random order", shuffled, qs, None),
             ("12000 exact duplicates of 40 points + 8000", dup, dup[:2048], None),
             ("dense cluster + outliers, far queries", cluster, far, None),
             ("100 valid of 5000 points", masked, rand(1024, 3), valid))
    for name, p, qq, v in cases:
        for k in (1, 16, 64, 192, 256):
            e = int((knn(p, qq, k, v) != knn_plain(p, qq, k, v)).sum())
            check(f"K1 knn k={k}, {name} (ids differing)", float(e), 0.0)


def select_edge_cases(check, gen, dev) -> None:
    """K2 and T1 against their plain versions, 0 positions or elements
    differing. K2 at kc in {1, 31, 32, 33, 100, 192, 256} and k in {1, 63,
    64, kc} on 4099 rows (no multiple of the rows a block takes): random
    rows with exact ties, rows all equal, rows of NaN, rows of -0 and +0,
    rows strewn with +-inf, +-1e38 and NaN. T1, every variant, at ncand in
    {1, 300, 1536} on 1001 rows, k = 64 (`full`: k = min(64, ncand))."""
    import torch

    from ppsurf_tpu_torch.ops.topk_rows import topk_rows, topk_rows_plain
    from ppsurf_tpu_torch.tools.microbench_extract import VARIANTS, extract, extract_plain

    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e38, -1e38, -0.0,
                            0.0], device=dev)
    for kc in (1, 31, 32, 33, 100, 192, 256):
        d = torch.rand(4099, kc, generator=gen, device=dev)
        d[::5, 1::2] = d[::5, 0:kc - 1:2][:, : d[::5, 1::2].shape[1]]
        d[1::5] = 0.25
        d[2::5] = float("nan")
        d[3::5] = torch.where(torch.rand(kc, generator=gen, device=dev) < 0.5, -0.0, 0.0)
        strew = torch.rand(d[4::5].shape, generator=gen, device=dev) < 0.3
        pick = torch.randint(0, special.numel(), d[4::5].shape, generator=gen, device=dev)
        d[4::5] = torch.where(strew, special[pick], d[4::5])
        for k in sorted({1, 63, 64, kc}):
            if k <= kc:
                e = int((topk_rows(d, k) != topk_rows_plain(d, k)).sum())
                check(f"K2 topk_rows kc={kc} k={k}, 4099 rows of ties, equal, NaN, +-0 and "
                      "+-inf/1e38 (positions differing)", float(e), 0.0)
    for n in (1, 300, 1536):
        cand = torch.rand(1001, n, generator=gen, device=dev)
        for variant in VARIANTS:
            k = min(64, n) if variant == "full" else 64
            e = int((extract(cand, variant, k) != extract_plain(cand, variant, k)).sum())
            check(f"T1 extract {variant} 1001x{n} k={k} (elements differing)", float(e), 0.0)


def bound_ms(n_bytes: float, ops: float, kind: str):
    tb = n_bytes / PEAK_BYTES * 1e3
    to = ops / PEAK_OPS[kind] * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def full_mantissas(t, gen):
    """f32 K3 or K4/K5 tables whose weights carry full f32 mantissas: each
    times (1 + 1e-3 seeded noise), the packs made again. The committed
    weights are f16 values, exact in tf32, so their 3xTF32 lo tiles are
    zero and a kernel that misread them would pass."""
    import dataclasses

    import torch

    from ppsurf_tpu_torch.ops.decoder_tail import (
        DecoderTables, pack_l32_tf32x3, pack_tf32x3_weights,
    )
    from ppsurf_tpu_torch.ops.pointnet_att import pack_head_tf32x3, pack_trunk_tf32x3

    def noisy(w):
        n = torch.randn(w.shape, generator=gen, device=w.device)
        return (w * (1 + 1e-3 * n)).contiguous()

    if isinstance(t, DecoderTables):
        t = dataclasses.replace(t, w2=noisy(t.w2), w3=noisy(t.w3), wq=noisy(t.wq), wv=noisy(t.wv))
        pack = pack_l32_tf32x3 if t.w2.shape[0] == 32 else pack_tf32x3_weights
        t.wpack = pack(t.w2, t.w3, t.wq, t.wv)
        return t
    trunk_w = tuple(noisy(w) for w in t.trunk_w)
    head_w = tuple(noisy(w) for w in t.head_w)
    return dataclasses.replace(t, trunk_w=trunk_w, trunk_pack=pack_trunk_tf32x3(*trunk_w[1:]),
                               head_w=head_w, head_pack=pack_head_tf32x3(*head_w[:3], head_w[4]))


@contextlib.contextmanager
def chunks_and_dtypes():
    """While the block runs: the field chunks (`FieldEvaluator._field`
    calls) under "chunks", and under "dtypes" each K3-K5 launch's dtype
    code (its C entry's last argument: 1 bf16, 0 f32) by launch counter."""
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.recon.field import FieldEvaluator

    seen = {"chunks": 0, "dtypes": {}}
    field_fn, launch_fn = FieldEvaluator._field, kernels.launch

    def count_field(self, *a, **kw):
        seen["chunks"] += 1
        return field_fn(self, *a, **kw)

    def launch_with_dtype(kernel, symbol, device, *a):
        if symbol in ("ppsurf_decoder_tail", "ppsurf_pointnet_trunk", "ppsurf_pointnet_head"):
            seen["dtypes"].setdefault(kernel, set()).add(a[-1])
        return launch_fn(kernel, symbol, device, *a)

    FieldEvaluator._field, kernels.launch = count_field, launch_with_dtype
    try:
        yield seen
    finally:
        FieldEvaluator._field, kernels.launch = field_fn, launch_fn


def kernel_bounds(n_bytes: float, ops: float, tag: str) -> dict:
    """A K3-K5 row's bound. bf16: by the bf16 tensor-core peak. f32: by
    both figures, its operations at the f32 FMA peak and as 3xTF32 on the
    tensor cores (three TF32 products for each f32 one at the TF32 peak);
    the lesser, 3xTF32, is its `bound_ms`."""
    if tag == "bf16":
        return dict(zip(("bound_ms", "bound_by"), bound_ms(n_bytes, ops, tag)))
    fma, _ = bound_ms(n_bytes, ops, "f32")
    tc, by = bound_ms(n_bytes, 3 * ops, "tf32")
    return dict(bound_ms=tc, bound_by=by, bound_fma_ms=fma, bound_tf32x3_ms=tc)


# K5 at P > 64 runs as a cluster of ceil(P / 64) CTAs: every cluster size,
# and last tiles of 1 to 64 rows
WIDE_P = (65, 100, 128, 129, 192, 200, 256)
# SFU operations a clock an SM (H100, compute capability 9.0: the CUDA
# programming guide's throughput table)
SFU_PER_CLOCK = 16


def launch_shape(symbol: str, *args: int) -> dict:
    """A kernel's launch for these arguments (`kernels.launch_info`): the
    CTAs a cluster, the clusters (or blocks an SM) the card holds at once,
    the grid's blocks, and the weight bytes a launch streams by design (a
    count from the kernel's constants, not a measurement). Printed on a
    comment line only, never in the kernels line."""
    from ppsurf_tpu_torch.ops import kernels

    cluster, active, blocks, weight_bytes = kernels.launch_info(symbol, *args)
    return dict(cluster=cluster, active=active, grid_blocks=blocks, weight_bytes=weight_bytes)


def sfu_floor_ms(c: int, k: int) -> float:
    """The latent-32 K3's softmax floor on the SFU, worked out, not
    measured: an exponential and a division (its reciprocal) for each of a
    query's k x 64 (row, head) pairs, 16 a clock on each SM, at the card's
    highest SM clock. Printed on a comment line only."""
    import torch

    mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"]).splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return c * k * 64 * 2 / (SFU_PER_CLOCK * sms * mhz * 1e6) * 1e3


def wide_builds(compare, yardstick, results, nets, poco_vars, pts, q, gen, dev) -> None:
    """The builds for POCO, patches wider than 64 and clouds under 64
    points against their plain versions, bf16
    and f32 under the K3-K5 limits: K3 at latent 32 (POCO, seeded weights
    and seeded nonzero biases) at k in {1, 33, 50, 63, 64}, K3 at latent 256 at k in {1, 33, 40, 50,
    63}, K4 and K5 at P in WIDE_P (two to four 64-row tiles).
    The bf16 ones at the main paths' shapes are timed beside their bound,
    their plain version and a bf16 torch.matmul yardstick of their
    products: K3-L32 at k=64, K3 at k=40 (a 40-point cloud), K4/K5 at
    P=100 and P=200. The latent-32 K3 and the cluster K5 print their
    launch shape; the latent-32 K3 its SFU floor."""
    import torch

    from ppsurf_tpu_torch.convert.infer_npz import load_network
    from ppsurf_tpu_torch.ops.decoder_tail import decoder_tables, decoder_tail, decoder_tail_plain
    from ppsurf_tpu_torch.ops.knn import knn
    from ppsurf_tpu_torch.ops.patches import patch_space
    from ppsurf_tpu_torch.ops.pointnet_att import (
        pointnet_head, pointnet_head_plain, pointnet_tables, pointnet_trunk,
        pointnet_trunk_plain, stn_apply,
    )
    from ppsurf_tpu_torch.train.model import poco_spec

    n, c = pts.shape[0], q.shape[0]
    ids256 = knn(pts, q, 256)

    def poco_projection(dt):
        """POCO's decoder on its seeded weights, whose biases flax
        initialises to zero, with seeded biases of scale 0.1: a zero bias
        would hide a dense epilogue that skips its rounding before the
        bias (`chip_rounding_control.py`)."""
        proj = load_network(poco_spec(dtype=dt), poco_vars, dev).projection
        g = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            for layer in (proj.fc2, proj.fc3, proj.fc_query, proj.fc_value):
                layer.bias.copy_(0.1 * torch.randn(layer.bias.shape, generator=g, device=dev))
        return proj

    for dt, tag, tol in ((torch.bfloat16, "bf16", (1.6e-2, 2e-6)),
                         (torch.float32, "f32", (1e-4, 2e-6))):
        bf = dt == torch.bfloat16
        esize = 2 if bf else 4
        for lat_w, proj, ks in ((32, poco_projection(dt), (1, 33, 50, 63, 64)),
                                (256, nets[dt].projection, (1, 33, 40, 50, 63))):
            tabs = decoder_tables(proj, dt)
            if not bf:
                tabs = full_mantissas(tabs, gen)
            lat = torch.randn(n, lat_w, generator=gen, device=dev).to(dt)
            for k in ks:
                idk = ids256[:, :k].contiguous()
                err = compare(f"K3 decoder_tail L={lat_w} k={k} {tag}",
                              [(decoder_tail(lat, pts, q, idk, tabs),
                                decoder_tail_plain(lat, pts, q, idk, tabs))], tol)
                name = ({(32, 64): "decoder_tail_l32", (256, 40): "decoder_tail_k40"} if bf
                        else {(32, 64): "decoder_tail_l32_f32"}).get((lat_w, k))
                if name is None:
                    continue
                nb = (n * lat_w * esize + n * 12 + c * 12 + c * k * 8 + c * lat_w * esize)
                ops = c * k * tail_macs(lat_w) * 2.0
                results[name] = dict(
                    name=name, route="cuda", source="ppsurf_tpu_torch/csrc/decoder_tail.cu",
                    replaces="ppsurf_tpu/ops/decoder_pallas.py:49", max_abs_err=err,
                    ms=cuda_ms(lambda: decoder_tail(lat, pts, q, idk, tabs)),
                    plain_ms=cuda_ms(lambda: decoder_tail_plain(lat, pts, q, idk, tabs), reps=2),
                    **kernel_bounds(nb, ops, tag),
                    library_ms=None, shape=f"C={c} k={k} L={lat_w} heads=64 {tag}",
                )
                if lat_w == 32:
                    res = results[name]
                    shp = launch_shape("ppsurf_decoder_tail_l32_info", c, int(bf))
                    b2b = cuda_ms(lambda: decoder_tail(lat, pts, q, idk, tabs), batch=20)
                    print(f"# K3 L=32 {tag} launch: {shp['active']} blocks an SM of "
                          f"{shp['grid_blocks'] // shp['active']} SMs ({shp['grid_blocks']} "
                          f"blocks, no cluster); weight bytes a launch streams by design "
                          f"{shp['weight_bytes']} (a count, not a measurement); "
                          f"{res['ms']:.4f} ms a call, {b2b:.4f} ms over 20 back-to-back "
                          f"calls, against its bound {res['bound_ms']:.4f} ms "
                          f"({res['bound_by']}) and its softmax's SFU floor "
                          f"{sfu_floor_ms(c, k):.4f} ms (worked out: {c} x {k} x 64 "
                          f"exponentials and divisions, {SFU_PER_CLOCK} a clock an SM)",
                          flush=True)
                xg = lat[idk].reshape(-1, lat_w)
                ys = yardstick(f"K3 L={lat_w} k={k} {tag}", "fc2, fc3, fc_query, fc_value",
                               [(xg, wt) for wt in (tabs.w2, tabs.w3, tabs.wq, tabs.wv)])
                if not bf:
                    results[name]["yardstick_ms"] = ys
                del xg
            del lat, tabs
        pt = pointnet_tables(nets[dt].point_net)
        if not bf:
            pt = full_mantissas(pt, gen)
        for p in WIDE_P:
            pp = patch_space(pts[ids256[:, :p]], q).to(dt).contiguous()
            b_k, pool_k = pointnet_trunk(pp, pt)
            b_p, pool_p = pointnet_trunk_plain(pp, pt)
            err4 = compare(f"K4 pointnet_trunk P={p} {tag}", [(b_k, b_p), (pool_k, pool_p)], tol)
            x2 = stn_apply(pool_p, b_p, pt).contiguous()
            err5 = compare(f"K5 pointnet_head P={p} {tag}",
                           [(pointnet_head(x2, pt), pointnet_head_plain(x2, pt))], tol)
            if p in (100, 200):
                sfx = "" if bf else "_f32"
                for kernel, err, fn, plain, nb, macs in (
                        ("pointnet_trunk", err4, lambda: pointnet_trunk(pp, pt),
                         lambda: pointnet_trunk_plain(pp, pt),
                         c * p * 3 * esize + c * p * 64 * esize + c * 256 * esize, TRUNK_MACS),
                        ("pointnet_head", err5, lambda: pointnet_head(x2, pt),
                         lambda: pointnet_head_plain(x2, pt),
                         c * p * 64 * esize + c * 256 * esize, HEAD_MACS)):
                    name = f"{kernel}_wide_p{p}{sfx}"
                    ops = c * p * macs * 2.0
                    results[name] = dict(
                        name=name, route="cuda", source="ppsurf_tpu_torch/csrc/pointnet.cu",
                        replaces="ppsurf_tpu/ops/pointnet_pallas.py:"
                                 + ("56" if kernel == "pointnet_trunk" else "72"),
                        max_abs_err=err, ms=cuda_ms(fn, reps=5), plain_ms=cuda_ms(plain, reps=2),
                        **kernel_bounds(nb, ops, tag),
                        library_ms=None, shape=f"C={c} P={p} {tag}",
                    )
            if bf and p in (100, 200):
                shp = launch_shape("ppsurf_pointnet_head_info", c, p)
                print(f"# K5 P={p} bf16 launch: clusters of {shp['cluster']} CTAs, "
                      f"{shp['active']} clusters at once ({shp['grid_blocks']} blocks); weight "
                      f"bytes a launch streams by design {shp['weight_bytes']} (a count, not "
                      f"a measurement); {results[f'pointnet_head_wide_p{p}']['ms']:.4f} ms a call, "
                      f"{cuda_ms(lambda: pointnet_head(x2, pt), batch=20):.4f} ms over 20 "
                      "back-to-back calls", flush=True)
            if p in (100, 200):
                w0a, w0b, ws1, ws2, ws3 = pt.trunk_w
                x3, x64 = pp.reshape(-1, 3), b_p.reshape(-1, 64)
                x128 = torch.matmul(x64, ws2)
                ys4 = yardstick(f"K4 P={p} {tag}", "conv0a, conv0b, stn conv1-3",
                                [(x3, w0a), (x64, w0b), (x64, ws1), (x64, ws2), (x128, ws3)])
                wc1, wc2, wc3, wq, wv = pt.head_w
                x64 = x2.reshape(-1, 64)
                x128 = torch.matmul(x64, wc2)
                x256 = torch.matmul(x128, wc3)
                ys5 = yardstick(f"K5 P={p} {tag}", "conv1-3, fc_query, fc_value",
                                [(x64, wc1), (x64, wc2), (x128, wc3), (x256, wq), (x256, wv)])
                if not bf:
                    results[f"pointnet_trunk_wide_p{p}_f32"]["yardstick_ms"] = ys4
                    results[f"pointnet_head_wide_p{p}_f32"]["yardstick_ms"] = ys5
                del x3, x64, x128, x256
            del pp, b_k, pool_k, b_p, pool_p, x2
    del ids256


# the training phase: PPSurf 50NN at full width (configs/ppsurf.yaml +
# ppsurf_50nn.yaml): batch 10, 10 000 manifold points, all 2 000 queries
TRAIN_SHAPES = {"trainset": 20, "valset": 2, "testset": 2}
TRAIN_QUERIES = 2000
K1_PER_CLOUD = 15  # graph 9 x k=16 + 4 x k=1, decoder ids k=64, masked patch k=50


def solid(kind: str, rng, n: int, queries):
    """n surface points of a seeded analytic solid at a random pose in the
    unit cube, and the signed distances of `queries` to it (negative
    inside; the ellipsoid's is the scaled sphere's, exact in sign)."""
    import numpy as np

    u = rng.rand(4)
    q = u / np.linalg.norm(u)  # a rotation from a random unit quaternion
    w, x, y, z = q
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    centre = (rng.rand(3) - 0.5) * 0.1
    local = (queries - centre) @ rot  # queries in the solid's frame
    if kind == "sphere":
        r = 0.2 + 0.15 * rng.rand()
        d = rng.randn(n, 3)
        surf = d / np.linalg.norm(d, axis=1, keepdims=True) * r
        dist = np.linalg.norm(local, axis=1) - r
    elif kind == "torus":
        big, small = 0.22 + 0.08 * rng.rand(), 0.06 + 0.05 * rng.rand()
        a, b = rng.rand(2, n) * 2 * np.pi
        surf = np.stack([(big + small * np.cos(b)) * np.cos(a),
                         (big + small * np.cos(b)) * np.sin(a), small * np.sin(b)], axis=1)
        ring = np.linalg.norm(local[:, :2], axis=1) - big
        dist = np.sqrt(ring ** 2 + local[:, 2] ** 2) - small
    else:
        radii = 0.12 + 0.25 * rng.rand(3)
        d = rng.randn(n, 3)
        surf = d / np.linalg.norm(d, axis=1, keepdims=True) * radii
        dist = (np.linalg.norm(local / radii, axis=1) - 1.0) * radii.min()
    return (surf @ rot.T + centre).astype(np.float32), dist.astype(np.float32)


def write_training_dataset(root: str, seed: int = 0) -> str:
    """The reference layout: 04_pts_vis/<name>.xyz.ply (20k-60k points),
    05_query_pts and 05_query_dist/<name>.ply.npy (2 000 queries in
    [-0.5, 0.5]^3 with their signed distances) and the set files; returns
    the test set's path."""
    import numpy as np

    from ppsurf_tpu_torch.io.ply import save_ply

    rng = np.random.RandomState(seed)
    for d in ("04_pts_vis", "05_query_pts", "05_query_dist"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    kinds = ("sphere", "torus", "ellipsoid")
    i = 0
    for split, count in TRAIN_SHAPES.items():
        names = []
        for _ in range(count):
            name = f"{kinds[i % 3]}_{i:02d}"
            queries = (rng.rand(TRAIN_QUERIES, 3) - 0.5).astype(np.float32)
            surf, dist = solid(kinds[i % 3], rng, int(rng.randint(20000, 60001)), queries)
            save_ply(os.path.join(root, "04_pts_vis", name + ".xyz.ply"), surf)
            np.save(os.path.join(root, "05_query_pts", name + ".ply.npy"), queries)
            np.save(os.path.join(root, "05_query_dist", name + ".ply.npy"), dist)
            names.append(name)
            i += 1
        with open(os.path.join(root, f"{split}.txt"), "w") as fp:
            fp.write("\n".join(names) + "\n")
    return os.path.join(root, "testset.txt")


def grad_diff(ga, gb) -> typing.Tuple[float, float, str]:
    """Gradients `ga` against `gb` (name -> tensor): the relative L2 of
    the whole, and the worst leaf's among those above 1e-5 of the largest
    |g| (with its name)."""
    gmax = max(float(g.abs().max()) for g in gb.values())
    num = sum(float(((ga[n] - gb[n]) ** 2).sum()) for n in gb)
    den = sum(float((gb[n] ** 2).sum()) for n in gb)
    leaves = {n: float((ga[n] - gb[n]).norm() / gb[n].norm()) for n in gb
              if float(gb[n].abs().max()) > 1e-5 * gmax}
    worst = max(leaves, key=leaves.get)
    return (num / den) ** 0.5, leaves[worst], worst


def training_phase(tmp: str, smi: str, profile: typing.Optional[str]) -> dict:
    """Phase 12: `cli fit`, an overfit run, one f32 step on the card against
    the CPU plain path, the bf16 step's time and memory, `cli test` and
    `cli predict` from the checkpoint. Returns the numbers it printed."""
    import numpy as np
    import torch

    from ppsurf_tpu_torch import cli
    from ppsurf_tpu_torch.convert.checkpoint import load_checkpoint
    from ppsurf_tpu_torch.convert.infer_npz import from_jax_variables, to_jax_variables
    from ppsurf_tpu_torch.convert.init import init_variables
    from ppsurf_tpu_torch.data.datasets import OccupancyDataModule
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.ops.knn import knn_plain
    from ppsurf_tpu_torch.ops.patches import patch_space
    from ppsurf_tpu_torch.train import loop
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    dev = torch.device("cuda")
    out = {}
    t0 = time.perf_counter()
    testset = write_training_dataset(os.path.join(tmp, "train_ds"))
    print(f"# train: dataset of {sum(TRAIN_SHAPES.values())} solids written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    configs = [a for c in ("poco", "ppsurf", "ppsurf_50nn")
               for a in ("-c", os.path.join(HERE, "configs", f"{c}.yaml"))]
    root = os.path.join(tmp, "models")
    common = [*configs, "--data.init_args.in_file", testset,
              "--trainer.default_root_dir", root,
              "--model.init_args.results_dir", os.path.join(tmp, "results")]

    # ---- 12a. cli fit: 2 epochs of 2 steps, bf16, seeded weights ----
    trainers = []
    fit = loop.Trainer.fit

    def capture_fit(self, *a, **kw):
        trainers.append(self)
        return fit(self, *a, **kw)

    loop.Trainer.fit = capture_fit
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["fit", *common, "--trainer.max_epochs", "2"])
    finally:
        loop.Trainer.fit = fit
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launch = dict(kernels.LAUNCHES)
    trainer = trainers[0]
    ckpt = os.path.join(root, "version_0", "checkpoints", "last.pt")
    losses = [loss for _, loss in trainer.history]
    print(f"# train: cli fit (ppsurf_50nn, bf16, batch 10, 10000 pts, {TRAIN_QUERIES} queries, "
          f"2 epochs) rc {rc}, {fit_s:.2f} s; steps {[s for s, _ in trainer.history]}, "
          f"losses {[round(v, 4) for v in losses]}; launches "
          f"{json.dumps({k: v for k, v in fit_launch.items() if v})}", flush=True)
    if rc != 0 or [s for s, _ in trainer.history] != [1, 2, 3, 4]:
        fail(f"cli fit did not take its 4 steps: rc {rc}, history {trainer.history}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    payload = load_checkpoint(ckpt)
    if payload["step"] != 4 or set(payload["variables"]) != {"params", "batch_stats"} \
            or not payload["optimizer"]["state"] \
            or not os.path.isfile(os.path.join(root, "version_0", "config.yaml")):
        fail(f"{ckpt}: unexpected checkpoint layout (step {payload['step']})")
    # 4 train steps of 10 clouds and 2 validation batches: 2 shapes, wrapped
    # around once to 4 (`epoch_batches` pads with the order's own head)
    n_val = TRAIN_SHAPES["valset"]
    want = K1_PER_CLOUD * (4 * 10 + 2 * (n_val + min(n_val, -n_val % 10)))
    if fit_launch["knn"] != want:
        fail(f"cli fit launched K1 {fit_launch['knn']} times, expected {want}")
    out["fit_s"] = fit_s

    # ---- 12b. one fixed batch, 30 steps: the loss must fall ----
    spec = ppsurf_spec(dtype=torch.bfloat16)
    cfg = loop.TrainConfig()
    dm = OccupancyDataModule(testset, batch_size=10, manifold_points=10000, seed=3)
    batch_np = next(iter(dm.epoch_batches(dm.train_dataset(), np.random.RandomState(0), True)))
    batch = loop.to_device(batch_np, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = spec.draw_step(10, 10000, gen, dev)

    def fresh(sp, device):
        net = sp.make_network()
        net.load_state_dict(from_jax_variables(init_variables(sp, seed=0), net), strict=True)
        net = net.to(device)
        return net, loop.make_optimizer(net, cfg)

    net, opt = fresh(spec, dev)
    kernels.reset_launches()
    loss, _ = loop.train_step(net, spec, opt, batch, draws, cfg.lr, generator=gen)
    torch.cuda.synchronize()
    step_launch = dict(kernels.LAUNCHES)
    print(f"# train: one step's launches {json.dumps({k: v for k, v in step_launch.items() if v})}"
          f" (K1 {K1_PER_CLOUD} a cloud x 10)", flush=True)
    if step_launch["knn"] != K1_PER_CLOUD * 10:
        fail(f"a training step launched K1 {step_launch['knn']} times, expected "
             f"{K1_PER_CLOUD * 10}")
    overfit = [float(loss)]
    for _ in range(29):
        overfit.append(float(loop.train_step(net, spec, opt, batch, draws, cfg.lr,
                                             generator=gen)[0]))
    late = float(np.mean(overfit[-5:]))
    print(f"# train: overfit one batch, 30 bf16 steps: first loss {overfit[0]:.4f}, mean of the "
          f"last 5 {late:.4f} ({late / overfit[0]:.3f} of the first; limit 0.8); losses "
          f"{[round(v, 4) for v in overfit]}", flush=True)
    if not (np.isfinite(overfit).all() and late <= 0.8 * overfit[0]):
        fail(f"the loss did not fall by 20% in 30 steps on one batch: {overfit}")
    out["overfit"] = (overfit[0], late)

    # ---- 12c. the bf16 step's time, peak memory and host share ----
    torch.cuda.reset_peak_memory_stats()
    host, times = [], []
    for i in range(12):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        h0 = time.perf_counter()
        step_draws = spec.draw_step(10, 10000, gen, dev)
        loop.train_step(net, spec, opt, batch, step_draws, cfg.lr, generator=gen)
        h1 = time.perf_counter()
        b.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(a.elapsed_time(b))
            host.append((h1 - h0) * 1e3)
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    host_share = statistics.median(host) / step_ms
    print(f"# train: bf16 step (batch 10, 10000 pts, {TRAIN_QUERIES} queries, P=50, k=64, graph "
          f"building included): median {step_ms:.1f} ms over 10 steps (min {min(times):.1f}, "
          f"max {max(times):.1f}); {smi}", flush=True)
    print(f"# train: peak memory {peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"host share {host_share:.3f} (host time to enqueue a step / its device time)",
          flush=True)
    out.update(step_ms=step_ms, peak_gib=peak / 2 ** 30, host_share=host_share)
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            p0 = time.perf_counter()
            for _ in range(3):
                loop.train_step(net, spec, opt, batch, draws, cfg.lr, generator=gen)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - p0
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        with open(profile + ".train", "w") as fp:
            fp.write(f"# {smi}; 3 bf16 training steps, {elapsed:.3f} s under the profiler\n")
            fp.write(events.table(sort_by="self_device_time_total", row_limit=40))
        print(f"# train: profile: device busy {busy:.3f} s of {elapsed:.3f} s "
              f"(idle share {1 - busy / elapsed:.3f}); table in {profile}.train", flush=True)
    del net, opt, batch
    torch.cuda.empty_cache()

    # ---- 12d. one f32 step on the card against the CPU plain path ----
    spec32 = ppsurf_spec(dtype=torch.float32)
    small = {k: v[:2] for k, v in batch_np.items()}
    qsel = np.random.RandomState(1).choice(TRAIN_QUERIES, 500, replace=False)
    small["pts_query_ms"] = small["pts_query_ms"][:, qsel]
    small["occ"] = small["occ"][:, qsel]
    cpu = torch.device("cpu")
    gen_cpu = torch.Generator().manual_seed(5)
    draws_cpu = spec32.draw_step(2, 10000, gen_cpu, cpu)
    masks_cpu = [torch.rand((2 * 500, 256), generator=gen_cpu) < 0.7 for _ in range(2)]
    nets = {}
    for name, device in (("card", dev), ("cpu", cpu), ("cpu_nudged", cpu)):
        tb = loop.to_device(small, device)
        dr = [[(t.to(device), r.to(device)) for t, r in d] for d in draws_cpu]
        kernels.reset_launches()
        own = spec32.assemble_step_data(tb, dr) if name != "cpu_nudged" else {}
        nets[name] = dict(data={k: v.cpu() for k, v in own.items()},
                          knn=kernels.LAUNCHES["knn"])
        # the CPU step takes the card's inputs: a point on a voxel face in
        # one device's rounding of the rotated cloud moves a support
        data = {k: v.to(device) for k, v in nets["card"]["data"].items()}
        net, opt = fresh(spec32, device)
        if name == "cpu_nudged":  # the weights moved by rounding's size, 2^-24
            with torch.no_grad():
                g_n = torch.Generator().manual_seed(9)
                for p_ in net.parameters():
                    p_.mul_(1 + (torch.rand(p_.shape, generator=g_n) - 0.5) * 2 ** -23)
        loss, _ = loop.train_step(net, types.SimpleNamespace(assemble_step_data=lambda *_: data),
                                  opt, tb, dr, cfg.lr, masks=[m.to(device) for m in masks_cpu])
        nets[name].update(loss=float(loss),
                          grads={n: p.grad.detach().cpu() for n, p in net.named_parameters()},
                          vars=to_jax_variables(net))
        del net, opt, own, data
    card, host_run = nets["card"], nets["cpu"]
    # K1's training calls against the plain kNN on the card's own inputs
    pts_c = card["data"]["pts"]
    sup = [pts_c] + [card["data"][f"support{i}"] for i in range(1, 5)]
    pairs = {"00": (0, 0), "01": (0, 1), "11": (1, 1), "12": (1, 2), "22": (2, 2),
             "23": (2, 3), "33": (3, 3), "34": (3, 4), "44": (4, 4),
             "43": (4, 3), "32": (3, 2), "21": (2, 1), "10": (1, 0)}
    bad = []
    for b in range(2):
        for key, (pi, qi) in pairs.items():
            ids = card["data"][f"ids{key}"][b]
            plain = knn_plain(sup[pi][b], sup[qi][b], ids.shape[1])
            bad += [] if torch.equal(ids, plain) else [f"ids{key}[{b}]"]
        plain = knn_plain(pts_c[b], card["data"]["pts_query"][b], 64)
        bad += [] if torch.equal(card["data"]["proj_ids"][b], plain) else [f"proj_ids[{b}]"]
        raw = torch.from_numpy(small["pts_raw_ms"][b])
        ids = knn_plain(raw, card["data"]["pts_query"][b], 50,
                        valid=torch.from_numpy(small["raw_valid"][b]))
        want_p = patch_space(raw[ids], card["data"]["pts_query"][b])
        if not torch.allclose(card["data"]["pts_local_ps"][b], want_p, rtol=1e-6, atol=1e-6):
            bad.append(f"pts_local_ps[{b}]")
    same_sup = all(torch.equal(card["data"][f"support{i}"], host_run["data"][f"support{i}"])
                   for i in range(1, 5))
    print(f"# train: f32 step, B=2, 10000 pts, 500 queries: K1's {card['knn']} "
          f"training-shaped launches (k=16, 1, 64 and the masked k=50 patch call) equal the "
          f"plain kNN on the card's inputs: {not bad} {bad}; supports equal to the CPU's: "
          f"{same_sup}", flush=True)
    if bad or card["knn"] != K1_PER_CLOUD * 2:
        fail(f"K1's training calls disagree with the plain kNN: {bad} ({card['knn']} launches)")
    # The gradient has kinks (ReLU, max, argmax) that rounding-level
    # differences cross: the CPU's own gradient moves under weights nudged
    # by 2^-24 (printed as the yardstick). Limits: the whole gradient within
    # 1e-2 relative L2, each leaf above 1e-5 of the largest |g| within 0.25;
    # each parameter within AdamW's first-step Lipschitz bound of its two
    # gradients, lr / eps x |g_card - g_cpu| + 1e-6; statistics within 1e-4
    # of a leaf's largest value, as tests/test_torch_train.py holds them.
    g_all, g_leaf, g_name = grad_diff(card["grads"], host_run["grads"])
    n_all, n_leaf, n_name = grad_diff(nets["cpu_nudged"]["grads"], host_run["grads"])

    def flat(tree, prefix=""):
        res = {}
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            res.update(flat(v, name) if isinstance(v, dict) else {name: v})
        return res

    pc, ph = flat(card["vars"]["params"]), flat(host_run["vars"]["params"])
    p_err = max(float(np.abs(pc[n] - ph[n]).max()) for n in ph)
    bad_p = [n for n in ph if (np.abs(pc[n] - ph[n]) > cfg.lr / cfg.eps * np.abs(
        card["grads"][n].numpy() - host_run["grads"][n].numpy()) + 1e-6).any()]
    sc, sh = flat(card["vars"]["batch_stats"]), flat(host_run["vars"]["batch_stats"])
    s_err = max(float(np.abs(sc[n] - sh[n]).max() / (np.abs(sh[n]).max() + 1e-12)) for n in sh)
    bad_s = [n for n in sh if np.abs(sc[n] - sh[n]).max() > 1e-4 * np.abs(sh[n]).max() + 1e-7]
    loss_rel = abs(card["loss"] - host_run["loss"]) / abs(host_run["loss"])
    print(f"# train: f32 step, card vs CPU: loss {card['loss']:.7f} vs {host_run['loss']:.7f} "
          f"(rel {loss_rel:.2e}, limit 1e-4); gradient rel L2 {g_all:.2e} (limit 1e-2), worst "
          f"leaf {g_leaf:.2e} {g_name} (limit 0.25); the CPU's own under weights nudged by "
          f"2^-24: {n_all:.2e}, worst leaf {n_leaf:.2e} {n_name}; parameters max |diff| "
          f"{p_err:.2e}, outside their bound {bad_p[:5]}; batch statistics {s_err:.2e} of a "
          f"leaf's max, outside {bad_s[:5]}", flush=True)
    if loss_rel > 1e-4 or g_all > 1e-2 or g_leaf > 0.25 or bad_p or bad_s:
        fail("the f32 training step on the card disagrees with the CPU plain path")
    out.update(loss_rel=loss_rel, grad_rel=g_all)
    del nets, card, host_run

    # ---- 12e. cli test on the checkpoint ----
    kernels.reset_launches()
    rc = cli.main(["test", *common])
    torch.cuda.synchronize()
    report = os.path.join(tmp, "results", "ppsurf_50nn", "train_ds", "metrics_ppsurf_50nn")
    rows = []
    if os.path.isfile(report + ".csv"):
        with open(report + ".csv") as fp:
            rows = [line.split(",")[0] for line in fp.read().splitlines()]
    print(f"# train: cli test rc {rc}: {os.path.relpath(report, tmp)}.csv rows {rows}; .xlsx "
          f"{os.path.isfile(report + '.xlsx')}; launches "
          f"{json.dumps({k: v for k, v in kernels.LAUNCHES.items() if v})}", flush=True)
    if rc != 0 or len(rows) != 1 + TRAIN_SHAPES["testset"] + 3 \
            or not os.path.isfile(report + ".xlsx"):
        fail("cli test did not write its report")

    # ---- 12f. cli rec of one test shape from last.pt: K3-K5 ----
    with open(testset) as fp:
        shape = fp.read().split()[0]
    cloud = os.path.join(tmp, "train_ds", "04_pts_vis", shape + ".xyz.ply")
    kernels.reset_launches()
    rc = cli.main(["rec", cloud, os.path.join(tmp, "rec"), *common, "--ckpt_path", ckpt,
                   "--model.init_args.gen_resolution_global", "65"])
    torch.cuda.synchronize()
    rlaunch = dict(kernels.LAUNCHES)
    mesh_file = os.path.join(tmp, "rec", shape + ".xyz.ply", shape + ".xyz.ply.ply")
    print(f"# train: cli rec of {shape} from last.pt at res 65: rc {rc}, mesh written "
          f"{os.path.isfile(mesh_file)}; launches "
          f"{json.dumps({k: v for k, v in rlaunch.items() if v})}", flush=True)
    if any(rlaunch[k] == 0 for k in ("knn", "decoder_tail", "pointnet_trunk", "pointnet_head")):
        fail(f"cli rec from the port checkpoint did not run K1 and K3-K5: {rlaunch}")
    return out


# the scoring phase: cube samples of IoU/F1 (`metrics/mesh_metrics.py`),
# W1's limits against its plain version, and the operations of one (query,
# face) pair: 9 differences, 3 norms (3 products, 2 sums), b x c (6, 3),
# a . (b x c) (3, 2), 3 dot products (3, 2), the denominator (5 products,
# 3 sums), the arctangent, its doubling and the running sum
SCORE_SAMPLES = 100000
GT_RESOLUTION = 257
SCORE_TABLES = ("chamfer_distance", "f1", "iou", "normal_error")
W1_ATOL, W1_BAND = 1e-4, 1e-3
# the seeds of `large_soup`s W1 is held to float64 on: they hold both kinds
# of pair that f32 cannot decide (`winding_checks`)
SOUP_SEEDS = range(48)
W1_OPS_PER_PAIR = 64
# the design's SFU operations a pair: three square roots, one reciprocal
W1_MUFU_PER_PAIR = 4


def w1_pair_sass(sass: str) -> typing.Optional[dict]:
    """SASS instructions W1's pair loop issues a (query, face) pair on its
    common path, by class, from `cuobjdump -sass` output holding
    `winding_kernel`. The loop is the conditional backward branch with the
    most MUFU instructions in its span and no mbarrier, bulk copy or block
    barrier; the path runs from its head to that branch, taking a
    conditional branch where the warp vote (VOTE.ALL) says every pair is
    inner, or where the way past it calls a slow-path subroutine, and
    falling through otherwise. Pairs an iteration = its square roots / 3."""
    import re

    for part in sass.split("Function : ")[1:]:
        head, body = part.split("\n", 1)
        if re.search(r"\d+winding_kernel", head):
            break
    else:
        return None
    code = [(int(m.group(1), 16), m.group(2)) for m in
            (re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line) for line in body.splitlines())
            if m]
    at = {a: i for i, (a, _) in enumerate(code)}

    def target(ins):
        m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", ins)
        return int(m.group(1), 16) if m else None

    def opcode(ins):
        return re.sub(r"^@!?U?P\w+\s+", "", ins)

    loops = []
    for i, (a, ins) in enumerate(code):
        t = target(ins)
        if t is not None and t < a and ins.startswith("@") and t in at:
            span = [x for _, x in code[at[t]:i + 1]]
            if not any(re.search(r"\b(SYNCS|UBLKCP|BAR)\b", x) for x in span):
                loops.append((sum(opcode(x).startswith("MUFU") for x in span), t, a))
    if not loops:
        return None
    _, start, latch = max(loops)
    i, seen, ops, votes = at[start], set(), [], set()
    while True:
        a, ins = code[i]
        if a in seen:
            return None
        seen.add(a)
        ops.append(opcode(ins).split()[0])
        if a == latch:
            break
        if ops[-1].startswith("VOTE.ALL"):
            votes.add(opcode(ins).split()[1].rstrip(","))
        t = target(ins)
        if t is not None:
            m = re.match(r"@(!?)(U?P\d)", ins)
            if m is None:
                take = True
            elif m.group(2) in votes:
                take = m.group(1) == ""
            else:
                j = i + 1
                while j < len(code) and code[j][0] != t and target(code[j][1]) is None:
                    j += 1
                take = any("CALL" in x for _, x in code[i + 1:j + 1])
            if take:
                i = at[t]
                continue
        i += 1
    pairs = sum(o.startswith(("MUFU.SQRT", "MUFU.RSQ")) for o in ops) / 3
    if not pairs:
        return None
    cls = {"FP32": sum(o.startswith("F") for o in ops),
           "MUFU": sum(o.startswith("MUFU") for o in ops),
           "LDS": sum(o.startswith("LDS") for o in ops)}
    cls["other"] = len(ops) - sum(cls.values())
    return dict(per_pair=len(ops) / pairs, pairs_an_iteration=pairs,
                **{k: v / pairs for k, v in cls.items()})


def sass_line(tag: str, r: typing.Optional[dict]) -> str:
    if r is None:
        return f"# W1 SASS ({tag}): pair loop not found"
    return (f"# W1 SASS ({tag}), the pair loop's common path: {r['per_pair']:.2f} instructions "
            f"a pair (FP32 {r['FP32']:.2f}, MUFU {r['MUFU']:.2f}, LDS {r['LDS']:.2f}, other "
            f"{r['other']:.2f}; {r['pairs_an_iteration']:g} pairs an iteration)")


def w1_baseline(path: str):
    """An earlier build of W1 from its `winding.cu` at `path`, with this
    one's C entry (queries, packed faces, partial, out, nq, tiles, splits,
    stream): nvcc with the port's flags into a temporary directory. Returns
    the winding function on `ops/winding.py`'s launch rule, with the
    normals packed as an f32 cross product, as earlier builds took them, and the
    build's SASS."""
    import ctypes
    import shutil

    import torch

    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.ops.winding import BLOCKS_PER_SM, W_BLOCK_QUERIES, W_TILE, pack_faces

    tmp = tempfile.mkdtemp(prefix="w1_baseline_")
    obj, so = os.path.join(tmp, "winding.o"), os.path.join(tmp, "libw1_baseline.so")
    run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-c", path, "-o", obj])
    run([kernels._nvcc(), "-shared", "-o", so, obj])
    sass = run([os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump"), "-sass", so])
    lib = ctypes.CDLL(so)
    shutil.rmtree(tmp)
    fn = lib.ppsurf_winding
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def winding_baseline(q, a, b, c):
        nq = q.shape[0]
        # the normals as every earlier W1 packed them: an f32 cross product
        faces = pack_faces(a, b, c)
        faces[:a.shape[0], 3::4] = torch.linalg.cross(b - a, c - a)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        tiles = faces.shape[0] // W_TILE
        splits = max(1, min(tiles, -(-sms * BLOCKS_PER_SM // -(-nq // W_BLOCK_QUERIES))))
        partial = torch.empty((splits, nq), dtype=torch.float32, device=q.device)
        out = torch.empty(nq, dtype=torch.float32, device=q.device)
        rc = fn(*(t.data_ptr() for t in (q, faces, partial, out)), nq, tiles, splits,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"the baseline W1 launch failed (cudaError {rc})")
        return out

    return winding_baseline, sass


def winding_f64(q, a, b, c):
    """The winding number in float64 (the reference W1 and its plain
    version are both held to; the same formula, 256 queries x 8192 faces
    a step)."""
    import math

    import torch

    q, a, b, c = (t.double() for t in (q, a, b, c))
    out = []
    for qq in q.split(256):
        acc = torch.zeros(qq.shape[0], dtype=torch.float64, device=q.device)
        for s in range(0, a.shape[0], 8192):
            x, y, z = (t[s:s + 8192][None] - qq[:, None] for t in (a, b, c))
            lx, ly, lz = x.norm(dim=-1), y.norm(dim=-1), z.norm(dim=-1)
            num = (x * torch.linalg.cross(y, z)).sum(-1)
            den = (lx * ly * lz + (x * y).sum(-1) * lz + (y * z).sum(-1) * lx
                   + (z * x).sum(-1) * ly)
            acc += 2.0 * torch.atan2(num, den).sum(-1)
        out.append(acc / (4.0 * math.pi))
    return torch.cat(out)


def icosphere(level: int, radius: float):
    """A closed icosphere: the icosahedron split `level` times (20 * 4^level
    faces), vertices on the sphere; (vertices f32, faces)."""
    import numpy as np

    t = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                  [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]])
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]])
    for _ in range(level):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v.shape[0] + inv.reshape(3, -1).T
        v = np.concatenate([v, 0.5 * (v[uniq[:, 0]] + v[uniq[:, 1]])])
        f = np.concatenate([np.stack([f[:, 0], mid[:, 0], mid[:, 2]], 1),
                            np.stack([mid[:, 0], f[:, 1], mid[:, 1]], 1),
                            np.stack([mid[:, 2], mid[:, 1], f[:, 2]], 1), mid])
    return (v / np.linalg.norm(v, axis=1, keepdims=True) * radius).astype(np.float32), f


def near_vertex_cases() -> dict:
    """name -> (queries, a, b, c): a closed 5 120-face icosphere and 20 000
    random triangles with edges about 1/256, each with queries t edges from
    the B and the C vertex of 64 of its faces, t in {1e-2, 1e-3, 1e-4,
    1e-5}, along +-N, in the face's plane away from the face (the two edges
    at the vertex reversed, the vertex minus the centroid) and from six
    random directions."""
    import numpy as np

    rng = np.random.default_rng(7)
    verts, faces = icosphere(4, 0.3)
    soup = rng.uniform(-0.4, 0.4, (20000, 1, 3)) + rng.normal(
        size=(20000, 3, 3)) / 256 / 3 ** 0.5
    cases = {"a 5120-face icosphere": [verts[faces[:, i]] for i in range(3)],
             "20000 small random triangles": [soup[:, i].astype(np.float32) for i in range(3)]}
    out = {}
    for name, (a, b, c) in cases.items():
        qs = []
        for f in rng.choice(a.shape[0], 64, replace=False):
            p = np.stack([a[f], b[f], c[f]]).astype(np.float64)
            n = np.cross(p[1] - p[0], p[2] - p[0])
            n /= np.linalg.norm(n)
            edge = np.mean([np.linalg.norm(p[i] - p[i - 1]) for i in range(3)])
            for k in (1, 2):
                dirs = [n, -n, p[k] - p.mean(0)] + [p[k] - p[j] for j in range(3) if j != k]
                for d in dirs + list(rng.normal(size=(6, 3))):
                    for t in (1e-2, 1e-3, 1e-4, 1e-5):
                        qs.append(p[k] + t * edge * d / np.linalg.norm(d))
        out[name] = (np.asarray(qs, np.float32), a, b, c)
    return out


def large_soup(seed: int, n: int = 200000, radius: float = 0.3):
    """`n` triangles with vertices drawn uniformly on a sphere (a soup of
    large triangles across it), from its own numpy generator: no draw
    elsewhere in the smoke moves it. (a, b, c) f32."""
    import numpy as np

    pts = np.random.default_rng(seed).standard_normal((3 * n, 3))
    pts = (pts / np.linalg.norm(pts, axis=1, keepdims=True) * radius).astype(np.float32)
    return [pts[i::3] for i in range(3)]


def near_plane_cases() -> dict:
    """name -> (queries, a, b, c): 20 000 large triangles across a sphere
    (`large_soup`) and a closed 5 120-face icosphere turned by a seeded
    rotation (the icosahedron's symmetric faces have planes that f32 points
    lie on exactly), each with one f32 query inside each of 2048 of its
    faces at a random barycentric point: within f32 rounding of the face's
    plane, where the numerator's sign alone picks a turn. Fails if a query
    lies on its face's plane in exact arithmetic (the winding number steps
    there)."""
    from fractions import Fraction

    import numpy as np

    rng = np.random.default_rng(11)
    verts, faces = icosphere(4, 0.3)
    rot, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    verts = (verts.astype(np.float64) @ rot).astype(np.float32)
    cases = {"20000 large triangles": large_soup(1000, 20000),
             "a 5120-face icosphere": [verts[faces[:, i]] for i in range(3)]}
    out = {}
    for name, (a, b, c) in cases.items():
        f = rng.choice(a.shape[0], 2048, replace=False)
        w = rng.dirichlet([1.0, 1.0, 1.0], 2048)
        qs = (w[:, :1] * a[f].astype(np.float64) + w[:, 1:2] * b[f]
              + w[:, 2:] * c[f]).astype(np.float32)
        for qi, fi in zip(qs, f):
            x, y, z = ([Fraction(float(t[fi][i])) - Fraction(float(qi[i])) for i in range(3)]
                       for t in (a, b, c))
            if (x[0] * (y[1] * z[2] - y[2] * z[1]) + x[1] * (y[2] * z[0] - y[0] * z[2])
                    + x[2] * (y[0] * z[1] - y[1] * z[0])) == 0:
                fail(f"near_plane_cases: a query of {name} lies on its face's plane")
        out[name] = (qs, a, b, c)
    return out



def winding_checks(check, results, gen, dev, mesh, sass: str,
                   baseline: typing.Optional[str] = None) -> None:
    """W1 against its plain version on the card: the production shape (the
    metrics' 100 000 seed-42 cube samples against the 50NN mesh), then
    faces no tile divides, a single face, degenerate faces, queries on
    vertices, query counts no block divides and queries near a face's B or
    C (`near_vertex_cases`). |w - plain| <= W1_ATOL, and the inside masks
    equal wherever |plain - 0.5| > W1_BAND. On 2048 of the samples, the
    near-vertex queries and the soups of large triangles (`large_soup`,
    SOUP_SEEDS), W1 against float64; at queries within f32 rounding of a
    face's plane (`near_plane_cases`), W1 within W1_ATOL of float64. Prints
    the SASS instructions of the pair loop a pair (`w1_pair_sass`); with
    `baseline` (an earlier winding.cu), that build's too, the
    two timed in turns at the production shape (baseline, this tree, this tree,
    baseline), and the baseline's float64 errors on the soups and the probe."""
    import numpy as np
    import torch

    from ppsurf_tpu_torch.metrics.mesh_metrics import _occupancy_samples
    from ppsurf_tpu_torch.ops.winding import winding, winding_plain

    v = torch.from_numpy(mesh.vertices).to(dev)
    f = torch.from_numpy(mesh.faces.astype(np.int64)).to(dev)
    tri = [v[f[:, i]].contiguous() for i in range(3)]
    q = torch.from_numpy(_occupancy_samples(SCORE_SAMPLES).astype(np.float32)).to(dev)

    def compare(name, w, p):
        far = (p - 0.5).abs() > W1_BAND
        flips = int(((w > 0.5) != (p > 0.5))[far].sum())
        err = float((w - p).abs().max())
        check(f"W1 winding {name}", err, W1_ATOL,
              note=f"; inside masks differ at {flips} queries outside |w - 0.5| <= {W1_BAND}")
        check(f"W1 winding {name} (inside masks differing)", float(flips), 0.0)
        return err

    def against_f64(name, w, p, ref):
        """W1 no further from the float64 winding number than twice its
        plain version (f32 both) is, or 1e-5."""
        ew, ep = float((w.double() - ref).abs().max()), float((p.double() - ref).abs().max())
        check(f"W1 winding {name} against float64", ew, max(2 * ep, 1e-5),
              note=f"; plain version against float64 {ep:.3e}")

    w = winding(q, *tri)
    torch.cuda.synchronize()
    t_plain = cuda_ms(lambda: winding_plain(q, *tri), reps=1, warmup=0)
    p = winding_plain(q, *tri)
    err = compare(f"{q.shape[0]} cube samples x {f.shape[0]} faces of the 50NN mesh", w, p)
    if not torch.equal(winding(q, *tri), w):
        check("W1 winding (two runs differing)", 1.0, 0.0)
    against_f64("first 2048 cube samples x the 50NN mesh", w[:2048], p[:2048],
                winding_f64(q[:2048], *tri))
    pairs = q.shape[0] * f.shape[0]
    n_bytes = q.shape[0] * 12 + 3 * f.shape[0] * 12 + q.shape[0] * 4
    b_ms, b_by = bound_ms(n_bytes, pairs * W1_OPS_PER_PAIR, "f32")
    mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"]).splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_ms = pairs * W1_MUFU_PER_PAIR / (SFU_PER_CLOCK * sms * mhz * 1e6) * 1e3
    results["winding"] = dict(
        name="winding", route="cuda", source="ppsurf_tpu_torch/csrc/winding.cu",
        replaces="ppsurf_tpu/metrics/winding.py:23",
        max_abs_err=err, ms=cuda_ms(lambda: winding(q, *tri), reps=5),
        plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"Q={q.shape[0]} F={f.shape[0]} f32",
        note="no Pallas counterpart: the JAX package computes it as a jitted XLA reduction",
    )
    print(f"# W1 bound: {pairs * W1_OPS_PER_PAIR:.3e} operations at 67 TFLOP/s f32 "
          f"{b_ms:.3f} ms; SFU floor of its {W1_MUFU_PER_PAIR} MUFU operations a pair (3 "
          f"square roots, 1 reciprocal; {SFU_PER_CLOCK} a clock on each of {sms} SMs at "
          f"{mhz:.0f} MHz) {sfu_ms:.3f} ms (worked out, not measured)", flush=True)
    print(sass_line("this tree", w1_pair_sass(sass)), flush=True)
    if baseline:
        winding_base, base_sass = w1_baseline(baseline)
        print(sass_line(f"baseline {baseline}", w1_pair_sass(base_sass)), flush=True)
        wb = winding_base(q, *tri)
        print(f"# W1 baseline against the plain version: max |dw| "
              f"{float((wb - p).abs().max()):.3e}", flush=True)
        turns = [("baseline", lambda: winding_base(q, *tri)), ("this tree", lambda: winding(q, *tri)),
                 ("this tree", lambda: winding(q, *tri)), ("baseline", lambda: winding_base(q, *tri))]
        times = [(tag, cuda_ms(fn, reps=5)) for tag, fn in turns]
        print("# W1 A/B at the production shape, in turns (CUDA-event medians of 5): "
              + ", ".join(f"{tag} {t:.3f} ms" for tag, t in times), flush=True)
        del wb
    del w, p

    # edge cases: faces of no tile's multiple, one face, degenerate faces
    # (a repeated vertex, a point), queries on vertices, odd query counts
    sub = [t[:8193] for t in tri]
    a, b, c = tri
    degenerate = [torch.cat([a[:5000], a[:300], a[300:400]]),
                  torch.cat([b[:5000], a[:300], a[300:400]]),
                  torch.cat([c[:5000], b[:300], a[300:400]])]
    on_vertex = torch.cat([v[torch.randperm(v.shape[0], generator=gen, device=dev)[:500]],
                           q[:501]])
    for name, qq, tt in (("F=8193 faces, Q=1001", q[:1001], sub),
                         ("a single face, Q=77", q[:77], [t[:1] for t in tri]),
                         ("5000 faces + 400 degenerate, Q=1001", q[:1001], degenerate),
                         ("1001 queries, 500 on vertices, 8193 faces", on_vertex, sub)):
        compare(name, winding(qq, *tt), winding_plain(qq, *tt))
    # queries 1e-2 to 1e-5 edges from a face's B or C, from every direction
    # (the numerator's rounding grows with the distance to the vertex it
    # is taken from), on a closed icosphere and on small random triangles
    for name, (qq, *tt) in near_vertex_cases().items():
        qq, tt = torch.from_numpy(qq).to(dev), [torch.from_numpy(t).to(dev) for t in tt]
        w_n, p_n = winding(qq, *tt), winding_plain(qq, *tt)
        compare(f"{qq.shape[0]} queries near vertices of {name}", w_n, p_n)
        against_f64(f"{qq.shape[0]} queries near vertices of {name}", w_n, p_n,
                    winding_f64(qq, *tt))
    # soups of large triangles across a sphere, each from its own seed:
    # queries near their planes and edges cancel in f32 in both versions, so
    # W1 is held to float64 there (in f32 alone, W1 loses a whole turn near
    # a plane on seeds 4, 11, 19 and 20 and errs over twice the plain
    # version near an edge on 17, 22, 32 and 35)
    qs = q[:2048]
    base_f64 = []
    for seed in SOUP_SEEDS:
        soup = [torch.from_numpy(t).to(dev) for t in large_soup(seed)]
        ref = winding_f64(qs, *soup)
        against_f64(f"2048 cube samples x 200000 large triangles, seed {seed}",
                    winding(qs, *soup), winding_plain(qs, *soup), ref)
        if baseline:
            base_f64.append(float((winding_base(qs, *soup).double() - ref).abs().max()))
    if baseline:
        print("# W1 baseline against float64 on the soups (no limit): " + ", ".join(
            f"seed {seed} {e:.3e}" for seed, e in zip(SOUP_SEEDS, base_f64)), flush=True)
    # f32 queries inside faces, within f32 rounding of their planes: the
    # numerator's sign picks a whole turn, which the plain version (the JAX
    # package's formula) can lose; W1 is held to float64 alone
    for name, (qq, *tt) in near_plane_cases().items():
        qq, tt = torch.from_numpy(qq).to(dev), [torch.from_numpy(t).to(dev) for t in tt]
        ref = winding_f64(qq, *tt)
        ep = (winding_plain(qq, *tt).double() - ref).abs()
        note = (f"; plain version {float(ep.max()):.3e}, a whole turn off at "
                f"{int((ep > 0.5).sum())} queries (no limit)")
        if baseline:
            eb = (winding_base(qq, *tt).double() - ref).abs()
            note += (f"; baseline {float(eb.max()):.3e}, a whole turn off at "
                     f"{int((eb > 0.5).sum())} queries (no limit)")
        check(f"W1 winding {qq.shape[0]} queries within f32 rounding of the planes of {name} "
              "against float64", float((winding(qq, *tt).double() - ref).abs().max()), W1_ATOL,
              note=note)


def scoring_phase(check, results, tmp: str, mesh, gt) -> None:
    """Score the 50NN mesh against the analytic ground truth with the
    metrics `predict` writes (launch counts reset before and read after);
    then the ground truth meshed at res 129, which must reach IoU and F1
    of 0.99; then the ground truth against itself: Chamfer 0, IoU 1, F1 1
    exactly, normal error under 0.05 rad."""
    import numpy as np
    import torch

    from ppsurf_tpu_torch.metrics.mesh_metrics import get_metric_mesh_single_file
    from ppsurf_tpu_torch.ops import kernels

    gt_file = os.path.join(tmp, "gt.ply")
    gt.export(gt_file)
    for label, scored in (("50NN mesh", mesh), ("ground truth at res 129", torus_gt_mesh(129)),
                          ("ground truth", gt)):
        file_in = os.path.join(tmp, "scored.ply")
        scored.export(file_in)
        kernels.reset_launches()
        got, secs = {}, {}
        for metric in ("chamfer", "iou", "f1", "normals"):
            t0 = time.perf_counter()
            got[metric] = get_metric_mesh_single_file(gt_file, file_in, SCORE_SAMPLES, metric,
                                                      device="cuda")
            torch.cuda.synchronize()
            secs[metric] = time.perf_counter() - t0
        launches = kernels.LAUNCHES["winding"]
        print(f"# scoring the {label} ({scored.faces.shape[0]} faces) against the ground truth "
              f"({gt.faces.shape[0]} faces), {SCORE_SAMPLES} samples: "
              + ", ".join(f"{k} {v!r} in {secs[k]:.3f} s" for k, v in got.items())
              + f"; {sum(secs.values()):.3f} s in all; W1 launches {launches}", flush=True)
        if not all(np.isfinite(v) for v in got.values()) or launches != 4:
            fail(f"scoring the {label}: {got}, W1 launches {launches} (4 expected)")
        if label == "50NN mesh":
            results["winding"]["launches"] = launches
        elif label == "ground truth at res 129":
            check("the ground truth at res 129 against res 257 (1 - min(IoU, F1))",
                  1.0 - min(got["iou"], got["f1"]), 0.01)
        else:
            same = (got["chamfer"] == 0.0 and got["iou"] == 1.0 and got["f1"] == 1.0
                    and got["normals"] < 0.05)
            check("the ground truth against itself (Chamfer 0, IoU 1, F1 1 exactly, normal "
                  "error < 0.05 rad; 1 where one fails)", float(not same), 0.0)


# the campaign phase: training solids added to phase 11's dataset, the mini
# run cut in length only (configs/ppsurf_mini.yaml at full width, res 129)
CAMPAIGN_SHAPES = {"trainset": 10, "valset": 1}
CAMPAIGN_EPOCHS = 2
COMPARISON_TABLES = ("chamfer_distance", "iou", "normal_error", "f1")


def write_campaign_dataset(root: str, names, seed: int = 5) -> str:
    """Phase 11's dataset (`root/tiny`: the test shapes' clouds and ground
    truth) made a training set in the reference layout: seeded solids of
    phase 12 for `trainset.txt` and `valset.txt`, and 2 000 queries in
    [-0.5, 0.5]^3 with their exact signed distances for each test shape
    (`torus_sdf`); returns its test set's path."""
    import numpy as np

    from ppsurf_tpu_torch.io.ply import save_ply

    rng = np.random.RandomState(seed)
    ds = os.path.join(root, "tiny")
    for d in ("05_query_pts", "05_query_dist"):
        os.makedirs(os.path.join(ds, d), exist_ok=True)

    def queries_of(name, queries, dist):
        np.save(os.path.join(ds, "05_query_pts", name + ".ply.npy"), queries)
        np.save(os.path.join(ds, "05_query_dist", name + ".ply.npy"), dist.astype(np.float32))

    kinds, i = ("sphere", "torus", "ellipsoid"), 0
    for split, count in CAMPAIGN_SHAPES.items():
        split_names = []
        for _ in range(count):
            name = f"{kinds[i % 3]}_{i:02d}"
            queries = (rng.rand(TRAIN_QUERIES, 3) - 0.5).astype(np.float32)
            surf, dist = solid(kinds[i % 3], rng, int(rng.randint(20000, 60001)), queries)
            save_ply(os.path.join(ds, "04_pts_vis", name + ".xyz.ply"), surf)
            queries_of(name, queries, dist)
            split_names.append(name)
            i += 1
        with open(os.path.join(ds, f"{split}.txt"), "w") as fp:
            fp.write("\n".join(split_names) + "\n")
    for name in names:
        queries = (rng.rand(TRAIN_QUERIES, 3) - 0.5).astype(np.float32)
        queries_of(name, queries, torus_sdf(*queries.T.astype(np.float64)))
    return os.path.join(ds, "testset.txt")


def campaign_phase(root: str, names) -> None:
    """Phase 14: `python -m ppsurf_tpu_torch.campaigns.full_run_pps_mini`
    (fit, test, predict through `cli.main`, here in this process) on phase
    11's dataset with training solids added, cut to CAMPAIGN_EPOCHS epochs;
    then `python -m ppsurf_tpu_torch.eval.make_comparison --render` over its
    results and phase 11's committed-weights 50NN results, and
    `figures.comp_base.merge_comps`. Every kernel's launch count is reset
    before each part and read after: K1 must launch in fit, K1 and K3-K5 in
    predict, W1 4 times a mesh scored."""
    import numpy as np
    import torch

    from ppsurf_tpu_torch.campaigns import full_run_pps_mini
    from ppsurf_tpu_torch.eval import make_comparison
    from ppsurf_tpu_torch.figures.comp_base import merge_comps
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.utils.png import read_png

    in_file = write_campaign_dataset(root, names)
    results, comp = os.path.join(root, "results"), os.path.join(root, "comp")
    parts = {}
    cli_main = full_run_pps_mini.main

    def counted(argv):
        kernels.reset_launches()
        t = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        parts[argv[0]] = (dict(kernels.LAUNCHES), time.perf_counter() - t, rc)
        return rc

    cwd = os.getcwd()
    os.chdir(HERE)  # the twin's config paths are relative to the checkout
    full_run_pps_mini.main = counted
    try:
        full_run_pps_mini.run([
            "--data.init_args.in_file", in_file,
            "--trainer.max_epochs", str(CAMPAIGN_EPOCHS),
            "--trainer.default_root_dir", os.path.join(root, "models", "ppsurf_mini"),
            "--model.init_args.results_dir", results])
    finally:
        full_run_pps_mini.main = cli_main
        os.chdir(cwd)
    rdir = os.path.join(results, "ppsurf_mini", "tiny")
    meshes = {n: os.path.isfile(os.path.join(rdir, "meshes", f"{n}.xyz.ply")) for n in names}
    for part, (launch, secs, rc) in parts.items():
        print(f"# campaign {part}: rc {rc}, {secs:.2f} s; launches "
              f"{json.dumps({k: v for k, v in launch.items() if v})}", flush=True)
    ckpt = os.path.join(root, "models", "ppsurf_mini", "version_0", "checkpoints", "last.pt")
    want = [ckpt, os.path.join(rdir, "metrics_ppsurf_mini.csv")]
    want += [os.path.join(rdir, f"{t}.csv") for t in SCORE_TABLES]
    missing = [w for w in want if not os.path.isfile(w)]
    print(f"# campaign: meshes {meshes} (a few-epoch model may print 'No reconstruction'); "
          f"missing outputs {missing}", flush=True)
    if sorted(parts) != ["fit", "predict", "test"] or missing:
        fail(f"the campaign ran {sorted(parts)} and did not write {missing}")
    fit_l, pred_l = parts["fit"][0], parts["predict"][0]
    if not fit_l["knn"] or any(pred_l[k] == 0 for k in ("knn", "decoder_tail", "pointnet_trunk",
                                                         "pointnet_head")):
        fail(f"the campaign did not run on its kernels: fit {fit_l}, predict {pred_l}")
    if pred_l["winding"] != 4 * sum(meshes.values()):
        fail(f"W1 launched {pred_l['winding']} times for {sum(meshes.values())} scored meshes")

    kernels.reset_launches()
    t = time.perf_counter()
    rc = make_comparison.main(["--data_dir", root, "--results_dir", results,
                               "--dataset_names", "tiny", "--comp_dir", comp, "--render"])
    merged = merge_comps("campaign", ["tiny"], comp)
    secs = time.perf_counter() - t
    methods = ("ppsurf_50nn", "ppsurf_mini")
    has_mesh = {("ppsurf_50nn", n): True for n in names}
    has_mesh.update({("ppsurf_mini", n): m for n, m in meshes.items()})
    print(f"# make_comparison --render, methods {methods}: rc {rc}, {secs:.2f} s (with "
          f"merge_comps); launches {sum(kernels.LAUNCHES.values())}", flush=True)
    problems = [] if rc == 0 else [f"rc {rc}"]
    cdir = os.path.join(comp, "tiny")
    for table in COMPARISON_TABLES:
        with open(os.path.join(cdir, f"{table}.csv")) as fp:
            rows = [line.rstrip("\n").split(",") for line in fp]
        if rows[0][1:] != list(methods) or [r[0] for r in rows[1:3]] != list(names):
            problems.append(f"{table}.csv laid out as {rows[:3]}")
            continue
        for r in rows[1:3]:
            for m, cell in zip(methods, r[1:]):
                if (cell != "") != has_mesh[(m, r[0])] or (cell and not np.isfinite(float(cell))):
                    problems.append(f"{table}.csv {m} {r[0]}: {cell!r}")
    with open(os.path.join(cdir, "comp_mean.csv")) as fp:
        mean = {r[0]: r[1:] for r in (line.rstrip("\n").split(",") for line in fp)}
    print(f"# comp_mean: {mean}", flush=True)
    if not all(c and np.isfinite(float(c)) for c in mean.get("ppsurf_50nn", [""])[:3]):
        problems.append(f"comp_mean's ppsurf_50nn row {mean.get('ppsurf_50nn')}")
    if not any(meshes.values()) and any(mean.get("ppsurf_mini", ["x"])[:3]):
        problems.append(f"comp_mean's ppsurf_mini row without meshes {mean.get('ppsurf_mini')}")
    pngs = [os.path.join(cdir, "renders", kind, f"{n}.png") for kind in ("gt", "pc") for n in names]
    for m in methods:
        for n in names:
            if has_mesh[(m, n)]:
                base = os.path.join(results, m, "tiny")
                for f in (os.path.join(base, "cd_vis", f"{n}.xyz.ply"),
                          os.path.join(base, "cd_vis", f"{n}.xyz.npz")):
                    if not os.path.isfile(f):
                        problems.append(f"no {os.path.relpath(f, root)}")
                pngs.append(os.path.join(base, "cd_vis_renders", f"{n}.png"))
    for png in pngs:
        try:
            img = read_png(png)
        except (OSError, ValueError) as exc:
            problems.append(f"{os.path.relpath(png, root)}: {exc}")
            continue
        if img.shape != (1024, 1024, 3) or not (img != 255).any():
            problems.append(f"{os.path.relpath(png, root)}: {img.shape}, "
                            f"{int((img != 255).any(axis=2).sum())} pixels drawn")
    with open(os.path.join(comp, "reports", "comp_all_tiny.html")) as fp:
        html = fp.read()
    absent = [w for w in [n.replace("_", " ") for n in names]
              + [m.replace("_", " ") for m in methods] if w not in html]
    if absent:
        problems.append(f"the HTML report does not name {absent}")
    for f in (merged, merged and merged[:-4] + ".tex"):
        if not f or not os.path.isfile(f) or not all(m in open(f).read() for m in methods):
            problems.append(f"merge_comps wrote {f}")
    print(f"# make_comparison: {len(pngs)} PNGs checked (signature, IHDR, 1024 x 1024, "
          f"drawn); problems {problems}", flush=True)
    if problems or sum(kernels.LAUNCHES.values()):
        fail(f"make_comparison: {problems}, launches {dict(kernels.LAUNCHES)}")


# the data-parallel phases (15-19) on phase 12's solids: a one-rank NCCL
# group, two gloo ranks sharing the card, the sharded field, the profiler
# preset and POCO training
POCO_K1_PER_CLOUD = 14  # graph 9 x k=16 + 4 x k=1, decoder ids k=64


def _flat_state(net) -> dict:
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def dp_one_rank_phase(tmp: str, smi: str) -> None:
    """Phase 15: `Trainer.fit` (one epoch: 2 steps at batch 10 and a
    validation batch, PPSurf 50NN at full width, bf16) without a process
    group, in a one-rank NCCL group that `maybe_init_distributed` makes
    from torchrun's environment, and without a group again, from the same
    seeds, under torch's deterministic algorithms: the losses, parameters
    and buffers of the group run must equal the others bit for bit (at
    world size 1 the mean is the identity), K1 15 times a cloud."""
    import torch
    import torch.distributed as dist

    from ppsurf_tpu_torch.data.datasets import OccupancyDataModule
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.parallel.mesh import free_port, maybe_init_distributed
    from ppsurf_tpu_torch.train import loop
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    testset = os.path.join(tmp, "train_ds", "testset.txt")
    spec = ppsurf_spec(dtype=torch.bfloat16)

    def fit(name):
        cfg = loop.TrainConfig(max_epochs=1, batch_size=10,
                               default_root_dir=os.path.join(tmp, "dp1", name))
        dm = OccupancyDataModule(testset, batch_size=10, manifold_points=10000, seed=42)
        kernels.reset_launches()
        t0 = time.perf_counter()
        trainer = loop.Trainer(spec, cfg, device="cuda")
        state = trainer.fit(dm)
        torch.cuda.synchronize()
        return dict(losses=[v for _, v in trainer.history], state=_flat_state(state.net),
                    knn=kernels.LAUNCHES["knn"], seconds=time.perf_counter() - t0,
                    ranks=trainer.mesh.size, distributed=trainer.mesh.distributed)

    env_keys = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "CUBLAS_WORKSPACE_CONFIG")
    saved = {k: os.environ.get(k) for k in env_keys}
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {"plain": fit("plain")}
        os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(free_port()))
        if not maybe_init_distributed("nccl"):
            fail("maybe_init_distributed did not join a group from torchrun's environment")
        backend = dist.get_backend()
        try:
            runs["nccl"] = fit("nccl")
        finally:
            dist.destroy_process_group()
        runs["plain_again"] = fit("plain_again")
    finally:
        torch.use_deterministic_algorithms(False)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    want_knn = K1_PER_CLOUD * (2 * 10 + 2 * TRAIN_SHAPES["valset"])
    plain, group, again = runs["plain"], runs["nccl"], runs["plain_again"]

    def same(a, b):
        return a["losses"] == b["losses"] and all(
            torch.equal(a["state"][k], b["state"][k]) for k in a["state"])

    print(f"# dp1: Trainer.fit, 1 epoch (2 steps, batch 10, ppsurf_50nn bf16): backend "
          f"{backend}, {group['ranks']} rank, reduced {group['distributed']}; losses "
          f"{group['losses']} vs {plain['losses']} without a group; parameters and buffers "
          f"bit-identical to the run without a group {same(group, plain)}, the two runs "
          f"without a group to each other {same(plain, again)}; K1 {group['knn']} launches "
          f"(expected {want_knn}); {group['seconds']:.2f} s in the group, "
          f"{plain['seconds']:.2f} / {again['seconds']:.2f} s without; {smi}", flush=True)
    if backend != "nccl" or not group["distributed"] or group["ranks"] != 1:
        fail(f"the one-rank phase did not train in an NCCL group: {backend}")
    if not same(plain, again):
        fail("two runs without a group differ: the training step is not deterministic here")
    if not same(group, plain):
        fail("the one-rank NCCL run differs from the run without a group")
    if any(r["knn"] != want_knn for r in runs.values()):
        fail(f"K1 launches {[r['knn'] for r in runs.values()]}, expected {want_knn} a run")


def dp_two_ranks_phase(tmp: str, smi: str) -> None:
    """Phase 16: two gloo ranks on the one card (`tools/dryrun_multihost.py`
    processes; NCCL refuses two ranks on one GPU), each building the
    kernels at first use into one empty build directory, one step each of
    PPSurf 50NN at full width (bf16) on a global batch of 10 of phase 12's
    solids, 5 a rank, with sync_batch_stats False and True: parameters
    bit-identical on both ranks; the all-reduced gradients against the
    mean of each rank's gradients of its half without the group (same
    draws and dropout), within phase 12's limits (relative L2 1e-2, worst
    leaf 0.25); the buffers rank 0's (or the ranks' mean) within 1e-4 of a
    leaf's largest value; K1 15 times a cloud on each rank; one library in
    the build directory. Step time and peak memory per rank are printed;
    both ranks share the card, so they are no scaling figure."""
    import numpy as np
    import torch

    from ppsurf_tpu_torch.convert.init import init_variables
    from ppsurf_tpu_torch.data.datasets import OccupancyDataModule
    from ppsurf_tpu_torch.tools.dryrun_multihost import run_job
    from ppsurf_tpu_torch.train import loop
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    testset = os.path.join(tmp, "train_ds", "testset.txt")
    dm = OccupancyDataModule(testset, batch_size=10, manifold_points=10000, seed=3)
    batch_np = next(iter(dm.epoch_batches(dm.train_dataset(), np.random.RandomState(0), True)))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch_np.items()
             if k in loop.BATCH_KEYS}
    variables = init_variables(ppsurf_spec(), seed=0)

    def tensors(tree):
        return {k: tensors(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
                for k, v in tree.items()}

    case = {"spec": {"kind": "ppsurf"}, "dtype": "bfloat16", "seed": 11,
            "variables": tensors(variables), "batch": batch}
    build_dir = os.path.join(tmp, "dp2_build")
    job = {"device": "cuda", "build_dir": build_dir,
           "cases": [dict(case, name="sync0", sync_batch_stats=False),
                     dict(case, name="sync1", sync_batch_stats=True)]}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = run_job(job, 2, os.path.join(tmp, "dp2_ranks"), backend="gloo", timeout=600)
    secs = time.perf_counter() - t0
    built = sorted(os.listdir(build_dir))
    libs = {r["lib_path"] for r in results}
    print(f"# dp2: two gloo ranks on one card, {secs:.1f} s with the build: each rank built "
          f"at first use in {[round(r['build_seconds'], 1) for r in results]} s into "
          f"{os.path.relpath(build_dir, tmp)}: {built} "
          f"{sorted(os.listdir(os.path.join(build_dir, built[0]))) if built else []}; one "
          f"library {len(libs) == 1}", flush=True)
    if len(built) != 1 or len(libs) != 1 or sorted(os.listdir(
            os.path.join(build_dir, built[0]))) != ["build.log", "libppsurf_kernels.so"]:
        fail(f"the two ranks' first builds did not leave one library: {built} {libs}")
    bad = []
    for ci, name in enumerate(("sync0", "sync1")):
        r0, r1 = (r["cases"][ci] for r in results)
        same_p = all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
        same_b = all(torch.equal(r0["buffers"][k], r1["buffers"][k]) for k in r0["buffers"])
        mean = {k: (r0["local_grads"][k] + r1["local_grads"][k]) / 2 for k in r0["grads"]}
        g_all, g_leaf, g_name = grad_diff(r0["grads"], mean)
        want_b = r0["local_buffers"] if name == "sync0" else {
            k: (r0["local_buffers"][k] + r1["local_buffers"][k]) / 2 for k in r0["buffers"]}
        b_err = max(float((r0["buffers"][k] - want_b[k]).abs().max()
                          / (want_b[k].abs().max() + 1e-12)) for k in want_b)
        knn = [r["launches"].get("knn", 0) for r in (r0, r1)]
        print(f"# dp2 {name}: loss {r0['loss']:.6f} on both ranks {r0['loss'] == r1['loss']}; "
              f"parameters bit-identical {same_p}, buffers {same_b}; all-reduced gradients "
              f"against the mean of the ranks' own: rel L2 {g_all:.2e} (limit 1e-2), worst "
              f"leaf {g_leaf:.2e} {g_name} (limit 0.25); buffers against "
              f"{'rank 0' if name == 'sync0' else 'the mean'}: {b_err:.2e} of a leaf's max "
              f"(limit 1e-4); K1 launches a rank {knn} (expected {K1_PER_CLOUD * 5} each)",
              flush=True)
        for res, r in zip(results, (r0, r1)):
            print(f"# dp2 {name} rank {res['rank']}: step {r['step_ms']:.1f} ms (host clock, "
                  f"synchronised; both ranks share the card), peak memory "
                  f"{r['peak_gib']:.2f} GiB; {smi}", flush=True)
        if not (same_p and same_b and r0["loss"] == r1["loss"]) or g_all > 1e-2 \
                or g_leaf > 0.25 or b_err > 1e-4 or knn != [K1_PER_CLOUD * 5] * 2:
            bad.append(name)
    if bad:
        fail(f"the two-rank step disagrees: {bad}")


def sharded_field_phase(predictor, variables, cloud, smi: str) -> None:
    """Phase 17: `FieldEvaluator` with the card listed twice (two replicas,
    dispatched from one thread) on phase 4's cloud, 50NN bf16, over 4 full
    chunks and a tail: the values must equal the single-device field bit
    for bit, K1 and K3-K5 launch once a chunk; `Predictor(devices=2)`
    clamps to the one card."""
    import numpy as np
    import torch

    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.recon.field import FieldEvaluator
    from ppsurf_tpu_torch.recon.predict import Predictor

    dev = torch.device("cuda", torch.cuda.current_device())
    spec = predictor.spec
    with torch.inference_mode():
        latents = predictor.encoder(torch.from_numpy(cloud).to(dev),
                                    generator=torch.Generator(device=dev).manual_seed(0))
    m = 4 * N_QUERIES + 1234
    queries = (np.random.RandomState(17).rand(m, 3) - 0.5).astype(np.float32)
    single = FieldEvaluator(predictor.net, spec, cloud, latents)
    sharded = FieldEvaluator(predictor.net, spec, cloud, latents, devices=[dev, dev])
    chunks = -(-m // sharded.chunk)
    times = {}
    for name, ev in (("single", single), ("sharded", sharded), ("single", single),
                     ("sharded", sharded)):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = ev(queries)
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        if name == "sharded":
            launches = dict(kernels.LAUNCHES)
            out_sharded = vals
        else:
            out_single = vals
    clamp = Predictor(spec, variables=variables, device="cuda", verbose=False, devices=2)
    same = np.array_equal(out_sharded, out_single)
    print(f"# sharded field: {m} queries ({chunks} chunks of {sharded.chunk}, the last "
          f"{m - (chunks - 1) * sharded.chunk}) on 2 replicas of the card: equal to one device "
          f"bit for bit {same} (max |diff| {float(np.abs(out_sharded - out_single).max()):.3g});"
          f" launches {json.dumps({k: v for k, v in launches.items() if v})}; seconds sharded "
          f"{[round(t, 3) for t in times['sharded']]}, single {[round(t, 3) for t in times['single']]}"
          f"; Predictor(devices=2) on {torch.cuda.device_count()} card(s): devices "
          f"{clamp.devices}; {smi}", flush=True)
    if not same:
        fail("the sharded field differs from the single-device field")
    if any(launches[k] != chunks for k in ("knn", "decoder_tail", "pointnet_trunk",
                                            "pointnet_head")):
        fail(f"the sharded field did not launch K1 and K3-K5 once a chunk: {launches}")
    if torch.cuda.device_count() == 1 and clamp.devices is not None:
        fail(f"Predictor(devices=2) did not clamp to the one card: {clamp.devices}")


def profiler_phase(tmp: str, smi: str) -> None:
    """Phase 18: `cli fit` with `configs/profiler.yaml` stacked (the
    preset `trainer.profiler: jax`), 5 steps at batch 4: the Chrome trace
    of steps 2-4 must exist, hold those three step spans and name K1's
    kernel."""
    import torch

    from ppsurf_tpu_torch import cli
    from ppsurf_tpu_torch.ops import kernels

    configs = [a for c in ("poco", "ppsurf", "ppsurf_50nn", "profiler")
               for a in ("-c", os.path.join(HERE, "configs", f"{c}.yaml"))]
    root = os.path.join(tmp, "models_profiler")
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["fit", *configs, "--data.init_args.in_file",
                   os.path.join(tmp, "train_ds", "testset.txt"),
                   "--data.init_args.batch_size", "4", "--trainer.max_epochs", "1",
                   "--trainer.default_root_dir", root])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    knn = kernels.LAUNCHES["knn"]
    trace = os.path.join(root, "version_0", "profile", "trace_rank0.json")
    events = []
    if os.path.isfile(trace):
        with open(trace) as fp:
            events = json.load(fp).get("traceEvents", [])
    steps = sorted({e["name"] for e in events if str(e.get("name", "")).startswith("train_step ")})
    gpu = [e for e in events if e.get("cat") == "kernel"]
    knn_events = [e for e in gpu if "knn_kernel" in e.get("name", "")]
    n_val = TRAIN_SHAPES["valset"]
    want = K1_PER_CLOUD * (5 * 4 + n_val + min(n_val, -n_val % 4))
    print(f"# profiler: cli fit with configs/profiler.yaml, 5 steps at batch 4: rc {rc}, "
          f"{secs:.2f} s; {os.path.relpath(trace, tmp)} "
          f"{os.path.getsize(trace) / 2 ** 20 if os.path.isfile(trace) else 0:.1f} MiB: step "
          f"spans {steps}, {len(gpu)} kernel events, {len(knn_events)} of K1 "
          f"({knn_events[0]['name'] if knn_events else None}); K1 launches {knn} (expected "
          f"{want}); {smi}", flush=True)
    if rc != 0 or steps != ["train_step 2", "train_step 3", "train_step 4"] \
            or not knn_events or knn != want:
        fail("the profiler preset did not trace steps 2-4 with K1's kernel in them")


def poco_training_phase(tmp: str, smi: str) -> None:
    """Phase 19: `cli fit` with `configs/poco.yaml` at full width (latent
    32, k=64, batch 10, bf16) for 2 epochs on phase 12's solids: every
    loss finite, `last.pt` written, K1 14 times a cloud; the median step
    time (host clock around each synchronised step) and peak memory."""
    import numpy as np
    import torch

    from ppsurf_tpu_torch import cli
    from ppsurf_tpu_torch.convert.checkpoint import load_checkpoint
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.train import loop

    root = os.path.join(tmp, "models_poco")
    trainers, step_ms = [], []
    fit, step = loop.Trainer.fit, loop.train_step

    def capture_fit(self, *a, **kw):
        trainers.append(self)
        return fit(self, *a, **kw)

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    loop.Trainer.fit, loop.train_step = capture_fit, timed_step
    kernels.reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["fit", "-c", os.path.join(HERE, "configs", "poco.yaml"),
                       "--data.init_args.in_file", os.path.join(tmp, "train_ds", "testset.txt"),
                       "--trainer.default_root_dir", root, "--trainer.max_epochs", "2"])
    finally:
        loop.Trainer.fit, loop.train_step = fit, step
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    history = trainers[0].history if trainers else []
    losses = [v for _, v in history]
    ckpt = os.path.join(root, "version_0", "checkpoints", "last.pt")
    n_val = TRAIN_SHAPES["valset"]
    want = POCO_K1_PER_CLOUD * (4 * 10 + 2 * (n_val + min(n_val, -n_val % 10)))
    knn = kernels.LAUNCHES["knn"]
    print(f"# poco train: cli fit (poco, latent 32, k=64, bf16, batch 10, 10000 pts, "
          f"{TRAIN_QUERIES} queries, 2 epochs) rc {rc}, {secs:.2f} s; steps "
          f"{[s for s, _ in history]}, losses {[round(v, 4) for v in losses]}; K1 {knn} launches "
          f"(expected {want}); step median {statistics.median(step_ms):.1f} ms (min "
          f"{min(step_ms):.1f}, max {max(step_ms):.1f}, {len(step_ms)} steps); peak memory "
          f"{peak:.2f} GiB; {smi}", flush=True)
    if rc != 0 or [s for s, _ in history] != [1, 2, 3, 4] or not np.isfinite(losses).all():
        fail(f"POCO training did not take 4 finite steps: rc {rc}, {history}")
    if not os.path.isfile(ckpt) or load_checkpoint(ckpt)["step"] != 4:
        fail(f"POCO training did not write {ckpt}")
    if knn != want:
        fail(f"POCO training launched K1 {knn} times, expected {want}")


# phase 20: the port's bench.py twin as its own process, then the grower's
# speculative prefill on phase 4's 50NN bf16 field
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline")
PREFILL = dict(prefill_radius=4, prefill_start=2)


def bench_twin_phase(args) -> None:
    """`python3 bench_torch.py --reps 3` (with the smoke's resolution,
    passes and refine where they differ from the defaults): exit 0, a last
    line of `bench.py`'s four keys with a finite positive value, and K1
    (k=64 and kc=192), K2 and K3-K5 in the detail line's launches of one
    pass."""
    import torch

    cmd = [sys.executable, "bench_torch.py", "--reps", "3"]
    for flag, value, default in (("--resolution", args.resolution, 257),
                                 ("--passes", args.passes, 10), ("--refine", args.refine, 10)):
        if value != default:
            cmd += [flag, str(value)]
    torch.cuda.empty_cache()  # the card's memory to the twin's process
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith("# "):
            print(f"# bench_torch: {line[2:]}", flush=True)
    out = proc.stdout.strip().splitlines()
    print(f"# bench_torch: {' '.join(cmd[1:])}: exit {proc.returncode} in {secs:.1f} s; last "
          f"line {out[-1] if out else None}", flush=True)
    if proc.returncode != 0 or not out:
        fail(f"bench_torch.py failed: {proc.stderr[-2000:]}")
    result = json.loads(out[-1])
    want = f"ppsurf50nn_e2e_reconstruction_res{args.resolution}"
    if (tuple(result) != BENCH_KEYS or result["metric"] != want
            or not (isinstance(result["value"], float) and 0 < result["value"] < float("inf"))):
        fail(f"bench_torch.py's last line is not {BENCH_KEYS} with {want} and a finite "
             f"positive value: {result}")
    detail = [json.loads(line[len("# detail: "):]) for line in proc.stderr.splitlines()
              if line.startswith("# detail: ")]
    missing = [k for k in PATH_KERNELS if not detail or not detail[-1]["launches"].get(k)]
    if missing:
        fail(f"bench_torch.py's pass did not launch {missing}")


def prefill_phase(args, predictor, cloud) -> None:
    """The grower on phase 4's field (`predictor`'s network, its encoding
    with seed 0), without the prefill `PREFILL` and with it, in turns (off,
    on, on, off): the same volume bit for bit (NaN pattern and values), at
    least one band, no more field calls; then `reconstruct_mesh` with
    prefill radius 0 and 4: the same mesh. A volume that differs means the
    field gives a query other bits in another batch (`FieldEvaluator`'s
    `fixed_rows` is there to prevent it); last, 120 000 queries in one
    call and in odd batches: the same bits (and, printed only, how many
    differ with `fixed_rows` off)."""
    import numpy as np
    import torch

    from ppsurf_tpu_torch.recon.engine import create_volume_region_growing, reconstruct_mesh
    from ppsurf_tpu_torch.recon.field import FieldEvaluator

    with torch.inference_mode():
        gen = torch.Generator(device=predictor.device).manual_seed(0)
        latents = predictor.encoder(torch.from_numpy(cloud).to(predictor.device), generator=gen)
        ev = FieldEvaluator(predictor.net, predictor.spec, cloud, latents)
        runs, grow_s = {}, {"off": [], "on": []}
        for name in ("off", "on", "on", "off"):
            kw = PREFILL if name == "on" else {}
            calls, stats = [], {}

            def field(q, calls=calls):
                calls.append(q.shape[0])
                return ev(q)

            with chunks_and_dtypes() as seen:
                t0 = time.perf_counter()
                vol = create_volume_region_growing(field, cloud, args.resolution, stats=stats,
                                                   **kw)[0]
                grow_s[name].append(time.perf_counter() - t0)
            if name in runs:
                if not np.array_equal(vol, runs[name]["vol"], equal_nan=True):
                    fail(f"two grows with prefill {name} gave other volumes")
                continue
            runs[name] = dict(vol=vol, calls=len(calls), **stats)
            print(f"# prefill {name} {kw}: {stats['rounds']} rounds, {len(calls)} field calls "
                  f"({seen['chunks']} chunks, {sum(calls)} queries), "
                  f"{stats['prefill_bands']} bands of {stats['prefill_voxels']} voxels",
                  flush=True)
        print("# prefill grow seconds in turns (off, on, on, off): off "
              + ", ".join(f"{t:.3f}" for t in grow_s["off"]) + "; on "
              + ", ".join(f"{t:.3f}" for t in grow_s["on"]), flush=True)
        a, b = runs["off"]["vol"], runs["on"]["vol"]
        same_nan = np.array_equal(np.isnan(a), np.isnan(b))
        both = ~np.isnan(a) & ~np.isnan(b)
        differ = int((a[both] != b[both]).sum())
        print(f"# prefill volumes: NaN patterns equal {same_nan}, {differ} of {int(both.sum())} "
              f"voxels differ (max |difference| "
              f"{float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0:.3e})", flush=True)
        if not same_nan or differ:
            fail("the prefill changed the volume: the field gives a query other bits in "
                 "another batch")
        if runs["on"]["prefill_bands"] < 1 or runs["on"]["calls"] > runs["off"]["calls"]:
            fail(f"the prefill fired {runs['on']['prefill_bands']} bands and took "
                 f"{runs['on']['calls']} field calls ({runs['off']['calls']} without)")
        meshes = {}
        for radius in (0, 4):
            t0 = time.perf_counter()
            meshes[radius] = reconstruct_mesh(ev, cloud, args.resolution,
                                              refine_iter=predictor.spec.gen_refine_iter,
                                              refine_device=ev.refine_bisection,
                                              prefill_radius=radius)
            print(f"# reconstruct_mesh prefill_radius={radius}: {time.perf_counter() - t0:.3f} s, "
                  f"{meshes[radius].vertices.shape[0]} vertices {meshes[radius].faces.shape[0]} "
                  "faces", flush=True)
        if not (np.array_equal(meshes[0].faces, meshes[4].faces)
                and np.array_equal(meshes[0].vertices, meshes[4].vertices)):
            fail("the prefill changed the mesh")

        # the premise: a query's value does not depend on the call that
        # holds it; without `fixed_rows` (printed, not a limit) it does
        rng = np.random.RandomState(3)
        q = cloud[rng.randint(0, cloud.shape[0], 120000)] + rng.randn(120000, 3) * 0.01
        q = q.astype(np.float32)
        for rows in (None, ev.fixed_rows):
            ev.fixed_rows = rows
            whole = ev(q)
            for sizes in ((7, 1000, 50049), (37, 129, 4096, 20000), (1, 1, 1, 300)):
                bounds = np.cumsum((0,) + sizes)
                split = np.concatenate([ev(q[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
                                       + [ev(q[bounds[-1]:])])
                differ = int((split != whole).sum())
                print(f"# field of {q.shape[0]} queries in one call and in calls of {sizes} and "
                      f"the rest, fixed_rows {rows}: {differ} values differ (max |difference| "
                      f"{float(np.abs(split - whole).max()):.3e})", flush=True)
                if rows is not None and differ:
                    fail("the field gives a query other bits in another batch")


# phase 21: the engine's mesh and clean phases on the card (`ops/mesh.py`,
# `csrc/mesh.cu`) against the host route
MESH_ROUNDS = 3
MESH_CUDA_KERNELS = ("classify_kernel", "edges_kernel", "vertices_kernel", "faces_kernel",
                     "round_keys_kernel", "runs_kernel", "groups_kernel", "face_keys_kernel",
                     "dedup_kernel", "edge_keys_kernel", "union_kernel", "roots_kernel",
                     "keep_kernel", "compact_faces_kernel", "compact_vertices_kernel")
# the C entries' launches an object: extraction once, a cleanup in each phase
MESH_LAUNCHES = {"mesh_classify": 1, "mesh_edges": 1, "mesh_emit": 1, "mesh_round_keys": 2,
                 "mesh_runs": 2, "mesh_groups": 2, "mesh_face_keys": 2, "mesh_dedup": 2,
                 "mesh_components": 2, "mesh_compact": 2}


def kernel_name(key: str) -> str:
    """A profiler event's function name: `(anonymous namespace)::f(args)`
    and `f(args)` give `f`."""
    m = re.search(r"(?:^|::)(\w+)\(", key)
    return m.group(1) if m else key


def mesh_kernel_bytes(points: int, raw_v: int, raw_f: int, v: int, f: int) -> int:
    """The bytes the meshing kernels of one object read and write, each
    array once a kernel: the grid passes (classify 8 + 1 + 4, edges
    8 + 4 + 1 + 4, the emitters 1 + 4 a point), the emitters' rows (a
    vertex 8 + 16 + 12, a face 1 + 8 + 3 x (1 + 8 + 8 + 8)), and a cleanup
    of n vertices and m faces (round keys 36, runs 36, groups 32 a vertex,
    the leaders' copy 40; face keys 80, dedup 17, edge keys 49, union 52,
    roots 13, keep 49, compaction 68 a face) of the raw mesh (raw_v, raw_f)
    in the mesh phase and of the mesh it leaves (v, f) in the clean phase."""
    def cleanup(n: int, m: int) -> int:
        return 144 * n + 328 * m

    return 35 * points + 36 * raw_v + 84 * raw_f + cleanup(raw_v, raw_f) + cleanup(v, f)


def mesh_phase(args, smi: str) -> dict:
    """The grown volume of the exact torus-and-sphere distance around
    phase 4's cloud at the smoke's resolution, and its mesh refined on the
    host (10 bisections of the same field): the card route's `mesh` phase
    (the volume's copy, extraction, merge, dedup, small components, the
    mesh back to the host) and `clean` phase (the refined vertices up, the
    cleaned mesh back) against the host route's, in turns (host, card,
    card, host; `MESH_ROUNDS` rounds): the same meshes bit for bit; each
    route's median host-clock seconds a phase; the kernels' device
    milliseconds an object (torch.profiler: the hand kernels, and the
    sorts and scans between them); the plain versions' seconds on CPU
    tensors (the same meshes); the volume's pageable copy rate and time;
    the kernels' bound (`mesh_kernel_bytes` at 3.35 TB/s). Returns the
    kernel table's row; phase 4 adds the launches an object."""
    import numpy as np
    import torch

    from ppsurf_tpu_torch.io.ply import Mesh
    from ppsurf_tpu_torch.recon import engine
    from ppsurf_tpu_torch.recon.marching_cubes import marching_cubes
    from ppsurf_tpu_torch.recon.mesh_ops import clean_simple, remove_small_connected_components
    from ppsurf_tpu_torch.utils.spans import span

    dev = torch.device("cuda")

    def field(q):
        return torus_sdf(*(q[:, i].astype(np.float64) for i in range(3))).astype(np.float32)

    cloud = torus_cloud(N_POINTS, seed=0)
    volume, step, bmin_pad = engine.create_volume_region_growing(field, cloud, args.resolution)

    def host_mesh():
        finite = volume[np.isfinite(volume)]
        assert finite.max() > 0.0 > finite.min()
        mesh = clean_simple(Mesh(*marching_cubes(volume, 0.0)))
        return remove_small_connected_components(mesh, num_faces=6)

    def host_clean(world, faces):
        mesh = clean_simple(Mesh(vertices=world, faces=faces))
        return remove_small_connected_components(mesh, num_faces=6)

    def card_mesh():
        with span("mesh") as sp:
            return engine._mesh_on_card(volume, 0.0, 6, dev, sp)

    def card_clean(world, faces):
        with span("clean") as sp:
            return engine._clean_on_card(world, faces, 6, sp)

    def same(a, b) -> bool:
        return (a.vertices.shape == b.vertices.shape and a.faces.shape == b.faces.shape
                and np.array_equal(a.vertices.view(np.int32), b.vertices.view(np.int32))
                and np.array_equal(a.faces, b.faces))

    mesh = host_mesh()
    raw_v, raw_f = (a.shape[0] for a in marching_cubes(volume, 0.0))
    world = engine.refine_vertices(mesh.vertices.astype(np.float64), volume, field, step,
                                   bmin_pad, refine_iter=10)
    card, faces_t = card_mesh()  # warm: the kernels' first launches
    card_clean(world, faces_t)
    times = {k: [] for k in ("host mesh", "card mesh", "host clean", "card clean")}
    for _ in range(MESH_ROUNDS):
        for route in ("host", "card", "card", "host"):
            t0 = time.perf_counter()
            m = host_mesh() if route == "host" else card_mesh()[0]
            torch.cuda.synchronize()
            times[f"{route} mesh"].append(time.perf_counter() - t0)
            if not same(m, mesh):
                fail(f"the card route's mesh phase differs from the host route's ({route})")
            t0 = time.perf_counter()
            c = host_clean(world, mesh.faces) if route == "host" else card_clean(world, faces_t)
            torch.cuda.synchronize()
            times[f"{route} clean"].append(time.perf_counter() - t0)
            if route == "host":
                want = c
            elif not same(c, want):
                fail("the card route's clean phase differs from the host route's")
    if not same(card_clean(world, faces_t), want):
        fail("the card route's clean phase differs from the host route's")
    med = {k: statistics.median(v) for k, v in times.items()}
    print("# mesh on the card, s a phase in turns (host, card, card, host; median of "
          f"{2 * MESH_ROUNDS}): " + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
          + f"; {mesh.faces.shape[0]} faces, {mesh.vertices.shape[0]} vertices; "
          f"clean {want.faces.shape[0]} faces", flush=True)

    # the plain PyTorch versions (CPU tensors), once: the same meshes
    from ppsurf_tpu_torch.ops import mesh as ops_mesh

    t0 = time.perf_counter()
    pv, pf, _ = ops_mesh.mesh_volume(torch.from_numpy(volume), 0.0, 6)
    plain_mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cv, cf = ops_mesh.clean(torch.from_numpy(world), pf, 6)
    plain_clean_s = time.perf_counter() - t0
    if not (same(Mesh(pv.numpy(), pf.numpy()), mesh) and same(Mesh(cv.numpy(), cf.numpy()), want)):
        fail("the plain meshing differs from the host route")
    print(f"# plain meshing on the host's CPU: mesh {plain_mesh_s:.3f} s, clean "
          f"{plain_clean_s:.3f} s (the same meshes)", flush=True)

    # the volume's copy as the engine makes it (pageable), and pinned
    copy_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        torch.from_numpy(volume).to(dev)
        torch.cuda.synchronize()
        copy_s.append(time.perf_counter() - t0)
    pinned = torch.from_numpy(volume).pin_memory()
    pinned_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        pinned.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        pinned_s.append(time.perf_counter() - t0)
    rate = volume.nbytes / statistics.median(copy_s)
    kernel_bytes = mesh_kernel_bytes(volume.size, raw_v, raw_f, mesh.vertices.shape[0],
                                     mesh.faces.shape[0])
    bound = kernel_bytes / PEAK_BYTES * 1e3
    print(f"# volume {volume.shape} float64, {volume.nbytes / 1e6:.1f} MB: pageable copy "
          f"{statistics.median(copy_s) * 1e3:.2f} ms ({rate / 1e9:.2f} GB/s), pinned "
          f"{statistics.median(pinned_s) * 1e3:.2f} ms; the kernels' bound {bound:.3f} ms "
          f"({kernel_bytes / 1e6:.1f} MB at 3.35 TB/s; raw mesh {raw_v} vertices {raw_f} "
          "faces)", flush=True)

    # device time an object by kernel: the second of two objects (a
    # trace's first events can go missing while it starts)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                                 active=1)) as prof:
        for i in range(2):
            _, faces_t = card_mesh()
            card_clean(world, faces_t)
            torch.cuda.synchronize()
            if i == 0:
                prof.step()
    own, copies, other = {}, {}, {}
    for e in prof.key_averages():
        ms = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 1e3
        if ms <= 0 or e.key.startswith("ProfilerStep"):
            continue
        name = kernel_name(e.key)
        if name in MESH_CUDA_KERNELS:
            own[name] = own.get(name, 0.0) + ms
        else:
            (copies if e.key.startswith("Memcpy") else other)[e.key] = ms
    own_ms = sum(own.values())
    print(f"# mesh + clean device ms an object: hand kernels {own_ms:.3f} ("
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(own.items(), key=lambda kv: -kv[1]))
          + f"); copies {sum(copies.values()):.3f} ("
          + ", ".join(f"{k} {v:.3f}" for k, v in copies.items())
          + f"); PyTorch's sorts, scans and gathers {sum(other.values()):.3f} ("
          + ", ".join(f"{k[:48]} {v:.3f}" for k, v in sorted(other.items(),
                                                             key=lambda kv: -kv[1])[:8])
          + ")", flush=True)
    if set(own) != set(MESH_CUDA_KERNELS):
        fail(f"meshing kernels missing from the trace: {set(MESH_CUDA_KERNELS) - set(own)}")
    return dict(name="mesh", route="cuda", source="ppsurf_tpu_torch/csrc/mesh.cu",
                replaces="none (host C++ meshing, native/ppsurf_native.cpp)",
                ms=own_ms, other_ms=sum(other.values()), bound_ms=bound, bound_by="bytes",
                card_mesh_s=med["card mesh"], card_clean_s=med["card clean"],
                host_mesh_s=med["host mesh"], host_clean_s=med["host clean"],
                copy_ms=statistics.median(copy_s) * 1e3,
                plain_ms=(plain_mesh_s + plain_clean_s) * 1e3,
                shape=f"{volume.shape} f64, {mesh.faces.shape[0]} faces")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--resolution", type=int, default=257)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--refine", type=int, default=10)
    ap.add_argument("--w1-baseline", default=None,
                    help="an earlier csrc/winding.cu with this one's C entry: phase 13 also "
                         "builds it and times the two in turns")
    ap.add_argument("--profile", default=None,
                    help="trace the reconstruction; write kernel time by name here")
    ap.add_argument("--no-campaign", action="store_true",
                    help="skip phases 14-19 (the campaign, data parallelism, the profiler "
                         "preset, POCO training; no kernel limits are held there)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "ppsurf_tpu_torch", "csrc")):
        fail("ppsurf_tpu_torch/ is not beside this script: run it from a checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from ppsurf_tpu_torch import native
    from ppsurf_tpu_torch import cli
    from ppsurf_tpu_torch.convert.infer_npz import load_infer_npz, load_network
    from ppsurf_tpu_torch.convert.init import init_variables
    from ppsurf_tpu_torch.io.ply import save_ply
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.ops.decoder_tail import decoder_tables, decoder_tail, decoder_tail_plain
    from ppsurf_tpu_torch.ops.knn import dist2, dist2_rows, knn, knn_blocks, knn_plain
    from ppsurf_tpu_torch.ops.morton import morton_order
    from ppsurf_tpu_torch.ops.patches import patch_space
    from ppsurf_tpu_torch.ops.pointnet_att import (
        pointnet_head, pointnet_head_plain, pointnet_tables, pointnet_trunk,
        pointnet_trunk_plain, stn_apply,
    )
    from ppsurf_tpu_torch.ops.topk_rows import topk_rows, topk_rows_plain
    from ppsurf_tpu_torch.recon.field import FieldEvaluator
    from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS, Predictor
    from ppsurf_tpu_torch.tools.microbench_extract import (
        VARIANTS, extract, extract_plain, sass_loops,
    )
    from ppsurf_tpu_torch.train.model import poco_spec, ppsurf_spec

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. toolchain ----
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    nvcc_version = run([kernels._nvcc(), "--version"]).splitlines()[-1]
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}; {nvcc_version}")
    print(f"# card: {smi}", flush=True)

    # ---- 2. build ----
    lib = kernels.build()
    print(f"# kernels built in {lib.build_seconds:.1f} s -> {os.path.relpath(lib.path, HERE)}")
    if not native.available():
        fail("the host library native/ppsurf_native.cpp did not build with g++")
    print("# host library native/ppsurf_native.cpp: built")
    for line in lib.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")) or line.startswith("=="):
            print(f"#   {line.strip()}")
    report = ptxas_report(lib.log)
    knn_frames = {name: r[0] for name, r in report.items() if "knn_kernel" in name}
    for name, b in sorted(knn_frames.items()):
        print(f"# K1 {name}: {b} bytes stack frame")
    if len(knn_frames) != 4 or any(knn_frames.values()):
        fail(f"every K1 instantiation must have a 0-byte stack frame: {knn_frames}")
    sass = run([os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump"), "-sass",
                lib.path])
    for tag, kernel, no_spill in (("K3 bf16", "decoder_tail_wgmma_kernel", False),
                                  ("K3 latent 32 bf16", "decoder_tail_narrow_wgmma_kernel", True),
                                  ("K4 bf16", "trunk_wgmma_kernel", True),
                                  ("K5 bf16", "head_wgmma_kernel", True),
                                  ("K5 cluster bf16", "head_cluster_kernel", True),
                                  ("K3 f32 3xTF32", "decoder_tail_tf32_kernel", True),
                                  ("K3 latent 32 f32 3xTF32", "decoder_tail_narrow_tf32_kernel",
                                   True),
                                  ("K4 f32 3xTF32", "trunk_tf32_kernel", True),
                                  ("K5 f32 3xTF32", "head_tf32_kernel", True)):
        hgmma = sum(part.count("HGMMA") for part in sass.split("Function : ")
                    if kernel in part.split("\n", 1)[0])
        frame, spill = report.get(kernel, (None, None))
        print(f"# {tag} {kernel}: {hgmma} HGMMA instructions in its SASS; "
              f"{frame} bytes stack frame, {spill} bytes spilled")
        if not hgmma:
            fail(f"no HGMMA in {kernel}")
        if no_spill and spill != 0:
            fail(f"ptxas reports {spill} spill bytes (or none) for {kernel}")
        if "f32" in tag and frame != 0:
            fail(f"ptxas reports a {frame}-byte stack frame (or none) for {kernel}")
    select = {name: r for name, r in report.items()
              if name.startswith(("topk_rows_kernel", "extract_kernel"))}
    print("# K2/T1 spill bytes: " + ", ".join(f"{name} {r[1]}" for name, r in sorted(select.items())))
    if len(select) != 8 + len(VARIANTS) or any(r[1] for r in select.values()):
        fail(f"every K2 and T1 kernel must build with 0 spill bytes: {select}")
    pass_loops = sass_loops(sass)
    for variant in VARIANTS:
        what = "innermost loops" if variant == "full" else "pass loop"
        print(f"# T1 {variant}: {what} {pass_loops.get(variant)} SASS instructions")
    sys.stdout.flush()

    # ---- 3. kernels at production shapes ----
    variables = load_infer_npz(DEFAULT_WEIGHTS)
    nets = {dt: load_network(ppsurf_spec(dtype=dt), variables, dev)
            for dt in (torch.float32, torch.bfloat16)}
    # POCO: no trained weights are committed; seeded ones of the JAX tree
    poco_vars = init_variables(poco_spec(), seed=0)
    cloud = torus_cloud(N_POINTS, seed=0)
    bbox = (cloud.min(0), cloud.max(0))
    pts = torch.from_numpy(cloud[morton_order(cloud, *bbox)]).to(dev)
    rng = np.random.RandomState(1)
    qn = cloud[rng.randint(0, cloud.shape[0], N_QUERIES)] + rng.randn(N_QUERIES, 3).astype(np.float32) * 0.02
    q = torch.from_numpy(np.ascontiguousarray(qn[morton_order(qn, *bbox)], np.float32)).to(dev)
    n, c = pts.shape[0], q.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    failures = []

    def check(name, err, limit, what="max_abs_err", note=""):
        ok = err <= limit
        print(f"# {name}: {what} {err:.3e} (limit {limit:.3e}){note}"
              + ("" if ok else "  FAILED"), flush=True)
        if not ok:
            failures.append(f"{name} {what}")

    def compare(name, pairs, tol):
        """Kernel against plain outputs, (kernel, plain) pairs, scale =
        max(1, max |plain|): max |difference| <= tol[0] * scale and mean
        |difference| <= tol[1] * scale. The share of elements that differ
        is printed beside them."""
        scale = max([1.0] + [float(p.float().abs().max()) for _, p in pairs])
        diffs = [(k.float() - p.float()).abs() for k, p in pairs]
        numel = sum(d.numel() for d in diffs)
        err = max(float(d.max()) for d in diffs)
        mean = sum(float(d.sum()) for d in diffs) / numel
        differ = sum(int((d > 0).sum()) for d in diffs) / numel
        check(f"{name} (scale {scale:.2f})", err, tol[0] * scale,
              note=f"; elements differing {differ:.4f}")
        check(f"{name} (scale {scale:.2f})", mean, tol[1] * scale, what="mean_abs_err")
        return err

    def id_distance_err(ids, ids_p):
        """max |distance of kernel id - distance of plain id| over q."""
        err = 0.0
        for s in range(0, c, 4096):
            dd = dist2(q[s:s + 4096], pts)
            err = max(err, float((dd.gather(1, ids[s:s + 4096])
                                  - dd.gather(1, ids_p[s:s + 4096])).abs().max()))
        return err

    with torch.inference_mode():
        # K1 at the field chunk (k=64) and at the encoder's k=16 / k=1
        ids = knn(pts, q, 64)
        ids_p = knn_plain(pts, q, 64)
        torch.cuda.synchronize()
        mism = int((ids != ids_p).sum())
        err = id_distance_err(ids, ids_p)
        check(f"K1 knn k=64 on {c} queries (ids differing)", float(mism), 0.0)
        check("K1 knn k=64 (distance of returned ids)", err, 0.0)
        sup = pts[torch.randperm(n, generator=gen, device=dev)[:10000]]
        for k in (16, 1):
            e = int((knn(sup, sup, k) != knn_plain(sup, sup, k)).sum())
            check(f"K1 knn k={k} on 10000 points (ids differing)", float(e), 0.0)
        knn_edge_cases(check, gen, dev, pts, q)
        # K1 is timed as the field evaluator calls it, with the cloud's
        # blocking made once per shape; that blocking's own time is printed
        blk = knn_blocks(pts)
        print(f"# K1 blocking of the {n}-point cloud (Morton sort and boxes, once per "
              f"cloud): {cuda_ms(lambda: knn_blocks(pts), reps=10):.3f} ms", flush=True)

        def lib_knn():
            for s in range(0, c, 4096):
                torch.topk(torch.cdist(q[s:s + 4096], pts), 64, largest=False)

        b_ms, b_by = bound_ms(n * 12 + c * 12 + c * 64 * 8, knn_needed_ops(pts, q, ids_p),
                              "f32")
        results["knn"] = dict(
            name="knn", route="cuda", source="ppsurf_tpu_torch/csrc/knn.cu",
            replaces="ppsurf_tpu/ops/knn_pallas.py:48",
            max_abs_err=err, ms=cuda_ms(lambda: knn(pts, q, 64, blocks=blk), reps=10),
            plain_ms=cuda_ms(lambda: knn_plain(pts, q, 64), reps=2),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_knn, reps=2),
            shape=f"N={n} Q={c} k=64 f32",
        )
        del ids_p

        # K1 at the candidate refinement's kc=192 (the KMAX=256 build), the
        # queries taken as edge midpoints
        ids_c = knn(pts, q, KC)
        ids_cp = knn_plain(pts, q, KC)
        torch.cuda.synchronize()
        mism = int((ids_c != ids_cp).sum())
        err = id_distance_err(ids_c, ids_cp)
        check(f"K1 knn k={KC} on {c} queries (ids differing)", float(mism), 0.0)
        check(f"K1 knn k={KC} (distance of returned ids)", err, 0.0)

        def lib_knn_c():
            for s in range(0, c, 4096):
                torch.topk(torch.cdist(q[s:s + 4096], pts), KC, largest=False)

        b_ms, b_by = bound_ms(n * 12 + c * 12 + c * KC * 8, knn_needed_ops(pts, q, ids_cp),
                              "f32")
        results["knn_k192"] = dict(
            name="knn_k192", route="cuda", source="ppsurf_tpu_torch/csrc/knn.cu",
            replaces="ppsurf_tpu/ops/knn_pallas.py:48",
            max_abs_err=err, ms=cuda_ms(lambda: knn(pts, q, KC, blocks=blk), reps=10),
            plain_ms=cuda_ms(lambda: knn_plain(pts, q, KC), reps=2),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_knn_c, reps=2),
            shape=f"N={n} Q={c} k={KC} f32",
        )
        del ids_cp, blk

        # K2 on the distances of an iterate near each midpoint to its kc
        # candidates, with exact ties forced in every fifth row
        cpts = pts[ids_c]
        x = q + 0.004 * torch.randn(q.shape, generator=gen, device=dev)
        d2c = dist2_rows(x, cpts)
        d2c[::5, 1::7] = d2c[::5, 0::7][:, : d2c[:, 1::7].shape[1]]
        pos = topk_rows(d2c, 64)
        pos_p = topk_rows_plain(d2c, 64)
        torch.cuda.synchronize()
        mism = int((pos != pos_p).sum())
        err = float((d2c.gather(1, pos) - d2c.gather(1, pos_p)).abs().max())
        check(f"K2 topk_rows C={c} kc={KC} k=64 (positions differing)", float(mism), 0.0)
        select_edge_cases(check, gen, dev)
        # the bound: bytes; a selection needs no more than kc*log2(k)
        # compares a row. K2 is timed L2-warm: the refinement hands it d2
        # straight from dist2_rows, so the path finds its 38 MB input in
        # the 50 MB L2 as the repeated calls here do
        b_ms, b_by = bound_ms(c * KC * 4 + c * 64 * 8, c * KC * 6.0, "f32")
        results["topk_rows"] = dict(
            name="topk_rows", route="cuda", source="ppsurf_tpu_torch/csrc/select.cu",
            replaces="ppsurf_tpu/ops/knn_pallas.py:269",
            max_abs_err=err, ms=cuda_ms(lambda: topk_rows(d2c, 64), reps=10),
            plain_ms=cuda_ms(lambda: topk_rows_plain(d2c, 64), reps=5),
            bound_ms=b_ms, bound_by=b_by,
            # a time only: torch.topk does not promise the tie order
            library_ms=cuda_ms(lambda: torch.topk(d2c, 64, dim=1, largest=False), reps=5),
            shape=f"C={c} kc={KC} k=64 f32",
        )
        print(f"# K2 topk_rows: {results['topk_rows']['ms']:.4f} ms a call, "
              f"{cuda_ms(lambda: topk_rows(d2c, 64), batch=20):.4f} ms over 20 back-to-back "
              "calls", flush=True)
        del ids_c, cpts, x, d2c, pos, pos_p

        # T1: the selection microbenchmark's variants at the TPU tool's
        # shape, each exact against its plain version. Bound: the slab read
        # once and the output written once; the least work of each variant's
        # output (one pass, or ncand*log2(k) compares) is below it.
        slab = torch.rand((T1_QUERIES, T1_NCAND), generator=gen, device=dev)
        library = {
            "sum_only": lambda: slab.sum(dim=1),
            "min_only": lambda: slab.amin(dim=1),
            "min_argmin": lambda: slab.argmin(dim=1),
            "full": lambda: torch.topk(slab, T1_K, dim=1, largest=False),
        }
        for variant in VARIANTS:
            out = extract(slab, variant, T1_K)
            ref = extract_plain(slab, variant, T1_K)
            torch.cuda.synchronize()
            mism = int((out != ref).sum())
            check(f"T1 extract {variant} {T1_QUERIES}x{T1_NCAND} k={T1_K} (elements differing)",
                  float(mism), 0.0)
            b_ms, b_by = bound_ms(T1_QUERIES * T1_NCAND * 4 + T1_QUERIES * T1_K * 4,
                                  T1_QUERIES * T1_NCAND * 6.0, "f32")
            lib = library.get(variant)
            res = results[f"extract_{variant}"] = dict(
                name=f"extract_{variant}", route="cuda",
                source="ppsurf_tpu_torch/csrc/select.cu",
                replaces="tools/microbench_extract.py:30",
                max_abs_err=float((out - ref).abs().max()),
                ms=cuda_ms(lambda: extract(slab, variant, T1_K)),
                plain_ms=cuda_ms(lambda: extract_plain(slab, variant, T1_K), reps=2),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=None if lib is None else cuda_ms(lib, reps=3),
                shape=f"Q={T1_QUERIES} ncand={T1_NCAND} k={T1_K} f32",
                sass_loops=pass_loops.get(variant),
            )
            per = (f"{res['ms'] * 1e6 / T1_QUERIES:.1f} ns per selection" if variant == "full"
                   else f"{res['ms'] * 1e3 / T1_K:.3f} us per pass")
            print(f"# T1 {variant}: {res['ms']:.4f} ms, {per}; SASS loop instructions "
                  f"{res['sass_loops']}; library {res['library_ms']} ms", flush=True)
            del out, ref
        del slab

        # a yardstick only, never called by the port: a kernel's products
        # alone as torch.matmul in the build's dtype (f32 with TF32 off, as
        # set above), each on an input of its (rows, K); returns its ms
        def yardstick(tag, what, products):
            def run_all():
                for x, wt in products:
                    torch.matmul(x, wt)

            rows = products[0][0].shape[0]
            dt = str(products[0][0].dtype).replace("torch.", "").replace("bfloat16", "bf16")
            ms = cuda_ms(run_all, reps=3)
            print(f"# {tag} yardstick: {what} as {dt} torch.matmul on ({rows}, K) inputs: "
                  f"{ms:.3f} ms", flush=True)
            return ms

        # a control, not a check: a plain version with its dense products as
        # bf16 torch.matmul (tensor cores, f32 accumulation in the library's
        # order) against the plain version, to read how far accumulation
        # order alone moves the kernel's function
        def control(tag, module, run_plain, refs, tol):
            def dense_tc(x, kernel, bias, dt):
                y = torch.matmul(x.to(dt), kernel.to(dt))
                return y if bias is None else (y.float() + bias.to(dt).float()).to(dt)

            plain_dense = module.dense
            module.dense = dense_tc
            try:
                outs = run_plain()
            finally:
                module.dense = plain_dense
            outs = outs if isinstance(outs, tuple) else (outs,)
            scale = max([1.0] + [float(r.float().abs().max()) for r in refs])
            diffs = [(o.float() - r.float()).abs() for o, r in zip(outs, refs)]
            err = max(float(d.max()) for d in diffs)
            mean = sum(float(d.sum()) for d in diffs) / sum(d.numel() for d in diffs)
            print(f"# {tag} control: plain version with bf16 tensor-core products vs plain "
                  f"version: max_abs_err/scale {err / scale:.3e}, mean_abs_err/scale "
                  f"{mean / scale:.3e} (limits {tol[0]:.1e}, {tol[1]:.1e})", flush=True)

        import ppsurf_tpu_torch.ops.decoder_tail as tail_mod
        import ppsurf_tpu_torch.ops.pointnet_att as pn_mod

        # (max, mean) |kernel - plain| limits over scale. bf16: the sound
        # tensor-core kernels read at most 8.5e-3 and 1.2e-6 (K3; K4 2.2e-8
        # and K5 2.7e-7 mean); kernels with one rounding step removed read
        # at least 1.4e-5 mean, K4's at least 2.6e-2 max. f32: the 3xTF32
        # K3-K5 read at most 1.5e-6 and 3.3e-7 (K3); with one TF32 term or
        # lo x hi dropped at least 1.1e-5 mean (K3) and 1.3e-4 max (K5)
        # (chip_rounding_control.py, PERF.md)
        for dt, tag, tol in ((torch.bfloat16, "bf16", (1.6e-2, 2e-6)),
                             (torch.float32, "f32", (1e-4, 2e-6))):
            net = nets[dt]
            lat = torch.randn(n, 256, generator=gen, device=dev).to(dt)
            tabs = decoder_tables(net.projection, dt)
            if dt == torch.float32:
                tabs = full_mantissas(tabs, gen)
            out = decoder_tail(lat, pts, q, ids, tabs)
            ref = decoder_tail_plain(lat, pts, q, ids, tabs)
            err = compare(f"K3 decoder_tail {tag}", [(out, ref)], tol)
            bf = dt == torch.bfloat16
            sfx, esize = ("", 2) if bf else ("_f32", 4)
            ops = c * 64 * tail_macs(256) * 2.0
            nb = n * 256 * esize + n * 12 + c * 12 + c * 64 * 8 + c * 256 * esize
            res = results["decoder_tail" + sfx] = dict(
                name="decoder_tail" + sfx, route="cuda",
                source="ppsurf_tpu_torch/csrc/decoder_tail.cu",
                replaces="ppsurf_tpu/ops/decoder_pallas.py:49",
                max_abs_err=err, ms=cuda_ms(lambda: decoder_tail(lat, pts, q, ids, tabs)),
                plain_ms=cuda_ms(lambda: decoder_tail_plain(lat, pts, q, ids, tabs), reps=2),
                **kernel_bounds(nb, ops, tag), library_ms=None,
                shape=f"C={c} k=64 L=256 heads=64 {tag}",
            )
            xg = lat[ids].reshape(-1, 256)
            ys = yardstick(f"K3 {tag}", "fc2, fc3, fc_query, fc_value",
                           [(xg, wt) for wt in (tabs.w2, tabs.w3, tabs.wq, tabs.wv)])
            del xg
            if bf:
                control("K3", tail_mod, lambda: decoder_tail_plain(lat, pts, q, ids, tabs),
                        [ref], tol)
            else:
                res["yardstick_ms"] = ys
            del out, ref

            pt = pointnet_tables(net.point_net)
            if dt == torch.float32:
                pt = full_mantissas(pt, gen)
            pp = patch_space(pts[ids[:, :50]], q).to(dt).contiguous()
            b_k, pool_k = pointnet_trunk(pp, pt)
            b_p, pool_p = pointnet_trunk_plain(pp, pt)
            err4 = compare(f"K4 pointnet_trunk {tag}", [(b_k, b_p), (pool_k, pool_p)], tol)
            x2 = stn_apply(pool_p, b_p, pt).contiguous()
            h_k = pointnet_head(x2, pt)
            h_p = pointnet_head_plain(x2, pt)
            err5 = compare(f"K5 pointnet_head {tag}", [(h_k, h_p)], tol)
            for kernel, err_k, fn, plain, nb, macs, line in (
                    ("pointnet_trunk", err4, lambda: pointnet_trunk(pp, pt),
                     lambda: pointnet_trunk_plain(pp, pt),
                     c * 50 * 3 * esize + c * 50 * 64 * esize + c * 256 * esize, TRUNK_MACS, 56),
                    ("pointnet_head", err5, lambda: pointnet_head(x2, pt),
                     lambda: pointnet_head_plain(x2, pt), c * 50 * 64 * esize + c * 256 * esize,
                     HEAD_MACS, 72)):
                ops = c * 50 * macs * 2.0
                results[kernel + sfx] = dict(
                    name=kernel + sfx, route="cuda", source="ppsurf_tpu_torch/csrc/pointnet.cu",
                    replaces=f"ppsurf_tpu/ops/pointnet_pallas.py:{line}",
                    max_abs_err=err_k, ms=cuda_ms(fn, reps=10), plain_ms=cuda_ms(plain, reps=2),
                    **kernel_bounds(nb, c * 50 * macs * 2.0, tag), library_ms=None,
                    shape=f"C={c} P=50 {tag}",
                )
            w0a, w0b, ws1, ws2, ws3 = pt.trunk_w
            x3, x64 = pp.reshape(-1, 3), b_p.reshape(-1, 64)
            x128 = torch.matmul(x64, ws2)
            ys = yardstick(f"K4 {tag}", "conv0a, conv0b, stn conv1-3",
                           [(x3, w0a), (x64, w0b), (x64, ws1), (x64, ws2), (x128, ws3)])
            if not bf:
                results["pointnet_trunk_f32"]["yardstick_ms"] = ys
            del x3, x64, x128
            if bf:
                control("K4", pn_mod, lambda: pointnet_trunk_plain(pp, pt), [b_p, pool_p], tol)
            wc1, wc2, wc3, wq, wv = pt.head_w
            x64 = x2.reshape(-1, 64)
            x128 = torch.matmul(x64, wc2)
            x256 = torch.matmul(x128, wc3)
            ys = yardstick(f"K5 {tag}", "conv1-3, fc_query, fc_value",
                           [(x64, wc1), (x64, wc2), (x128, wc3), (x256, wq), (x256, wv)])
            if not bf:
                results["pointnet_head_f32"]["yardstick_ms"] = ys
            del x64, x128, x256
            if bf:
                control("K5", pn_mod, lambda: pointnet_head_plain(x2, pt), [h_p], tol)
            del pp, b_k, pool_k, b_p, pool_p, x2, h_k, h_p
        wide_builds(compare, yardstick, results, nets, poco_vars, pts, q, gen, dev)
        for name in F32_BUILDS:
            results[name]["kernel"] = F32_KERNELS[name[:-len("_f32")].split("_wide")[0]]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for res in results.values():
        print(f"# timed {res['name']} ({res['shape']}): {res['ms']:.4f} ms, plain "
              f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})"
              + (f", FMA bound {res['bound_fma_ms']:.4f} ms, yardstick "
                 f"{res['yardstick_ms']:.3f} ms" if "bound_fma_ms" in res else ""), flush=True)
    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")

    # ---- 4. the main path: one reconstruction, bf16, committed weights ----
    spec = ppsurf_spec(dtype=torch.bfloat16, gen_subsample_manifold_iter=args.passes,
                       gen_refine_iter=args.refine)
    predictor = Predictor(spec, variables=variables, device="cuda", verbose=False)
    timings = {}
    tracer = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        tracer = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    # capture the refinement's inputs for phase 5 (the evaluator is made
    # inside reconstruct_shape)
    refine_in = {}
    refine_bisection = FieldEvaluator.refine_bisection

    def capture_refine(self, v, v1, v2, p1, p2, iters, force_full=False):
        refine_in.update(v=v.copy(), v1=v1.copy(), v2=v2.copy(), p1=p1.copy(),
                         p2=p2.copy(), iters=iters)
        return refine_bisection(self, v, v1, v2, p1, p2, iters, force_full)

    FieldEvaluator.refine_bisection = capture_refine
    kernels.reset_launches()
    with tracer as prof:
        t0 = time.perf_counter()
        mesh = predictor.reconstruct_shape(cloud, seed=0, resolution=args.resolution,
                                           timings=timings)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    FieldEvaluator.refine_bisection = refine_bisection
    if args.profile:
        events = prof.key_averages()
        # device-side events only: CPU ops also carry their kernels' time
        busy_us = sum(e.self_device_time_total for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        with open(args.profile, "w") as fp:
            fp.write(f"# {smi}; e2e {total:.3f} s under the profiler\n")
            fp.write(events.table(sort_by="self_device_time_total", row_limit=40))
        print(f"# profile: device busy {busy_us / 1e6:.3f} s of {total:.3f} s "
              f"({100 * busy_us / 1e6 / total:.1f}%); table in {args.profile}", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total):
            if e.device_type == torch.autograd.DeviceType.CUDA and any(
                    n in e.key for n in ("knn_kernel", "decoder_tail", "trunk_", "head_",
                                         "topk_rows_kernel")):
                print(f"# profile: {e.key[:60]}: {e.self_device_time_total / 1e3:.3f} ms "
                      f"device time in {e.count} calls", flush=True)
    if mesh is None or mesh.faces.shape[0] == 0:
        fail("the reconstruction produced no mesh")
    if not np.isfinite(mesh.vertices).all():
        fail("non-finite vertices")
    zero = [k for k in PATH_KERNELS if launches[k] == 0]
    if zero:
        fail(f"kernels not launched on the main path: {zero}")
    # the mesh and clean phases on the card: the engine's card route
    mesh_launches = {k: launches[k] for k in kernels.MESH_KERNELS}
    if mesh_launches != MESH_LAUNCHES:
        fail(f"the reconstruction's meshing launches: {mesh_launches}, not {MESH_LAUNCHES}")
    ev = predictor.last_evaluator
    queries = ev.stat_queries
    print(f"# e2e res {args.resolution}, {N_POINTS} pts, {args.passes} passes, "
          f"refine {args.refine}: {total:.2f} s; phases "
          + " ".join(f"{k}={v:.2f}s" for k, v in timings.items()))
    print(f"# e2e field queries {queries}, mesh {mesh.vertices.shape[0]} vertices "
          f"{mesh.faces.shape[0]} faces (with K4 and K5 on the CUDA cores: 323677 vertices "
          f"647018 faces at res 257); launches {json.dumps(launches)}", flush=True)
    for name in PATH_KERNELS + tuple(f"extract_{v}" for v in VARIANTS):
        results[name]["launches"] = launches[name]
    n_ref, iters = refine_in["v"].shape[0], refine_in["iters"]
    chunks = -(-n_ref // ev.chunk)
    print(f"# refine: {n_ref} vertices in {chunks} chunks x {iters} iterations on the "
          f"candidate path: topk_rows {launches['topk_rows']}, knn k={KC} "
          f"{launches['knn_k192']} launches; {ev.stat_cert_failed} vertices failed the "
          "certificate and were refined on the plain path", flush=True)
    if launches["topk_rows"] != chunks * iters or launches["knn_k192"] != chunks:
        fail(f"the refinement did not run on the candidate path: {launches}")

    # ---- 5. candidate path against plain path on the card ----
    with torch.inference_mode():
        # where K3's bf16 results moved by an ulp, the mesh moves only
        # where the field is near zero: the field near the mesh with the
        # kernel and with its plain version, and where their signs differ
        import ppsurf_tpu_torch.recon.field as field_mod

        rng_m = np.random.RandomState(2)
        near = mesh.vertices[rng_m.randint(0, mesh.vertices.shape[0], 65536)]
        near = (near + rng_m.randn(*near.shape) / args.resolution).astype(np.float32)
        v_kernel = ev(near)
        field_mod.decoder_tail = decoder_tail_plain
        try:
            v_plain = ev(near)
        finally:
            field_mod.decoder_tail = decoder_tail
        flips = np.sign(v_kernel) != np.sign(v_plain)
        at = np.abs(v_kernel[flips])
        print(f"# bf16 field at {near.shape[0]} points within a voxel of the mesh, K3 kernel vs "
              f"its plain version: signs differ at {int(flips.sum())}, |field| there at most "
              f"{float(at.max()) if at.size else 0.0:.3e} (median |field| "
              f"{float(np.median(np.abs(v_kernel))):.3e}); max |difference| "
              f"{float(np.abs(v_kernel - v_plain).max()):.3e}", flush=True)
        names = ("v", "v1", "v2", "p1", "p2")
        first = morton_order(refine_in["v"], *ev._bbox)[:ev.chunk]
        chunk_in = [refine_in[k][first] for k in names]
        runs = {}
        for path in ("plain", "cand"):
            kernels.reset_launches()
            failed0 = ev.stat_cert_failed
            runs[path] = ev.refine_bisection(*chunk_in, iters, force_full=path == "plain")
            nonzero = {k: v for k, v in kernels.LAUNCHES.items() if v}
            print(f"# first refine chunk ({first.size} vertices) on the {path} path: launches "
                  f"{json.dumps(nonzero)}; certificate failures "
                  f"{ev.stat_cert_failed - failed0}", flush=True)
        # the plain path's iterates, replayed bit for bit, explain a
        # difference where one of them has an exact distance tie among its
        # 65 nearest (K2 orders tied candidates by position, K1 by id)
        order = morton_order(chunk_in[0], *ev._bbox)
        iterates = []

        def replay_ids(x):
            iterates.append(x.clone())
            return knn(ev.pts, x, ev.k)

        replay = ev._bisect(*ev._sorted(*chunk_in, order=order), iters, replay_ids)
        if not np.array_equal(replay.cpu().numpy(), runs["plain"][order]):
            fail("the replay of the plain path differs from the plain path")
        differ = np.flatnonzero((runs["plain"][order] != runs["cand"][order]).any(axis=1))
        unexplained = []
        for i in differ:
            tied = False
            for x in iterates:
                ds = torch.sort(dist2(x[i:i + 1], ev.pts)[0])[0][:ev.k + 1]
                tied |= bool((ds[1:] == ds[:-1]).any())
            if not tied:
                unexplained.append(int(i))
        print(f"# candidate vs plain path: {differ.size} of {first.size} vertices differ "
              f"(limit {first.size // 1000}), {len(unexplained)} of them without an exact "
              f"distance tie among an iterate's {ev.k + 1} nearest", flush=True)
        if differ.size > first.size // 1000 or unexplained:
            fail(f"candidate and plain refinement disagree: {differ.size} vertices, "
                 f"unexplained {unexplained[:10]}")

        # the refinement of every vertex on both paths, in turns
        all_args = [refine_in[k] for k in names]
        secs = {"plain": [], "cand": []}
        for path in ("plain", "cand", "cand", "plain"):
            t0 = time.perf_counter()
            ev.refine_bisection(*all_args, iters, force_full=path == "plain")
            secs[path].append(time.perf_counter() - t0)
        print(f"# refine phase over {n_ref} vertices, {iters} iterations: plain path "
              + ", ".join(f"{t:.3f}" for t in secs["plain"]) + " s; candidate path "
              + ", ".join(f"{t:.3f}" for t in secs["cand"]) + " s", flush=True)
        del runs, iterates, replay

    # ---- 5b. the f32 main path: the 50NN reconstruction in f32, as `cli rec
    # --trainer.precision 32` runs it ----
    spec_f32 = ppsurf_spec(dtype=torch.float32, gen_subsample_manifold_iter=args.passes,
                           gen_refine_iter=args.refine)
    predictor_f32 = Predictor(spec_f32, variables=variables, device="cuda", verbose=False)
    times_f32 = {}
    kernels.reset_launches()
    with chunks_and_dtypes() as seen:
        t0 = time.perf_counter()
        mesh_f32 = predictor_f32.reconstruct_shape(cloud, seed=0, resolution=args.resolution,
                                                   timings=times_f32)
        torch.cuda.synchronize()
        total_f32 = time.perf_counter() - t0
    launches_f32 = dict(kernels.LAUNCHES)
    field_calls, dtype_codes = [seen["chunks"]], seen["dtypes"]
    if mesh_f32 is None or mesh_f32.faces.shape[0] == 0 or not np.isfinite(mesh_f32.vertices).all():
        fail("the f32 reconstruction produced no finite mesh")
    print(f"# f32 e2e res {args.resolution}, {N_POINTS} pts, {args.passes} passes, refine "
          f"{args.refine}: {total_f32:.2f} s; phases "
          + " ".join(f"{k}={v:.2f}s" for k, v in times_f32.items())
          + f"; field queries {predictor_f32.last_evaluator.stat_queries} in {field_calls[0]} "
          f"chunks; launches {json.dumps({k: v for k, v in launches_f32.items() if v})}; K3-K5 "
          f"dtype codes {json.dumps({k: sorted(v) for k, v in dtype_codes.items()})}",
          flush=True)
    from ppsurf_tpu_torch.metrics.proximity import nn_query

    voxel = 1.0 / (args.resolution - 1)
    d_fb = nn_query(mesh.vertices, mesh_f32.vertices)[0][:, 0]
    d_bf = nn_query(mesh_f32.vertices, mesh.vertices)[0][:, 0]
    print(f"# f32 mesh {mesh_f32.vertices.shape[0]} vertices {mesh_f32.faces.shape[0]} faces "
          f"against the bf16 mesh of phase 4, {mesh.vertices.shape[0]} vertices "
          f"{mesh.faces.shape[0]} faces: f32 vertices within a voxel ({voxel:.5f}) of a bf16 "
          f"vertex {float(np.mean(d_fb <= voxel)):.5f}, bf16 vertices within a voxel of an f32 "
          f"vertex {float(np.mean(d_bf <= voxel)):.5f} (printed, not a limit: the two dtypes "
          "give different fields)", flush=True)
    once = ("decoder_tail", "pointnet_trunk", "pointnet_head")
    if any(launches_f32[k] != field_calls[0] for k in once) or any(
            launches_f32[k] == 0 for k in ("knn", "knn_k192", "topk_rows")):
        fail(f"the f32 reconstruction did not launch K3-K5 once a chunk ({field_calls[0]} "
             f"chunks) and K1/K2: {launches_f32}")
    if set(dtype_codes) != set(once) or any(v != {0} for v in dtype_codes.values()):
        fail(f"the f32 reconstruction launched a bf16 build: {dtype_codes}")
    for name in once:
        results[name + "_f32"]["launches"] = launches_f32[name]
    del predictor_f32, mesh_f32, d_fb, d_bf

    # ---- 6. one chunk on the card vs the CPU plain path, f32 ----
    with torch.inference_mode():
        spec32 = ppsurf_spec(dtype=torch.float32)
        lat32 = predictor.encoder(torch.from_numpy(cloud).to(dev),
                                  generator=torch.Generator(device=dev).manual_seed(1))
        gpu_eval = FieldEvaluator(nets[torch.float32], spec32, cloud, lat32)
        net_cpu = load_network(spec32, variables, torch.device("cpu"))
        cpu_eval = FieldEvaluator(net_cpu, spec32, cloud, lat32.cpu())
        qc = qn[:4096]
        v_gpu = gpu_eval(qc)
        v_cpu = cpu_eval(qc)
        err = float(np.abs(v_gpu - v_cpu).max())
        print(f"# f32 field chunk of {qc.shape[0]}: card vs CPU plain path max_abs_err "
              f"{err:.3e}, sign agreement {float(np.mean(np.sign(v_gpu) == np.sign(v_cpu))):.5f}")
        if not (np.isfinite(v_gpu).all() and err <= 1e-3):
            fail(f"f32 field on the card disagrees with the CPU plain path: {err}")

    # ---- 7. ppsurf_100nn and ppsurf_200nn: one f32 chunk each on the card
    # vs the CPU plain path (and the 100NN chunk in bf16 on the card) ----
    with torch.inference_mode():
        for p_loc in (100, 200):
            spec_p = ppsurf_spec(num_pts_local=p_loc, dtype=torch.float32)
            gpu_p = FieldEvaluator(load_network(spec_p, variables, dev), spec_p, cloud, lat32)
            cpu_p = FieldEvaluator(load_network(spec_p, variables, torch.device("cpu")), spec_p,
                                   cloud, lat32.cpu())
            kernels.reset_launches()
            v_gpu = gpu_p(qc)
            torch.cuda.synchronize()
            launches_p = dict(kernels.LAUNCHES)
            v_cpu = cpu_p(qc)
            err = float(np.abs(v_gpu - v_cpu).max())
            print(f"# ppsurf_{p_loc}nn f32 field chunk of {qc.shape[0]} (patch P={p_loc} from "
                  f"one K1 call at k={p_loc}): card vs CPU plain path max_abs_err {err:.3e}; "
                  f"launches {json.dumps({k: v for k, v in launches_p.items() if v})}",
                  flush=True)
            if not (np.isfinite(v_gpu).all() and err <= 1e-3):
                fail(f"ppsurf_{p_loc}nn f32 field on the card disagrees with the CPU plain "
                     f"path: {err}")
            # K1 at k=P counts under "knn_k192" for P > 128
            need = ("knn" if p_loc <= 128 else "knn_k192", "decoder_tail",
                    "pointnet_trunk_wide", "pointnet_head_wide")
            if any(launches_p[k] == 0 for k in need) or launches_p["pointnet_trunk"]:
                fail(f"the ppsurf_{p_loc}nn chunk did not run on the wide K4/K5 builds: "
                     f"{launches_p}")
            for name in ("pointnet_trunk_wide", "pointnet_head_wide"):
                results[f"{name}_p{p_loc}_f32"]["launches"] = launches_p[name]
            del gpu_p, cpu_p
        spec100 = ppsurf_spec(num_pts_local=100, dtype=torch.bfloat16)
        gpu100 = FieldEvaluator(load_network(spec100, variables, dev), spec100, cloud, lat32)
        kernels.reset_launches()
        v_gpu = gpu100(qc)
        torch.cuda.synchronize()
        if not np.isfinite(v_gpu).all() or not all(
                kernels.LAUNCHES[k] for k in ("pointnet_trunk_wide", "pointnet_head_wide")):
            fail(f"the ppsurf_100nn bf16 chunk did not run: {kernels.LAUNCHES}")
        for name in ("pointnet_trunk_wide", "pointnet_head_wide"):
            results[f"{name}_p100"]["launches"] = kernels.LAUNCHES[name]
        del gpu100

    # ---- 8. POCO at res 257: seeded weights, bench.py's analytic blend ----
    radius = float(np.abs(cloud).max())

    def blend(vals, qq):
        """bench.py:125-133: the untrained field plus a sphere's SDF, so
        that region growing and refinement see a surface"""
        return 0.01 * vals + (torch.sqrt((qq.float() ** 2).sum(-1)) - radius)

    pspec = poco_spec(dtype=torch.bfloat16, gen_subsample_manifold_iter=args.passes,
                      gen_refine_iter=args.refine)
    poco = Predictor(pspec, variables=poco_vars, device="cuda", verbose=False)
    ptimes = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    pmesh = poco.reconstruct_shape(cloud, seed=0, resolution=args.resolution, transform=blend,
                                   timings=ptimes)
    torch.cuda.synchronize()
    ptotal = time.perf_counter() - t0
    plaunch = dict(kernels.LAUNCHES)
    if pmesh is None or pmesh.faces.shape[0] == 0 or not np.isfinite(pmesh.vertices).all():
        fail("the POCO reconstruction produced no finite mesh")
    # the surface lies where |q| - radius = -0.01 x field, the field in
    # [-1, 1]: within 0.01 of the sphere, plus the mesh's voxel error
    off = np.abs(np.linalg.norm(pmesh.vertices, axis=1) - radius)
    band = 0.01 + 2.0 / args.resolution
    print(f"# POCO (latent 32, k=64, bf16, seeded weights + blend) res {args.resolution}: "
          f"{ptotal:.2f} s; phases " + " ".join(f"{k}={v:.2f}s" for k, v in ptimes.items())
          + f"; mesh {pmesh.vertices.shape[0]} vertices {pmesh.faces.shape[0]} faces, "
          f"| |vertex| - {radius:.4f} | at most {off.max():.4f}, 99th percentile "
          f"{np.percentile(off, 99):.4f} (band {band:.4f}); field queries "
          f"{poco.last_evaluator.stat_queries}; launches "
          f"{json.dumps({k: v for k, v in plaunch.items() if v})}", flush=True)
    if np.percentile(off, 99) > band:
        fail(f"the POCO mesh is not the blend's sphere: 99th percentile of the radial "
             f"offset {np.percentile(off, 99)} > {band}")
    need = ("knn", "knn_k192", "decoder_tail_l32", "topk_rows")
    if (any(plaunch[k] == 0 for k in need)
            or any(plaunch[k] for k in ("decoder_tail", "pointnet_trunk", "pointnet_head"))):
        fail(f"the POCO reconstruction did not run on its kernels: {plaunch}")
    results["decoder_tail_l32"]["launches"] = plaunch["decoder_tail_l32"]
    # the POCO reconstruction in f32 (as `cli rec --trainer.precision 32`):
    # K3 at latent 32 once a field chunk, its f32 build only
    pspec_f32 = poco_spec(dtype=torch.float32, gen_subsample_manifold_iter=args.passes,
                          gen_refine_iter=args.refine)
    poco_f32 = Predictor(pspec_f32, variables=poco_vars, device="cuda", verbose=False)
    ptimes32 = {}
    kernels.reset_launches()
    with chunks_and_dtypes() as seen:
        t0 = time.perf_counter()
        pmesh32 = poco_f32.reconstruct_shape(cloud, seed=0, resolution=args.resolution,
                                             transform=blend, timings=ptimes32)
        torch.cuda.synchronize()
        ptotal32 = time.perf_counter() - t0
    plaunch_e2e32 = dict(kernels.LAUNCHES)
    if pmesh32 is None or pmesh32.faces.shape[0] == 0 or not np.isfinite(pmesh32.vertices).all():
        fail("the POCO f32 reconstruction produced no finite mesh")
    off32 = np.abs(np.linalg.norm(pmesh32.vertices, axis=1) - radius)
    print(f"# POCO f32 (latent 32, k=64, seeded weights + blend) res {args.resolution}: "
          f"{ptotal32:.2f} s; phases " + " ".join(f"{k}={v:.2f}s" for k, v in ptimes32.items())
          + f"; mesh {pmesh32.vertices.shape[0]} vertices {pmesh32.faces.shape[0]} faces (bf16: "
          f"{pmesh.vertices.shape[0]}), 99th percentile of | |vertex| - {radius:.4f} | "
          f"{np.percentile(off32, 99):.4f} (band {band:.4f}); field queries "
          f"{poco_f32.last_evaluator.stat_queries} in {seen['chunks']} chunks; launches "
          f"{json.dumps({k: v for k, v in plaunch_e2e32.items() if v})}; K3 dtype codes "
          f"{json.dumps({k: sorted(v) for k, v in seen['dtypes'].items()})}", flush=True)
    if np.percentile(off32, 99) > band:
        fail(f"the POCO f32 mesh is not the blend's sphere: 99th percentile of the radial "
             f"offset {np.percentile(off32, 99)} > {band}")
    if (plaunch_e2e32["decoder_tail_l32"] != seen["chunks"]
            or any(plaunch_e2e32[k] == 0 for k in ("knn", "knn_k192", "topk_rows"))
            or seen["dtypes"] != {"decoder_tail_l32": {0}}):
        fail(f"the POCO f32 reconstruction did not launch the f32 K3 at latent 32 once a "
             f"chunk ({seen['chunks']} chunks) and no other K3-K5 build: {plaunch_e2e32}, "
             f"dtype codes {seen['dtypes']}")
    results["decoder_tail_l32_f32"]["launches"] = plaunch_e2e32["decoder_tail_l32"]
    del poco_f32, pmesh32
    # one POCO f32 chunk on the card vs the CPU plain path (K3 at latent 32, f32)
    with torch.inference_mode():
        pspec32 = poco_spec(dtype=torch.float32)
        plat = poco.encoder(torch.from_numpy(cloud).to(dev),
                            generator=torch.Generator(device=dev).manual_seed(1)).float()
        gpu_poco = FieldEvaluator(load_network(pspec32, poco_vars, dev), pspec32, cloud, plat)
        cpu_poco = FieldEvaluator(load_network(pspec32, poco_vars, torch.device("cpu")),
                                  pspec32, cloud, plat.cpu())
        kernels.reset_launches()
        v_gpu = gpu_poco(qc)
        torch.cuda.synchronize()
        plaunch32 = dict(kernels.LAUNCHES)
        err = float(np.abs(v_gpu - cpu_poco(qc)).max())
        print(f"# POCO f32 field chunk of {qc.shape[0]}: card vs CPU plain path max_abs_err "
              f"{err:.3e}; launches {json.dumps({k: v for k, v in plaunch32.items() if v})}",
              flush=True)
        if not (np.isfinite(v_gpu).all() and err <= 1e-3) or not plaunch32["decoder_tail_l32"]:
            fail(f"the POCO f32 chunk on the card disagrees with the CPU plain path or did "
                 f"not launch K3 at latent 32: {err}, {plaunch32}")
        del gpu_poco, cpu_poco, plat
    del poco, pmesh

    # ---- 9. ppsurf_200nn at res 257: four-tile K4/K5, K1 at k=200 ----
    spec200 = ppsurf_spec(num_pts_local=200, dtype=torch.bfloat16,
                          gen_subsample_manifold_iter=args.passes, gen_refine_iter=args.refine)
    wide = Predictor(spec200, variables=variables, device="cuda", verbose=False)
    wtimes = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    wmesh = wide.reconstruct_shape(cloud, seed=0, resolution=args.resolution, timings=wtimes)
    torch.cuda.synchronize()
    wtotal = time.perf_counter() - t0
    wlaunch = dict(kernels.LAUNCHES)
    if wmesh is None or wmesh.faces.shape[0] == 0 or not np.isfinite(wmesh.vertices).all():
        fail("the ppsurf_200nn reconstruction produced no finite mesh")
    print(f"# ppsurf_200nn (P=200, bf16, committed weights) res {args.resolution}: "
          f"{wtotal:.2f} s; phases " + " ".join(f"{k}={v:.2f}s" for k, v in wtimes.items())
          + f"; mesh {wmesh.vertices.shape[0]} vertices {wmesh.faces.shape[0]} faces (50NN: "
          f"{mesh.vertices.shape[0]}); field queries {wide.last_evaluator.stat_queries}; "
          f"launches {json.dumps({k: v for k, v in wlaunch.items() if v})}", flush=True)
    need = ("knn", "knn_k192", "decoder_tail", "pointnet_trunk_wide", "pointnet_head_wide",
            "topk_rows")
    if any(wlaunch[k] == 0 for k in need) or wlaunch["pointnet_trunk"]:
        fail(f"the ppsurf_200nn reconstruction did not run on its kernels: {wlaunch}")
    for name in ("pointnet_trunk_wide_p200", "pointnet_head_wide_p200"):
        results[name]["launches"] = wlaunch[name[:-5]]
    del wide, wmesh

    # ---- 10. a 40-point cloud: K3 at k=40, K4/K5 at P=40 ----
    d = np.random.RandomState(3).randn(40, 3)
    small = (d / np.linalg.norm(d, axis=1, keepdims=True) * 0.4).astype(np.float32)
    kernels.reset_launches()
    smesh = predictor.reconstruct_shape(small, seed=0, resolution=33)
    torch.cuda.synchronize()
    slaunch = dict(kernels.LAUNCHES)
    ev_small = predictor.last_evaluator
    if smesh is None or smesh.faces.shape[0] == 0 or not np.isfinite(smesh.vertices).all():
        fail("the 40-point cloud produced no finite mesh")
    print(f"# 40-point cloud, res 33, bf16: decoder k={ev_small.k}, patch P={ev_small.patch_k}; "
          f"mesh {smesh.vertices.shape[0]} vertices {smesh.faces.shape[0]} faces; launches "
          f"{json.dumps({k: v for k, v in slaunch.items() if v})}", flush=True)
    if (ev_small.k, ev_small.patch_k) != (40, 40) or not slaunch["decoder_tail"]:
        fail(f"the 40-point cloud did not run K3 at k=40: {slaunch}")
    results["decoder_tail_k40"]["launches"] = slaunch["decoder_tail"]

    # ---- 11. `cli predict` on a two-shape dataset written to a temp dir,
    # scored against its ground truth ----
    t0 = time.perf_counter()
    gt = torus_gt_mesh(GT_RESOLUTION)
    print(f"# ground truth: marching cubes of the torus and sphere at res {GT_RESOLUTION}: "
          f"{gt.vertices.shape[0]} vertices {gt.faces.shape[0]} faces in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # phase 11's dataset and results stay for the campaign (phase 14)
    shared = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    with contextlib.nullcontext(shared.name) as tmp:
        names = ("shape_a", "shape_b")
        os.makedirs(os.path.join(tmp, "tiny", "04_pts_vis"))
        os.makedirs(os.path.join(tmp, "tiny", "03_meshes"))
        for i, name in enumerate(names):
            save_ply(os.path.join(tmp, "tiny", "04_pts_vis", name + ".xyz.ply"),
                     torus_cloud(20000, seed=10 + i))
            gt.export(os.path.join(tmp, "tiny", "03_meshes", name + ".ply"))
        testset = os.path.join(tmp, "tiny", "testset.txt")
        with open(testset, "w") as fp:
            fp.write("\n".join(names) + "\n")
        results_dir = os.path.join(tmp, "results")
        configs = [os.path.join(HERE, "configs", f"{c}.yaml")
                   for c in ("poco", "ppsurf", "ppsurf_50nn")]
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["predict", *[a for c in configs for a in ("-c", c)],
                       "--data.init_args.in_file", testset,
                       "--model.init_args.results_dir", results_dir,
                       "--model.init_args.gen_resolution_global", "129"])
        csecs = time.perf_counter() - t0
        clau = dict(kernels.LAUNCHES)
        rdir = os.path.join(results_dir, "ppsurf_50nn", "tiny")
        want = [os.path.join(rdir, "meshes", f"{name}.xyz.ply") for name in names]
        want += [os.path.join(rdir, f"{t}.{ext}") for t in SCORE_TABLES for ext in ("csv", "xlsx")]
        found = sorted(os.path.relpath(os.path.join(r, f), tmp)
                       for r, _, fs in os.walk(results_dir) for f in fs)
        print(f"# cli predict, two shapes, res 129, scored: rc {rc}, {csecs:.2f} s; wrote "
              f"{found}; launches {json.dumps({k: v for k, v in clau.items() if v})}", flush=True)
        if rc != 0 or found != sorted(os.path.relpath(w, tmp) for w in want):
            fail(f"cli predict wrote {found}, expected {want} (rc {rc})")
        if any(clau[k] == 0 for k in PATH_KERNELS) or clau["winding"] != 4 * len(names):
            fail(f"cli predict did not run every path kernel, and W1 4 times a shape: {clau}")
        for table in SCORE_TABLES:
            with open(os.path.join(rdir, table + ".csv")) as fp:
                rows = [line.rstrip("\n").split(",") for line in fp]
            values = [float(r[1]) if r[1] else float("nan") for r in rows[1:1 + len(names)]]
            print(f"# cli predict {table}: " + ", ".join(
                f"{r[0]} {v!r}" for r, v in zip(rows[1:], values)), flush=True)
            if ([r[0] for r in rows[1:1 + len(names)]] != list(names)
                    or not np.isfinite(values).all()):
                fail(f"cli predict's {table} table is not one finite row a shape: {rows}")

    # ---- 12. training: fit, overfit, card vs CPU, step time, test, rec ----
    # (its solids stay for phases 15, 16, 18 and 19)
    train_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    t0 = time.perf_counter()
    training_phase(train_tmp.name, smi, args.profile)
    print(f"# train: phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 13. scoring: W1 against its plain version, the 50NN mesh scored ----
    t0 = time.perf_counter()
    with torch.inference_mode():
        winding_checks(check, results, gen, dev, mesh, sass, args.w1_baseline)
    with tempfile.TemporaryDirectory() as tmp:
        scoring_phase(check, results, tmp, mesh, gt)
    if failures:
        fail(f"the scoring phase failed: {failures}")
    print(f"# scoring: phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 14. the campaign: full_run_pps_mini, make_comparison --render ----
    if not args.no_campaign:
        t0 = time.perf_counter()
        campaign_phase(shared.name, names)
        print(f"# campaign: phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    shared.cleanup()

    # ---- 15-19. data parallelism, the sharded field, the profiler preset,
    # POCO training ----
    for number, phase, phase_args in () if args.no_campaign else (
            (15, dp_one_rank_phase, (train_tmp.name, smi)),
            (16, dp_two_ranks_phase, (train_tmp.name, smi)),
            (17, sharded_field_phase, (predictor, variables, cloud, smi)),
            (18, profiler_phase, (train_tmp.name, smi)),
            (19, poco_training_phase, (train_tmp.name, smi))):
        t0 = time.perf_counter()
        phase(*phase_args)
        print(f"# {phase.__name__}: phase {number} took {time.perf_counter() - t0:.1f} s",
              flush=True)
    train_tmp.cleanup()

    # ---- 20. the benchmark twin as its own process; the grower's prefill ----
    t0 = time.perf_counter()
    bench_twin_phase(args)
    prefill_phase(args, predictor, cloud)
    print(f"# benchmark and prefill: phase 20 took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- 21. the engine's mesh and clean phases on the card ----
    t0 = time.perf_counter()
    results["mesh"] = mesh_phase(args, smi)
    results["mesh"]["launches"] = sum(mesh_launches.values())
    print(f"# mesh on the card: phase 21 took {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"# total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [results[k] for k in
                                  PATH_KERNELS + NEW_BUILDS + F32_BUILDS
                                  + tuple(f"extract_{v}" for v in VARIANTS)
                                  + ("winding", "mesh")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
