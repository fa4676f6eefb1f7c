"""Run a tiny cell on the CPU with a fault planted under the timed path.

    python benchmark/tests/drive_tiny.py <config|train> <fault> <seed>

`config` names a reconstruction configuration (its tiny cell), `train`
the tiny training cell. Faults of reconstruction: refine_unchanged (the
bisection hands its vertices back unmoved), half_batch (the field
computes the first half of each call and gives the rest the first half's
mean), altered_answer (every 64th field value of a call negated),
grow_half (the grower's volume holds no value past the middle of its
first axis, as if it never reached that half of the surface), grow_shift
(the grower's values land one voxel off along the first axis),
mc_faces (marching cubes gives every 8th face a corner from a face half
the list away). Faults
of training: state_unchanged (the optimizer's step leaves the weights as
they are), half_batch (the loss's mean over the first half of the batch
only). `none` plants nothing. The run's own code does the rest: the
window, the reference, the checks, the last line.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.tests.conftest import tiny_cell, tiny_train_cell  # noqa: E402


def plant(fault: str, train: bool = False) -> None:
    if fault == "none":
        return
    if train:
        from ppsurf_tpu_torch.train import loop

        if fault == "state_unchanged":
            loop.torch.optim.AdamW.step = lambda self, closure=None: None
        elif fault == "half_batch":
            ce = loop.cross_entropy_loss

            def half(logits, occ):
                b = logits.shape[0]
                return ce(logits[: b // 2], occ[: b // 2])

            loop.cross_entropy_loss = half
        else:
            raise ValueError(fault)
        return
    from ppsurf_tpu_torch.recon import engine
    from ppsurf_tpu_torch.recon.field import FieldEvaluator

    call = FieldEvaluator.__call__
    grow, mc = engine.create_volume_region_growing, engine.marching_cubes
    if fault in ("grow_half", "grow_shift"):
        def grown(*a, **k):
            volume, step, bmin_pad = grow(*a, **k)
            if fault == "grow_half":
                volume[volume.shape[0] // 2: -1] = np.nan
            else:
                volume = np.roll(volume, 1, axis=0)
            return volume, step, bmin_pad
        engine.create_volume_region_growing = grown
        return
    if fault == "mc_faces":
        def cubes(volume, level):
            verts, faces = mc(volume, level)
            faces = faces.copy()
            rows = np.arange(0, faces.shape[0], 8)
            faces[rows, 2] = faces[(rows + faces.shape[0] // 2) % faces.shape[0], 2]
            return verts, faces
        engine.marching_cubes = cubes
        return
    if fault == "refine_unchanged":
        FieldEvaluator.refine_bisection = lambda self, v, *a, **k: np.asarray(v, np.float32)
    elif fault == "half_batch":
        def half(self, q):
            m = q.shape[0]
            out = np.empty((m,), np.float32)
            out[: (m + 1) // 2] = call(self, q[: (m + 1) // 2])
            out[(m + 1) // 2:] = out[: (m + 1) // 2].mean()
            return out
        FieldEvaluator.__call__ = half
    elif fault == "altered_answer":
        def altered(self, q):
            out = call(self, q).copy()
            out[::64] = -out[::64]
            return out
        FieldEvaluator.__call__ = altered
    else:
        raise ValueError(fault)


if __name__ == "__main__":
    config, fault, seed = sys.argv[1], sys.argv[2], sys.argv[3]
    train = config == "train"
    plant(fault, train)
    cell = tiny_train_cell() if train else tiny_cell(config)
    sys.exit(run.main(["--workload", "tiny", "--seed", seed, "--seconds", "0", "--trace", "0"],
                      cell=cell, device=torch.device("cpu")))
