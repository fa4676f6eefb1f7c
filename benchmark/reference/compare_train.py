"""The comparison that decides `correct` for training cells.

The plain float32 reference (`train_plain.py`) follows the program's
first steps from the same initial weights, dataset and seeds. Leaves
count where the reference's first gradient is at least a thousandth of
the median leaf's (a bias before a BatchNorm has a gradient of nought in
exact arithmetic, which only round-off moves). Three numbers are
compared, each steady from seed to seed:

- `loss_gap`: the first step's loss, |program - reference| / reference;
- `grad_gap`: the first step's gradient, by the median counted leaf: the
  gap between the program's norm of the leaf and the reference's, over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger;
- `change_gap`: the parameters' change over the steps, by the median
  counted leaf, in the same measure.

Reported beside them, not compared: the loss gap of every step
(`loss_gap_steps`, the largest), and the worst counted leaf of the
gradient and of the change (`grad_gap_worst`, `change_gap_worst`, with
the leaves' names). Those swing from seed to seed in sound runs: after a
step, AdamW moves every element by about the learning rate whatever its
size, so the elements that round-off decides (the FKAConv kernel nets
behind their instance norms) send the two sides apart.
"""
from __future__ import annotations

import typing

import torch

from benchmark.reference import train_plain


def gaps(prog: dict, ref: dict, p0: typing.Dict[str, torch.Tensor]) -> typing.Dict[str, float]:
    """prog/ref: `losses`, `first_grad` {leaf: tensor}, and the parameters
    after the steps (`p_end` / `params`)."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    leaves = sorted(ref["first_grad"])
    gr = torch.stack([ref["first_grad"][k].float().norm() for k in leaves])
    gp = torch.stack([prog["first_grad"][k].float().to(gr.device).norm() for k in leaves])
    med_g = gr.median()
    counted = gr >= 1e-3 * med_g
    grad = ((gp - gr).abs() / torch.maximum(gr, med_g))[counted]
    dr = torch.stack([(ref["params"][k] - p0[k]).float().norm() for k in leaves])
    dp = torch.stack([(prog["p_end"][k].to(dr.device) - p0[k]).float().norm() for k in leaves])
    dr, dp = dr[counted], dp[counted]
    change = (dp - dr).abs() / torch.maximum(dr, dr.median())
    names = [k for k, c in zip(leaves, counted.tolist()) if c]
    return dict(loss_gap=float(steps[0]), grad_gap=float(grad.median()),
                change_gap=float(change.median()), loss_gap_steps=float(max(steps)),
                grad_gap_worst=float(grad.max()), change_gap_worst=float(change.max()),
                grad_worst=names[int(torch.argmax(grad))],
                change_worst=names[int(torch.argmax(change))],
                leaves=len(leaves), leaves_counted=int(counted.sum()))


def reference_steps(config: dict, mix: dict, flat: dict, shapes, seeds: dict, device,
                    q=lambda x: x, half_batch: bool = False) -> dict:
    """The reference's (or the control's, with a rounding `q`) first
    `check_steps` steps."""
    steps = train_plain.batches(shapes, int(mix["batch_size"]), seeds["shuffle"],
                                seeds["data"], int(mix["manifold_points"]),
                                int(mix["check_steps"]))
    return train_plain.train_steps(flat, config, steps, seeds["generator"], float(mix["lr"]),
                                   float(mix["weight_decay"]), device, q, half_batch)


def numbers(config: dict, mix: dict, flat: dict, shapes, seeds: dict, device, prog: dict,
            log) -> typing.Dict[str, float]:
    ref = reference_steps(config, mix, flat, shapes, seeds, device)
    g = gaps(prog, ref, prog["p0"])
    log(f"# reference losses {ref['losses']}; program {prog['losses']}")
    log("# checked steps: " + " ".join(f"{k}={v}" for k, v in g.items()))
    return g
