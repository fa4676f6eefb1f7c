"""The whole training step's share of the card's peak: three times the
forward's operations over the batch (`yardstick/opcount.py::
train_step_flops`) over the seconds a step of the window took and the
peak of the configuration's precision, in percent."""
from benchmark.yardstick import opcount


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    mix = run.mix
    ops = opcount.train_step_flops(run.config, int(mix["batch_size"]),
                                   int(mix["manifold_points"]), int(mix["queries"]))
    return 100.0 * ops * len(run.steps) / (run.window_s * opcount.peak_ops(run.config))
