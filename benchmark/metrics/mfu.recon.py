"""The whole object's share of the card's peak: the operations of every
object of the window (encoder passes, the latents' fold, every field
query; `yardstick/opcount.py::object_flops`) over the window's seconds
and the peak of the configuration's precision, in percent."""
from benchmark.yardstick import opcount


def read(run):
    if not run.objects or run.window_s <= 0:
        return None
    ops = sum(opcount.object_flops(run.config, o["points"], o["queries"])
              for o in run.objects)
    return 100.0 * ops / (run.window_s * opcount.peak_ops(run.config))
