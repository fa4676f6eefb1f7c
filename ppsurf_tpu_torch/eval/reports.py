"""The `test` report: per-shape metric tables with stat rows, without pandas.

Port of `export_table` and `make_test_report` of
`ppsurf_tpu/eval/reports.py:28-76, 104-144` (reference
`source/base/evaluation.py:209-353`). The table is written as CSV with the
standard library's `csv` module, laid out as pandas' `DataFrame.to_csv`
writes the JAX package's (index column first, floats as their shortest
repr, NaN as an empty cell), and, for an `.xlsx` name, also as `.xlsx`
through the first-party writer. The AVERAGE/MEDIAN/STDEV rows skip NaN,
as pandas' mean, median and std (ddof 1) do. `make_quantitative_comparison`
(`ppsurf_tpu/eval/reports.py:139-171`, reference `evaluation.py:32-59`)
writes the four mesh-metric tables of a set of methods. The reports of
`make_comparison` (dataset comparison, assembly, LaTeX, HTML) stay with
the JAX package.
"""
from __future__ import annotations

import csv
import os
import typing

import numpy as np

from ppsurf_tpu_torch.device import resolve_device
from ppsurf_tpu_torch.metrics.mesh_metrics import get_metric_meshes
from ppsurf_tpu_torch.metrics.winding import Device

STAT_ROWS = ("AVERAGE", "MEDIAN", "STDEV")


def _csv_path(output_file: str) -> str:
    return os.path.splitext(output_file)[0] + ".csv"


def _stats(col: np.ndarray) -> typing.List[float]:
    """mean, median and std (ddof 1) over the non-NaN values, as pandas'
    nanops compute them; NaN where too few values remain."""
    v = col[~np.isnan(col)]
    n = v.size
    if n == 0:
        return [float("nan")] * 3
    mean = v.sum() / n
    std = np.sqrt(((v - mean) ** 2).sum() / (n - 1)) if n > 1 else np.nan
    return [float(mean), float(np.median(v)), float(std)]


def _fmt(v: float) -> str:
    return "" if v != v else repr(float(v))


def export_table(
    header: typing.Sequence[str],
    index: typing.Sequence[str],
    data: np.ndarray,
    output_file: str,
    index_name: str = "",
    low_metrics_better: typing.Union[None, bool, typing.Sequence[bool]] = True,
    add_stats: bool = True,
) -> str:
    """Write a (rows, columns) float table with stat rows; returns the CSV
    path. `output_file` ending in `.xlsx` also writes the `.xlsx`."""
    data = np.asarray(data, np.float64)
    rows = [[float(v) for v in row] for row in data]
    names = [str(i) for i in index]
    if add_stats:
        stats = np.array([_stats(data[:, c]) for c in range(data.shape[1])]).T
        rows += [[float(v) for v in row] for row in stats]
        names += list(STAT_ROWS)

    csv_file = _csv_path(output_file)
    os.makedirs(os.path.dirname(os.path.abspath(csv_file)), exist_ok=True)
    with open(csv_file, "w", newline="") as fp:
        writer = csv.writer(fp, lineterminator="\n")
        writer.writerow([index_name] + [str(h) for h in header])
        for name, row in zip(names, rows):
            writer.writerow([name] + [_fmt(v) for v in row])

    if output_file.endswith(".xlsx"):
        from ppsurf_tpu_torch.eval.xlsx import write_xlsx

        write_xlsx(output_file, header=[str(h) for h in header], index=names, rows=rows,
                   low_metrics_better=low_metrics_better, color_rows=data.shape[0])
    return csv_file


def make_test_report(
    shape_names: typing.Sequence[str],
    results: typing.Dict[str, np.ndarray],
    output_file: str,
    output_names: typing.Sequence[str],
) -> typing.Tuple[float, float, float]:
    """Per-shape test table -> (loss_mean, rmse_mean, f1_mean).

    `results` maps 'loss', 'loss_components_mean', 'abs_dist_rms',
    'accuracy', 'precision', 'recall' and 'f1_score' to per-shape arrays.
    """
    metrics_keys = ["abs_dist_rms", "accuracy", "precision", "recall", "f1_score"]
    headers = ["Loss total"] + list(output_names) + metrics_keys

    loss_total = np.asarray(results["loss"], np.float64)
    loss_components = np.asarray(results["loss_components_mean"], np.float64)
    if loss_components.ndim == 1:
        loss_components = loss_components[:, None]
    metrics = np.stack([np.asarray(results[k], np.float64) for k in metrics_keys], axis=1)

    data = np.concatenate([loss_total[:, None], loss_components, metrics], axis=1)
    export_table(headers, shape_names, data, output_file, index_name="Shape")
    return (
        float(np.mean(loss_total)),
        float(np.nanmean(metrics[:, 0])),
        float(np.nanmean(metrics[:, -1])),
    )


# metric -> table file; every table takes the default color scale (lower is
# better), as the JAX package writes them
_METRIC_FILES = {
    "chamfer": "chamfer_distance.xlsx",
    "f1": "f1.xlsx",
    "iou": "iou.xlsx",
    "normals": "normal_error.xlsx",
}


def make_quantitative_comparison(
    shape_names: typing.Sequence[str],
    gt_mesh_files: typing.Sequence[str],
    result_headers: typing.Sequence[str],
    result_file_templates: typing.Sequence[str],
    comp_output_dir: str,
    num_samples: int = 10000,
    num_processes: int = 0,
    device: Device = None,
) -> typing.Dict[str, str]:
    """Chamfer, F1, IoU and normal-error tables (a column per method, a row
    per shape, `.csv` and `.xlsx`) in `comp_output_dir`; metric -> CSV path.
    The inside/outside tests of IoU and F1 run on `device`."""
    device = resolve_device(device)
    written = {}
    for metric, file_name in _METRIC_FILES.items():
        values = get_metric_meshes(
            result_file_template=result_file_templates,
            shape_list=shape_names,
            gt_mesh_files=gt_mesh_files,
            num_samples=num_samples,
            metric=metric,
            device=device,
        )
        arr = np.asarray(values, np.float64).T  # (shapes, methods)
        out = os.path.join(comp_output_dir, file_name)
        written[metric] = export_table(result_headers, shape_names, arr, out,
                                       index_name="Shape")
    return written
