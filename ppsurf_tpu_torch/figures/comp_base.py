"""The comparison run shared by the `comp_*.py` figure configurations.

Port of `ppsurf_tpu/figures/comp_base.py` (reference
`source/figures/comp_*.py`, `evaluation.py:549-604` merge_comps) without
pandas: `run_comparison` runs `eval/make_comparison.comparison_main` over
a set of datasets and methods, then `merge_comps` stacks the datasets'
`comp_mean` tables into `<comp_dir>/reports/<name>.csv|.xlsx` with a
Dataset column, and its LaTeX into `<name>.tex`, as the JAX package
writes them.
"""
from __future__ import annotations

import os
import typing

from ppsurf_tpu_torch.eval.make_comparison import comparison_main
from ppsurf_tpu_torch.eval.reports import concat_rows, latex_table, read_metrics_table, write_table


def run_comparison(
    name: str,
    datasets: typing.Sequence[str],
    methods: typing.Optional[typing.Sequence[str]] = None,
    data_dir: str = "datasets",
    results_dir: str = "results",
    comp_dir: str = "results/comp",
    workers: int = 8,
    render: bool = True,
) -> None:
    """Compare `methods` on each dataset (a dataset whose comparison fails
    is reported and skipped, as the reference's figure scripts do), then
    merge the summaries."""
    for dataset in datasets:
        try:
            comparison_main(
                data_dir=data_dir, results_dir=results_dir, dataset=dataset,
                workers=workers, comp_name=name, comp_dir=comp_dir,
                methods=methods, html_name=f"{name}.html", render=render,
            )
        except Exception as exc:
            print(f"comparison failed for {dataset}: {exc}")
    merge_comps(name, datasets, comp_dir)


def merge_comps(
    name: str, datasets: typing.Sequence[str], comp_dir: str = "results/comp"
) -> typing.Optional[str]:
    """The datasets' `comp_mean` tables one after the other, each row led
    by its dataset, as `<comp_dir>/reports/<name>.csv|.xlsx` and `.tex`;
    returns the CSV path, or None where no dataset has a summary."""
    tables = []
    for dataset in datasets:
        try:
            table = read_metrics_table(os.path.join(comp_dir, dataset, "comp_mean.xlsx"))
        except FileNotFoundError:
            continue
        table.header.insert(0, "Dataset")
        table.numeric.insert(0, False)
        for row in table.rows:
            row.insert(0, dataset)
        tables.append(table)
    if not tables:
        return None
    merged = concat_rows(tables)
    written = write_table(merged, os.path.join(comp_dir, "reports", f"{name}.xlsx"),
                          add_stats=False)
    with open(os.path.join(comp_dir, "reports", f"{name}.tex"), "w") as fp:
        fp.write(latex_table(merged, "%.3f"))
    return written
