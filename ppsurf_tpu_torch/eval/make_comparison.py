"""Cross-method comparison of a dataset: assembled metric tables, the
dataset summary, Chamfer-coloured meshes with their renders, and the HTML
gallery.

    python -m ppsurf_tpu_torch.eval.make_comparison --dataset_names D [D ...]
        [--data_dir datasets] [--results_dir results] [--methods M ...]
        [--comp_dir results/comp] [--comp_name comp] [--workers 8]
        [--dist_cut_off 0.03] [--render]

Port of `ppsurf_tpu/eval/make_comparison.py` (reference
`source/make_comparison.py:43-109`), with the same arguments, paths and
outputs, on the port's reports (`eval/reports.py`), its Chamfer colouring
and renderer (`utils/visualization.py`) and its PNG writer. For each
dataset `D` with a `testset.txt`, over the methods with a
`<results_dir>/<method>/D` directory (or `--methods`), it writes
`<comp_dir>/D/{chamfer_distance,iou,normal_error,f1}.csv|.xlsx` (a column
a method), `<comp_dir>/D/comp_mean.csv|.xlsx` (a row a method), with
`--render` the ground truth, input cloud and Chamfer-coloured renders
(`<comp_dir>/D/renders/{gt,pc}/<shape>.png`,
`<results_dir>/<method>/D/cd_vis/<shape>.xyz.ply|.npz` and
`cd_vis_renders/<shape>.png`), and
`<comp_dir>/reports/<comp_name>_D.html`. Host work only: nothing here
runs on the card.
"""
from __future__ import annotations

import argparse
import os
import typing

import numpy as np

from ppsurf_tpu_torch.data.datasets import read_shape_list
from ppsurf_tpu_torch.eval.reports import (
    assemble_quantitative_comparison,
    make_dataset_comparison,
    make_html_report,
    read_metrics_table,
)
from ppsurf_tpu_torch.utils.visualization import visualize_chamfer_distance_pool


def comparison_main(
    data_dir: str,
    results_dir: str,
    dataset: str,
    workers: int = 8,
    dist_cut_off: float = 0.03,
    comp_name: str = "comp",
    comp_dir: str = "results/comp",
    html_name: str = "comp_all.html",
    methods: typing.Optional[typing.Sequence[str]] = None,
    render: bool = True,
) -> None:
    """Compare `methods` (default: every results directory holding
    `dataset`) on one dataset; renders are skipped where up to date."""
    in_file = os.path.join(data_dir, dataset, "testset.txt")
    if not os.path.isfile(in_file):
        print(f"skip {dataset}: no testset")
        return
    shape_names = read_shape_list(in_file)
    gt_dir = os.path.join(data_dir, dataset, "03_meshes")

    if methods is None:
        methods = sorted(d for d in os.listdir(results_dir)
                         if os.path.isdir(os.path.join(results_dir, d, dataset)))

    comp_ds_dir = os.path.join(comp_dir, dataset)
    os.makedirs(comp_ds_dir, exist_ok=True)

    templates = [os.path.join(results_dir, m, dataset, "{}.xlsx") for m in methods]
    assemble_quantitative_comparison(comp_ds_dir, templates)

    reports = [[os.path.join(results_dir, m, dataset, f"{metric}.xlsx")
                for metric in ("chamfer_distance", "iou", "normal_error", "f1")]
               for m in methods]
    make_dataset_comparison(reports, os.path.join(comp_ds_dir, "comp_mean.xlsx"))

    renders: typing.Optional[dict] = None
    pc_renders = gt_renders = None
    if render:
        from ppsurf_tpu_torch.utils.visualization import render_meshes

        gts = [os.path.join(gt_dir, f"{n}.ply") for n in shape_names]
        gt_renders = [os.path.join(comp_ds_dir, "renders", "gt", f"{n}.png")
                      for n in shape_names]
        render_meshes(gts, gt_renders, workers)

        pc_dir = os.path.join(data_dir, dataset, "04_pts_vis")
        pcs = [os.path.join(pc_dir, f"{n}.xyz.ply") for n in shape_names]
        if not all(os.path.isfile(p) for p in pcs):
            pcs = [os.path.join(pc_dir, f"{n}.ply") for n in shape_names]
        pc_renders = [os.path.join(comp_ds_dir, "renders", "pc", f"{n}.png")
                      for n in shape_names]
        render_meshes(pcs, pc_renders, workers)

        renders = {}
        for m in methods:
            rec_dir = os.path.join(results_dir, m, dataset, "meshes")
            out_dir = os.path.join(results_dir, m, dataset, "cd_vis")
            recs = [os.path.join(rec_dir, f"{n}.xyz.ply") for n in shape_names]
            outs = [os.path.join(out_dir, f"{n}.xyz.ply") for n in shape_names]
            visualize_chamfer_distance_pool(recs, gts, outs, dist_cut_off, workers)
            pngs = [os.path.join(results_dir, m, dataset, "cd_vis_renders", f"{n}.png")
                    for n in shape_names]
            render_meshes([o for o in outs if os.path.isfile(o)],
                          [p for o, p in zip(outs, pngs) if os.path.isfile(o)], workers)
            for n, p in zip(shape_names, pngs):
                if os.path.isfile(p):
                    renders[(m, n)] = p

    def metric_matrix(metric_file: str) -> np.ndarray:
        """(methods, shapes): each method's first column, NaN where its
        table is missing or empty."""
        rows = []
        for m in methods:
            try:
                table = read_metrics_table(os.path.join(results_dir, m, dataset, metric_file))
            except FileNotFoundError:
                table = None
            rows.append(table.values(0) if table and table.header
                        else np.full(len(shape_names), np.nan))
        return np.asarray(rows)

    make_html_report(
        os.path.join(comp_dir, "reports", html_name.replace(".html", f"_{dataset}.html")),
        comp_name=f"{comp_name} — {dataset}",
        shape_names=shape_names,
        methods=list(methods),
        metrics_cd=metric_matrix("chamfer_distance.xlsx"),
        metrics_iou=metric_matrix("iou.xlsx"),
        metrics_nc=metric_matrix("normal_error.xlsx"),
        renders=renders,
        pc_renders=pc_renders,
        gt_renders=gt_renders,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="datasets")
    parser.add_argument("--results_dir", type=str, default="results")
    parser.add_argument("--dataset_names", type=str, nargs="+", required=True)
    parser.add_argument("--methods", type=str, nargs="*", default=None)
    parser.add_argument("--comp_dir", type=str, default="results/comp")
    parser.add_argument("--comp_name", type=str, default="comp")
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--dist_cut_off", type=float, default=0.03)
    parser.add_argument("--render", action="store_true")
    args = parser.parse_args(argv)

    for dataset in args.dataset_names:
        comparison_main(
            data_dir=args.data_dir,
            results_dir=args.results_dir,
            dataset=dataset,
            workers=args.workers,
            dist_cut_off=args.dist_cut_off,
            comp_name=args.comp_name,
            comp_dir=args.comp_dir,
            methods=args.methods,
            render=args.render,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
