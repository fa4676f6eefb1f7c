"""Quantitative reports without pandas: the per-shape metric tables with
stat rows, the cross-method comparisons, their LaTeX and the HTML gallery.

Port of `ppsurf_tpu/eval/reports.py` (reference
`source/base/evaluation.py:32-604`). The JAX package holds its tables in
pandas DataFrames; the machine the port runs on has no pandas, so a
table here is a `Table` (column names, row names, rows of cells and which
columns pandas would hold as numbers), and every writer lays its file out
as pandas writes the JAX package's, byte for byte:
- CSV as `DataFrame.to_csv` (index column first, floats as their
  shortest repr, NaN and missing cells empty), through the standard
  library's `csv` module, and read back with pandas' float parsing; for an
  `.xlsx` name also the `.xlsx`, through
  the first-party writer (`eval/xlsx.py`);
- the AVERAGE/MEDIAN/STDEV rows over the numeric columns, skipping NaN as
  pandas' mean, median and std (ddof 1) do;
- LaTeX as `DataFrame.to_latex(float_format=...)` (booktabs rules, `l` for
  the index and text columns, `r` for numeric ones, the index's name on a
  row of its own, NaN as `NaN`, no escaping);
- outer joins of tables as `pd.concat` makes them (row or column names in
  order of first appearance).
`make_test_report` writes the `test` report; `make_quantitative_comparison`
the four mesh-metric tables of a set of methods; `make_dataset_comparison`,
`assemble_quantitative_comparison`, `table_to_latex` and
`make_html_report` the reports of `eval/make_comparison.py`.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import re
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


def _fmt(v) -> str:
    """A CSV cell as `DataFrame.to_csv` writes it."""
    if v is None:
        return ""
    if isinstance(v, str):
        return v
    return "" if v != v else repr(float(v))


Cell = typing.Union[float, str, None]


@dataclasses.dataclass
class Table:
    """A table as the JAX package's DataFrame holds it: `header` the column
    names, `index` the row names, `rows` the cells (floats with NaN, None
    for an empty spreadsheet cell, or text), `numeric` whether pandas holds
    each column as numbers (a column of text, or one read from a
    spreadsheet with every cell empty, is held as objects) and
    `index_name` the index's name (None where pandas has none)."""

    header: typing.List[str]
    index: typing.List[str]
    rows: typing.List[typing.List[Cell]]
    numeric: typing.List[bool]
    index_name: typing.Optional[str] = None

    def values(self, c: int) -> np.ndarray:
        """Column c as float64, None as NaN."""
        return np.array([np.nan if row[c] is None else row[c] for row in self.rows], np.float64)


def _numeric(cells: typing.Sequence[Cell]) -> bool:
    """pandas' dtype of a column built from these cells: numbers unless
    some cell is text or none is a number (every cell None, or no rows)."""
    return (not any(isinstance(v, str) for v in cells)
            and any(v is not None for v in cells))


def write_table(table: Table, output_file: str,
                low_metrics_better: typing.Union[None, bool, typing.Sequence[bool]] = True,
                add_stats: bool = True) -> str:
    """Write `table` with stat rows (over its numeric columns; NaN in the
    others) as `<output_file>.csv`, and for an `.xlsx` name also as `.xlsx`
    (text and empty cells left blank); returns the CSV path."""
    rows = [list(r) for r in table.rows]
    names = [str(i) for i in table.index]
    if add_stats:
        stats = np.array([_stats(table.values(c)) if table.numeric[c] else [np.nan] * 3
                          for c in range(len(table.header))]).reshape(-1, 3).T
        rows += [[float(v) for v in row] for row in stats]
        names += list(STAT_ROWS)

    csv_file = _csv_path(output_file)
    os.makedirs(os.path.dirname(os.path.abspath(csv_file)), exist_ok=True)
    with open(csv_file, "w", newline="") as fp:
        writer = csv.writer(fp, lineterminator="\n")
        writer.writerow([table.index_name or ""] + [str(h) for h in table.header])
        for name, row in zip(names, rows):
            writer.writerow([name] + [_fmt(v) for v in row])

    if output_file.endswith(".xlsx"):
        from ppsurf_tpu_torch.eval.xlsx import write_xlsx

        cells = [[v if isinstance(v, float) else float("nan") for v in row] for row in rows]
        write_xlsx(output_file, header=[str(h) for h in table.header], index=names, rows=cells,
                   low_metrics_better=low_metrics_better, color_rows=len(table.rows))
    return csv_file


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
    data = np.asarray(data, np.float64).reshape(len(index), len(header))
    table = Table(header=[str(h) for h in header], index=[str(i) for i in index],
                  rows=[[float(v) for v in row] for row in data],
                  numeric=[True] * len(header), index_name=index_name or None)
    return write_table(table, output_file, low_metrics_better, add_stats)


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


_DECIMAL = re.compile(r"([+-]?)(\d+)(?:\.(\d*))?(?:[eE]([+-]?\d+))?")


def _pandas_float(text: str) -> float:
    """A decimal number as pandas' C parser reads it (`precise_xstrtod`,
    its default): up to 17 significant digits gathered into a double, then
    scaled once by a power of ten. That is not always the correctly
    rounded value (`float(text)`), so the port reads as pandas does."""
    m = _DECIMAL.fullmatch(text.strip())
    if m is None:
        return float(text)  # nan, inf and other spellings
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    used = 0
    for ch in frac or "":
        if digits >= 17:
            break
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        used += 1
    exponent -= used
    if sign == "-":
        number = -number
    exponent += int(exp or 0)
    if exponent > 308:
        return float("inf") if number > 0 else (-float("inf") if number < 0 else number)
    if exponent > 0:
        return number * float(f"1e{exponent}")
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / float(f"1e{-308 - exponent}") / 1e308
    return number / float(f"1e{-exponent}")



def _read_csv(path: str) -> Table:
    """A CSV as `pd.read_csv(path, header=0, index_col=0)` reads it: an
    empty cell is NaN, a column with any cell that is not a number is held
    as text."""
    with open(path, newline="") as fp:
        lines = list(csv.reader(fp))
    head, body = lines[0], [line for line in lines[1:] if line]
    header, index = head[1:], [line[0] for line in body]
    columns = [[line[c] if c < len(line) else "" for line in body]
               for c in range(1, len(head))]
    numeric, parsed = [], []
    for col in columns:
        try:
            vals = [_pandas_float(v) if v else float("nan") for v in col]
            numeric.append(True)
        except ValueError:
            vals = [v if v else float("nan") for v in col]
            numeric.append(False)
        parsed.append(vals)
    rows = [[parsed[c][r] for c in range(len(header))] for r in range(len(index))]
    return Table(header, index, rows, numeric, head[0] or None)


def read_metrics_table(path: str) -> Table:
    """A table written by `write_table` (.xlsx where that file exists, else
    its .csv twin) without its stat rows; FileNotFoundError where neither
    exists. A spreadsheet's index has no name, as pandas reads it."""
    if not os.path.isfile(path):
        path_csv = _csv_path(path)
        if os.path.isfile(path_csv):
            path = path_csv
        else:
            raise FileNotFoundError(path)
    if path.endswith(".xlsx"):
        from ppsurf_tpu_torch.eval.xlsx import read_xlsx

        header, index, rows = read_xlsx(path)
        table = Table([str(h) for h in header], [str(i) for i in index], rows,
                      [_numeric([row[c] for row in rows]) for c in range(len(header))])
    else:
        table = _read_csv(path)
    drop = {"AVG", "AVERAGE", "MEAN", "MEDIAN", "STDEV.P", "STDEV"}
    keep = [r for r, name in enumerate(table.index) if name not in drop]
    table.index = [table.index[r] for r in keep]
    table.rows = [table.rows[r] for r in keep]
    return table


def _union(names: typing.Iterable[typing.Sequence[str]]) -> typing.List[str]:
    """Names in order of first appearance (pandas' outer join, unsorted)."""
    out: typing.Dict[str, None] = {}
    for seq in names:
        out.update(dict.fromkeys(seq))
    return list(out)


def concat_columns(tables: typing.Sequence[Table]) -> Table:
    """`pd.concat(frames, axis=1)`: the columns side by side over the union
    of the row names, NaN where a table lacks a row."""
    index = _union(t.index for t in tables)
    names = {t.index_name for t in tables}
    rows: typing.List[typing.List[Cell]] = [[] for _ in index]
    for t in tables:
        at = {name: r for r, name in enumerate(t.index)}
        for i, name in enumerate(index):
            rows[i] += t.rows[at[name]] if name in at else [float("nan")] * len(t.header)
    return Table([h for t in tables for h in t.header], index, rows,
                 [n for t in tables for n in t.numeric],
                 names.pop() if len(names) == 1 else None)


def concat_rows(tables: typing.Sequence[Table]) -> Table:
    """`pd.concat(frames, axis=0)`: the rows one after the other over the
    union of the columns, NaN where a table lacks a column; a column is
    numeric where every table that has it holds it as numbers."""
    header = _union(t.header for t in tables)
    rows, numeric = [], {h: True for h in header}
    for t in tables:
        at = {h: c for c, h in enumerate(t.header)}
        for h, c in at.items():
            numeric[h] &= t.numeric[c]
        rows += [[row[at[h]] if h in at else float("nan") for h in header] for row in t.rows]
    names = {t.index_name for t in tables}
    return Table(header, [i for t in tables for i in t.index], rows,
                 [numeric[h] for h in header], names.pop() if len(names) == 1 else None)


def _sort_descending(keys: np.ndarray) -> np.ndarray:
    """`sort_values(ascending=False)`'s order (pandas' `nargsort`): the
    non-NaN keys reversed, sorted with numpy's default sort, the result
    reversed, then the NaN rows in their order."""
    idx = np.arange(keys.size)
    mask = np.isnan(keys)
    non_nans, non_nan_idx = keys[~mask][::-1], idx[~mask][::-1]
    order = non_nan_idx[non_nans.argsort(kind="quicksort")][::-1]
    return np.concatenate([order, np.nonzero(mask)[0]])


def make_dataset_comparison(
    results_reports: typing.Sequence[typing.Sequence[str]], output_file: str
) -> str:
    """A row a method: mean, median and stdev of each of its metric tables
    (NaN where a table is missing), or the means of a test report's
    columns and its shape count; sorted by mean Chamfer distance,
    largest first (reference `evaluation.py:364-422`)."""
    named_rows = []
    for reports_model in results_reports:
        row: typing.Dict[str, float] = {}
        model_name = None
        for report_file in reports_model:
            metrics_type = os.path.splitext(os.path.basename(report_file))[0]
            try:
                table = read_metrics_table(report_file)
            except FileNotFoundError:
                model_name = model_name or os.path.basename(
                    os.path.split(os.path.split(report_file)[0])[0])
                for stat in ("Mean", "Median", "Stdev"):
                    row[f"{stat} {metrics_type}"] = float("nan")
                continue
            if len(table.header) == 1:
                model_name = model_name or str(table.header[0])
                mean, median, std = _stats(table.values(0))
                row[f"Mean {metrics_type}"] = mean
                row[f"Median {metrics_type}"] = median
                row[f"Stdev {metrics_type}"] = std
            else:  # a test report: one column a metric
                model_name = model_name or os.path.splitext(
                    os.path.basename(report_file).split("metrics_")[-1])[0]
                row["Count"] = float(len(table.index))
                for c, h in enumerate(table.header):
                    row[str(h)] = _stats(table.values(c))[0]
        named_rows.append((model_name, row))

    header = _union(row.keys() for _, row in named_rows)
    table = Table(header, [str(n) for n, _ in named_rows],
                  [[row.get(h, float("nan")) for h in header] for _, row in named_rows],
                  [True] * len(header), "Model")
    if "Mean chamfer_distance" in header:
        order = _sort_descending(table.values(header.index("Mean chamfer_distance")))
        table.index = [table.index[i] for i in order]
        table.rows = [table.rows[i] for i in order]
    return write_table(table, output_file, add_stats=False)


def assemble_quantitative_comparison(
    comp_output_dir: str,
    report_path_templates: typing.Sequence[str],
    metrics: typing.Sequence[str] = ("chamfer_distance", "iou", "normal_error", "f1"),
) -> typing.Dict[str, str]:
    """Each metric's tables of several methods side by side, a single
    column named after its method's directory, written with stat rows to
    `comp_output_dir/{metric}` (reference `evaluation.py:425-461`)."""
    written = {}
    for metric in metrics:
        tables = []
        for template in report_path_templates:
            path = template.format(metric)
            try:
                table = read_metrics_table(path)
            except FileNotFoundError:
                continue
            if len(table.header) == 1:
                table.header = [os.path.basename(os.path.dirname(os.path.dirname(path)))]
            tables.append(table)
        if not tables:
            continue
        out = os.path.join(comp_output_dir, f"{metric}.xlsx")
        written[metric] = write_table(concat_columns(tables), out, add_stats=True)
    return written


def latex_table(table: Table, float_format: str = "%.3f") -> str:
    """`DataFrame.to_latex(float_format=lambda x: float_format % x)` of the
    table (pandas' booktabs layout, no escaping)."""

    def cell(v: Cell) -> str:
        if isinstance(v, str):
            return v
        return "NaN" if v is None or v != v else float_format % v

    lines = ["\\begin{tabular}{l" + "".join("r" if n else "l" for n in table.numeric) + "}",
             "\\toprule",
             " & ".join([""] + [str(h) for h in table.header]) + " \\\\"]
    if table.index_name:
        lines.append(" & ".join([table.index_name] + [""] * len(table.header)) + " \\\\")
    lines.append("\\midrule")
    lines += [" & ".join([str(name)] + [cell(v) for v in row]) + " \\\\"
              for name, row in zip(table.index, table.rows)]
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    return "\n".join(lines)


def table_to_latex(path: str, output_file: str, float_format: str = "%.3f") -> str:
    """The metrics table at `path` as LaTeX in `output_file`."""
    table = read_metrics_table(path)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with open(output_file, "w") as fp:
        fp.write(latex_table(table, float_format))
    return output_file


def make_html_report(
    report_file_out: str,
    comp_name: str,
    shape_names: typing.Sequence[str],
    methods: typing.Sequence[str],
    metrics_cd: np.ndarray,  # (methods, shapes)
    metrics_iou: np.ndarray,
    metrics_nc: np.ndarray,
    renders: typing.Optional[dict] = None,
    pc_renders: typing.Optional[typing.Sequence[str]] = None,
    gt_renders: typing.Optional[typing.Sequence[str]] = None,
    img_size: int = 300,
) -> str:
    """The qualitative and quantitative HTML gallery (reference
    `evaluation.py:62-206`): a row a shape with sticky name, point-cloud
    and ground-truth columns, then a column a method with its
    Chamfer-coloured render (paths relative to the report) and its CD,
    IoU and NCE; numbers only where renders are absent."""
    report_dir = os.path.dirname(os.path.abspath(report_file_out))

    def rel(p):
        return os.path.relpath(os.path.abspath(p), report_dir).replace("\\", "/")

    def img(path):
        return (f"<img src='{rel(path)}' alt='{os.path.basename(path)}' "
                f"width='{img_size}' height='{img_size}'/>")

    rows = []
    for si, shape in enumerate(shape_names):
        cells = [f"<td class='sticky'>{shape.replace('_', ' ')}</td>"]
        if pc_renders is not None:
            cells.append(f"<td class='sticky'>{img(pc_renders[si])}</td>")
        if gt_renders is not None:
            cells.append(f"<td class='sticky'>{img(gt_renders[si])}</td>")
        for mi, method in enumerate(methods):
            cd = metrics_cd[mi][si]
            iou = metrics_iou[mi][si]
            nc = metrics_nc[mi][si]
            pic = ""
            if renders and (method, shape) in renders:
                pic = img(renders[(method, shape)]) + "<br/>"
            cells.append(f"<td>{pic}CD: {cd * 100.0:.2f}, IoU: {iou:.2f}, NCE: {nc:.2f}</td>")
        rows.append("<tr>" + "".join(cells) + "</tr>")

    heads = ["Shape Name"]
    if pc_renders is not None:
        heads.append("Point Cloud")
    if gt_renders is not None:
        heads.append("GT Object")
    heads += [m.replace("_", " ") for m in methods]
    head_cells = "".join(f"<th>{h}</th>" for h in heads)
    html = f"""<!DOCTYPE html>
<html><head><title>{comp_name}</title>
<style>
 td {{ border: 1px solid #000; vertical-align: top; }}
 table {{ width: 100%; border-collapse: collapse; }}
 th {{ border: 1px solid #000; background: #EEE; position: sticky; top: 0; z-index: 2; }}
 tr:hover {{ background-color: #D6EEEE; }}
 td.sticky {{ position: sticky; left: 0; background: #FFF; z-index: 1; }}
</style></head>
<body><h1>{comp_name}</h1>
<table><tr>{head_cells}</tr>
{''.join(rows)}
</table></body></html>"""
    os.makedirs(report_dir, exist_ok=True)
    with open(report_file_out, "w") as fp:
        fp.write(html)
    return report_file_out
