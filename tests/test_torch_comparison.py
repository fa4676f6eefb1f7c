"""The port's comparison layer against the JAX package's on the CPU.

Inputs are made from a seed with numpy and written by the JAX package's
`export_table` (pandas); the same files go through the JAX function and
its port (`ppsurf_tpu_torch/eval/reports.py`, `eval/make_comparison.py`),
and what each writes is compared: CSV, LaTeX and HTML byte for byte,
spreadsheets cell for cell (their zip members carry a time stamp), PLY
bytes, `.npz` arrays, and PNG pixels (the JAX package's PNG read with
PIL, here in the test only; the port writes its PNGs without PIL).
"""
from __future__ import annotations

import filecmp
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from ppsurf_tpu.eval import make_comparison as jcomp
from ppsurf_tpu.eval import reports as jrep
from ppsurf_tpu_torch.eval import make_comparison as pcomp
from ppsurf_tpu_torch.eval import reports as prep
from ppsurf_tpu_torch.eval.xlsx import read_xlsx
from tests.test_eval_drivers import synthetic_tree  # noqa: F401  (a fixture)
from tests.test_mesh_metrics import make_sphere_mesh

METRICS = ("chamfer_distance", "iou", "normal_error", "f1")


def _frame(values, columns, index, index_name="Shape"):
    df = pd.DataFrame(np.asarray(values, np.float64), columns=list(columns), index=list(index))
    df.index.name = index_name
    return df


def _same_tree(a: str, b: str, png=True) -> int:
    """Every file under `a` equals its twin under `b` (PNG: pixels,
    .xlsx: cells, .npz: arrays); the number of files compared."""
    from PIL import Image

    from ppsurf_tpu_torch.utils.png import read_png

    def files(root):
        return sorted(os.path.relpath(os.path.join(r, f), root)
                      for r, _, fs in os.walk(root) for f in fs)

    assert files(a) == files(b)
    for rel in files(a):
        fa, fb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            assert png
            want = np.asarray(Image.open(fa).convert("RGB"))
            np.testing.assert_array_equal(read_png(fb), want, err_msg=rel)
        elif rel.endswith(".xlsx"):
            assert read_xlsx(fa) == read_xlsx(fb) or _nan_equal(read_xlsx(fa), read_xlsx(fb)), rel
        elif rel.endswith(".npz"):
            za, zb = np.load(fa), np.load(fb)
            assert sorted(za.files) == sorted(zb.files), rel
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=rel)
        else:
            assert filecmp.cmp(fa, fb, shallow=False), (rel, open(fa, "rb").read()[:400],
                                                        open(fb, "rb").read()[:400])
    return len(files(a))


def _nan_equal(x, y) -> bool:
    return repr(x).replace("nan", "N") == repr(y).replace("nan", "N")


def _method_tables(results: str, method: str, dataset: str, values: np.ndarray, shapes,
                   header: str) -> None:
    """A method's four metric tables as the JAX package's `predict` writes
    them (`.xlsx` and `.csv`), one column named `header`."""
    for metric, col in zip(METRICS, values.T):
        jrep.export_table(_frame(col[:, None], [header], shapes),
                          os.path.join(results, method, dataset, f"{metric}.xlsx"))


@pytest.fixture()
def report_inputs(tmp_path):
    """Metric tables of four methods: one complete, one with NaN and
    negative values, one missing a table, one test report with several
    columns; equal means for a tie in the sort."""
    rng = np.random.default_rng(0)
    root = str(tmp_path / "in")
    shapes = ["shape_a", "shape_b", "shape_c"]
    full = rng.random((3, 4))
    _method_tables(root, "m_full", "ds", full, shapes, "m_full")
    holes = -rng.random((3, 4))
    holes[1, :2] = np.nan
    _method_tables(root, "m_holes", "ds", holes, shapes, "ppsurf_holes")
    _method_tables(root, "m_tie", "ds", full.copy(), shapes, "m_tie")
    os.remove(os.path.join(root, "m_tie", "ds", "iou.xlsx"))
    os.remove(os.path.join(root, "m_tie", "ds", "iou.csv"))
    jrep.export_table(_frame(rng.random((3, 3)), ["Loss total", "f1_score", "accuracy"], shapes),
                      os.path.join(root, "m_test", "ds", "metrics_m_test.xlsx"))
    return root, shapes


def _both(tmp_path, src):
    """Two copies of `src`: (for the JAX package, for the port)."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    skip = shutil.ignore_patterns("jax", "port")  # where `src` is tmp_path itself
    shutil.copytree(src, a, ignore=skip)
    shutil.copytree(src, b, ignore=skip)
    return a, b


@pytest.mark.parametrize("ext", [".xlsx", ".csv"])
def test_read_metrics_table_matches_pandas(report_inputs, ext):
    root, shapes = report_inputs
    for method in ("m_full", "m_holes"):
        path = os.path.join(root, method, "ds", "iou" + ext)
        theirs = jrep.read_metrics_table(path)
        ours = prep.read_metrics_table(path)
        assert ours.header == [str(c) for c in theirs.columns]
        assert ours.index == [str(i) for i in theirs.index] == shapes
        assert ours.index_name == theirs.index.name
        np.testing.assert_array_equal(ours.values(0), theirs.iloc[:, 0].to_numpy(np.float64))
    with pytest.raises(FileNotFoundError):
        prep.read_metrics_table(os.path.join(root, "m_tie", "ds", "iou.xlsx"))


def test_make_dataset_comparison_writes_the_same_table(report_inputs, tmp_path):
    root, _ = report_inputs
    a, b = _both(tmp_path, root)
    for base, fn in ((a, jrep.make_dataset_comparison), (b, prep.make_dataset_comparison)):
        reports = [[os.path.join(base, m, "ds", f"{metric}.xlsx") for metric in METRICS]
                   for m in ("m_full", "m_holes", "m_tie", "m_missing")]
        reports.append([os.path.join(base, "m_test", "ds", "metrics_m_test.xlsx")])
        fn(reports, os.path.join(base, "comp", "comp_mean.xlsx"))
    assert _same_tree(os.path.join(a, "comp"), os.path.join(b, "comp")) == 2
    with open(os.path.join(b, "comp", "comp_mean.csv")) as fp:
        rows = [line.split(",")[0] for line in fp]
    # sorted by mean Chamfer distance, largest first; a method without it last
    assert rows[0] == "Model" and rows[-1] in ("m_missing", "m_test")


def test_assemble_quantitative_comparison_writes_the_same_tables(report_inputs, tmp_path):
    root, shapes = report_inputs
    # a method with other shapes: the outer join of the rows
    jrep.export_table(_frame(np.arange(4.0).reshape(2, 2)[:, :1], ["m_other"],
                             ["shape_c", "shape_d"]),
                      os.path.join(root, "m_other", "ds", "iou.xlsx"))
    a, b = _both(tmp_path, root)
    for base, fn in ((a, jrep.assemble_quantitative_comparison),
                     (b, prep.assemble_quantitative_comparison)):
        templates = [os.path.join(base, m, "ds", "{}.xlsx")
                     for m in ("m_full", "m_holes", "m_tie", "m_other", "m_missing")]
        fn(os.path.join(base, "comp"), templates)
    assert _same_tree(os.path.join(a, "comp"), os.path.join(b, "comp")) == 8
    with open(os.path.join(b, "comp", "iou.csv")) as fp:
        assert [line.split(",")[0] for line in fp][1:5] == shapes + ["shape_d"]


@pytest.mark.parametrize("case", ["xlsx", "csv_with_text", "nan_negative"])
def test_table_to_latex_matches_to_latex(tmp_path, case):
    rng = np.random.default_rng(1)
    df = _frame(rng.normal(size=(3, 3)), ["Mean chamfer_distance", "f1_score", "x"],
                ["ppsurf_50nn", "poco_mini", "m_3"], "Model")
    if case == "nan_negative":
        df.iloc[0, 1] = np.nan
        df.iloc[2, :] = -np.abs(df.iloc[2, :])
    if case == "csv_with_text":
        df.insert(0, "Dataset", ["abc_extra", "famous_dense", "real_world"])
        path = str(tmp_path / "t.csv")
        df.to_csv(path)
    else:
        path = jrep.export_table(df, str(tmp_path / "t.xlsx"), add_stats=False)
        if case == "xlsx":
            path = str(tmp_path / "t.xlsx")
    want = jrep.table_to_latex(path, str(tmp_path / "jax.tex"))
    got = prep.table_to_latex(path, str(tmp_path / "port.tex"))
    assert open(got).read() == open(want).read()
    for ff in ("%.1f", "%.5f"):
        assert prep.latex_table(prep.read_metrics_table(path), ff) == \
            jrep.read_metrics_table(path).to_latex(float_format=lambda x: ff % x)


@pytest.mark.parametrize("with_renders", [False, True])
def test_make_html_report_is_byte_identical(tmp_path, with_renders):
    rng = np.random.default_rng(2)
    shapes, methods = ["shape_a", "b_2"], ["ppsurf_50nn", "poco_mini", "m"]
    mats = [rng.random((3, 2)) for _ in range(3)]
    mats[0][1, 0] = np.nan
    kw = {}
    if with_renders:
        kw = dict(renders={(m, s): str(tmp_path / "r" / m / f"{s}.png")
                           for m in methods[:2] for s in shapes},
                  pc_renders=[str(tmp_path / "pc" / f"{s}.png") for s in shapes],
                  gt_renders=[str(tmp_path / "gt" / f"{s}.png") for s in shapes])
    want = jrep.make_html_report(str(tmp_path / "jax" / "r.html"), "comp — ds", shapes, methods,
                                 *mats, **kw)
    got = prep.make_html_report(str(tmp_path / "port" / "r.html"), "comp — ds", shapes,
                                methods, *mats, **kw)
    assert open(got, "rb").read() == open(want, "rb").read()


@pytest.fixture()
def comparison_tree(tmp_path):
    """The synthetic dataset of `tests/test_eval_drivers.py` (two shapes,
    ground-truth spheres r 0.3) with input clouds, and three methods:
    spheres r 0.29, spheres r 0.26, and one whose second mesh is missing;
    the metric tables as the JAX package writes them."""
    rng = np.random.default_rng(3)
    from ppsurf_tpu.io.ply import save_ply

    root = tmp_path / "tree"
    data_dir, results_dir = root / "datasets", root / "results"
    names, ds = ["sa", "sb"], "synth"
    (data_dir / ds / "03_meshes").mkdir(parents=True)
    (data_dir / ds / "04_pts_vis").mkdir(parents=True)
    (data_dir / ds / "testset.txt").write_text("\n".join(names))
    for n in names:
        make_sphere_mesh(0.3).export(str(data_dir / ds / "03_meshes" / f"{n}.ply"))
        pts = rng.normal(size=(400, 3))
        save_ply(str(data_dir / ds / "04_pts_vis" / f"{n}.xyz.ply"),
                 (pts / np.linalg.norm(pts, axis=1, keepdims=True) * 0.3).astype(np.float32))
    for m, r in (("m1", 0.29), ("m2", 0.26), ("m_part", 0.28)):
        (results_dir / m / ds / "meshes").mkdir(parents=True)
        for n in (names[:1] if m == "m_part" else names):
            make_sphere_mesh(r, n=17).export(str(results_dir / m / ds / "meshes" / f"{n}.xyz.ply"))
        values = rng.random((2, 4))
        if m == "m_part":
            values[1] = np.nan
        _method_tables(str(results_dir), m, ds, values, names, m)
    return str(root), ds


def test_comparison_main_matches_on_the_synthetic_tree(comparison_tree, tmp_path):
    root, ds = comparison_tree
    a, b = _both(tmp_path, root)
    argv = ["--dataset_names", ds, "--comp_name", "test_comp", "--workers", "1", "--render"]
    for base, main in ((a, jcomp.main), (b, pcomp.main)):
        assert main([*argv, "--data_dir", os.path.join(base, "datasets"),
                     "--results_dir", os.path.join(base, "results"),
                     "--comp_dir", os.path.join(base, "comp")]) == 0
    n = _same_tree(os.path.join(a, "comp"), os.path.join(b, "comp"))
    assert n == 8 + 2 + 4 + 1  # tables, comp_mean, gt and pc renders, report
    m = _same_tree(os.path.join(a, "results"), os.path.join(b, "results"))
    assert m == 3 * 8 + 5 + 5 * 2 + 5  # tables, meshes, cd_vis ply + npz, renders
    html = open(os.path.join(b, "comp", "reports", f"comp_all_{ds}.html")).read()
    assert all(s in html for s in ("sa", "sb", "m1", "m2", "m part", "nan"))


def test_comparison_main_on_the_eval_tests_synthetic_tree(synthetic_tree, tmp_path):
    """`tests/test_eval_drivers.py`'s tree as it stands before scoring: no
    metric tables, so no assembled tables and a NaN summary row a method
    named after its directory; renders of the ground truth and the
    Chamfer-coloured meshes, no input clouds."""
    data_dir, results_dir, ds, _ = synthetic_tree
    root = os.path.dirname(data_dir)
    a, b = _both(tmp_path, root)
    for base, fn in ((a, jcomp.comparison_main), (b, pcomp.comparison_main)):
        fn(data_dir=os.path.join(base, "datasets"), results_dir=os.path.join(base, "results"),
           dataset=ds, comp_dir=os.path.join(base, "comp"), comp_name="test_comp", workers=1)
    assert _same_tree(os.path.join(a, "comp"), os.path.join(b, "comp")) == 2 + 2 + 1
    assert _same_tree(os.path.join(a, "results"), os.path.join(b, "results")) == 4 + 4 * 2 + 4
    with open(os.path.join(b, "comp", ds, "comp_mean.csv")) as fp:
        assert [line.split(",")[0] for line in fp] == ["Model", "m1", "m2"]


def test_comparison_main_without_renders(comparison_tree, tmp_path):
    root, ds = comparison_tree
    a, b = _both(tmp_path, root)
    for base, fn in ((a, jcomp.comparison_main), (b, pcomp.comparison_main)):
        fn(data_dir=os.path.join(base, "datasets"), results_dir=os.path.join(base, "results"),
           dataset=ds, comp_dir=os.path.join(base, "comp"), methods=["m2", "m1"], render=False)
    assert _same_tree(os.path.join(a, "comp"), os.path.join(b, "comp"), png=False) == 11


def test_comparison_of_a_method_without_any_mesh(comparison_tree, tmp_path):
    """A method whose every score is NaN: its spreadsheet cells are empty,
    so its columns read back as objects, not numbers (the JAX package's
    report fails on them there); the port writes NaN rows and `nan` in
    the report."""
    root, ds = comparison_tree
    results = os.path.join(root, "results")
    _method_tables(results, "m_none", ds, np.full((2, 4), np.nan), ["sa", "sb"], "m_none")
    comp = str(tmp_path / "comp")
    pcomp.comparison_main(os.path.join(root, "datasets"), results, ds, workers=1,
                          comp_dir=comp, methods=["m1", "m_none"], render=True)
    with open(os.path.join(comp, ds, "comp_mean.csv")) as fp:
        rows = {line.split(",")[0]: line.rstrip("\n").split(",")[1:] for line in fp}
    assert all(v == "" for v in rows["m_none"]) and all(v != "" for v in rows["m1"][:2])
    table = prep.read_metrics_table(os.path.join(results, "m_none", ds, "iou.xlsx"))
    assert table.numeric == [False] and table.rows == [[None], [None]]
    html = open(os.path.join(comp, "reports", f"comp_all_{ds}.html")).read()
    assert "CD: nan, IoU: nan, NCE: nan" in html
    assert not os.path.exists(os.path.join(results, "m_none", ds, "cd_vis_renders"))
