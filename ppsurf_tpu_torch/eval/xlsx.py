"""Minimal first-party XLSX writer with color-scale formatting.

A copy of `ppsurf_tpu/eval/xlsx.py`, which needs only the standard library.

The reference writes its metric tables through openpyxl with 3-color
conditional scales per metric column (`source/base/evaluation.py:252-353`).
openpyxl is not available in this environment, so this module emits the
Office Open XML package directly (an .xlsx file is a zip of small XML
parts) — enough for numeric metric tables: one sheet, an index column of
strings, float cells, and one colorScale conditional-format rule per data
column (green=best to red=worst, direction per `low_metrics_better`).

Readable by Excel/LibreOffice and by `pandas.read_excel` (openpyxl-free
consumers can keep using the CSV twin written by `reports.export_table`).
"""
from __future__ import annotations

import os
import typing
import zipfile
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
<Override PartName="/xl/styles.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.styles+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="{name}" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
<Relationship Id="rId2" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/styles" Target="styles.xml"/>
</Relationships>"""

_STYLES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<styleSheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">
<fonts count="2"><font><sz val="11"/><name val="Calibri"/></font>
<font><b/><sz val="11"/><name val="Calibri"/></font></fonts>
<fills count="2"><fill><patternFill patternType="none"/></fill>
<fill><patternFill patternType="gray125"/></fill></fills>
<borders count="1"><border/></borders>
<cellStyleXfs count="1"><xf/></cellStyleXfs>
<cellXfs count="2"><xf/><xf fontId="1" applyFont="1"/></cellXfs>
</styleSheet>"""


def _col_letter(idx: int) -> str:
    """0-based column index -> A1-style letters."""
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _cell(col: int, row: int, value) -> str:
    ref = f"{_col_letter(col)}{row + 1}"
    if value is None:
        return ""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if value != value:  # NaN
            return ""
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    style = ' s="1"' if row == 0 else ""
    return (
        f'<c r="{ref}" t="inlineStr"{style}><is><t>'
        f"{escape(str(value))}</t></is></c>"
    )


def write_xlsx(
    output_file: str,
    header: typing.Sequence[str],
    index: typing.Sequence[str],
    rows: typing.Sequence[typing.Sequence[float]],
    low_metrics_better: typing.Union[None, bool, typing.Sequence[bool]] = True,
    color_rows: typing.Optional[int] = None,
    sheet_name: str = "metrics",
) -> str:
    """Write a metric table: header row, string index column, float cells,
    and a 3-color scale per data column (reference `evaluation.py:307-331`).

    color_rows limits the color scale to the first N data rows (the
    reference excludes the AVERAGE/MEDIAN/STDEV footer).
    """
    n_cols = len(header)
    n_rows = len(rows)
    if color_rows is None:
        color_rows = n_rows

    lines = ["<sheetData>"]
    head = "".join(
        _cell(c, 0, h) for c, h in enumerate([""] + list(header))
    )
    lines.append(f'<row r="1">{head}</row>')
    for r, (name, vals) in enumerate(zip(index, rows), start=1):
        cells = _cell(0, r, name) + "".join(
            _cell(c + 1, r, v) for c, v in enumerate(vals)
        )
        lines.append(f'<row r="{r + 1}">{cells}</row>')
    lines.append("</sheetData>")

    # per-column 3-color scales over the data rows
    if low_metrics_better is not None and color_rows > 0:
        if isinstance(low_metrics_better, bool):
            low = [low_metrics_better] * n_cols
        else:
            low = list(low_metrics_better)
        good, mid, bad = "FF63BE7B", "FFFFEB84", "FFF8696B"
        pri = 1
        for c in range(n_cols):
            letter = _col_letter(c + 1)
            sqref = f"{letter}2:{letter}{color_rows + 1}"
            lo_best = low[c] if c < len(low) else True
            c0, c2 = (good, bad) if lo_best else (bad, good)
            lines.append(
                f'<conditionalFormatting sqref="{sqref}">'
                f'<cfRule type="colorScale" priority="{pri}"><colorScale>'
                f'<cfvo type="min"/><cfvo type="percentile" val="50"/>'
                f'<cfvo type="max"/>'
                f'<color rgb="{c0}"/><color rgb="{mid}"/><color rgb="{c2}"/>'
                f"</colorScale></cfRule></conditionalFormatting>"
            )
            pri += 1

    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main">' + "".join(lines) + "</worksheet>"
    )

    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with zipfile.ZipFile(output_file, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK.format(name=escape(sheet_name)))
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/styles.xml", _STYLES)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    return output_file


def read_xlsx(path: str):
    """Read a single-sheet xlsx written by `write_xlsx` (or any writer
    using inline strings / shared strings + numeric cells) into
    (header, index, rows) — the openpyxl-free consumer path."""
    import xml.etree.ElementTree as ET

    ns = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}
    with zipfile.ZipFile(path) as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            shared = ["".join(t.text or "" for t in si.iter(
                "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}t"
            )) for si in root.findall("m:si", ns)]
        sheet = ET.fromstring(z.read("xl/worksheets/sheet1.xml"))

    def cell_value(c):
        t = c.get("t")
        if t == "inlineStr":
            el = c.find("m:is/m:t", ns)
            return el.text if el is not None else ""
        v = c.find("m:v", ns)
        if v is None:
            return None
        if t == "s":
            return shared[int(v.text)]
        try:
            return float(v.text)
        except ValueError:
            return v.text

    def col_of(ref):
        letters = "".join(ch for ch in ref if ch.isalpha())
        idx = 0
        for ch in letters:
            idx = idx * 26 + (ord(ch) - ord("A") + 1)
        return idx - 1

    grid: typing.Dict[int, typing.Dict[int, typing.Any]] = {}
    for row in sheet.iter(
        "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}row"
    ):
        r = int(row.get("r")) - 1
        for c in row.findall("m:c", ns):
            grid.setdefault(r, {})[col_of(c.get("r"))] = cell_value(c)

    if not grid:
        return [], [], []
    n_cols = max(max(cols) for cols in grid.values()) + 1
    header = [grid.get(0, {}).get(c) for c in range(1, n_cols)]
    index, rows = [], []
    for r in sorted(k for k in grid if k > 0):
        index.append(grid[r].get(0))
        rows.append([grid[r].get(c) for c in range(1, n_cols)])
    return header, index, rows
