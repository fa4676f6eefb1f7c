"""Filesystem helpers with mtime-based recompute caching.

Port of `ppsurf_tpu/utils/fs.py` (reference `source/base/fs.py:69-130`):
`call_necessary` lets a batch evaluation resume by skipping outputs that
are complete and newer than their inputs.
"""
from __future__ import annotations

import os
import typing


def make_dir_for_file(file: str) -> None:
    dir_name = os.path.dirname(file)
    if dir_name and not os.path.exists(dir_name):
        os.makedirs(dir_name, exist_ok=True)


def call_necessary(
    file_in: typing.Union[str, typing.Sequence[str]],
    file_out: typing.Union[str, typing.Sequence[str]],
    min_file_size: int = 0,
    verbose: bool = False,
) -> bool:
    """True if outputs are missing, too small, or older than any input."""
    if isinstance(file_in, str):
        file_in = [file_in]
    if isinstance(file_out, str):
        file_out = [file_out]

    inputs_missing = [f for f in file_in if not os.path.isfile(f)]
    if inputs_missing:
        if verbose:
            print(f"WARNING: inputs missing {inputs_missing}")
        return True

    if not file_out:
        return True
    outputs_missing = [f for f in file_out if not os.path.isfile(f)]
    if outputs_missing:
        return True

    min_output_file_size = min(os.path.getsize(f) for f in file_out)
    if min_output_file_size < min_file_size:
        return True

    oldest_output_file_mtime = min(os.path.getmtime(f) for f in file_out)
    youngest_input_file_mtime = max(os.path.getmtime(f) for f in file_in)
    return youngest_input_file_mtime >= oldest_output_file_mtime
