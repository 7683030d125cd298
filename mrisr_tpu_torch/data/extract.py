"""Streaming ZIP extractor (D1), the port's copy of
``mrisr_tpu/data/extract.py``.

Analog of `reference/src/Extract ZIP.ipynb:cell6`: extract member by
member so a partially corrupt archive yields everything readable instead of
failing outright.
"""

from __future__ import annotations

import os
import zipfile
from typing import Tuple


def extract_zip(
    zip_path: str, out_dir: str, verbose: bool = False
) -> Tuple[int, int]:
    """Extract all members, tolerating bad entries.

    Returns (extracted, failed)."""
    os.makedirs(out_dir, exist_ok=True)
    ok = failed = 0
    try:
        zf = zipfile.ZipFile(zip_path)
    except zipfile.BadZipFile:
        raise ValueError(f"not a zip archive: {zip_path}")
    with zf:
        for member in zf.infolist():
            try:
                zf.extract(member, out_dir)
                ok += 1
            except (zipfile.BadZipFile, OSError) as e:
                failed += 1
                if verbose:
                    print(f"skip {member.filename}: {e}")
    return ok, failed
