"""CSV export of benchmark rows (port of the JAX package's
``report/export.py:write_csv``; its JSON and WAV writers are not ported
yet). Reference: tpus_benchmark...:708-721, the same union-of-keys
fieldnames."""

from __future__ import annotations

import csv
import os
from typing import List


def write_csv(results: List[dict], path: str, append: bool = False) -> None:
    """Union-of-keys fieldnames, blank for missing (reference :710-717).

    ``append=True`` reuses an existing file's header (extra keys in the new
    rows are dropped to keep the columns aligned), so a sweep split across
    processes lands in one file."""
    if not results:
        return
    existing_header = None
    if append and os.path.exists(path):
        with open(path, newline="", encoding="utf-8") as f:
            existing_header = next(csv.reader(f), None)
    if existing_header:
        fieldnames = existing_header
        mode = "a"
    else:
        fieldnames = sorted(set().union(*(r.keys() for r in results)))
        mode = "w"
    with open(path, mode, newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
        if mode == "w":
            writer.writeheader()
        for r in results:
            writer.writerow({k: r.get(k, "") for k in fieldnames})
