"""CSV stream source (ENGIE La Haute Borne format analog).

The paper streams the open wind-farm CSV (one row per 10-minute sample,
columns per sensor).  This reader is dependency-free (the standard
library's ``csv``, no pandas): it parses the header, selects the five
temperature channels the paper uses, handles missing values by forward
fill, and yields either the full array or throttled windows.  ``write_csv`` produces a compatible file
from any array (used by tests and to materialize the synthetic dataset in
the paper's format).  Numpy only, copied from the reference.
"""
from __future__ import annotations

import csv
import io
from typing import List, Optional, Sequence

import numpy as np

PAPER_CHANNELS = ("Db1t_avg", "Db2t_avg", "Gb1t_avg", "Gb2t_avg", "Ot_avg")


def write_csv(path: str, data: np.ndarray,
              channels: Sequence[str] = PAPER_CHANNELS,
              timestamp_col: bool = True) -> None:
    data = np.asarray(data)
    assert data.ndim == 2 and data.shape[1] == len(channels)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        hdr = (["Date_time"] if timestamp_col else []) + list(channels)
        w.writerow(hdr)
        for i, row in enumerate(data):
            ts = [f"2017-01-01T{i:06d}"] if timestamp_col else []
            w.writerow(ts + [f"{v:.4f}" for v in row])


def read_csv(
    path_or_buf,
    channels: Sequence[str] = PAPER_CHANNELS,
    max_rows: Optional[int] = None,
) -> np.ndarray:
    """Returns (n, len(channels)) float32 with forward-filled gaps."""
    close = False
    if isinstance(path_or_buf, str):
        f = open(path_or_buf, newline="")
        close = True
    else:
        f = path_or_buf
    try:
        r = csv.reader(f)
        header = next(r)
        idx = []
        for c in channels:
            if c not in header:
                raise KeyError(f"column {c!r} not in CSV header {header}")
            idx.append(header.index(c))
        rows: List[List[float]] = []
        last: Optional[List[float]] = None
        for line in r:
            vals = []
            for j in idx:
                raw = line[j].strip() if j < len(line) else ""
                if raw in ("", "NA", "NaN", "nan"):
                    vals.append(np.nan)
                else:
                    try:
                        vals.append(float(raw))
                    except ValueError:
                        vals.append(np.nan)
            if last is not None:
                vals = [last[k] if np.isnan(v) else v
                        for k, v in enumerate(vals)]
            elif any(np.isnan(v) for v in vals):
                continue  # drop leading incomplete rows
            rows.append(vals)
            last = vals
            if max_rows is not None and len(rows) >= max_rows:
                break
        return np.asarray(rows, np.float32)
    finally:
        if close:
            f.close()


def read_csv_str(text: str, **kw) -> np.ndarray:
    return read_csv(io.StringIO(text), **kw)
