"""Submission CSV writer (port of ``mallorn_tpu.io.submission``; the
reference's output contract ``object_id,target``), through the ``csv``
module: the machine with the card has no pandas."""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


def write_submission(path, object_ids, binary_preds) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["object_id", "target"])
        w.writerows(zip(np.asarray(object_ids).tolist(),
                        np.asarray(binary_preds).astype(int).tolist()))
    return path
