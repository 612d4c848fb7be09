"""CSV data loading in the reference's on-disk layout (port of
``mallorn_tpu.data.loader``; numpy, no pandas).

Layout (reference: src/utils/data_loader.py):

- ``{split}_log.csv``: object_id, Z, EBV, [SpecType], [target] (:20-33);
- ``split_01..split_20/{split}_full_lightcurves.csv``: object_id,
  Time (MJD), Flux, Flux_err, Filter (:36-62).

A log is a dict of numpy columns: ``object_id`` as text, every other
column int64 when each field is an integer, float64 when each field is a
number or empty (NaN), text otherwise. Lightcurve files go through the
native parser (``io.native.parse_lightcurves``) unless the caller asks
for its numpy twin with ``use_native=False``; a parser that cannot be
built raises. Object rows follow the log; rows of objects the log does
not list are dropped.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from mallorn_tpu_torch.data.packing import (Metadata, PackedLightcurves, pack_lightcurves,
                                            unify_time_padding)
from mallorn_tpu_torch.io import native
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device

MAX_SPLIT_DIRS = 20  # the reference scans split_01..split_20 (data_loader.py:53)

Log = Dict[str, np.ndarray]

_INT = re.compile(r"[+-]?[0-9]+\Z")


def _column(name: str, fields) -> np.ndarray:
    if name == "object_id":
        return np.array(fields, dtype=str)
    if fields and all(_INT.match(v.strip()) for v in fields):
        return np.array([int(v) for v in fields], np.int64)
    try:
        return np.array([float(v) if v.strip() else np.nan for v in fields], np.float64)
    except ValueError:
        return np.array(fields, dtype=str)


def load_metadata(data_path, split: str = "train") -> Log:
    """``{split}_log.csv`` as a dict of numpy columns (``FileNotFoundError``
    when the file is missing)."""
    with open(Path(data_path) / f"{split}_log.csv", newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{split}_log.csv under {data_path} has no header")
    header, body = rows[0], [r for r in rows[1:] if r]
    return {name: _column(name, [r[i] if i < len(r) else "" for r in body])
            for i, name in enumerate(header)}


def _shards(data_path, split: str):
    filename = f"{split}_full_lightcurves.csv"
    found = [Path(data_path) / f"split_{i:02d}" / filename for i in range(1, MAX_SPLIT_DIRS + 1)]
    found = [p for p in found if p.exists()]
    if not found:
        raise FileNotFoundError(f"No {split} lightcurve files found under {data_path}")
    return found


def _parser(use_native: bool):
    return native.parse_lightcurves if use_native else native.parse_lightcurves_np


def metadata_of(log: Log) -> Metadata:
    """The per-object metadata of a log: Z and EBV as float32 (zeros when
    absent), target as int32 and SpecType when present."""
    object_ids = log["object_id"]
    n = len(object_ids)
    return Metadata(
        object_ids=object_ids,
        z=log["Z"].astype(np.float32) if "Z" in log else np.zeros(n, np.float32),
        ebv=log["EBV"].astype(np.float32) if "EBV" in log else np.zeros(n, np.float32),
        target=log["target"].astype(np.int32) if "target" in log else None,
        spec_type=log["SpecType"] if "SpecType" in log else None)


def pack_split_native(data_path, log: Log, split: str, use_native: bool = True,
                      device: DeviceLike = None) -> Tuple[PackedLightcurves, Metadata]:
    """Per shard: parse (the native parser, or its numpy twin), map the
    shard's own object table onto the log's rows (unknown objects dropped);
    then one pack of every shard's rows on ``device``."""
    id_to_row = {str(oid): i for i, oid in enumerate(log["object_id"])}
    parse = _parser(use_native)
    cols = {k: [] for k in ("object_index", "time", "flux", "flux_err", "band")}
    for p in _shards(data_path, split):
        d = parse(p)
        remap = np.array([id_to_row.get(oid, -1) for oid in d["object_ids"]], np.int64)
        gidx = remap[d["object_index"]]
        keep = gidx >= 0
        cols["object_index"].append(gidx[keep])
        for k in ("time", "flux", "flux_err", "band"):
            cols[k].append(d[k][keep])
    flat = {k: np.concatenate(v) for k, v in cols.items()}
    packed = pack_lightcurves(flat["object_index"], flat["time"], flat["flux"],
                              flat["flux_err"], flat["band"],
                              n_objects=len(log["object_id"]),
                              device=device)
    return packed, metadata_of(log)


def load_all_data(data_path, use_native: bool = True, device: DeviceLike = None
                  ) -> Dict[str, object]:
    """Load and pack every split found (mirrors the reference's
    load_all_data, :65-88): ``{split}_packed`` on ``device`` (the card
    unless the caller asks for the CPU) and ``{split}_meta``. A split
    without its log or without lightcurve files is skipped;
    ``FileNotFoundError`` when no split is found. Two splits share one time
    padding (``unify_time_padding``)."""
    dev = resolve_device(device)
    out: Dict[str, object] = {}
    for split in ("train", "test"):
        try:
            log = load_metadata(data_path, split)
            packed, meta = pack_split_native(data_path, log, split, use_native, dev)
        except FileNotFoundError:
            continue
        out[f"{split}_packed"] = packed
        out[f"{split}_meta"] = meta
    if not out:
        raise FileNotFoundError(f"no data found under {data_path}")
    if "train_packed" in out and "test_packed" in out:
        out["train_packed"], out["test_packed"] = unify_time_padding(
            out["train_packed"], out["test_packed"])
    return out
