"""Feature cache: the staged-artifact store (port of ``mallorn_tpu.io.cache``).

The reference checkpoints every expensive stage ("if cache exists load,
else compute and dump"; scripts/train_v19_multiband_gp.py:92-112). One
entry is one npz, ``matrix`` [N, F] float32, ``object_ids`` as text and
``names``, written atomically, plus a ``.manifest.json`` sidecar with the
names for human readers: the JAX package's layout, so an entry either
package writes loads in the other.
"""

from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch


def atomic_savez(path, **arrays) -> Path:
    """``np.savez_compressed`` through a temporary file and ``os.replace``:
    a concurrent load-or-compute of the same entry never reads a partial
    file."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.npz")
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return path


def _atomic_write_text(path: Path, text: str) -> None:
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, path)


def save_features(path, features: Dict[str, object], object_ids: np.ndarray) -> None:
    """A FeatureSet (tensors on any one device, or numpy columns) as one
    entry, its columns in the set's order, fetched from the device at once."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    names = list(features)
    cols = [torch.as_tensor(features[n]).to(torch.float32) for n in names]
    mat = torch.stack(cols, dim=1).cpu().numpy()
    # the names live inside the npz, so one atomic file pairs them with
    # their matrix; the manifest is for people and older readers
    atomic_savez(path, matrix=mat, object_ids=np.asarray(object_ids).astype(str),
                 names=np.asarray(names, dtype=str))
    _atomic_write_text(path.with_suffix(".manifest.json"), json.dumps({"names": names}))


def load_features(path) -> Tuple[np.ndarray, List[str], np.ndarray]:
    """(matrix [N, F], names, object_ids)."""
    path = Path(path)
    with np.load(path if path.suffix == ".npz" else path.with_suffix(".npz"),
                 allow_pickle=False) as z:
        if "names" in z.files:
            names = [str(n) for n in z["names"]]
        else:  # an entry with its names only in the manifest
            names = json.loads(path.with_suffix(".manifest.json").read_text())["names"]
        mat, ids = z["matrix"], z["object_ids"]
    if len(names) != mat.shape[1]:
        raise ValueError(f"feature cache {path.name}: {len(names)} names vs "
                         f"{mat.shape[1]} columns (mismatched generations)")
    return mat, names, ids


def cached(path, compute_fn, object_ids=None):
    """Load the entry if present, else ``compute_fn()`` and store it.

    An entry that fails to parse (truncated, its manifest gone, names and
    columns of different generations) is deleted and recomputed, never an
    error; other errors (memory, interrupts) propagate and leave the entry
    alone."""
    path = Path(path)
    npz = path if path.suffix == ".npz" else path.with_suffix(".npz")
    if npz.exists():
        try:
            return load_features(npz)
        except (zipfile.BadZipFile, EOFError, KeyError, ValueError,
                json.JSONDecodeError, FileNotFoundError):
            npz.unlink(missing_ok=True)
            npz.with_suffix(".manifest.json").unlink(missing_ok=True)
    save_features(npz, compute_fn(), object_ids)
    return load_features(npz)
