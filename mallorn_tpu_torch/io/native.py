"""The native lightcurve CSV parser (``csrc/fast_csv.cpp``, shared with the
JAX package and read as it is) bound with ``ctypes``, and its plain numpy
twin.

- ``parse_lightcurves(path)``: the C++ parser. The library is built on
  first use with ``g++ -O3 -shared -fPIC`` into
  ``build/mallorn_tpu_torch/libfast_csv_<sha>.so``, keyed by a digest of
  the source and the flags, through a temporary name and ``os.replace``
  (as ``utils.cuda_build`` builds the CUDA kernels). A failed build
  raises with the compiler's message; nothing falls back quietly.
- ``parse_lightcurves_np(path)``: the same function in Python and numpy,
  field for field the parser's rules: the five named header columns in
  any order, a row dropped when it has too few fields or its filter's
  first letter is not one of ``ugrizy``, a trailing ``\\r`` trimmed from
  each field, numbers read as ``strtod`` reads the field's first 63 bytes
  (a numeric prefix, so ``1.5x`` is 1.5; a field with no number is NaN),
  object ids in order of first appearance.

Both return ``{"object_ids": [n_objects] str, "object_index": [M] int32,
"time", "flux", "flux_err": [M] float64, "band": [M] int32}``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from mallorn_tpu_torch.utils.cuda_build import BUILD_DIR

SRC = Path(__file__).resolve().parents[2] / "csrc" / "fast_csv.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _CsvResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_objects", ctypes.c_int64),
        ("time", ctypes.POINTER(ctypes.c_double)),
        ("flux", ctypes.POINTER(ctypes.c_double)),
        ("flux_err", ctypes.POINTER(ctypes.c_double)),
        ("band", ctypes.POINTER(ctypes.c_int32)),
        ("obj_idx", ctypes.POINTER(ctypes.c_int32)),
        ("ids", ctypes.POINTER(ctypes.c_char)),  # null-separated, not a C string
        ("ids_len", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfast_csv_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser if it is not built yet; returns the library's
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}_{threading.get_ident()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native CSV parser build failed: $ {' '.join(cmd)}\n{e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native CSV parser build failed: $ {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.parse_lightcurves.restype = ctypes.POINTER(_CsvResult)
            lib.parse_lightcurves.argtypes = [ctypes.c_char_p]
            lib.free_result.argtypes = [ctypes.POINTER(_CsvResult)]
            _lib = lib
        return _lib


def parse_lightcurves(path) -> Dict[str, np.ndarray]:
    """Parse one lightcurve CSV with the C++ parser."""
    lib = load()
    res = lib.parse_lightcurves(str(path).encode())
    try:
        r = res.contents
        if r.error:
            raise ValueError(f"fast_csv: {r.error.decode()} ({path})")
        n = r.n_rows

        def column(ptr, dtype):
            return np.ctypeslib.as_array(ptr, (n,)).copy() if n else np.zeros(0, dtype)

        out = {"time": column(r.time, np.float64), "flux": column(r.flux, np.float64),
               "flux_err": column(r.flux_err, np.float64), "band": column(r.band, np.int32),
               "object_index": column(r.obj_idx, np.int32)}
        raw = ctypes.string_at(r.ids, r.ids_len) if r.ids_len else b""
        out["object_ids"] = np.array(raw.decode().split("\0")[:-1], dtype=str)
        return out
    finally:
        lib.free_result(res)


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

_COLUMNS = ("object_id", "Time (MJD)", "Flux", "Flux_err", "Filter")
_BANDS = {ord(c): i for i, c in enumerate("ugrizy")}
_MAX_FIELDS = 64  # the parser's field table
_FIELD_BYTES = 63  # strtod sees at most this many bytes of a field
_FAST_HEAD = frozenset(b"0123456789+-.")
_FAST_TAIL = frozenset(b"0123456789.")
# strtod's grammar (C locale): leading white space, a sign, then a hex
# float, a decimal float, inf[inity] or nan
_STRTOD = re.compile(
    rb"[ \t\n\v\f\r]*([+-]?)(?:"
    rb"(0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)(?:[pP][+-]?[0-9]+)?)"
    rb"|((?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?)"
    rb"|([iI][nN][fF](?:[iI][nN][iI][tT][yY])?)"
    rb"|([nN][aA][nN]))")


def strtod(field: bytes) -> float:
    """The value ``strtod`` reads from the start of ``field``, NaN when it
    reads nothing (the parser's rule for an empty or non-numeric field)."""
    field = field[:_FIELD_BYTES]
    # Python's float() agrees with strtod on a plain decimal field (both
    # round correctly); anything else takes the grammar
    if (field and field[0] in _FAST_HEAD and field[-1] in _FAST_TAIL
            and b"_" not in field):
        try:
            return float(field)
        except ValueError:
            pass
    m = _STRTOD.match(field)
    if m is None:
        return float("nan")
    sign = -1.0 if m.group(1) == b"-" else 1.0
    if m.group(2) is not None:
        return sign * float.fromhex(m.group(2).decode())
    if m.group(3) is not None:
        return sign * float(m.group(3))
    if m.group(4) is not None:
        return sign * float("inf")
    return float("nan")


def parse_lightcurves_np(path) -> Dict[str, np.ndarray]:
    """``parse_lightcurves`` in Python and numpy: the same arrays."""
    buf = Path(path).read_bytes()
    head_end = buf.find(b"\n")
    if head_end < 0:
        raise ValueError(f"fast_csv: no header line ({path})")
    names = [n[:-1] if n.endswith(b"\r") else n for n in buf[:head_end].split(b",")]
    pos = {}
    for i, n in enumerate(names):
        pos[n.decode(errors="replace")] = i  # the parser keeps the last match
    if any(c not in pos for c in _COLUMNS):
        raise ValueError(f"fast_csv: missing required columns in header ({path})")
    c_id, c_t, c_f, c_e, c_b = (pos[c] for c in _COLUMNS)
    max_col = max(c_id, c_t, c_f, c_e, c_b)

    ids: Dict[bytes, int] = {}
    t, f, e, b, o = [], [], [], [], []
    if max_col < _MAX_FIELDS:
        for line in buf[head_end + 1:].split(b"\n"):
            fields = line.split(b",", max_col + 1)
            if len(fields) <= max_col:
                continue  # an empty line or too few fields
            band_field = fields[c_b]
            if band_field.endswith(b"\r"):
                band_field = band_field[:-1]
            band = _BANDS.get(band_field[0], -1) if band_field else -1
            if band < 0:
                continue
            oid = fields[c_id]
            if oid.endswith(b"\r"):
                oid = oid[:-1]
            k = ids.setdefault(oid, len(ids))
            for col, out in ((c_t, t), (c_f, f), (c_e, e)):
                v = fields[col]
                out.append(strtod(v[:-1] if v.endswith(b"\r") else v))
            b.append(band)
            o.append(k)
    return {"time": np.array(t, np.float64), "flux": np.array(f, np.float64),
            "flux_err": np.array(e, np.float64), "band": np.array(b, np.int32),
            "object_index": np.array(o, np.int32),
            "object_ids": np.array([k.decode() for k in ids], dtype=str)}
