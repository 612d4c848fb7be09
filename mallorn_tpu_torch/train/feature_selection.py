"""Feature selection: correlation pruning + importance ranking (port of
``mallorn_tpu.train.feature_selection``).

Absolute-correlation pairs >= 0.95 (pandas' pairwise-complete Pearson
correlation), a greedy drop of the second feature of each pair, strongest
correlation first, then the survivors ranked by GBDT gain, top K kept.
The machine with the card has no pandas: the tables are plain arrays,
and the two descending sorts repeat pandas' ``sort_values`` index order
(``nargsort``), so ties fall the same way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Set, Tuple

import numpy as np


@dataclasses.dataclass
class SelectionResult:
    selected: List[str]
    dropped_correlated: List[str]
    importance: Dict[str, np.ndarray]  # feature, gain, normalized (by gain, descending)
    high_corr_pairs: Dict[str, np.ndarray]  # feature_1, feature_2, correlation


def _argsort_desc(v: np.ndarray) -> np.ndarray:
    """pandas' ``sort_values(ascending=False)`` order (``nargsort``): the
    reversed array's ascending quicksort, reversed; NaNs last."""
    v = np.asarray(v)
    nan = np.isnan(v)
    idx = np.arange(len(v))[~nan][::-1]
    order = idx[v[~nan][::-1].argsort(kind="quicksort")][::-1]
    return np.concatenate([order, np.flatnonzero(nan)])


def _pairwise_complete_corr(X: np.ndarray) -> np.ndarray:
    """Pearson correlation with pandas' pairwise-complete-NaN semantics, as
    [F, N] @ [N, F] products over centred columns."""
    M = np.isfinite(X)
    with np.errstate(invalid="ignore"):
        mu = np.where(M.any(0), np.nanmean(np.where(M, X, np.nan), axis=0), 0.0)
    V = np.where(M, X - mu, 0.0)
    Mf = M.astype(np.float64)
    n = Mf.T @ Mf
    sx = V.T @ Mf
    sxy = V.T @ V
    sxx = (V * V).T @ Mf
    with np.errstate(invalid="ignore", divide="ignore"):
        cov = n * sxy - sx * sx.T
        var_x = n * sxx - sx * sx
        corr = cov / np.sqrt(var_x * var_x.T)
    corr[n < 2] = np.nan
    return corr


def correlation_prune(X: np.ndarray, names: Sequence[str], threshold: float = 0.95
                      ) -> Tuple[Dict[str, np.ndarray], Set[str]]:
    """(pairs with |corr| >= threshold, strongest first; names to drop)."""
    corr = np.abs(_pairwise_complete_corr(np.asarray(X, dtype=np.float64)))
    iu = np.triu_indices(len(names), k=1)
    sel = corr[iu] >= threshold
    c = corr[iu][sel]
    order = _argsort_desc(c)
    names = np.asarray(names)
    pairs = {"feature_1": names[iu[0][sel]][order], "feature_2": names[iu[1][sel]][order],
             "correlation": c[order]}
    to_drop: Set[str] = set()
    for f1, f2 in zip(pairs["feature_1"], pairs["feature_2"]):
        if f1 not in to_drop:
            to_drop.add(str(f2))
    return pairs, to_drop


def select_features(X: np.ndarray, names: Sequence[str], importance_gain: np.ndarray,
                    top_k: int = 120, corr_threshold: float = 0.95) -> SelectionResult:
    pairs, to_drop = correlation_prune(X, names, corr_threshold)
    imp = np.asarray(importance_gain, dtype=np.float64)
    order = _argsort_desc(imp)
    importance = {"feature": np.asarray(names)[order], "gain": imp[order],
                  "normalized": (imp / max(imp.sum(), 1e-12))[order]}
    selected = [str(n) for n in importance["feature"] if n not in to_drop][:top_k]
    return SelectionResult(selected=selected, dropped_correlated=sorted(to_drop),
                           importance=importance, high_corr_pairs=pairs)


def _selection_digest(X: np.ndarray, y: np.ndarray, names: Sequence[str], top_k: int,
                      corr_threshold: float, key_extra: str) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(np.asarray(X, np.float32)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(y, np.float32)).tobytes())
    h.update("\x00".join(names).encode())
    h.update(f"|{top_k}|{corr_threshold}|{key_extra}".encode())
    return h.hexdigest()[:16]


def cached_select_features(cache_file, X: np.ndarray, y: np.ndarray,
                           names: Sequence[str], importance_fn: Callable[[], np.ndarray],
                           top_k: int = 120, corr_threshold: float = 0.95,
                           key_extra: str = "", save: bool = True) -> SelectionResult:
    """Load-or-compute the staged selection artifact (an npz keyed by a
    content digest of X, y, names and the settings): ``importance_fn()``
    (the selection CV) runs only on a miss. ``cache_file=None`` always
    computes and writes nothing; ``save=False`` reads the artifact but
    never writes it (the ranks of a mesh other than rank 0)."""
    dig = _selection_digest(X, y, names, top_k, corr_threshold, key_extra)
    path = None if cache_file is None else Path(cache_file)
    if path is not None and path.exists():
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["digest"]) == dig:
                    return SelectionResult(
                        selected=[str(n) for n in z["selected"]],
                        dropped_correlated=[str(n) for n in z["dropped"]],
                        importance={"feature": z["imp_feature"], "gain": z["imp_gain"],
                                    "normalized": z["imp_norm"]},
                        high_corr_pairs={"feature_1": z["pair_1"], "feature_2": z["pair_2"],
                                         "correlation": z["pair_corr"]})
        except (OSError, KeyError, ValueError):
            pass  # stale or corrupt: recompute
    res = select_features(X, names, importance_fn(), top_k, corr_threshold)
    if path is not None and save:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz")
        os.close(fd)
        np.savez(tmp, digest=dig,
                 selected=np.asarray(res.selected, dtype="U128"),
                 dropped=np.asarray(res.dropped_correlated, dtype="U128"),
                 imp_feature=np.asarray(res.importance["feature"], dtype="U128"),
                 imp_gain=res.importance["gain"], imp_norm=res.importance["normalized"],
                 pair_1=np.asarray(res.high_corr_pairs["feature_1"], dtype="U128"),
                 pair_2=np.asarray(res.high_corr_pairs["feature_2"], dtype="U128"),
                 pair_corr=np.asarray(res.high_corr_pairs["correlation"], np.float64))
        os.replace(tmp, path)
    return res
