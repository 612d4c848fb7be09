"""Analysis utilities (port of ``mallorn_tpu.train.analysis``): feature
importance reports, train/test drift per feature, experiment comparison
tables, per-object error analysis and prediction agreement.

The machine with the card has no pandas, so where the JAX package returns
a DataFrame the port returns a ``Table``: a plain dict of column name ->
numpy array, in the DataFrame's column order, each array in its row order
(``table_len``, ``table_head`` and ``format_table`` are the little the
callers need of a DataFrame). A single-key sort is stable here; pandas'
``sort_values`` leaves the order of ties undefined, so rows that tie on
the key may come in another order than the JAX package's.
``prediction_agreement``'s rows are its columns' names, in order (the
DataFrame's index).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from mallorn_tpu_torch.train.cv import threshold_sweep

Table = Dict[str, np.ndarray]


def table_len(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def table_take(table: Table, idx) -> Table:
    return {k: v[idx] for k, v in table.items()}


def table_head(table: Table, n: int) -> Table:
    return table_take(table, slice(0, n))


def _from_rows(rows: List[Dict], columns: Sequence[str] = ()) -> Table:
    """A table of row dicts: the columns in first-seen order (after
    ``columns``), a missing cell NaN (as pandas builds a DataFrame)."""
    names = list(columns)
    for r in rows:
        names += [k for k in r if k not in names]
    return {k: np.asarray([r.get(k, np.nan) for r in rows]) for k in names}


def _sorted_desc(table: Table, key: str, top_k: Optional[int] = None) -> Table:
    """Rows by ``key`` descending (stable; NaN last), the first ``top_k``."""
    v = np.asarray(table[key], np.float64)
    order = np.argsort(-v, kind="stable")
    return table_take(table, order[:top_k])


def format_table(table: Table, max_rows: Optional[int] = None) -> str:
    """A fixed-width text rendering of the first ``max_rows`` rows."""
    t = table if max_rows is None else table_head(table, max_rows)

    def cell(x):
        if isinstance(x, (float, np.floating)):
            return f"{x:.6g}"
        return str(x)

    cols = [[k] + [cell(x) for x in v] for k, v in t.items()]
    widths = [max(len(s) for s in c) for c in cols]
    return "\n".join(" ".join(c[i].rjust(w) for c, w in zip(cols, widths))
                     for i in range(table_len(t) + 1))


def importance_report(names: Sequence[str], gains: np.ndarray, top_k: int = 30) -> Table:
    """Ranked gain-importance table: feature, gain, share."""
    gain = np.asarray(gains, np.float64)
    table = {"feature": np.asarray(list(names), dtype=object), "gain": gain,
             "share": gain / max(gain.sum(), 1e-12)}
    return _sorted_desc(table, "gain", top_k)


def distribution_drift(X_train: np.ndarray, X_test: np.ndarray,
                       names: Sequence[str], top_k: int = 20) -> Table:
    """Per-feature mean / std drift between splits (features with >= 3
    finite values on each side)."""
    rows = []
    for i, n in enumerate(names):
        a = X_train[:, i][np.isfinite(X_train[:, i])]
        b = X_test[:, i][np.isfinite(X_test[:, i])]
        if len(a) < 3 or len(b) < 3:
            continue
        mu_a, mu_b = a.mean(), b.mean()
        sd = max(a.std(), 1e-12)
        rows.append({"feature": n, "train_mean": mu_a, "test_mean": mu_b,
                     "shift_sigma": abs(mu_b - mu_a) / sd,
                     "train_nan_frac": 1 - len(a) / len(X_train),
                     "test_nan_frac": 1 - len(b) / len(X_test)})
    return _sorted_desc(_from_rows(rows), "shift_sigma", top_k)


def compare_experiments(results: Dict[str, Dict]) -> Table:
    """Ledger table over experiment result dicts ({name: {oof_f1,
    threshold, ...}}): one row each, best OOF F1 first; the other scalar
    entries become columns."""
    rows = [{"experiment": name, "oof_f1": r.get("oof_f1", np.nan),
             "threshold": r.get("threshold", np.nan),
             **{k: v for k, v in r.items()
                if k not in ("oof_f1", "threshold") and np.isscalar(v)}}
            for name, r in results.items()]
    return _sorted_desc(_from_rows(rows), "oof_f1")


def error_analysis(
    y: np.ndarray,
    oof_preds: np.ndarray,
    threshold: float,
    X: Optional[np.ndarray] = None,
    feature_names: Optional[Sequence[str]] = None,
    importance_gain: Optional[np.ndarray] = None,
    object_ids: Optional[np.ndarray] = None,
    z: Optional[np.ndarray] = None,
    spec_type: Optional[np.ndarray] = None,
    other_models: Optional[Dict[str, np.ndarray]] = None,
    top_k_features: int = 15,
    borderline_margin: float = 0.1,
) -> Dict[str, object]:
    """Per-object misclassification report. A dict of:

    - confusion: {tp, fp, fn, tn} counts at ``threshold``;
    - hard_tde_count: true TDEs with OOF probability < 0.1;
    - errors: a Table of every FN / FP object (object_id, row, group,
      oof_prob, margin, spec_type, z) sorted by (group, oof_prob);
    - group_stats (with X and names): per-{TP, FN, FP, TN} means of the
      top-importance features and |FN - TP| in units of the TP spread;
    - confidence: probability statistics per group and the borderline
      count;
    - fn_recovery (with ``other_models``): per model, how many of these
      FNs it recovers at its own best threshold, and how many all miss.
    """
    y = np.asarray(y).astype(int)
    p = np.asarray(oof_preds, np.float64)
    pred = (p > threshold).astype(int)
    tp_i = np.where((pred == 1) & (y == 1))[0]
    fp_i = np.where((pred == 1) & (y == 0))[0]
    fn_i = np.where((pred == 0) & (y == 1))[0]
    tn_i = np.where((pred == 0) & (y == 0))[0]
    groups = {"TP": tp_i, "FN": fn_i, "FP": fp_i, "TN": tn_i}

    out: Dict[str, object] = {
        "confusion": {"tp": len(tp_i), "fp": len(fp_i), "fn": len(fn_i), "tn": len(tn_i)},
        "hard_tde_count": int((p[y == 1] < 0.1).sum()),
    }

    def _col(a, idx, default=np.nan):
        if a is None:
            return np.full(len(idx), default)
        return np.asarray(a)[idx]

    err_idx = np.concatenate([fn_i, fp_i]).astype(int)
    errors = {
        "object_id": _col(object_ids, err_idx, -1),
        "row": err_idx,
        "group": np.asarray(["FN"] * len(fn_i) + ["FP"] * len(fp_i), dtype=object),
        "oof_prob": p[err_idx],
        "margin": p[err_idx] - threshold,
        "spec_type": _col(spec_type, err_idx, ""),
        "z": _col(z, err_idx),
    }
    out["errors"] = table_take(errors, np.lexsort((errors["oof_prob"],
                                                   errors["group"].astype(str))))

    if X is not None and feature_names is not None:
        X = np.asarray(X, np.float64)
        order = (np.argsort(np.asarray(importance_gain))[::-1]
                 if importance_gain is not None else np.arange(X.shape[1]))
        rows = []
        for f in [feature_names[i] for i in order[:top_k_features]]:
            j = list(feature_names).index(f)
            means = {g: (np.nanmean(X[idx, j]) if len(idx) else np.nan)
                     for g, idx in groups.items()}
            # the gap in units of the TP group's spread
            tp_sd = np.nanstd(X[tp_i, j]) if len(tp_i) else np.nan
            gap = abs(means["FN"] - means["TP"]) / (tp_sd + 1e-10)
            rows.append({"feature": f, **{f"{g.lower()}_mean": v for g, v in means.items()},
                         "fn_tp_gap": gap})
        out["group_stats"] = _sorted_desc(_from_rows(rows), "fn_tp_gap")

    conf = {g: {"n": len(idx),
                "mean": float(p[idx].mean()) if len(idx) else np.nan,
                "std": float(p[idx].std()) if len(idx) else np.nan}
            for g, idx in groups.items()}
    border = np.abs(p - threshold) < borderline_margin
    conf["borderline"] = {"n": int(border.sum()), "tde": int(y[border].sum())}
    out["confidence"] = conf

    if other_models:
        rec = {}
        missed_by_all = np.ones(len(fn_i), bool)
        for name, mp in other_models.items():
            mp = np.asarray(mp, np.float64)
            _, t_m = threshold_sweep(y, mp)
            hit = mp[fn_i] > t_m
            rec[name] = int(hit.sum())
            missed_by_all &= ~hit
        rec["missed_by_all"] = int(missed_by_all.sum())
        out["fn_recovery"] = rec
    return out


def print_error_analysis(report: Dict[str, object], max_rows: int = 20) -> None:
    """A readable rendering of ``error_analysis``: the confusion counts,
    the first misclassified objects, the top FN-vs-TP gaps and the FN
    recovery."""
    c = report["confusion"]
    print(f"   confusion: TP={c['tp']} FP={c['fp']} FN={c['fn']} TN={c['tn']}"
          f" | hard TDEs (prob<0.1): {report['hard_tde_count']}", flush=True)
    errors: Table = report["errors"]  # type: ignore[assignment]
    if table_len(errors):
        print(f"   misclassified objects ({table_len(errors)}):", flush=True)
        print(format_table(errors, max_rows), flush=True)
    if "group_stats" in report:
        print("   top FN-vs-TP feature gaps:", flush=True)
        print(format_table(report["group_stats"], 8), flush=True)
    if "fn_recovery" in report:
        print(f"   FN recovery by other models: {report['fn_recovery']}", flush=True)


def prediction_agreement(preds: Dict[str, np.ndarray], threshold: float = 0.5) -> Table:
    """Pairwise share of equal binary predictions between prediction
    vectors: one column per name, rows in the same order."""
    names = list(preds)
    bins = {n: (np.asarray(p) > threshold) for n, p in preds.items()}
    return {b: np.asarray([(bins[a] == bins[b]).mean() for a in names]) for b in names}
