"""Hyperparameter search over ``GBDTParams`` (port of
``mallorn_tpu.train.hpo``): seeded random search and a TPE sampler
(``tpe_search``: trials split into good and bad at the gamma quantile, a
Parzen KDE per dimension on each side, the candidate that maximises
l(x) / g(x) proposed). The sampler is the JAX package's numpy code, so a
seed gives the same sequence of configs; each trial is one ``train_cv``
of the port on ``device``. ``train_cv`` is this module's global, looked
up at call time, so that a test can replace it."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from mallorn_tpu_torch.train.cv import train_cv
from mallorn_tpu_torch.trees.gbdt import GBDTParams
from mallorn_tpu_torch.utils.device import DeviceLike

# search space mirroring the reference's Optuna ranges
DEFAULT_SPACE = {
    "max_depth": (3, 8),
    "learning_rate": (0.01, 0.2, "log"),
    "subsample": (0.6, 1.0),
    "colsample_bytree": (0.6, 1.0),
    "min_child_weight": (1.0, 10.0),
    "reg_alpha": (0.0, 2.0),
    "reg_lambda": (0.5, 5.0),
}


def _sample(rng, space) -> Dict:
    out = {}
    for k, v in space.items():
        lo, hi = v[0], v[1]
        if len(v) == 3 and v[2] == "log":
            out[k] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        elif isinstance(lo, int):
            out[k] = int(rng.integers(lo, hi + 1))
        else:
            out[k] = float(rng.uniform(lo, hi))
    return out


@dataclasses.dataclass
class Trial:
    params: GBDTParams
    oof_f1: float
    threshold: float


def random_search(
    X: np.ndarray, y: np.ndarray,
    n_trials: int = 20,
    base: GBDTParams = GBDTParams(),
    space: Dict = None,
    sample_weight: Optional[np.ndarray] = None,
    seed: int = 42,
    n_rounds: int = 300,
    device: DeviceLike = None,
    verbose: bool = False,
) -> List[Trial]:
    """Random search maximizing OOF F1; returns trials sorted best-first."""
    rng = np.random.default_rng(seed)
    trials: List[Trial] = []
    for t in range(n_trials):
        cfg = _sample(rng, space or DEFAULT_SPACE)
        params = base._replace(n_rounds=n_rounds, **cfg)
        cv = train_cv(X, y, None, params, sample_weight=sample_weight, device=device)
        trials.append(Trial(params=params, oof_f1=cv.best_f1,
                            threshold=cv.best_threshold))
        if verbose:
            print(f"   trial {t + 1}/{n_trials}: F1={cv.best_f1:.4f} {cfg}",
                  flush=True)
    trials.sort(key=lambda tr: -tr.oof_f1)
    return trials


def _to_internal(space, k, x):
    """Map a config value into the (possibly log) sampling space."""
    v = space[k]
    return float(np.log(x)) if len(v) == 3 and v[2] == "log" else float(x)


def _from_internal(space, k, u, rng):
    v = space[k]
    lo, hi = v[0], v[1]
    if len(v) == 3 and v[2] == "log":
        return float(np.clip(np.exp(u), lo, hi))
    if isinstance(lo, int):
        return int(np.clip(round(u), lo, hi))
    return float(np.clip(u, lo, hi))


def _tpe_propose(rng, space, trials: Sequence[Trial], gamma: float,
                 n_candidates: int) -> Dict:
    """One TPE proposal: per-dimension Parzen KDEs over the good/bad
    trial splits; return the candidate maximizing sum_k log l_k - log g_k."""
    ordered = sorted(trials, key=lambda tr: -tr.oof_f1)
    n_good = max(1, int(np.ceil(gamma * len(ordered))))
    good, bad = ordered[:n_good], ordered[n_good:] or ordered[-1:]

    def kde_logpdf(xs, centers, lo, hi):
        centers = np.asarray(centers, np.float64)
        bw = max(1.06 * centers.std() * len(centers) ** -0.2,
                 1e-3 * max(hi - lo, 1e-12))
        z = (xs[:, None] - centers[None, :]) / bw
        return np.log(np.mean(np.exp(-0.5 * z * z), axis=1) /
                      (bw * np.sqrt(2 * np.pi)) + 1e-300)

    keys = list(space)
    score = np.zeros(n_candidates)
    cand_vals: Dict[str, np.ndarray] = {}
    for k in keys:
        v = space[k]
        lo, hi = v[0], v[1]
        ilo, ihi = _to_internal(space, k, lo), _to_internal(space, k, hi)
        gvals = [_to_internal(space, k, getattr(tr.params, k)) for tr in good]
        bvals = [_to_internal(space, k, getattr(tr.params, k)) for tr in bad]
        bw = max(1.06 * np.std(gvals) * len(gvals) ** -0.2,
                 1e-3 * (ihi - ilo))
        # sample candidates from the good-KDE mixture
        picks = rng.integers(0, len(gvals), n_candidates)
        xs = np.asarray(gvals)[picks] + bw * rng.standard_normal(n_candidates)
        xs = np.clip(xs, ilo, ihi)
        score += kde_logpdf(xs, gvals, ilo, ihi)
        score -= kde_logpdf(xs, bvals, ilo, ihi)
        cand_vals[k] = xs
    best = int(np.argmax(score))
    return {k: _from_internal(space, k, cand_vals[k][best], rng)
            for k in keys}


def tpe_search(
    X: np.ndarray, y: np.ndarray,
    n_trials: int = 20,
    n_startup: int = 8,
    gamma: float = 0.25,
    n_candidates: int = 24,
    base: GBDTParams = GBDTParams(),
    space: Dict = None,
    sample_weight: Optional[np.ndarray] = None,
    seed: int = 42,
    n_rounds: int = 300,
    device: DeviceLike = None,
    verbose: bool = False,
) -> List[Trial]:
    """TPE search maximizing OOF F1 (the Optuna-default sampler, natively):
    the first ``n_startup`` trials are random; afterwards each proposal
    maximizes the good/bad Parzen density ratio. Returns trials sorted
    best-first."""
    rng = np.random.default_rng(seed)
    space = space or DEFAULT_SPACE
    trials: List[Trial] = []
    for t in range(n_trials):
        if t < n_startup:
            cfg = _sample(rng, space)
        else:
            cfg = _tpe_propose(rng, space, trials, gamma, n_candidates)
        params = base._replace(n_rounds=n_rounds, **cfg)
        cv = train_cv(X, y, None, params, sample_weight=sample_weight, device=device)
        trials.append(Trial(params=params, oof_f1=cv.best_f1,
                            threshold=cv.best_threshold))
        if verbose:
            print(f"   trial {t + 1}/{n_trials}"
                  f"{' (tpe)' if t >= n_startup else ''}: "
                  f"F1={cv.best_f1:.4f} {cfg}", flush=True)
    trials.sort(key=lambda tr: -tr.oof_f1)
    return trials
