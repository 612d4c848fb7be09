"""The v92d training pipeline (port of the v34a/v92 parts of
``mallorn_tpu.train.pipelines``).

- feature assembly: ``extract_features_v4`` (statistical + colors + shape
  + physics), ``extract_v34a_bundle`` (+ TDE, 2D-GP, Bazin) and
  ``assemble_v34a_matrix`` (selected-120 + the other families, pandas-style
  ``_x``/``_y`` collision names);
- ``run_v92``: v34a columns minus the two shift features, adversarial
  weights, then one CV per objective variant; v92d (plain logistic with
  adversarial weights and ``scale_pos_weight``) is the winner;
- ``train_v92d``: the whole v92d workload on packed train and test splits
  (features of both, the top-120 selection CV on features_v4, assembly,
  adversarial validation, the v92d CV, the threshold sweep), with the
  seconds of each stage;
- ``run_kaggle_ensemble``: the shipped deliverable, 3 models (v92d, v34a,
  and the leaf-wise v114d on the base columns + six research columns) x 5
  model seeds x 5 fixed folds, seed-averaged and blended 0.45 / 0.30 /
  0.25; ``train_kaggle_ensemble`` runs it on packed splits (the v34a
  matrix as ``train_v92d`` builds it, plus the research family of both
  splits).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mallorn_tpu_torch.data.packing import Metadata, PackedLightcurves, unify_time_padding
from mallorn_tpu_torch.features import (bazin, colors, multiband_gp, physics, research,
                                        shape, statistical, tde)
from mallorn_tpu_torch.features.base import (FeatureSet, chunked_extract, feature_matrix,
                                             merge)
from mallorn_tpu_torch.train.adversarial import (ADV_PARAMS, AdversarialResult,
                                                 adversarial_validation)
from mallorn_tpu_torch.train.cv import (CVResult, f1_score, stratified_kfold,
                                        threshold_sweep, train_cv)
from mallorn_tpu_torch.train.feature_selection import (SelectionResult,
                                                       cached_select_features)
from mallorn_tpu_torch.trees import objectives
from mallorn_tpu_torch.trees.gbdt import (V34A_PARAMS, GBDTParams, predict_margin_models,
                                          train_gbdt_folds)
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device

# v92d drops these as train/test-shift-prone
# (reference: train_v92_focal_adversarial.py:95-96).
SHIFT_FEATURES = ("all_rise_time", "all_asymmetry")

# v92 variant table (reference: train_v92_focal_adversarial.py:171-197)
V92_VARIANTS = {
    "v92a_focal_adv_g1_a85": {"gamma": 1.0, "alpha": 0.85},
    "v92b_focal_adv_g2_a85": {"gamma": 2.0, "alpha": 0.85},
    "v92c_focal_adv_g2_a90": {"gamma": 2.0, "alpha": 0.90},
    "v92d_baseline_adv": {"gamma": 0.0, "alpha": 0.5, "use_scale_pos_weight": True},
}
V92D_ONLY = {"v92d_baseline_adv": V92_VARIANTS["v92d_baseline_adv"]}


def finite_or_nan(X: torch.Tensor) -> torch.Tensor:
    """+-inf -> +-1e10, NaN kept (reference: train_v92_focal_adversarial.py:102-103)."""
    return torch.nan_to_num(X, nan=float("nan"), posinf=1e10, neginf=-1e10)


def _finite_or_nan(X: np.ndarray) -> np.ndarray:
    """``finite_or_nan`` of a host matrix."""
    return np.nan_to_num(X, nan=np.nan, posinf=1e10, neginf=-1e10)


@contextlib.contextmanager
def stage(timings: Optional[Dict[str, float]], name: str, device: torch.device):
    """Adds the stage's wall time to ``timings[name]`` (the device
    synchronised on both ends); does nothing when ``timings`` is None."""
    if timings is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def extract_features_v4(packed: PackedLightcurves, meta: Metadata,
                        chunk_size: int = 2048) -> FeatureSet:
    """statistical + colors + shape + physics: the features_v4 contract."""
    return merge(chunked_extract(statistical.extract, packed, meta, chunk_size=chunk_size),
                 chunked_extract(colors.extract, packed, meta, chunk_size=chunk_size),
                 chunked_extract(shape.extract, packed, chunk_size=chunk_size),
                 chunked_extract(physics.extract, packed, meta, chunk_size=chunk_size),
                 pandas_suffix=True)


def extract_v34a_bundle(packed: PackedLightcurves, meta: Metadata, gp_steps: int = 200,
                        chunk_size: int = 2048,
                        timings: Optional[Dict[str, float]] = None,
                        prefix: str = "") -> Dict[str, FeatureSet]:
    """The four families feeding v34a/v92d; ``timings`` (when given)
    collects each family's seconds as ``prefix + family``."""
    fams = (
        ("features_v4", lambda: extract_features_v4(packed, meta, chunk_size)),
        ("tde_physics", lambda: chunked_extract(tde.extract, packed, chunk_size=chunk_size)),
        ("multiband_gp", lambda: multiband_gp.extract(packed, meta, n_steps=gp_steps,
                                                      chunk_size=chunk_size)),
        ("bazin", lambda: chunked_extract(bazin.extract, packed, chunk_size=chunk_size)),
    )
    out = {}
    for name, fn in fams:
        with stage(timings, prefix + name, packed.device):
            out[name] = fn()
    return out


def assemble_v34a_matrix(bundle: Dict[str, FeatureSet], selected: Sequence[str]
                         ) -> Tuple[torch.Tensor, List[str]]:
    """selected-120 of features_v4 + tde + gp2d + bazin with pandas-style
    collision suffixes -> (finite-or-NaN matrix, column names)."""
    base = {k: bundle["features_v4"][k] for k in selected}
    full = merge(base, bundle["tde_physics"], bundle["multiband_gp"], bundle["bazin"],
                 pandas_suffix=True)
    X, names = feature_matrix(full)
    return finite_or_nan(X), names


def params_digest(params: GBDTParams) -> str:
    """A short digest of a fit configuration (the selection artifact's key)."""
    return hashlib.sha1(repr(tuple(params)).encode()).hexdigest()[:16]


@dataclasses.dataclass
class V92Result:
    variants: Dict[str, CVResult]
    adversarial: AdversarialResult
    feature_names: List[str]
    best_variant: str

    @property
    def winner(self) -> CVResult:
        return self.variants["v92d_baseline_adv"]


def run_v92(X_train: np.ndarray, y: np.ndarray, feature_names: Sequence[str],
            X_test: Optional[np.ndarray] = None, params: GBDTParams = V34A_PARAMS,
            variants: Optional[Dict] = None, adv: Optional[AdversarialResult] = None,
            adv_params: Optional[GBDTParams] = None, device: DeviceLike = None,
            verbose: bool = False, timings: Optional[Dict[str, float]] = None
            ) -> V92Result:
    """The winning pipeline: v34a columns minus the shift features, the
    adversarial weights, one CV per objective variant (reference:
    train_v92_focal_adversarial.py). ``timings`` collects the seconds of
    the adversarial stage and of each variant's CV."""
    timings = {} if timings is None else timings
    keep = [i for i, n in enumerate(feature_names) if n not in SHIFT_FEATURES]
    names = [feature_names[i] for i in keep]
    Xtr = _finite_or_nan(np.asarray(X_train)[:, keep])
    Xte = _finite_or_nan(np.asarray(X_test)[:, keep]) if X_test is not None else None

    if adv is None:
        if Xte is None:
            adv = AdversarialResult(auc=0.5, distribution_shift=False,
                                    sample_weights=np.ones(len(Xtr)),
                                    train_adv_preds=np.zeros(len(Xtr)),
                                    importance_gain=np.zeros(Xtr.shape[1]))
        else:
            t0 = time.perf_counter()
            adv = adversarial_validation(Xtr, Xte, params=adv_params or ADV_PARAMS,
                                         device=device)
            timings["adversarial"] = time.perf_counter() - t0

    results: Dict[str, CVResult] = {}
    for name, cfg in (variants or V92_VARIANTS).items():
        t0 = time.perf_counter()
        gamma = cfg.get("gamma", 0.0)
        common = dict(sample_weight=adv.sample_weights,
                      threshold_grid=np.linspace(0.05, 0.5, 200), device=device,
                      verbose=verbose)
        if gamma > 0:
            cv = train_cv(Xtr, y, Xte, params, use_scale_pos_weight=False,
                          objective=objectives.make_focal(gamma=gamma, alpha=cfg["alpha"]),
                          sigmoid_outputs=True, **common)
        else:
            cv = train_cv(Xtr, y, Xte, params,
                          use_scale_pos_weight=cfg.get("use_scale_pos_weight", False),
                          **common)
        results[name] = cv
        timings[f"cv_{name}"] = time.perf_counter() - t0
        if verbose:
            print(f"   {name}: OOF F1={cv.best_f1:.4f} @ {cv.best_threshold:.3f}", flush=True)
    best = max(results, key=lambda k: results[k].best_f1)
    return V92Result(variants=results, adversarial=adv, feature_names=names,
                     best_variant=best)


@dataclasses.dataclass
class V92dTraining:
    winner: CVResult
    adversarial: AdversarialResult
    selection: SelectionResult
    feature_names: List[str]  # the v92d columns (222 at full width)
    test_f1: Optional[float]  # against the test split's targets, when known
    timings: Dict[str, float]  # seconds per stage
    # boosting rounds each fit ran (selection 0 when its artifact was loaded)
    rounds_run: Dict[str, int]
    # the v34a families of (train, test), for a later run on the same data
    bundles: Optional[Tuple[Dict[str, FeatureSet], Dict[str, FeatureSet]]] = None


@dataclasses.dataclass
class _V34aMatrix:
    splits: Tuple[PackedLightcurves, PackedLightcurves]  # time padding unified
    bundles: Tuple[Dict[str, FeatureSet], Dict[str, FeatureSet]]
    selection: Optional[SelectionResult]  # None when the names were given
    X_tr: np.ndarray
    X_te: np.ndarray
    names: List[str]


def _v34a_matrix(tr_packed: PackedLightcurves, tr_meta: Metadata,
                 te_packed: PackedLightcurves, te_meta: Metadata, gp_steps: int,
                 params: GBDTParams, top_k: int, device: DeviceLike,
                 timings: Dict[str, float], rounds: Dict[str, int], bundles=None,
                 selected: Optional[Sequence[str]] = None, selection_cache=None
                 ) -> _V34aMatrix:
    """The prelude of ``train_v92d`` and ``train_kaggle_ensemble``: the
    v34a families of both splits (or ``bundles`` already extracted from
    them), the staged top-``top_k``
    selection (a ``params`` CV on features_v4 ranks the columns; loaded
    from ``selection_cache`` when its digest matches, never cached when
    None; skipped when ``selected`` names are given) and the 224-column
    assembly of both splits. ``rounds["selection"]`` gets the CV's rounds
    (0 when it did not run)."""
    tr_packed, te_packed = unify_time_padding(tr_packed, te_packed)
    if bundles is None:
        bundles = (extract_v34a_bundle(tr_packed, tr_meta, gp_steps, timings=timings,
                                       prefix="features_train/"),
                   extract_v34a_bundle(te_packed, te_meta, gp_steps, timings=timings,
                                       prefix="features_test/"))
    tr_bundle, te_bundle = bundles
    rounds["selection"] = 0
    selection = None
    if selected is None:
        t0 = time.perf_counter()
        y = np.asarray(tr_meta.target)
        Xv4, v4_names = feature_matrix(tr_bundle["features_v4"])
        Xv4 = finite_or_nan(Xv4).cpu().numpy()

        def importance():
            cv = train_cv(Xv4, y, None, params, device=device)
            rounds["selection"] = cv.rounds_run
            return cv.importance_gain

        selection = cached_select_features(selection_cache, Xv4, y, v4_names, importance,
                                           top_k, key_extra=params_digest(params))
        selected = selection.selected
        timings["selection"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    X_tr, names = assemble_v34a_matrix(tr_bundle, selected)
    X_te, _ = assemble_v34a_matrix(te_bundle, selected)
    timings["assembly"] = time.perf_counter() - t0
    return _V34aMatrix(splits=(tr_packed, te_packed), bundles=bundles, selection=selection,
                       X_tr=X_tr.cpu().numpy(), X_te=X_te.cpu().numpy(), names=names)


def train_v92d(tr_packed: PackedLightcurves, tr_meta: Metadata,
               te_packed: PackedLightcurves, te_meta: Metadata, gp_steps: int = 100,
               selection_cache=None, top_k: int = 120, params: GBDTParams = V34A_PARAMS,
               adv_params: GBDTParams = ADV_PARAMS, device: DeviceLike = None
               ) -> V92dTraining:
    """The v92d workload end to end, as the JAX package's benchmark runs
    it: the four feature families of both splits, the staged top-``top_k``
    selection (a ``params`` CV on features_v4 ranks the columns; loaded
    from ``selection_cache`` when its digest matches, never cached when
    None), the 224-column assembly, ``run_v92`` with the v92d variant
    (which drops the 2 shift features and runs adversarial validation with
    ``adv_params``), and the test F1 at the OOF threshold."""
    timings: Dict[str, float] = {}
    t_all = time.perf_counter()
    rounds: Dict[str, int] = {}
    mx = _v34a_matrix(tr_packed, tr_meta, te_packed, te_meta, gp_steps, params, top_k,
                      device, timings, rounds, selection_cache=selection_cache)
    y = np.asarray(tr_meta.target)
    out = run_v92(mx.X_tr, y, mx.names, mx.X_te, params=params, variants=V92D_ONLY,
                  adv_params=adv_params, device=device, timings=timings)
    timings["v92d_cv"] = timings.pop("cv_v92d_baseline_adv")
    winner = out.winner
    test_f1 = None
    if te_meta.target is not None:
        test_f1 = f1_score(te_meta.target, winner.test_preds > winner.best_threshold)
    timings["total"] = time.perf_counter() - t_all
    rounds.update(adversarial=out.adversarial.rounds_run, v92d=winner.rounds_run)
    return V92dTraining(winner=winner, adversarial=out.adversarial, selection=mx.selection,
                        feature_names=out.feature_names, test_f1=test_f1, timings=timings,
                        rounds_run=rounds, bundles=mx.bundles)


# ---------------------------------------------------------------------------
# the shipped Kaggle ensemble
# ---------------------------------------------------------------------------

# v115 research columns of the v114d member
# (reference: train_v115_xgb_research.py:120-132)
V115_MINIMAL_RESEARCH = (
    "nuclear_concentration", "nuclear_smoothness",
    "g_r_color_at_peak", "r_i_color_at_peak",
    "mhps_10_100_ratio", "mhps_30_100_ratio",
)

# v114d: the Optuna-tuned leaf-wise member (reference:
# scripts/package_features_for_kaggle.py:160-180; LightGBM's
# bagging_freq=5 as per-round subsampling at the same fraction,
# min_child_samples=42 as min_child_weight 10.5 = 42 x 0.25)
V114D_PARAMS = GBDTParams(
    n_rounds=654, max_depth=5, learning_rate=0.0394,
    subsample=0.659, colsample_bytree=0.591,
    min_child_weight=10.5, reg_alpha=1.524, reg_lambda=2.72,
    grow_policy="lossguide", max_leaves=8,
)

# the shipped notebook's contract (reference:
# notebooks/kaggle_multiseed_ensemble.py:78-91): CV seed 42 shared by
# every model, 5 model seeds, blend weights from leaderboard scores
KAGGLE_MODEL_SEEDS = (42, 123, 456, 789, 2024)
KAGGLE_CV_SEED = 42
KAGGLE_ENSEMBLE_WEIGHTS = {"v92d": 0.45, "v34a": 0.30, "v114d": 0.25}


@dataclasses.dataclass
class KaggleEnsembleResult:
    per_model: Dict[str, Dict]  # oof/test preds, threshold, f1s, rounds_run
    ensemble_oof: np.ndarray
    ensemble_test: Optional[np.ndarray]
    oof_f1: float
    threshold: float
    weights: Dict[str, float]
    adversarial: AdversarialResult


def _kaggle_nan(X: np.ndarray) -> np.ndarray:
    """The notebook's NaN policy (kaggle_multiseed_ensemble.py:237-238):
    NaN -> 0, +-inf -> +-1e10."""
    return np.nan_to_num(np.asarray(X, np.float32), nan=0.0, posinf=1e10, neginf=-1e10)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _multi_seed_cv(X: np.ndarray, y: np.ndarray, X_test: Optional[np.ndarray],
                   params: GBDTParams, folds: Sequence, seeds: Sequence[int],
                   sample_weight: Optional[np.ndarray], spw: float,
                   early_stopping_rounds: int = 50, verbose: bool = False, tag: str = "",
                   device: DeviceLike = None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict[int, float], int]:
    """One model x S seeds x K fixed folds as one batched fit of S*K lanes
    (the notebook varies only the model seed). Returns the seed-averaged
    OOF and test probabilities, each seed's OOF F1 and the boosting rounds
    the batched fit ran."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    lanes, lane_va = [], []
    for seed in seeds:
        for tr, va in folds:
            lanes.append({"y": y[tr], "w": (None if sample_weight is None
                                            else np.asarray(sample_weight[tr], np.float32)),
                          "y_val": y[va], "spw": spw, "seed": seed,
                          "X_parent": X, "tr_idx": tr, "va_idx": va})
            lane_va.append(va)
    models = train_gbdt_folds(
        lanes, params, early_stopping_rounds=early_stopping_rounds,
        pad_rows_to=max(len(l["y"]) for l in lanes),
        pad_val_rows_to=max(len(va) for va in lane_va), device=dev)
    rounds_run = max(int(np.isfinite(m.eval_history).sum()) for m in models)
    val_margins = predict_margin_models(
        models, [torch.as_tensor(X[va], device=dev) for va in lane_va]).cpu().numpy()
    test_margins = None
    if X_test is not None:
        Xt = torch.as_tensor(np.asarray(X_test, np.float32), device=dev)
        test_margins = predict_margin_models(models, Xt).cpu().numpy()

    def _sig(m):
        return 1.0 / (1.0 + np.exp(-np.asarray(m)))

    grid = np.linspace(0.03, 0.5, 100)  # notebook find_best_threshold :212
    n_folds = len(folds)
    oofs, tests, f1s = [], [], {}
    for si, seed in enumerate(seeds):
        oof = np.zeros(len(y))
        test_cols = []
        for fi in range(n_folds):
            li = si * n_folds + fi
            va = lane_va[li]
            oof[va] = _sig(val_margins[li][: len(va)])
            if test_margins is not None:
                test_cols.append(_sig(test_margins[li]))
        oofs.append(oof)
        if test_cols:
            tests.append(np.mean(test_cols, axis=0))
        f1s[seed], _ = threshold_sweep(y, oof, grid)
        if verbose:
            print(f"   [{tag}] seed {seed}: OOF F1={f1s[seed]:.4f}", flush=True)
    return (np.mean(oofs, axis=0), (np.mean(tests, axis=0) if tests else None), f1s,
            rounds_run)


def run_kaggle_ensemble(X_train: np.ndarray, y: np.ndarray, feature_names: Sequence[str],
                        research_train: FeatureSet, X_test: Optional[np.ndarray] = None,
                        research_test: Optional[FeatureSet] = None,
                        xgb_params: GBDTParams = V34A_PARAMS,
                        lgbm_params: GBDTParams = V114D_PARAMS,
                        seeds: Sequence[int] = KAGGLE_MODEL_SEEDS,
                        weights: Optional[Dict[str, float]] = None,
                        adv: Optional[AdversarialResult] = None, n_folds: int = 5,
                        verbose: bool = False, device: DeviceLike = None,
                        timings: Optional[Dict[str, float]] = None) -> KaggleEnsembleResult:
    """The final Kaggle deliverable: 3 models x 5 seeds over fixed folds
    (CV seed 42), LB-weighted blend (reference:
    notebooks/kaggle_multiseed_ensemble.py, scripts/package_features_for_kaggle.py:92-188).

    - v92d: ``xgb_params`` trees, adversarial weights and the global
      scale_pos_weight, on all 224 v34a names (the shift features kept);
    - v34a: the same without the adversarial weights;
    - v114d: ``lgbm_params`` (leaf-wise) with adversarial weights on the
      222 base columns + the six ``V115_MINIMAL_RESEARCH`` columns.

    Every matrix takes the notebook's NaN policy (``_kaggle_nan``); the
    adversarial weights come from the shift-dropped matrix (NaN kept). The
    per-model probabilities are seed averages; the blend's threshold
    comes from the 100-point grid 0.03..0.5. ``timings`` (when given)
    collects the seconds of the adversarial stage and of each member."""
    timings = {} if timings is None else timings
    y = np.asarray(y)
    weights = dict(weights or KAGGLE_ENSEMBLE_WEIGHTS)
    names = list(feature_names)
    keep = [i for i, n in enumerate(names) if n not in SHIFT_FEATURES]

    def v114_stack(X, research_set):
        cols = [_host(research_set[n]).astype(np.float32)[:, None]
                for n in V115_MINIMAL_RESEARCH]
        return np.concatenate([np.asarray(X, np.float32)[:, keep]] + cols, axis=1)

    X92 = _kaggle_nan(X_train)
    X92_te = _kaggle_nan(X_test) if X_test is not None else None
    X114 = _kaggle_nan(v114_stack(X_train, research_train))
    X114_te = (_kaggle_nan(v114_stack(X_test, research_test))
               if X_test is not None else None)

    if adv is None:
        if X_test is None:
            adv = AdversarialResult(auc=0.5, distribution_shift=False,
                                    sample_weights=np.ones(len(X92)),
                                    train_adv_preds=np.zeros(len(X92)),
                                    importance_gain=np.zeros(len(keep)))
        else:
            t0 = time.perf_counter()
            adv = adversarial_validation(
                _finite_or_nan(np.asarray(X_train, np.float32)[:, keep]),
                _finite_or_nan(np.asarray(X_test, np.float32)[:, keep]),
                params=ADV_PARAMS, device=device)
            timings["adversarial"] = time.perf_counter() - t0

    spw = float((y == 0).sum() / max((y == 1).sum(), 1))  # notebook :83
    folds = stratified_kfold(y, n_folds, KAGGLE_CV_SEED)
    grid = np.linspace(0.03, 0.5, 100)
    specs = {
        "v92d": (X92, X92_te, xgb_params, adv.sample_weights),
        "v34a": (X92, X92_te, xgb_params, None),
        "v114d": (X114, X114_te, lgbm_params, adv.sample_weights),
    }
    per_model: Dict[str, Dict] = {}
    for mname, (X, Xte, params, w) in specs.items():
        t0 = time.perf_counter()
        oof, test, seed_f1s, rounds_run = _multi_seed_cv(
            X, y, Xte, params, folds, seeds, w, spw, verbose=verbose, tag=mname, device=device)
        f1, thr = threshold_sweep(y, oof, grid)
        per_model[mname] = {"oof": oof, "test": test, "oof_f1": f1, "threshold": thr,
                            "seed_f1s": seed_f1s, "rounds_run": rounds_run}
        timings[mname] = time.perf_counter() - t0
        if verbose:
            print(f"  [kaggle] {mname}: seed-avg OOF F1={f1:.4f} @ {thr:.3f} "
                  f"({timings[mname]:.2f}s)", flush=True)

    ens_oof = np.zeros(len(y))
    ens_test = np.zeros(len(X92_te)) if X92_te is not None else None
    for mname, wgt in weights.items():
        ens_oof += wgt * per_model[mname]["oof"]
        if ens_test is not None and per_model[mname]["test"] is not None:
            ens_test += wgt * per_model[mname]["test"]
    f1, thr = threshold_sweep(y, ens_oof, grid)
    if verbose:
        print(f"  [kaggle] ensemble OOF F1={f1:.4f} @ {thr:.3f} (weights {weights})",
              flush=True)
    return KaggleEnsembleResult(per_model=per_model, ensemble_oof=ens_oof,
                                ensemble_test=ens_test, oof_f1=f1, threshold=thr,
                                weights=weights, adversarial=adv)


@dataclasses.dataclass
class KaggleTraining:
    result: KaggleEnsembleResult
    feature_names: List[str]  # the 224 v34a columns
    test_f1: Optional[float]  # the blend against the test split's targets, when known
    timings: Dict[str, float]  # seconds per stage
    rounds_run: Dict[str, int]  # boosting rounds of each batched fit


def train_kaggle_ensemble(tr_packed: PackedLightcurves, tr_meta: Metadata,
                          te_packed: PackedLightcurves, te_meta: Metadata,
                          gp_steps: int = 100,
                          bundles: Optional[Tuple[Dict[str, FeatureSet],
                                                  Dict[str, FeatureSet]]] = None,
                          selected: Optional[Sequence[str]] = None, top_k: int = 120,
                          params: GBDTParams = V34A_PARAMS,
                          lgbm_params: GBDTParams = V114D_PARAMS,
                          seeds: Sequence[int] = KAGGLE_MODEL_SEEDS,
                          device: DeviceLike = None, verbose: bool = False) -> KaggleTraining:
    """The shipped ensemble end to end on packed splits: the 224-column
    matrix as ``train_v92d`` builds it (from ``bundles`` and ``selected``
    when given, e.g. a ``V92dTraining``'s), the research family of both
    splits, then ``run_kaggle_ensemble`` and the blend's test F1 at its OOF
    threshold, with the seconds of each stage."""
    dev = resolve_device(device)
    timings: Dict[str, float] = {}
    t_all = time.perf_counter()
    rounds: Dict[str, int] = {}
    mx = _v34a_matrix(tr_packed, tr_meta, te_packed, te_meta, gp_steps, params, top_k,
                      dev, timings, rounds, bundles=bundles, selected=selected)
    tr_packed, te_packed = mx.splits
    y = np.asarray(tr_meta.target)
    with stage(timings, "research", dev):
        res_tr = chunked_extract(research.extract, tr_packed, tr_meta)
        res_te = chunked_extract(research.extract, te_packed, te_meta)

    result = run_kaggle_ensemble(mx.X_tr, y, mx.names, res_tr, mx.X_te, res_te,
                                 xgb_params=params, lgbm_params=lgbm_params, seeds=seeds,
                                 device=dev, verbose=verbose, timings=timings)
    test_f1 = None
    if te_meta.target is not None:
        test_f1 = f1_score(te_meta.target, result.ensemble_test > result.threshold)
    timings["total"] = time.perf_counter() - t_all
    rounds.update(adversarial=result.adversarial.rounds_run,
                  **{m: r["rounds_run"] for m, r in result.per_model.items()})
    return KaggleTraining(result=result, feature_names=mx.names, test_f1=test_f1,
                          timings=timings, rounds_run=rounds)
