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
  splits);
- the other binary runners: ``run_baseline`` (statistical features, a
  depth-6 and a 31-leaf CV, a 50/50 blend), ``run_v34a``, the
  squarederror soft-label regressions ``run_label_smoothing`` (v102),
  ``run_distillation`` (v108) and ``run_soft_pseudo`` (v97),
  ``run_pseudo_label`` (v42), ``run_mixup`` (v106), ``run_seed_ensemble``
  (v104: 10 seeds x 5 folds as one batched fit), ``run_easy_ensemble``
  (v93) and ``run_v115``;
- the other tree policies' configurations: ``V110_PARAMS`` (leaf-wise,
  heavily regularised), ``V111_PARAMS`` (its DART twin) and
  ``V118_PARAMS`` (symmetric trees), which the v119 stack combines with
  v34a (``train.ensembles.stack_oof``);
- ``run_v62``: a 4-class multi:softprob head on the simplified spectral
  type (``simplify_spectype``), whose class probabilities join the
  features of a final binary CV.
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
                                        threshold_sweep, train_cv, train_cv_multiclass)
from mallorn_tpu_torch.train.feature_selection import (SelectionResult,
                                                       cached_select_features)
from mallorn_tpu_torch.trees import objectives
from mallorn_tpu_torch.trees.gbdt import (V34A_PARAMS, GBDTModel, GBDTParams,
                                          predict_margin_models, train_gbdt_folds)
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
    # time padding unified; the test entries are None without a test split
    splits: Tuple[PackedLightcurves, Optional[PackedLightcurves]]
    bundles: Tuple[Dict[str, FeatureSet], Optional[Dict[str, FeatureSet]]]
    selection: Optional[SelectionResult]  # None when the names were given
    X_tr: np.ndarray
    X_te: Optional[np.ndarray]
    names: List[str]


def _v34a_matrix(tr_packed: PackedLightcurves, tr_meta: Metadata,
                 te_packed: Optional[PackedLightcurves], te_meta: Optional[Metadata],
                 gp_steps: int, params: GBDTParams, top_k: int, device: DeviceLike,
                 timings: Dict[str, float], rounds: Dict[str, int], bundles=None,
                 selected: Optional[Sequence[str]] = None, selection_cache=None
                 ) -> _V34aMatrix:
    """The prelude of ``train_v92d``, ``train_kaggle_ensemble`` and
    ``run_v34a``: the v34a families of both splits (or ``bundles`` already
    extracted from them; no test split when ``te_packed`` is None), the
    staged top-``top_k``
    selection (a ``params`` CV on features_v4 ranks the columns; loaded
    from ``selection_cache`` when its digest matches, never cached when
    None; skipped when ``selected`` names are given) and the 224-column
    assembly of both splits. ``rounds["selection"]`` gets the CV's rounds
    (0 when it did not run)."""
    if te_packed is not None:
        tr_packed, te_packed = unify_time_padding(tr_packed, te_packed)
    if bundles is None:
        bundles = (extract_v34a_bundle(tr_packed, tr_meta, gp_steps, timings=timings,
                                       prefix="features_train/"),
                   None if te_packed is None else
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
    X_te = None if te_bundle is None else assemble_v34a_matrix(te_bundle, selected)[0]
    timings["assembly"] = time.perf_counter() - t0
    return _V34aMatrix(splits=(tr_packed, te_packed), bundles=bundles, selection=selection,
                       X_tr=X_tr.cpu().numpy(),
                       X_te=None if X_te is None else X_te.cpu().numpy(), names=names)


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


def _sigmoid(m) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.asarray(m)))


# the shipped notebook's threshold grid (find_best_threshold :212)
KAGGLE_GRID = np.linspace(0.03, 0.5, 100)


def _multi_seed_cv(X: np.ndarray, y: np.ndarray, X_test: Optional[np.ndarray],
                   params: GBDTParams, seed_folds: Sequence[Sequence], seeds: Sequence[int],
                   sample_weight: Optional[np.ndarray], spw: Optional[float],
                   early_stopping_rounds: int = 50, verbose: bool = False, tag: str = "",
                   grid: Optional[np.ndarray] = KAGGLE_GRID, device: DeviceLike = None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict[int, float], int]:
    """One model x S seeds x K folds as one batched fit of S*K lanes: seed
    ``seeds[s]`` is the model seed of the lanes of its folds
    ``seed_folds[s]`` ((train, validation) index pairs; the notebook
    passes the same fixed folds for every seed, v104 each seed's own).
    ``spw`` None gives each lane its training rows' neg/pos ratio. Returns
    the seed-averaged OOF and test probabilities, each seed's OOF F1 over
    ``grid`` and the boosting rounds the batched fit ran."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    lanes, lane_va = [], []
    for seed, folds in zip(seeds, seed_folds):
        for tr, va in folds:
            lanes.append({"y": y[tr], "w": (None if sample_weight is None
                                            else np.asarray(sample_weight[tr], np.float32)),
                          "y_val": y[va], "seed": seed,
                          "spw": (float((y[tr] == 0).sum() / max((y[tr] == 1).sum(), 1))
                                  if spw is None else spw),
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

    oofs, tests, f1s = [], [], {}
    li = 0
    for seed, folds in zip(seeds, seed_folds):
        oof = np.zeros(len(y))
        test_cols = []
        for _, va in folds:
            oof[va] = _sigmoid(val_margins[li][: len(va)])
            if test_margins is not None:
                test_cols.append(_sigmoid(test_margins[li]))
            li += 1
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
    grid = KAGGLE_GRID
    specs = {
        "v92d": (X92, X92_te, xgb_params, adv.sample_weights),
        "v34a": (X92, X92_te, xgb_params, None),
        "v114d": (X114, X114_te, lgbm_params, adv.sample_weights),
    }
    per_model: Dict[str, Dict] = {}
    for mname, (X, Xte, params, w) in specs.items():
        t0 = time.perf_counter()
        oof, test, seed_f1s, rounds_run = _multi_seed_cv(
            X, y, Xte, params, [folds] * len(seeds), seeds, w, spw, verbose=verbose,
            tag=mname, device=device)
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
    # the research family of (train, test), for a later run on the same data
    research: Optional[Tuple[FeatureSet, FeatureSet]] = None


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
                          timings=timings, rounds_run=rounds, research=(res_tr, res_te))


# ---------------------------------------------------------------------------
# the baseline and v34a
# ---------------------------------------------------------------------------

# The reference baseline's XGBoost config (reference:
# scripts/train_baseline.py:112-123): depth 6, lr 0.05, 500 rounds,
# subsample / colsample 0.8, scale_pos_weight.
BASELINE_PARAMS = GBDTParams(
    n_rounds=500, max_depth=6, learning_rate=0.05,
    subsample=0.8, colsample_bytree=0.8,
    min_child_weight=1.0, reg_alpha=0.0, reg_lambda=1.0,
)

# Its LightGBM config (reference: scripts/train_baseline.py:182-194):
# leaf-wise, LightGBM's default 31 leaves, depth cap 6, lr 0.05.
BASELINE_LGBM_PARAMS = GBDTParams(
    n_rounds=500, max_depth=6, learning_rate=0.05,
    subsample=0.8, colsample_bytree=0.8,
    min_child_weight=1e-3, reg_alpha=0.0, reg_lambda=0.0,
    grow_policy="lossguide", max_leaves=31,
)


@dataclasses.dataclass
class PipelineResult:
    cv: CVResult
    feature_names: list
    oof_f1: float
    threshold: float
    test_binary: Optional[np.ndarray]
    timings: Dict[str, float]
    lgbm_cv: Optional[CVResult] = None  # the baseline's leaf-wise family
    blend_test_preds: Optional[np.ndarray] = None  # 50/50 depthwise + leaf-wise


def _zero_filled(X: torch.Tensor) -> np.ndarray:
    """The baseline's NaN policy (train_baseline.py:89): NaN and +-inf -> 0."""
    return torch.nan_to_num(X, nan=0.0, posinf=0.0, neginf=0.0).cpu().numpy()


def run_baseline(train_packed: PackedLightcurves, train_meta: Metadata,
                 test_packed: Optional[PackedLightcurves] = None,
                 test_meta: Optional[Metadata] = None,
                 params: GBDTParams = BASELINE_PARAMS,
                 lgbm_params: Optional[GBDTParams] = BASELINE_LGBM_PARAMS,
                 verbose: bool = False, device: DeviceLike = None) -> PipelineResult:
    """Statistical features + GBDT, the train_baseline.py equivalent: NaN
    and +-inf set to 0, a depthwise CV at ``params`` and (unless
    ``lgbm_params`` is None) a leaf-wise CV on the same folds; the test
    probabilities blend 50/50 and are thresholded at a fixed 0.5
    (train_baseline.py:169-261, 298-303). The headline OOF F1 and threshold
    are the depthwise CV's sweep. ``timings``: features_s and train_s (both
    CVs), and each CV's share, depthwise_s and lgbm_s."""
    dev = resolve_device(device)
    timings: Dict[str, float] = {}
    with stage(timings, "features_s", dev):
        X_tr, names = feature_matrix(chunked_extract(statistical.extract, train_packed,
                                                     train_meta))
        X_train = _zero_filled(X_tr)
        X_test = None
        if test_packed is not None:
            X_te, _ = feature_matrix(chunked_extract(statistical.extract, test_packed,
                                                     test_meta), names)
            X_test = _zero_filled(X_te)
    y = np.asarray(train_meta.target)
    with stage(timings, "train_s", dev):
        with stage(timings, "depthwise_s", dev):
            cv = train_cv(X_train, y, X_test, params, device=dev, verbose=verbose)
        lgbm_cv = None
        if lgbm_params is not None:
            with stage(timings, "lgbm_s", dev):
                lgbm_cv = train_cv(X_train, y, X_test, lgbm_params, device=dev,
                                   verbose=verbose)
    test_binary = blend = None
    if cv.test_preds is not None:
        blend = cv.test_preds
        if lgbm_cv is not None and lgbm_cv.test_preds is not None:
            blend = 0.5 * cv.test_preds + 0.5 * lgbm_cv.test_preds
        test_binary = (blend > 0.5).astype(int)
    return PipelineResult(cv=cv, feature_names=names, oof_f1=cv.best_f1,
                          threshold=cv.best_threshold, test_binary=test_binary,
                          timings=timings, lgbm_cv=lgbm_cv, blend_test_preds=blend)


@dataclasses.dataclass
class V34aResult:
    cv: CVResult
    feature_names: List[str]
    selection: Optional[SelectionResult]  # None when ``selected`` was given
    oof_f1: float
    threshold: float
    test_preds: Optional[np.ndarray]
    timings: Dict[str, float]


def run_v34a(train_packed: PackedLightcurves, train_meta: Metadata,
             test_packed: Optional[PackedLightcurves] = None,
             test_meta: Optional[Metadata] = None, params: GBDTParams = V34A_PARAMS,
             gp_steps: int = 200, selection_params: Optional[GBDTParams] = None,
             top_k: int = 120, selection_cache=None, verbose: bool = False,
             bundles: Optional[Tuple[Dict[str, FeatureSet],
                                     Optional[Dict[str, FeatureSet]]]] = None,
             selected: Optional[Sequence[str]] = None,
             device: DeviceLike = None) -> V34aResult:
    """The v34a Bazin-backbone pipeline (reference: train_v34a_bazin.py):
    features_v4 -> the top-``top_k`` selection (a CV at
    ``selection_params or params``, staged in ``selection_cache``) -> +
    TDE + 2D-GP + Bazin -> a 5-fold CV at ``params`` with
    scale_pos_weight. As ``train_kaggle_ensemble``, it takes the families
    (``bundles``) and the selected names (``selected``) of an earlier run
    on the same splits, and then extracts or selects nothing."""
    dev = resolve_device(device)
    timings: Dict[str, float] = {}
    mx = _v34a_matrix(train_packed, train_meta, test_packed, test_meta, gp_steps,
                      selection_params or params, top_k, dev, timings, {}, bundles=bundles,
                      selected=selected, selection_cache=selection_cache)
    y = np.asarray(train_meta.target)
    with stage(timings, "train_s", dev):
        cv = train_cv(mx.X_tr, y, mx.X_te, params, device=dev, verbose=verbose)
    return V34aResult(cv=cv, feature_names=mx.names, selection=mx.selection,
                      oof_f1=cv.best_f1, threshold=cv.best_threshold,
                      test_preds=cv.test_preds, timings=timings)


# ---------------------------------------------------------------------------
# the soft-label regressions (v102, v97, v108), pseudo-labels (v42), MixUp
# (v106)
# ---------------------------------------------------------------------------

# the reg:squarederror config shared by v102 / v97 / v108 (reference:
# train_v102_label_smoothing.py:134-146, train_v108:213-223: depth 6, lr
# 0.02, alpha 0.1, lambda 1.0; the reference's 1500 estimators early-stop
# far sooner at lr 0.02)
SOFT_LABEL_PARAMS = GBDTParams(
    n_rounds=600, max_depth=6, learning_rate=0.02,
    subsample=0.8, colsample_bytree=0.8,
    min_child_weight=1.0, reg_alpha=0.1, reg_lambda=1.0,
    base_score=0.5, eval_metric="rmse",
)

# v102 epsilon variants (reference: train_v102_label_smoothing.py:152-156)
V102_EPSILONS = {"v102a_eps01": 0.01, "v102b_eps05": 0.05, "v102c_eps10": 0.10}


def _soft_cv(X_train, y, X_test, params, sample_weight, verbose, device, **hooks) -> CVResult:
    """A squarederror CV without scale_pos_weight, on raw margins."""
    return train_cv(X_train, y, X_test, params, sample_weight=sample_weight,
                    use_scale_pos_weight=False, objective=objectives.squarederror,
                    sigmoid_outputs=False, device=device, verbose=verbose, **hooks)


def run_label_smoothing(X_train: np.ndarray, y: np.ndarray,
                        X_test: Optional[np.ndarray] = None, epsilon: float = 0.05,
                        params: GBDTParams = SOFT_LABEL_PARAMS,
                        sample_weight: Optional[np.ndarray] = None, verbose: bool = False,
                        device: DeviceLike = None) -> CVResult:
    """v102: regression on smoothed labels 0 -> eps, 1 -> 1 - eps
    (reference: train_v102_label_smoothing.py:113-114), which also feed the
    early-stopping metric; hard-label OOF F1; raw regression outputs."""
    y = np.asarray(y)
    y_smooth = np.where(y == 1, 1.0 - epsilon, epsilon).astype(np.float32)
    return _soft_cv(X_train, y, X_test, params, sample_weight, verbose, device,
                    y_train_soft=y_smooth)


def run_soft_pseudo(X_train: np.ndarray, y: np.ndarray, X_test: np.ndarray,
                    test_preds: np.ndarray, threshold: float = 0.90, soft_tde: float = 0.90,
                    soft_non_tde: float = 0.10, use_actual_probs: bool = False,
                    match_class_ratio: bool = True, params: GBDTParams = SOFT_LABEL_PARAMS,
                    sample_weight: Optional[np.ndarray] = None, seed: int = 42,
                    verbose: bool = False, device: DeviceLike = None) -> CVResult:
    """v97: test objects the teacher is confident about (``test_preds`` >
    ``threshold`` or < 1 - ``threshold``) join every fold's training rows
    with soft targets (``soft_tde`` / ``soft_non_tde``, or the teacher's
    own probabilities with ``use_actual_probs``); the non-TDE rows are
    subsampled to the training split's class ratio (reference:
    train_v97_soft_pseudo.py:139-230)."""
    y = np.asarray(y).astype(np.float32)
    test_preds = np.asarray(test_preds)
    rng = np.random.default_rng(seed)
    tde_idx = np.nonzero(test_preds > threshold)[0]
    non_idx = np.nonzero(test_preds < (1.0 - threshold))[0]
    if match_class_ratio and len(tde_idx) > 0:
        ratio = float((y == 0).sum()) / max(float((y == 1).sum()), 1.0)
        n_non = min(int(len(tde_idx) * ratio), len(non_idx))
        if n_non < len(non_idx):
            non_idx = np.sort(rng.choice(non_idx, size=n_non, replace=False))
    keep = np.concatenate([tde_idx, non_idx]).astype(int)
    if use_actual_probs:
        y_pseudo = test_preds[keep].astype(np.float32)
    else:
        y_pseudo = np.where(test_preds[keep] > 0.5, soft_tde, soft_non_tde).astype(np.float32)
    if verbose:
        print(f"   soft pseudo: +{len(tde_idx)} TDE, +{len(non_idx)} non-TDE", flush=True)
    extra = (np.asarray(X_test, np.float32)[keep], y_pseudo, None) if len(keep) else None
    return _soft_cv(X_train, y, X_test, params, sample_weight, verbose, device,
                    extra_train=extra)


def temperature_scale(probs: np.ndarray, temperature: float) -> np.ndarray:
    """p -> sigmoid(logit(p) / T) (reference:
    train_v108_knowledge_distillation.py:150-163)."""
    p = np.clip(np.asarray(probs, np.float64), 1e-7, 1.0 - 1e-7)
    logits = np.log(p / (1.0 - p))
    return 1.0 / (1.0 + np.exp(-logits / temperature))


def run_distillation(X_train: np.ndarray, y: np.ndarray, teacher_oof: np.ndarray,
                     X_test: Optional[np.ndarray] = None, alpha: float = 0.5,
                     temperature: float = 1.0, params: GBDTParams = SOFT_LABEL_PARAMS,
                     sample_weight: Optional[np.ndarray] = None, verbose: bool = False,
                     device: DeviceLike = None) -> CVResult:
    """v108: the student regresses on alpha * hard + (1 - alpha) *
    temperature_scale(teacher) (reference:
    train_v108_knowledge_distillation.py:166-180, 227-241; the teachers are
    OOF probability vectors such as v92d's)."""
    y = np.asarray(y).astype(np.float32)
    targets = (alpha * y + (1.0 - alpha)
               * temperature_scale(teacher_oof, temperature)).astype(np.float32)
    return _soft_cv(X_train, y, X_test, params, sample_weight, verbose, device,
                    y_train_soft=targets)


def run_pseudo_label(X_train: np.ndarray, y: np.ndarray, X_test: np.ndarray,
                     test_preds: np.ndarray, params: GBDTParams = V34A_PARAMS,
                     confidence: float = 0.99, sample_weight: Optional[np.ndarray] = None,
                     verbose: bool = False, device: DeviceLike = None) -> CVResult:
    """v42: test objects predicted > 0.99 (TDE) or < 0.01 (non-TDE) join
    the training set as hard pseudo-labels (weight 1), then an ordinary
    logistic CV runs over the enlarged set (reference:
    train_v42_pseudolabel.py:68-171)."""
    hi = test_preds > confidence
    lo = test_preds < 1.0 - confidence
    X_aug = np.vstack([X_train, X_test[hi], X_test[lo]])
    y_aug = np.concatenate([y, np.ones(hi.sum()), np.zeros(lo.sum())])
    w_aug = None
    if sample_weight is not None:
        w_aug = np.concatenate([sample_weight, np.ones(hi.sum() + lo.sum())])
    if verbose:
        print(f"   pseudo-labels: +{hi.sum()} TDE, +{lo.sum()} non-TDE", flush=True)
    return train_cv(X_aug, y_aug, X_test, params, sample_weight=w_aug, device=device)


def mixup_matrix(X: np.ndarray, y: np.ndarray, sample_weight: Optional[np.ndarray],
                 alpha: float, seed: int):
    """MixUp on a feature matrix (reference: train_v106_mixup.py:123-164):
    lambda ~ Beta(alpha, alpha) folded to >= 0.5, rows replaced by their
    mixes with a random partner, weights by their geometric mean; NaN in,
    NaN out. numpy's ``default_rng(seed)`` draws lambda, then the
    permutation."""
    rng = np.random.default_rng(seed)
    n = len(X)
    lam = rng.beta(alpha, alpha, size=n).astype(np.float32)
    lam = np.maximum(lam, 1.0 - lam)
    idx = rng.permutation(n)
    X_mix = lam[:, None] * X + (1.0 - lam[:, None]) * X[idx]
    y_mix = lam * y + (1.0 - lam) * y[idx]
    w_mix = None
    if sample_weight is not None:
        w_mix = np.sqrt(sample_weight * sample_weight[idx]).astype(np.float32)
    return X_mix.astype(np.float32), y_mix.astype(np.float32), w_mix


def run_mixup(X_train: np.ndarray, y: np.ndarray, X_test: Optional[np.ndarray] = None,
              alpha: float = 0.2, seeds: Sequence[int] = (42, 123, 456),
              params: GBDTParams = SOFT_LABEL_PARAMS,
              sample_weight: Optional[np.ndarray] = None, n_folds: int = 5,
              verbose: bool = False, device: DeviceLike = None) -> CVResult:
    """v106 (reference: train_v106_mixup.py): per seed, a stratified K-fold
    squarederror CV whose folds' training rows are replaced by their MixUp
    (``mixup_matrix`` seeded seed + fold + 1) and whose validation rows
    keep their hard labels (:249-257). OOF and test outputs are clipped to
    [0, 1] and averaged over the seeds; the sweep runs on the average
    (:283-291). ``models`` holds each seed's fold models in turn."""
    y = np.asarray(y)
    oof_runs, test_runs, per_seed_f1 = [], [], []
    models, importance = [], None
    for seed in seeds:
        cv = _soft_cv(X_train, y, X_test, params, sample_weight, verbose, device,
                      n_folds=n_folds, seed=seed,
                      train_transform=lambda Xf, yf, wf, k, _s=seed: mixup_matrix(
                          Xf, yf, wf, alpha, _s + k + 1))
        oof_runs.append(np.clip(cv.oof_preds, 0.0, 1.0))
        if X_test is not None:
            test_runs.append(np.clip(cv.test_preds, 0.0, 1.0))
        per_seed_f1.append(cv.best_f1)
        models.extend(cv.models)
        imp = np.asarray(cv.importance_gain)
        importance = imp if importance is None else importance + imp
        if verbose:
            print(f"   mixup seed {seed}: OOF F1 {cv.best_f1:.4f}", flush=True)
    oof = np.mean(oof_runs, axis=0)
    test_preds = np.mean(test_runs, axis=0) if test_runs else None
    best_f1, best_threshold = threshold_sweep(y, oof, np.linspace(0.05, 0.5, 200))
    return CVResult(oof_preds=oof, test_preds=test_preds, fold_f1s=per_seed_f1,
                    best_f1=best_f1, best_threshold=best_threshold,
                    importance_gain=importance, models=models)


# ---------------------------------------------------------------------------
# the seed ensemble (v104), the easy ensemble (v93), v115
# ---------------------------------------------------------------------------

# v104 seed list (reference: train_v104_seed_ensemble.py:130)
V104_SEEDS = (42, 123, 456, 789, 1024, 2048, 3141, 4242, 5555, 6789)

# v115c's research columns (reference: train_v115_xgb_research.py:120-132)
V115_EXTENDED_RESEARCH = V115_MINIMAL_RESEARCH + (
    "nuclear_position_score", "mhps_10d", "mhps_30d",
    "g_r_color_peak_to_late", "r_i_color_peak_to_late",
)


def run_seed_ensemble(X_train: np.ndarray, y: np.ndarray, X_test: np.ndarray,
                      params: GBDTParams = V34A_PARAMS,
                      sample_weight: Optional[np.ndarray] = None,
                      seeds: Sequence[int] = V104_SEEDS, n_folds: int = 5,
                      early_stopping_rounds: int = 50, verbose: bool = False,
                      device: DeviceLike = None, rounds: Optional[Dict[str, int]] = None
                      ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict[int, float]]:
    """v104 (reference: train_v104_seed_ensemble.py:129-203): per seed its
    own stratified folds and model seed, each lane with its fold's
    scale_pos_weight; all seeds x folds train as ONE batched fit. Returns
    the seed-averaged OOF and test probabilities and each seed's OOF F1;
    ``rounds["fit"]`` (when given) gets the rounds the batched fit ran."""
    y = np.asarray(y)
    oof, test, f1s, rounds_run = _multi_seed_cv(
        X_train, y, X_test, params, [stratified_kfold(y, n_folds, s) for s in seeds], seeds,
        sample_weight, None, early_stopping_rounds=early_stopping_rounds, verbose=verbose,
        tag="v104", grid=None, device=device)
    if rounds is not None:
        rounds["fit"] = rounds_run
    return oof, test, f1s


def run_easy_ensemble(X_train: np.ndarray, y: np.ndarray,
                      X_test: Optional[np.ndarray] = None, n_estimators: int = 10,
                      undersample_ratio: float = 1.0,
                      params: GBDTParams = V34A_PARAMS._replace(n_rounds=300),
                      sample_weight: Optional[np.ndarray] = None, seed: int = 42,
                      verbose: bool = False, device: DeviceLike = None) -> CVResult:
    """v93 EasyEnsemble (reference: train_v93_easy_ensemble.py:119-183):
    ``n_estimators`` models, each on every minority row plus
    ``undersample_ratio`` x as many majority rows drawn without
    replacement, at a fixed round count with no early stopping (an 8-row
    dummy validation set only tracks the metric), trained as ONE batched
    fit; probabilities average over the models. The sweep runs on the
    averaged FULL-TRAIN probabilities, in-sample as in the reference
    (:176-180), so its F1 is optimistic."""
    dev = resolve_device(device)
    y = np.asarray(y)
    rng = np.random.default_rng(seed)
    minority = np.where(y == 1)[0]
    majority = np.where(y == 0)[0]
    n_maj = min(int(len(minority) * undersample_ratio), len(majority))
    X_dummy_val = np.asarray(X_train[:8], np.float32)
    y_dummy_val = y[:8].astype(np.float32)
    folds = []
    for _ in range(n_estimators):
        sub = np.concatenate([minority, rng.choice(majority, size=n_maj, replace=False)])
        rng.shuffle(sub)
        folds.append({"X": np.asarray(X_train[sub], np.float32), "y": y[sub],
                      "w": (np.asarray(sample_weight[sub], np.float32)
                            if sample_weight is not None else None),
                      "X_val": X_dummy_val, "y_val": y_dummy_val, "spw": 1.0,
                      "seed": params.seed})
    if verbose:
        print(f"   easy-ensemble: {n_estimators} models, {len(minority)} TDE + {n_maj} "
              f"non-TDE each", flush=True)
    models = train_gbdt_folds(folds, params, early_stopping_rounds=None, device=dev)

    def mean_prob(X):
        Xd = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        return _sigmoid(predict_margin_models(models, Xd).cpu().numpy()).mean(axis=0)

    oof = mean_prob(X_train)
    test_preds = None if X_test is None else mean_prob(X_test)
    best_f1, best_threshold = threshold_sweep(y, oof, np.linspace(0.05, 0.5, 200))
    importance = None
    for m in models:
        imp = np.asarray(m.importance_gain)
        importance = imp if importance is None else importance + imp
    return CVResult(oof_preds=oof, test_preds=test_preds, fold_f1s=[], best_f1=best_f1,
                    best_threshold=best_threshold, importance_gain=importance,
                    models=list(models))


def run_v115(X_train: np.ndarray, y: np.ndarray, feature_names: Sequence[str],
             research_train: FeatureSet, X_test: Optional[np.ndarray] = None,
             research_test: Optional[FeatureSet] = None,
             extra: Sequence[str] = V115_EXTENDED_RESEARCH, params: GBDTParams = V34A_PARAMS,
             adv: Optional[AdversarialResult] = None, verbose: bool = False,
             device: DeviceLike = None) -> V92Result:
    """v115c: the v92d recipe on the v34a columns + the ``extra`` research
    columns (reference: train_v115_xgb_research.py; v115c scored private LB
    0.6757, the best post-deadline config)."""

    def stack(X, research_set):
        cols = [_host(research_set[n]).astype(np.float32)[:, None] for n in extra]
        return np.concatenate([np.asarray(X, np.float32)] + cols, axis=1)

    Xtr = stack(X_train, research_train)
    Xte = stack(X_test, research_test) if X_test is not None else None
    names = list(feature_names) + list(extra)
    return run_v92(Xtr, y, names, Xte, params=params,
                   variants={"v92d_baseline_adv": {"gamma": 0.0, "use_scale_pos_weight": True}},
                   adv=adv, device=device, verbose=verbose)


# ---------------------------------------------------------------------------
# the other tree policies (v110, v111, v118) and the multiclass head (v62)
# ---------------------------------------------------------------------------

# v110 heavily-regularized LightGBM (reference:
# scripts/train_v110_lgbm_regularized.py:118-139)
V110_PARAMS = GBDTParams(
    n_rounds=600, max_depth=4, learning_rate=0.02,
    subsample=0.5, colsample_bytree=0.4,
    min_child_weight=1e-3, reg_alpha=5.0, reg_lambda=10.0,
    grow_policy="lossguide", max_leaves=15,
)

# v111 LightGBM DART (reference: scripts/train_v111_lgbm_dart.py:114-130:
# boosting 'dart', drop_rate 0.15 on the v110 shape)
V111_PARAMS = V110_PARAMS._replace(dart_rate=0.15)

# v118 CatBoost-for-diversity (reference: scripts/train_v118_catboost.py:5-11):
# symmetric (oblivious) trees, depth 5, l2_leaf_reg ~3, no per-tree column
# sampling (rsm=1)
V118_PARAMS = GBDTParams(
    n_rounds=500, max_depth=5, learning_rate=0.03,
    subsample=0.8, colsample_bytree=1.0,
    min_child_weight=1e-3, reg_alpha=0.0, reg_lambda=3.0,
    grow_policy="symmetric",
)

# v62 multiclass config (reference:
# scripts/train_v62_multiclass_ensemble.py:171-186): multi:softprob, depth
# 5, lr 0.03, mcw 3, alpha 0.3, lambda 1.5, 400 rounds, ES 50; run_v62 sets
# num_class
V62_MC_PARAMS = GBDTParams(
    n_rounds=400, max_depth=5, learning_rate=0.03,
    subsample=0.8, colsample_bytree=0.8,
    min_child_weight=3.0, reg_alpha=0.3, reg_lambda=1.5,
    eval_metric="mlogloss",
)


def simplify_spectype(spec_type: np.ndarray) -> np.ndarray:
    """7 SpecType classes -> 4 (reference: train_v62:74-85): TDE, AGN,
    SN_Ia (thermonuclear), SN_CC (II/IIn/Ibc/SLSN core-collapse bucket)."""
    st = np.asarray(spec_type).astype(str)
    out = np.full(len(st), "SN_CC", dtype=object)
    out[st == "TDE"] = "TDE"
    out[st == "AGN"] = "AGN"
    out[st == "SN Ia"] = "SN_Ia"
    return out.astype(str)


@dataclasses.dataclass
class V62Result:
    cv: CVResult  # final binary classifier on the enhanced features
    mc_oof: np.ndarray  # [N, K] multiclass OOF probabilities
    mc_test: Optional[np.ndarray]
    mc_classes: List[str]
    mc_tde_f1: float  # TDE detection F1 from the multiclass head alone
    feature_names: List[str]
    oof_f1: float
    threshold: float
    mc_models: Optional[List[GBDTModel]] = None  # the multiclass head's fold models


def run_v62(X_train: np.ndarray, y_binary: np.ndarray, spec_type: np.ndarray,
            feature_names: Sequence[str], X_test: Optional[np.ndarray] = None,
            mc_params: GBDTParams = V62_MC_PARAMS, params: GBDTParams = V34A_PARAMS,
            verbose: bool = False, device: DeviceLike = None) -> V62Result:
    """v62: a 4-class multi:softprob model over the simplified SpecType,
    whose class probabilities join the features of a final binary CV
    (reference: scripts/train_v62_multiclass_ensemble.py): P(TDE), P(AGN),
    P(SN_Ia), P(SN_CC) and the TDE/AGN and TDE/SN_Ia probability ratios
    (:245-268). The multiclass head's own TDE F1 sweeps
    ``linspace(0.01, 0.5, 100)`` (:224-233)."""
    y_mc_names = simplify_spectype(spec_type)
    classes = sorted(set(y_mc_names))  # LabelEncoder order (sorted)
    cls_idx = {c: i for i, c in enumerate(classes)}
    y_mc = np.asarray([cls_idx[c] for c in y_mc_names], np.int32)

    Xtr = _finite_or_nan(np.asarray(X_train, np.float32))
    Xte = _finite_or_nan(np.asarray(X_test, np.float32)) if X_test is not None else None
    mc_oof, mc_test, mc_models = train_cv_multiclass(
        Xtr, y_mc, Xte, mc_params._replace(num_class=len(classes)), device=device,
        verbose=verbose)

    ti, ai, si, ci = (cls_idx[c] for c in ("TDE", "AGN", "SN_Ia", "SN_CC"))

    def mc_cols(P):
        return np.column_stack([P[:, ti], P[:, ai], P[:, si], P[:, ci],
                                P[:, ti] / (P[:, ai] + 0.001),
                                P[:, ti] / (P[:, si] + 0.001)]).astype(np.float32)

    mc_f1, _ = threshold_sweep(y_binary, mc_oof[:, ti], np.linspace(0.01, 0.5, 100))
    mc_names = ["mc_prob_tde", "mc_prob_agn", "mc_prob_sn_ia", "mc_prob_sn_cc",
                "mc_ratio_tde_agn", "mc_ratio_tde_sn_ia"]
    X_enh = np.column_stack([Xtr, mc_cols(mc_oof)])
    X_enh_te = np.column_stack([Xte, mc_cols(mc_test)]) if Xte is not None else None
    cv = train_cv(X_enh, y_binary, X_enh_te, params, use_scale_pos_weight=True,
                  device=device, verbose=verbose)
    return V62Result(cv=cv, mc_oof=mc_oof, mc_test=mc_test, mc_classes=classes,
                     mc_tde_f1=mc_f1, feature_names=list(feature_names) + mc_names,
                     oof_f1=cv.best_f1, threshold=cv.best_threshold, mc_models=mc_models)
