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
  seconds of each stage.
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
from mallorn_tpu_torch.features import (bazin, colors, multiband_gp, physics, shape,
                                        statistical, tde)
from mallorn_tpu_torch.features.base import (FeatureSet, chunked_extract, feature_matrix,
                                             merge)
from mallorn_tpu_torch.train.adversarial import (ADV_PARAMS, AdversarialResult,
                                                 adversarial_validation)
from mallorn_tpu_torch.train.cv import CVResult, f1_score, train_cv
from mallorn_tpu_torch.train.feature_selection import (SelectionResult,
                                                       cached_select_features)
from mallorn_tpu_torch.trees import objectives
from mallorn_tpu_torch.trees.gbdt import V34A_PARAMS, GBDTParams
from mallorn_tpu_torch.utils.device import DeviceLike

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
    tr_packed, te_packed = unify_time_padding(tr_packed, te_packed)
    tr_bundle = extract_v34a_bundle(tr_packed, tr_meta, gp_steps, timings=timings,
                                    prefix="features_train/")
    te_bundle = extract_v34a_bundle(te_packed, te_meta, gp_steps, timings=timings,
                                    prefix="features_test/")
    y = np.asarray(tr_meta.target)

    t0 = time.perf_counter()
    Xv4, v4_names = feature_matrix(tr_bundle["features_v4"])
    Xv4 = finite_or_nan(Xv4).cpu().numpy()

    rounds = {"selection": 0}

    def importance():
        cv = train_cv(Xv4, y, None, params, device=device)
        rounds["selection"] = cv.rounds_run
        return cv.importance_gain

    selection = cached_select_features(selection_cache, Xv4, y, v4_names, importance,
                                       top_k, key_extra=params_digest(params))
    timings["selection"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    X_tr, names = assemble_v34a_matrix(tr_bundle, selection.selected)
    X_te, _ = assemble_v34a_matrix(te_bundle, selection.selected)
    X_tr, X_te = X_tr.cpu().numpy(), X_te.cpu().numpy()
    timings["assembly"] = time.perf_counter() - t0

    out = run_v92(X_tr, y, names, X_te, params=params, variants=V92D_ONLY,
                  adv_params=adv_params, device=device, timings=timings)
    timings["v92d_cv"] = timings.pop("cv_v92d_baseline_adv")
    winner = out.winner
    test_f1 = None
    if te_meta.target is not None:
        test_f1 = f1_score(te_meta.target, winner.test_preds > winner.best_threshold)
    timings["total"] = time.perf_counter() - t_all
    rounds.update(adversarial=out.adversarial.rounds_run, v92d=winner.rounds_run)
    return V92dTraining(winner=winner, adversarial=out.adversarial, selection=selection,
                        feature_names=out.feature_names, test_f1=test_f1, timings=timings,
                        rounds_run=rounds)
