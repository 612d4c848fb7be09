"""mallorn-torch: the port's command line (port of ``mallorn_tpu.cli.main``).

    python -m mallorn_tpu_torch.cli.main synth   --out data/ --n-objects 1000
    python -m mallorn_tpu_torch.cli.main extract --data data/ --cache cache/
    python -m mallorn_tpu_torch.cli.main train   --data data/ --cache cache/ --config v92d
    python -m mallorn_tpu_torch.cli.main predict --data data/ --cache cache/ \\
        --model artifacts/models_v92d

The JAX command line's commands, options and ``--config`` choices, over
the port's modules: CSV files in the reference's layout in
(``data.loader``, the native parser), feature caches (``io.cache``),
model files (``io.model_store``) and submissions out. Every command runs
on the card; ``main(argv, device="cpu")`` runs it on the host (the tests
do).

``train --mesh N`` runs the command on N ranks (``parallel.mesh.launch``:
NCCL, one card per rank; gloo ranks on the host under ``device="cpu"``),
with the rank's mesh as the default mesh of that invocation only, so every
GBDT CV of the config trains with its rows split over the ranks (the same
forests as on one device). Rank 0 writes every file.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np

from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device

CONFIGS = ["baseline", "v9", "v10", "v13", "v14", "v16", "v19", "v20",
           "v22", "v26", "v27", "v30", "v34a",
           "v35", "v40", "v42", "v45", "v47", "v48",
           "v55", "v56", "v57", "v58", "v59b",
           "v60", "v62", "v64", "v65", "v66",
           "v92", "v92a", "v92b", "v92c", "v92d", "v93",
           "v97", "v102", "v102a", "v102b", "v102c",
           "v103", "v103a", "v103b", "v103c",
           "v104", "v105", "v106", "v108",
           "v110", "v111", "v114d", "v115c", "v118",
           "v119", "kaggle"]

FAMILIES = ("features_v4", "tde_physics", "multiband_gp", "bazin",
            "research", "powerlaw", "powerlaw_ratio", "tde_models",
            "time_to_decline", "fourier", "enhanced_colors", "high_snr",
            "cesium", "gp1d", "peak_ordering", "fwhm", "temp_fwhm",
            "advanced", "advanced_physics", "blackbody", "dtw", "astromer")

# the backbone-plus-family experiments (reference: train_v9_dtw.py,
# train_v20_advanced.py, train_v26_astromer.py, ..., train_v66_high_snr.py)
FAMILY_CONFIGS = {"v9": "dtw", "v20": "advanced", "v26": "astromer",
                  "v30": "advanced_physics", "v35": "cesium", "v40": "fourier",
                  "v47": "enhanced_colors", "v48": "time_to_decline",
                  "v55": "powerlaw", "v56": "peak_ordering", "v58": "fwhm",
                  "v59b": "temp_fwhm", "v64": "blackbody", "v65": "powerlaw_ratio",
                  "v66": "high_snr"}


def _log(msg):
    print(msg, flush=True)


def cmd_synth(args):
    from mallorn_tpu_torch.data.synthetic import generate_dataset, write_reference_layout

    for split, n, seed in (("train", args.n_objects, args.seed),
                           ("test", int(args.n_objects * 2.33), args.seed + 1)):
        _, meta, cols = generate_dataset(n, seed=seed, tde_frac=0.05, device=args.device)
        write_reference_layout(args.out, cols, meta, split=split)
        _log(f"wrote {split}: {n} objects under {args.out}")


def extract_family(family, packed, meta, gp_steps, dtw_templates=None):
    """One family's FeatureSet on the packed split's device."""
    from mallorn_tpu_torch.features import (advanced, advanced_physics, astromer, bazin,
                                            blackbody, cesium, dtw, enhanced_colors,
                                            fourier, fwhm, gp1d, high_snr, multiband_gp,
                                            peak_ordering, powerlaw, powerlaw_ratio,
                                            research, tde, tde_models, temp_fwhm,
                                            time_to_decline)
    from mallorn_tpu_torch.features.base import chunked_extract
    from mallorn_tpu_torch.train.pipelines import extract_features_v4

    if family == "features_v4":
        return extract_features_v4(packed, meta)
    if family == "multiband_gp":
        return multiband_gp.extract(packed, meta, n_steps=gp_steps)
    # these batch the whole split themselves
    if family == "astromer":
        return astromer.extract(packed, meta)
    if family == "advanced":
        return advanced.extract(packed, meta)
    if family == "advanced_physics":
        return advanced_physics.extract(packed, meta)
    if family == "blackbody":
        return blackbody.extract(packed, meta)
    if family == "dtw":
        if dtw_templates is None:
            raise ValueError("dtw extraction needs templates built from the "
                             "labeled train split (dtw.build_templates)")
        return dtw.extract(packed, dtw_templates, meta)
    table = {
        "tde_physics": (tde.extract, ()),
        "bazin": (bazin.extract, ()),
        "research": (research.extract, (meta,)),
        "powerlaw": (powerlaw.extract, ()),
        "powerlaw_ratio": (powerlaw_ratio.extract, ()),
        "tde_models": (tde_models.extract, ()),
        "time_to_decline": (time_to_decline.extract, ()),
        "fourier": (fourier.extract, ()),
        "enhanced_colors": (enhanced_colors.extract, ()),
        "high_snr": (high_snr.extract, ()),
        "cesium": (cesium.extract, ()),
        "gp1d": (gp1d.extract, ()),
        "peak_ordering": (peak_ordering.extract, ()),
        "fwhm": (fwhm.extract, ()),
        "temp_fwhm": (temp_fwhm.extract, ()),
    }
    if family not in table:
        raise ValueError(f"unknown family {family}")
    fn, fargs = table[family]
    return chunked_extract(fn, packed, *fargs)


def cmd_extract(args):
    from mallorn_tpu_torch.data.loader import load_all_data
    from mallorn_tpu_torch.io.cache import save_features

    data = load_all_data(Path(args.data), device=args.device)
    cache = Path(args.cache)
    families = args.families.split(",") if args.families else FAMILIES
    # DTW's class templates come from the labeled train split and serve
    # both splits (reference src/features/dtw_features.py:91-150)
    dtw_templates = None
    if "dtw" in families and "train_packed" in data:
        from mallorn_tpu_torch.features.dtw import build_templates
        dtw_templates = build_templates(data["train_packed"], data["train_meta"].target)
    for split in ("train", "test"):
        if f"{split}_packed" not in data:
            continue
        packed, meta = data[f"{split}_packed"], data[f"{split}_meta"]
        for family in families:
            t0 = time.perf_counter()
            feats = extract_family(family, packed, meta, args.gp_steps,
                                   dtw_templates=dtw_templates)
            save_features(cache / f"{family}_{split}.npz", feats, meta.object_ids)
            _log(f"{split}/{family}: {len(feats)} features "
                 f"in {time.perf_counter() - t0:.1f}s")


def load_matrices(cache, split, families):
    """The cached families of a split side by side: (matrix, names)."""
    from mallorn_tpu_torch.io.cache import load_features

    mats, names = [], []
    for fam in families:
        m, n, _ = load_features(Path(cache) / f"{fam}_{split}.npz")
        mats.append(m)
        names.extend(n)
    return np.concatenate(mats, axis=1), names


def apply_overrides(params, rounds=None, overrides=None):
    """``--rounds`` and ``--set`` on a GBDTParams: any field by name, e.g.
    ``--set reg_lambda=5.0,subsample=0.7,max_depth=4`` (the reference's
    parameter-delta scripts: train_v8_tuned.py, train_v28a_regularized.py,
    train_v29a_mild_reg.py, train_v81_stronger_regularization.py)."""
    if rounds is not None:
        params = params._replace(n_rounds=rounds)
    for kv in (overrides.split(",") if overrides else ()):
        k, _, v = kv.partition("=")
        k = k.strip()
        if k not in params._fields:
            raise SystemExit(f"--set: unknown GBDTParams field {k!r} "
                             f"(valid: {', '.join(params._fields)})")
        cur = getattr(params, k)
        v = v.strip()
        low = v.lower()
        typ = type(cur)
        if typ is bool:
            if low in ("1", "true", "yes"):
                val = True
            elif low in ("0", "false", "no"):
                val = False
            else:
                raise SystemExit(f"--set: {k} is a boolean field, got {v!r} "
                                 "(use true/false/1/0/yes/no)")
        elif typ is str:
            val = v
        elif typ is int:
            try:
                val = int(v, 10)  # exact (float() would round beyond 2^53)
            except ValueError:
                raise SystemExit(f"--set: {k} is an integer field, got {v!r}")
        else:
            try:
                num = float(v)
            except ValueError:
                raise SystemExit(f"--set: {k}={v!r} is not a number "
                                 f"(field type {typ.__name__})")
            if not math.isfinite(num):
                raise SystemExit(f"--set: {k}={v!r} must be finite")
            val = typ(num)
        params = params._replace(**{k: val})
    return params


def _research(cache, with_test):
    from mallorn_tpu_torch.io.cache import load_features

    r_tr, r_names, _ = load_features(Path(cache) / "research_train.npz")
    research_tr = {n: r_tr[:, i] for i, n in enumerate(r_names)}
    research_te = None
    if with_test:
        r_te, _, _ = load_features(Path(cache) / "research_test.npz")
        research_te = {n: r_te[:, i] for i, n in enumerate(r_names)}
    return research_tr, research_te


def cmd_train(args):
    from mallorn_tpu_torch.data.loader import load_metadata
    from mallorn_tpu_torch.io.model_store import save_cv_models
    from mallorn_tpu_torch.io.submission import write_submission
    from mallorn_tpu_torch.train import pipelines
    from mallorn_tpu_torch.train.cv import train_cv

    dev = args.device
    writer = getattr(args, "writer", True)  # False on the ranks of a mesh but rank 0
    log = load_metadata(Path(args.data), "train")
    y = log["target"]

    def R(params):
        return apply_overrides(params, args.rounds, args.set)

    def cv_result(cv, **extra):
        return ({"oof_f1": cv.best_f1, "threshold": cv.best_threshold, **extra},
                cv.test_preds, cv.best_threshold)

    object_ids_test = None
    try:
        object_ids_test = load_metadata(Path(args.data), "test")["object_id"]
    except FileNotFoundError:
        pass
    has_test = object_ids_test is not None

    out_dir = Path(args.out)
    if writer:
        out_dir.mkdir(parents=True, exist_ok=True)

    if args.config == "baseline":
        Xtr, names = load_matrices(args.cache, "train", ["features_v4"])
        Xte = load_matrices(args.cache, "test", ["features_v4"])[0] if has_test else None
        Xtr = np.nan_to_num(Xtr, nan=0.0, posinf=0.0, neginf=0.0)
        Xte = np.nan_to_num(Xte, nan=0.0, posinf=0.0, neginf=0.0) if has_test else None
        # a depth-6 and a leaf-wise CV on the same folds, a 50/50 test blend
        # at a fixed 0.5 threshold (reference: train_baseline.py:169-303)
        cv = train_cv(Xtr, y, Xte, R(pipelines.BASELINE_PARAMS), device=dev, verbose=True)
        lgbm_cv = train_cv(Xtr, y, Xte, R(pipelines.BASELINE_LGBM_PARAMS), device=dev,
                           verbose=True)
        result = {"oof_f1": cv.best_f1, "threshold": cv.best_threshold,
                  "lgbm_oof_f1": lgbm_cv.best_f1}
        test_preds = cv.test_preds
        if test_preds is not None:
            test_preds = 0.5 * cv.test_preds + 0.5 * lgbm_cv.test_preds
        threshold = 0.5
    else:
        # v19 predates the Bazin cache: selected-120 + tde + gp2d only
        # (reference: scripts/train_v19_multiband_gp.py:64-112)
        fams = (["features_v4", "tde_physics", "multiband_gp"] if args.config == "v19"
                else ["features_v4", "tde_physics", "multiband_gp", "bazin"])
        Xv4, v4_names = load_matrices(args.cache, "train", ["features_v4"])
        Xv4 = pipelines._finite_or_nan(Xv4)
        # the staged selection artifact under the feature cache, keyed by
        # the data and the selection CV's parameters (reference:
        # scripts/feature_selection.py:352-358, train_v34a_bazin.py:59-68)
        from mallorn_tpu_torch.train.feature_selection import cached_select_features

        sel_params = R(pipelines.V34A_PARAMS._replace(n_rounds=200))
        selection = cached_select_features(
            Path(args.cache) / "selected_features.npz", Xv4, y, v4_names,
            lambda: train_cv(Xv4, y, None, sel_params, device=dev).importance_gain,
            120, key_extra=pipelines.params_digest(sel_params), save=writer)

        sel_idx = [v4_names.index(n) for n in selection.selected]
        Xtr_all, all_names = load_matrices(args.cache, "train", fams)
        keep = sel_idx + list(range(len(v4_names), len(all_names)))
        names = [all_names[i] for i in keep]
        Xtr = pipelines._finite_or_nan(Xtr_all[:, keep])
        Xte = None
        if has_test:
            Xte = pipelines._finite_or_nan(load_matrices(args.cache, "test", fams)[0][:, keep])

        def with_columns(extra_tr, extra_te, **extra):
            """``train_cv`` at V34A_PARAMS on the backbone + extra columns."""
            Xtr2 = pipelines._finite_or_nan(np.concatenate([Xtr, extra_tr], axis=1))
            Xte2 = None if not has_test else pipelines._finite_or_nan(
                np.concatenate([Xte, extra_te], axis=1))
            cv = train_cv(Xtr2, y, Xte2, R(pipelines.V34A_PARAMS), device=dev, verbose=True)
            return cv_result(cv, n_features=Xtr2.shape[1], **extra)

        if args.config in ("v34a", "v19"):
            cv = train_cv(Xtr, y, Xte, R(pipelines.V34A_PARAMS), device=dev, verbose=True)
            result, test_preds, threshold = cv_result(cv, n_features=len(names))
            if writer:
                save_cv_models(out_dir / f"models_{args.config}", cv.models,
                               cv.best_threshold, names)
        elif args.config == "v14":
            # the residual MLP's CV on the selected engineered columns
            # (reference scripts/train_v14_nn_features.py:51-117, 141-153)
            from mallorn_tpu_torch.models.mlp import train_mlp_cv

            Xte14 = None
            if has_test:
                Xte_v4, _ = load_matrices(args.cache, "test", ["features_v4"])
                Xte14 = pipelines._finite_or_nan(Xte_v4)[:, sel_idx]
            n_ep = args.rounds if args.rounds is not None else 150
            out = train_mlp_cv(Xv4[:, sel_idx], y, Xte14, n_epochs=n_ep, device=dev)
            result = {"oof_f1": out["best_f1"], "threshold": out["threshold"],
                      "n_features": len(sel_idx)}
            test_preds, threshold = out["test_preds"], out["threshold"]
        elif args.config in ("v110", "v111", "v118"):
            # regularised leaf-wise / DART / symmetric trees on the v34a
            # columns (reference: train_v110_lgbm_regularized.py,
            # train_v111_lgbm_dart.py, train_v118_catboost.py)
            params = {"v110": pipelines.V110_PARAMS, "v111": pipelines.V111_PARAMS,
                      "v118": pipelines.V118_PARAMS}[args.config]
            cv = train_cv(Xtr, y, Xte, R(params), device=dev, verbose=True)
            result, test_preds, threshold = cv_result(cv, n_features=len(names))
        elif args.config == "v119":
            # stacking: depthwise + leaf-wise + symmetric base CVs -> a
            # logistic meta-learner (reference: train_v119_stacking.py:33,139-163)
            from mallorn_tpu_torch.train.ensembles import stack_oof

            bases = {}
            for nm, p in (("xgb", pipelines.V34A_PARAMS), ("lgbm", pipelines.V110_PARAMS),
                          ("cat", pipelines.V118_PARAMS)):
                bases[nm] = train_cv(Xtr, y, Xte, R(p), device=dev)
                print(f"  base {nm}: OOF F1={bases[nm].best_f1:.4f}")
            out = stack_oof([b.oof_preds for b in bases.values()], y,
                            test_preds=([b.test_preds for b in bases.values()]
                                        if Xte is not None else None))
            result = {"oof_f1": out["best_f1"], "threshold": out["threshold"],
                      "base_f1": {k: b.best_f1 for k, b in bases.items()}}
            test_preds, threshold = out["test_preds"], out["threshold"]
        elif args.config == "v60":
            # the two-stage cautious-AGN-filter classifier
            # (reference: scripts/train_v60_two_stage.py:1-12)
            from mallorn_tpu_torch.train.ensembles import two_stage

            out = two_stage(Xtr, y, Xte, stage1_params=R(pipelines.V34A_PARAMS),
                            stage2_params=R(pipelines.V34A_PARAMS), device=dev)
            result = {"oof_f1": out["best_f1"], "threshold": out["threshold"],
                      "n_filtered": out["n_filtered"]}
            test_preds, threshold = out["test_preds"], out["threshold"]
        elif args.config.startswith("v92"):
            key = {"v92": "v92d_baseline_adv", "v92d": "v92d_baseline_adv",
                   "v92a": "v92a_focal_adv_g1_a85", "v92b": "v92b_focal_adv_g2_a85",
                   "v92c": "v92c_focal_adv_g2_a90"}[args.config]
            # bare "v92" runs the whole reference script (all four objective
            # variants); vNN one variant
            variants = (pipelines.V92_VARIANTS if args.config == "v92"
                        else {key: pipelines.V92_VARIANTS[key]})
            out = pipelines.run_v92(Xtr, y, names, Xte, params=R(pipelines.V34A_PARAMS),
                                    variants=variants, device=dev, verbose=True)
            cv = out.variants[key]
            result, test_preds, threshold = cv_result(
                cv, adv_auc=out.adversarial.auc, n_features=len(out.feature_names))
            if writer:
                save_cv_models(out_dir / f"models_{args.config}", cv.models,
                               cv.best_threshold, out.feature_names)
            # v121's per-object error analysis of the winner's OOF
            # (reference: scripts/train_v121_error_analysis.py)
            from mallorn_tpu_torch.train.analysis import error_analysis, print_error_analysis

            kept = [i for i, n in enumerate(names) if n not in pipelines.SHIFT_FEATURES]
            report = error_analysis(
                y, cv.oof_preds, cv.best_threshold, X=Xtr[:, kept],
                feature_names=out.feature_names, importance_gain=cv.importance_gain,
                object_ids=log["object_id"], z=log.get("Z"), spec_type=log.get("SpecType"),
                other_models={k: v.oof_preds for k, v in out.variants.items() if k != key})
            print_error_analysis(report)
            result["confusion"] = report["confusion"]
            result["hard_tde_count"] = report["hard_tde_count"]
        elif args.config == "v104":
            # the v92d columns and adversarial weights, then the 10-seed ensemble
            out = pipelines.run_v92(Xtr, y, names, Xte, params=R(pipelines.V34A_PARAMS),
                                    variants=pipelines.V92D_ONLY, device=dev)
            kept = [i for i, n in enumerate(names) if n not in pipelines.SHIFT_FEATURES]
            X92tr = pipelines._finite_or_nan(np.asarray(Xtr)[:, kept])
            X92te = None if Xte is None else pipelines._finite_or_nan(np.asarray(Xte)[:, kept])
            oof, test_preds, f1s = pipelines.run_seed_ensemble(
                X92tr, y, X92te, params=R(pipelines.V34A_PARAMS),
                sample_weight=out.adversarial.sample_weights, device=dev, verbose=True)
            from mallorn_tpu_torch.train.cv import threshold_sweep
            f1, threshold = threshold_sweep(y, oof, np.linspace(0.05, 0.5, 200))
            result = {"oof_f1": f1, "threshold": threshold, "seed_f1s": f1s}
        elif args.config == "v42":
            base = train_cv(Xtr, y, Xte, R(pipelines.V34A_PARAMS), device=dev)
            cv = pipelines.run_pseudo_label(Xtr, y, Xte, base.test_preds,
                                            params=R(pipelines.V34A_PARAMS), device=dev,
                                            verbose=True)
            result, test_preds, threshold = cv_result(cv)
        elif args.config in ("v115c", "v114d"):
            # v115c: the v92d recipe + research columns; v114d: the tuned
            # leaf-wise member of the shipped ensemble on the minimal research
            # columns (reference: package_features_for_kaggle.py:160-180,
            # train_v114_optimized_lgbm.py, train_v115_xgb_research.py)
            research_tr, research_te = _research(args.cache, has_test)
            kw = ({"params": R(pipelines.V34A_PARAMS)} if args.config == "v115c" else
                  {"extra": pipelines.V115_MINIMAL_RESEARCH,
                   "params": R(pipelines.V114D_PARAMS)})
            out = pipelines.run_v115(Xtr, y, names, research_tr, Xte, research_te,
                                     device=dev, verbose=True, **kw)
            result, test_preds, threshold = cv_result(
                out.winner, adv_auc=out.adversarial.auc, n_features=len(out.feature_names))
        elif args.config == "kaggle":
            # the final deliverable: 3 models x 5 seeds, LB-weighted blend
            # (reference: notebooks/kaggle_multiseed_ensemble.py:1-35)
            research_tr, research_te = _research(args.cache, has_test)
            out = pipelines.run_kaggle_ensemble(
                Xtr, y, names, research_tr, Xte, research_te,
                xgb_params=R(pipelines.V34A_PARAMS), lgbm_params=R(pipelines.V114D_PARAMS),
                device=dev, verbose=True)
            result = {"oof_f1": out.oof_f1, "threshold": out.threshold,
                      "weights": out.weights, "adv_auc": out.adversarial.auc,
                      "model_f1s": {k: v["oof_f1"] for k, v in out.per_model.items()},
                      "model_thresholds": {k: v["threshold"]
                                           for k, v in out.per_model.items()}}
            test_preds, threshold = out.ensemble_test, out.threshold
            # per-model multiseed submissions beside the blend (notebook :316-326)
            if has_test and writer:
                for mname, m in out.per_model.items():
                    if m["test"] is not None:
                        write_submission(out_dir / f"submission_{mname}_multiseed.csv",
                                         object_ids_test,
                                         (m["test"] > m["threshold"]).astype(int))
        elif args.config == "v16":
            # external labeled rows join every fold's training rows; the
            # folds, validation and OOF stay on the primary data (reference:
            # prepare_plasticc_data.py + train_v16_plasticc_combined.py:160-190)
            if not args.data_external or not args.cache_external:
                raise SystemExit("v16 needs --data-external and --cache-external")
            y_ext = load_metadata(Path(args.data_external), "train")["target"]
            Xe_all, _ = load_matrices(args.cache_external, "train", fams)
            Xe = pipelines._finite_or_nan(Xe_all[:, keep])
            cv = train_cv(Xtr, y, Xte, R(pipelines.V34A_PARAMS), extra_train=(Xe, y_ext),
                          device=dev, verbose=True)
            result, test_preds, threshold = cv_result(
                cv, n_external=len(y_ext), external_tdes=int(y_ext.sum()))
        elif args.config == "v57":
            # dereddened colour twins on the v34a backbone
            # (reference: scripts/train_v57_extinction_corrected.py:143-177)
            from mallorn_tpu_torch.features.extinction import dered_matrix

            d_tr, d_names = dered_matrix(Xtr, names, log["EBV"])
            d_te = None
            if has_test:
                d_te, _ = dered_matrix(Xte, names,
                                       load_metadata(Path(args.data), "test")["EBV"])
            result, test_preds, threshold = with_columns(d_tr, d_te, n_dered=len(d_names))
        elif args.config in FAMILY_CONFIGS:
            # a cached family's columns on the v34a backbone (v26: the
            # pretrained astromer embeddings)
            fam = FAMILY_CONFIGS[args.config]
            p_tr, _ = load_matrices(args.cache, "train", [fam])
            p_te = load_matrices(args.cache, "test", [fam])[0] if has_test else None
            result, test_preds, threshold = with_columns(p_tr, p_te)
        elif args.config == "v45":
            # physics-binned categorical columns on the backbone (reference:
            # src/features/catboost_categorical.py:21-159)
            from mallorn_tpu_torch.features.categorical import add_categorical_features

            def cats(X):
                c, c_names = add_categorical_features(dict(zip(names, np.asarray(X, np.float64).T)))
                cols = (np.stack([c[k] for k in c_names], axis=1) if c_names
                        else np.zeros((len(X), 0)))
                return cols, c_names

            c_tr, cat_names = cats(Xtr)
            c_te = cats(Xte)[0] if has_test else None
            result, test_preds, threshold = with_columns(c_tr, c_te,
                                                         n_categorical=len(cat_names))
        elif args.config == "v105":
            # physics interactions, the top 30 by point-biserial correlation on
            # the train split (reference: src/features/interactions.py:23-196)
            from mallorn_tpu_torch.features.interactions import (
                create_physics_interactions, select_top_interactions)

            inter_tr = create_physics_interactions(dict(zip(names, np.asarray(Xtr, np.float64).T)))
            top = select_top_interactions(inter_tr, y, top_k=30)

            def stack(inter, n):
                return (np.stack([inter[k] for k in top], axis=1) if top
                        else np.zeros((n, 0)))

            i_te = None
            if has_test:
                i_te = stack(create_physics_interactions(
                    dict(zip(names, np.asarray(Xte, np.float64).T))), len(Xte))
            result, test_preds, threshold = with_columns(stack(inter_tr, len(Xtr)), i_te,
                                                         n_interactions=len(top))
        elif args.config == "v62":
            # a 4-class softprob head -> class-probability columns -> the final
            # binary CV (reference: scripts/train_v62_multiclass_ensemble.py)
            if "SpecType" not in log:
                raise SystemExit("v62 needs SpecType in the train log")
            out62 = pipelines.run_v62(Xtr, y, log["SpecType"], names, Xte,
                                      mc_params=R(pipelines.V62_MC_PARAMS),
                                      params=R(pipelines.V34A_PARAMS), device=dev,
                                      verbose=True)
            result = {"oof_f1": out62.oof_f1, "threshold": out62.threshold,
                      "mc_tde_f1": out62.mc_tde_f1, "mc_classes": out62.mc_classes,
                      "n_features": len(out62.feature_names)}
            test_preds, threshold = out62.cv.test_preds, out62.threshold
        elif args.config.startswith("v102"):
            # label-smoothing regression (reference: train_v102_label_smoothing.py;
            # a/b/c = eps .01/.05/.10)
            eps = {"v102": 0.05, "v102a": 0.01, "v102b": 0.05, "v102c": 0.10}[args.config]
            cv = pipelines.run_label_smoothing(Xtr, y, Xte, epsilon=eps,
                                               params=R(pipelines.SOFT_LABEL_PARAMS),
                                               device=dev, verbose=True)
            result, test_preds, threshold = cv_result(cv, epsilon=eps)
        elif args.config == "v97":
            # soft pseudo-labels from a v34a teacher (reference:
            # train_v97_soft_pseudo.py, v97b: threshold .90)
            base = train_cv(Xtr, y, Xte, R(pipelines.V34A_PARAMS), device=dev)
            cv = pipelines.run_soft_pseudo(Xtr, y, Xte, base.test_preds,
                                           params=R(pipelines.SOFT_LABEL_PARAMS), device=dev,
                                           verbose=True)
            result, test_preds, threshold = cv_result(cv, teacher_oof_f1=base.best_f1)
        elif args.config == "v108":
            # knowledge distillation from a v34a teacher (reference:
            # train_v108_knowledge_distillation.py, v108a: T=1 a=.5)
            teacher = train_cv(Xtr, y, Xte, R(pipelines.V34A_PARAMS), device=dev)
            cv = pipelines.run_distillation(Xtr, y, teacher.oof_preds, Xte,
                                            params=R(pipelines.SOFT_LABEL_PARAMS),
                                            device=dev, verbose=True)
            result, test_preds, threshold = cv_result(cv, teacher_oof_f1=teacher.best_f1)
        elif args.config == "v93":
            # EasyEnsemble: balanced undersampled models (reference:
            # train_v93_easy_ensemble.py, v93a: 10 models, 1:1)
            cv = pipelines.run_easy_ensemble(
                Xtr, y, Xte, n_estimators=10, undersample_ratio=1.0,
                params=R(pipelines.V34A_PARAMS._replace(n_rounds=300)), device=dev,
                verbose=True)
            result, test_preds, threshold = cv_result(cv, in_sample_f1=True)
        elif args.config.startswith("v103"):
            # CV pseudo-labels without test leakage: the student regresses on
            # blend * hard + (1 - blend) * teacher OOF (reference:
            # train_v103_cv_pseudo.py:199-236)
            blend = {"v103": 0.5, "v103a": 0.0, "v103b": 0.5, "v103c": 0.8}[args.config]
            teacher = train_cv(Xtr, y, Xte, R(pipelines.V34A_PARAMS), device=dev)
            cv = pipelines.run_distillation(Xtr, y, teacher.oof_preds, Xte, alpha=blend,
                                            temperature=1.0,
                                            params=R(pipelines.SOFT_LABEL_PARAMS),
                                            device=dev, verbose=True)
            result, test_preds, threshold = cv_result(cv, blend=blend,
                                                      teacher_oof_f1=teacher.best_f1)
        elif args.config == "v106":
            # MixUp (reference: train_v106_mixup.py, v106a: alpha 0.2, 3 seeds)
            cv = pipelines.run_mixup(Xtr, y, Xte, alpha=0.2,
                                     params=R(pipelines.SOFT_LABEL_PARAMS), device=dev,
                                     verbose=True)
            result, test_preds, threshold = cv_result(cv, seed_f1s=cv.fold_f1s)
        elif args.config in pipelines.DL_CONFIGS:
            # the sequence models on the stratified 80/20 holdout, focal
            # loss, full-batch Adam; --rounds maps to epochs (reference
            # BENCHMARKS.md:32-60; ATAT's tabular tower reads the matrix)
            from mallorn_tpu_torch.data.loader import load_all_data

            data = load_all_data(Path(args.data), device=dev)
            with_test = has_test and "test_packed" in data
            res = pipelines.run_dl_model(
                args.config, data["train_packed"], data["train_meta"],
                data["test_packed"] if with_test else None,
                data["test_meta"] if with_test else None,
                X_tab=Xtr if args.config == "v22" else None,
                X_tab_test=Xte if args.config == "v22" and with_test else None,
                n_epochs=args.rounds if args.rounds is not None else 100, device=dev)
            result = {"val_f1": res.val_f1, "threshold": res.threshold,
                      "final_loss": float(res.losses[-1])}
            test_preds, threshold = res.test_preds, res.threshold
        else:
            raise SystemExit(f"unknown config {args.config}")

    _log(json.dumps(result, default=float))
    if not writer:
        return
    (out_dir / f"result_{args.config}.json").write_text(
        json.dumps(result, default=float, indent=2))

    if object_ids_test is not None and test_preds is not None:
        sub = write_submission(out_dir / f"submission_{args.config}.csv", object_ids_test,
                               (test_preds > threshold).astype(int))
        _log(f"submission: {sub}")


def model_columns(all_names, feature_names):
    """Indices into the cached families' columns (``all_names``) of a
    model's ``feature_names``. A name that several families carry (colors'
    and tde_physics' ``temp_stability``, say) names one column per copy
    the model kept: ``train`` keeps features_v4's selected columns and then
    every column of the other families, so the model's k-th of m copies is
    the k-th of the last m of the cache's copies. (The JAX command line
    maps every copy to the last, ``mallorn_tpu/cli/main.py:777-781``, which
    feeds a model that kept both copies the wrong column.)"""
    where = {}
    for i, n in enumerate(all_names):
        where.setdefault(n, []).append(i)
    missing = [n for n in feature_names if n not in where]
    if missing:
        raise SystemExit(f"cached features missing columns: {missing[:5]}...")
    wanted = {n: feature_names.count(n) for n in where if n in feature_names}
    seen = dict.fromkeys(wanted, 0)
    idx = []
    for n in feature_names:
        copies = where[n]
        if wanted[n] > len(copies):
            raise SystemExit(f"the model has {wanted[n]} columns named {n!r}; the cache "
                             f"{len(copies)}")
        idx.append(copies[len(copies) - wanted[n] + seen[n]])
        seen[n] += 1
    return idx


def cmd_predict(args):
    """Predictions of saved fold models on cached features."""
    from mallorn_tpu_torch.data.loader import load_metadata
    from mallorn_tpu_torch.io.model_store import load_cv_models
    from mallorn_tpu_torch.io.submission import write_submission
    from mallorn_tpu_torch.train import pipelines
    from mallorn_tpu_torch.trees.gbdt import predict_proba_folds

    models, man = load_cv_models(args.model, device=args.device)
    fams = ["features_v4", "tde_physics", "multiband_gp", "bazin"]
    X_all, all_names = load_matrices(args.cache, args.split, fams)
    X = X_all[:, model_columns(all_names, man["feature_names"])]
    X = pipelines._finite_or_nan(X)

    probs = predict_proba_folds(models, X).mean(axis=0)
    log = load_metadata(Path(args.data), args.split)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / f"probs_{args.split}.npy", probs)
    sub = write_submission(out / f"submission_{args.split}.csv", log["object_id"],
                           (probs > man["threshold"]).astype(int))
    _log(f"wrote {sub} ({int((probs > man['threshold']).sum())} TDEs "
         f"@ threshold {man['threshold']:.3f})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mallorn-torch",
                                description="MALLORN pipeline on PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("synth", help="generate synthetic data")
    ps.add_argument("--out", required=True)
    ps.add_argument("--n-objects", type=int, default=300)
    ps.add_argument("--seed", type=int, default=0)
    ps.set_defaults(fn=cmd_synth)

    pe = sub.add_parser("extract", help="extract + cache features")
    pe.add_argument("--data", required=True)
    pe.add_argument("--cache", required=True)
    pe.add_argument("--families", default=None,
                    help=f"comma list of {','.join(FAMILIES)}")
    pe.add_argument("--gp-steps", type=int, default=200)
    pe.set_defaults(fn=cmd_extract)

    pt = sub.add_parser("train", help="train a pipeline config")
    pt.add_argument("--data", required=True)
    pt.add_argument("--cache", required=True)
    pt.add_argument("--config", default="v92d", choices=CONFIGS)
    pt.add_argument("--data-external", default=None,
                    help="external labeled dataset dir (v16)")
    pt.add_argument("--cache-external", default=None,
                    help="feature cache for the external dataset (v16)")
    pt.add_argument("--out", default="artifacts")
    pt.add_argument("--set", default=None, metavar="K=V[,K=V...]",
                    help="override GBDTParams fields on the chosen config "
                         "(e.g. reg_lambda=5.0,subsample=0.7): the "
                         "reference's regularization-variant scripts "
                         "(v8/v28a/v29a/v81) as one flag")
    pt.add_argument("--rounds", type=int, default=None,
                    help="override n_rounds on every GBDT config (epochs for "
                         "the DL configs)")
    pt.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="train every GBDT CV distributed over N ranks (one card "
                         "each; rows split, histograms all-reduced; forests "
                         "identical to single-device)")
    pt.set_defaults(fn=cmd_train)

    pp = sub.add_parser("predict", help="predict from saved fold models")
    pp.add_argument("--data", required=True)
    pp.add_argument("--cache", required=True)
    pp.add_argument("--model", required=True, help="saved models dir")
    pp.add_argument("--split", default="test")
    pp.add_argument("--out", default="artifacts")
    pp.set_defaults(fn=cmd_predict)
    return p


def _train_on_rank(mesh, args) -> None:
    """One rank of ``train --mesh N``: the rank's mesh is the default mesh
    while the command runs; rank 0 alone writes files and prints."""
    import contextlib
    import os

    from mallorn_tpu_torch.parallel.mesh import set_default_mesh

    args.device, args.writer = mesh.device, mesh.rank == 0
    set_default_mesh(mesh)
    try:
        with contextlib.ExitStack() as stack:
            if mesh.rank:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            args.fn(args)
    finally:
        set_default_mesh(None)


def main(argv=None, device: DeviceLike = None):
    """Parse ``argv`` and run the command on ``device`` (the card unless
    the caller asks for the CPU; with no card and no request, raises).
    ``train --mesh N`` runs on N ranks: N cards, or N host processes under
    ``device="cpu"``; more ranks than cards raises ``SystemExit``."""
    args = build_parser().parse_args(argv)
    n = getattr(args, "mesh", None)
    if n is not None:
        import torch

        if torch.device("cuda" if device is None else device).type == "cuda":
            n_dev = torch.cuda.device_count()
            if n > n_dev:
                raise SystemExit(f"--mesh {n}: only {n_dev} devices available")
        if n < 1:
            raise SystemExit(f"--mesh {n}: at least one rank")
    args.device = resolve_device(device)
    if n is None:
        args.fn(args)
        return
    from mallorn_tpu_torch.parallel.mesh import launch

    launch(_train_on_rank, n, (args,), device=args.device)


if __name__ == "__main__":
    main()
