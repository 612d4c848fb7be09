"""GBDT model files (port of ``mallorn_tpu.io.model_store``).

The JAX package's own format, read and written with numpy: one
``fold_<i>.npz`` per fold (forest arrays, bin edges, params as JSON,
importance, metric history, best iteration) and a ``manifest.json``
(fold count, threshold, feature names), written last. A model trained by
either package loads in the other. The format holds heap forests, the
forest arrays as they are: depthwise and symmetric trees, DART (its
leaves already at the final scales) and multiclass ([R, C, ...], one tree
per class and round). It has no child pointers, so a leaf-wise
``LGForest`` cannot be saved.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from mallorn_tpu_torch.trees.binning import BinSpec, check_n_bins
from mallorn_tpu_torch.trees.gbdt import Forest, GBDTModel, GBDTParams, LGForest
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


def forest_from_numpy(feature, split_bin, default_left, is_leaf, leaf_value,
                      device: DeviceLike = None) -> Forest:
    dev = resolve_device(device)
    return Forest(
        feature=torch.as_tensor(np.asarray(feature, np.int32)).to(dev),
        split_bin=torch.as_tensor(np.asarray(split_bin, np.int32)).to(dev),
        default_left=torch.as_tensor(np.asarray(default_left, bool)).to(dev),
        is_leaf=torch.as_tensor(np.asarray(is_leaf, bool)).to(dev),
        leaf_value=torch.as_tensor(np.asarray(leaf_value, np.float32)).to(dev),
    )


def params_from_dict(d: dict) -> GBDTParams:
    """The port's params from a model file, ``hist_dtype`` (the histogram
    mode it was trained in) included; the TPU-only knobs
    (``use_pallas_hist``, ``use_binlane_hist``, ...) are dropped."""
    return GBDTParams(**{k: d[k] for k in GBDTParams._fields if k in d})


def _replace_atomically(path: Path, write) -> None:
    """``write(tmp)`` then move ``tmp`` onto ``path``: a reader never sees a
    partial file."""
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    write(tmp)
    os.replace(tmp, path)


def save_model(path, model: GBDTModel) -> Path:
    """One fold model as an npz the JAX package's ``load_model`` reads."""
    if isinstance(model.forest, LGForest):
        raise ValueError("the model format has no child pointers: a leaf-wise "
                         "(LGForest) model cannot be saved")
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    n_feat = model.bin_spec.edges.shape[0]
    arrays = {name: getattr(model.forest, name).cpu().numpy() for name in Forest._fields}
    arrays.update(
        edges=model.bin_spec.edges.cpu().numpy(),
        importance_gain=(np.zeros(n_feat, np.float32) if model.importance_gain is None
                         else np.asarray(model.importance_gain, np.float32)),
        eval_history=(np.zeros(0, np.float32) if model.eval_history is None
                      else np.asarray(model.eval_history, np.float32)),
        best_iteration=model.best_iteration,
        params=json.dumps(model.params._asdict()),
        n_bins=model.bin_spec.n_bins)

    def write(tmp):
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)

    _replace_atomically(path, write)
    return path


def save_cv_models(dirpath, models: Sequence[GBDTModel], threshold: float,
                   feature_names: Sequence[str]) -> Path:
    """Fold models + ``manifest.json`` (written last: a reader that finds
    the manifest finds every fold file)."""
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    for i, m in enumerate(models):
        save_model(d / f"fold_{i}.npz", m)
    text = json.dumps({"n_folds": len(models), "threshold": float(threshold),
                       "feature_names": list(feature_names)})
    _replace_atomically(d / "manifest.json", lambda tmp: tmp.write_text(text))
    return d


def load_model(path, device: DeviceLike = None) -> GBDTModel:
    dev = resolve_device(device)
    with np.load(Path(path), allow_pickle=False) as z:
        forest = forest_from_numpy(z["feature"], z["split_bin"], z["default_left"],
                                   z["is_leaf"], z["leaf_value"], dev)
        edges = torch.as_tensor(np.asarray(z["edges"], np.float32)).to(dev)
        return GBDTModel(forest=forest,
                         bin_spec=BinSpec(edges=edges, n_bins=check_n_bins(z["n_bins"])),
                         params=params_from_dict(json.loads(str(z["params"]))),
                         best_iteration=int(z["best_iteration"]),
                         importance_gain=np.asarray(z["importance_gain"]),
                         eval_history=np.asarray(z["eval_history"]))


def load_cv_models(dirpath, device: DeviceLike = None
                   ) -> Tuple[List[GBDTModel], dict]:
    """(fold models, manifest) from a directory the JAX package's
    ``save_cv_models`` wrote."""
    d = Path(dirpath)
    man = json.loads((d / "manifest.json").read_text())
    models = [load_model(d / f"fold_{i}.npz", device) for i in range(man["n_folds"])]
    return models, man
