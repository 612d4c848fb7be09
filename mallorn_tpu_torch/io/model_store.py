"""GBDT model files (port of ``mallorn_tpu.io.model_store``, read side).

Reads the JAX package's own format with numpy: one ``fold_<i>.npz`` per
fold (forest arrays, bin edges, params as JSON, best iteration) and a
``manifest.json`` (fold count, threshold, feature names). This is where
a model trained by the JAX package is carried across into the port's
tensors.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from mallorn_tpu_torch.trees.binning import BinSpec
from mallorn_tpu_torch.trees.gbdt import Forest, GBDTParams
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


class GBDTModel(NamedTuple):
    forest: Forest
    bin_spec: BinSpec
    params: GBDTParams
    best_iteration: int  # -1 when the fit did not early-stop

    @property
    def n_trees(self) -> int:
        """Trees that count at prediction (best_iteration + 1, or all)."""
        if self.best_iteration >= 0:
            return self.best_iteration + 1
        return self.forest.feature.shape[0]


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
    return GBDTParams(**{k: d[k] for k in GBDTParams._fields if k in d})


def load_model(path, device: DeviceLike = None) -> GBDTModel:
    dev = resolve_device(device)
    with np.load(Path(path), allow_pickle=False) as z:
        forest = forest_from_numpy(z["feature"], z["split_bin"], z["default_left"],
                                   z["is_leaf"], z["leaf_value"], dev)
        edges = torch.as_tensor(np.asarray(z["edges"], np.float32)).to(dev)
        return GBDTModel(forest=forest,
                         bin_spec=BinSpec(edges=edges, n_bins=int(z["n_bins"])),
                         params=params_from_dict(json.loads(str(z["params"]))),
                         best_iteration=int(z["best_iteration"]))


def load_cv_models(dirpath, device: DeviceLike = None
                   ) -> Tuple[List[GBDTModel], dict]:
    """(fold models, manifest) from a directory the JAX package's
    ``save_cv_models`` wrote."""
    d = Path(dirpath)
    man = json.loads((d / "manifest.json").read_text())
    models = [load_model(d / f"fold_{i}.npz", device) for i in range(man["n_folds"])]
    return models, man
