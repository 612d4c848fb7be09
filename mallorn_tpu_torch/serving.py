"""v92d serving: raw packed lightcurves -> TDE probability (port of the
flagship ``forward`` of ``__graft_entry__._build_flagship``).

``V92dServer.forward(packed, z, ebv)``:

1. ``features_v4`` = statistical + colors + shape + physics, merged with
   pandas ``_x``/``_y`` suffixes;
2. the selected-120 of those, merged with TDE, 2D-GP and Bazin features;
3. the feature matrix in the model's column order, +-inf -> +-1e10 (NaN
   kept), NaN-padded to the model's width;
4. per-fold binning, fold margins averaged, sigmoid.

The 2D-GP is the expensive step: every Adam step factorises a
[request, T, T] batch through the Hopper Cholesky-inverse kernel. Its
compaction width and two-phase decision are server state, fixed when the
model is built or loaded (``multiband_gp.serving_config``), as the
flagship fixes them at build.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mallorn_tpu_torch.data.packing import Metadata, PackedLightcurves
from mallorn_tpu_torch.features import (bazin, colors, multiband_gp, physics,
                                        shape, statistical, tde)
from mallorn_tpu_torch.features.base import FeatureSet, feature_matrix, merge
from mallorn_tpu_torch.io.model_store import GBDTModel, load_cv_models
from mallorn_tpu_torch.trees.binning import BinSpec, apply_bins
from mallorn_tpu_torch.trees.gbdt import Forest, predict_margin_folds, stack_forests
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device

# v92d drops these as train/test-shift-prone
# (reference: train_v92_focal_adversarial.py:95-96).
SHIFT_FEATURES = ("all_rise_time", "all_asymmetry")


@contextlib.contextmanager
def _phase(timings: Optional[Dict[str, float]], name: str, device: torch.device):
    """Adds the phase's wall time to ``timings[name]`` (device synchronised
    on both ends); does nothing when ``timings`` is None."""
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


def finite_or_nan(X: torch.Tensor) -> torch.Tensor:
    """+-inf -> +-1e10, NaN preserved."""
    return torch.nan_to_num(X, nan=float("nan"), posinf=1e10, neginf=-1e10)


def extract_features_v4(packed: PackedLightcurves, meta: Metadata) -> FeatureSet:
    """statistical + colors + shape + physics (the features_v4 cache)."""
    return merge(statistical.extract(packed, meta), colors.extract(packed, meta),
                 shape.extract(packed), physics.extract(packed, meta),
                 pandas_suffix=True)


def extract_bundle(packed: PackedLightcurves, z, ebv, gp_steps: int,
                   gp_t_compact: int, gp_two_phase: bool,
                   timings: Optional[Dict[str, float]] = None
                   ) -> Dict[str, FeatureSet]:
    """The v34a families of a request: features_v4, tde_physics,
    multiband_gp (one fit at the given width and path) and bazin.
    ``timings`` (when given) collects each family's synchronised wall
    time."""
    n_max = int(multiband_gp._use_mask(packed).sum(dim=1).max())
    if n_max > gp_t_compact:
        raise ValueError(f"an object has {n_max} valid points, more than the "
                         f"GP width {gp_t_compact} the server was built with")
    meta = Metadata(object_ids=None, z=z, ebv=ebv)
    dev = packed.device
    bundle = {}
    with _phase(timings, "features_v4", dev):
        bundle["features_v4"] = extract_features_v4(packed, meta)
    with _phase(timings, "tde", dev):
        bundle["tde_physics"] = tde.extract(packed)
    with _phase(timings, "gp2d", dev):
        bundle["multiband_gp"] = multiband_gp._extract_chunk(
            packed, gp_steps, gp_t_compact, gp_two_phase)
    with _phase(timings, "bazin", dev):
        bundle["bazin"] = bazin.extract(packed)
    return bundle


def assemble_v34a_matrix(bundle: Dict[str, FeatureSet], selected: Sequence[str]
                         ) -> Tuple[torch.Tensor, List[str]]:
    """selected-120 of features_v4 + tde + gp2d + bazin with pandas-style
    collision suffixes -> (finite-or-NaN matrix, column names)."""
    base = {k: bundle["features_v4"][k] for k in selected}
    full = merge(base, bundle["tde_physics"], bundle["multiband_gp"],
                 bundle["bazin"], pandas_suffix=True)
    X, names = feature_matrix(full)
    return finite_or_nan(X), names


class V92dServer(nn.Module):
    """The v92d model: fold forests + bin specs over named columns.

    State: ``names`` (the model's columns, 222 for v92d), ``selected`` (the
    selected-120 of features_v4), the 2D-GP's steps, compaction width and
    two-phase decision, and per fold a forest and bin edges (buffers, on
    ``device``)."""

    def __init__(self, models: Sequence[GBDTModel], names: Sequence[str],
                 selected: Sequence[str], *, gp_t_compact: int,
                 gp_two_phase: bool, gp_steps: int = 100,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        if not models:
            raise ValueError("V92dServer needs at least one fold model")
        p0 = models[0].params
        for m in models[1:]:
            if (m.params.n_bins, m.params.max_depth, m.params.base_score) != (
                    p0.n_bins, p0.max_depth, p0.base_score):
                raise ValueError("fold models disagree on n_bins/max_depth/base_score")
        self.names = list(names)
        self.selected = list(selected)
        self.gp_steps = int(gp_steps)
        self.gp_t_compact = int(gp_t_compact)
        self.gp_two_phase = bool(gp_two_phase)
        self.n_bins = int(p0.n_bins)
        self.max_depth = int(p0.max_depth)
        self.base_score = float(p0.base_score)
        forest = stack_forests([m.forest for m in models])
        for name, a in forest._asdict().items():
            self.register_buffer(name, a.to(dev))
        self.register_buffer("edges", torch.stack([m.bin_spec.edges for m in models]).to(dev))
        self.register_buffer("n_trees", torch.tensor([m.n_trees for m in models], device=dev))
        if len(self.names) > self.edges.shape[1]:
            raise ValueError(f"{len(self.names)} columns but the model has "
                             f"{self.edges.shape[1]} features")

    @classmethod
    def load(cls, dirpath, selected: Sequence[str], device: DeviceLike = None,
             **kw) -> "V92dServer":
        """From a directory of fold models written by the JAX package's
        ``save_cv_models`` (its manifest holds the column names); ``kw``
        gives the GP state (``gp_t_compact``, ``gp_two_phase``,
        ``gp_steps``)."""
        models, man = load_cv_models(dirpath, device)
        return cls(models, man["feature_names"], selected, device=device, **kw)

    @property
    def forest(self) -> Forest:
        return Forest(self.feature, self.split_bin, self.default_left,
                      self.is_leaf, self.leaf_value)

    def features(self, packed: PackedLightcurves, z, ebv,
                 timings: Optional[Dict[str, float]] = None) -> FeatureSet:
        """The merged v34a feature set of a request; ``timings`` (when
        given) collects each family's synchronised wall time."""
        b = self.bundle(packed, z, ebv, timings)
        return merge({k: b["features_v4"][k] for k in self.selected},
                     b["tde_physics"], b["multiband_gp"], b["bazin"],
                     pandas_suffix=True)

    def bundle(self, packed: PackedLightcurves, z, ebv,
               timings: Optional[Dict[str, float]] = None
               ) -> Dict[str, FeatureSet]:
        """The request's v34a families, the GP at the server's state."""
        return extract_bundle(packed, z, ebv, self.gp_steps, self.gp_t_compact,
                              self.gp_two_phase, timings)

    def matrix(self, full: FeatureSet) -> torch.Tensor:
        """[N, F_model] float32: model-order columns, finite-or-NaN, NaN pad."""
        mat = finite_or_nan(feature_matrix(full, self.names)[0])
        f_model = self.edges.shape[1]
        if mat.shape[1] < f_model:
            pad = torch.full((mat.shape[0], f_model - mat.shape[1]), float("nan"),
                             dtype=mat.dtype, device=mat.device)
            mat = torch.cat([mat, pad], dim=1)
        return mat

    def binned(self, mat: torch.Tensor) -> torch.Tensor:
        """[K, N, F] bin ids, one matrix per fold's bin spec."""
        return torch.stack([apply_bins(BinSpec(e, self.n_bins), mat)
                            for e in self.edges])

    def predict_binned(self, binned: torch.Tensor) -> torch.Tensor:
        """Probabilities [N] from binned matrices ([K, N, F] or [N, F])."""
        margins = predict_margin_folds(self.forest, binned, self.n_trees,
                                       self.n_bins, self.max_depth, self.base_score)
        return torch.sigmoid(margins.mean(dim=0))

    def forward(self, packed: PackedLightcurves, z, ebv,
                timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
        """TDE probabilities [N] for a request of N packed objects."""
        full = self.features(packed, z, ebv, timings)
        with _phase(timings, "bin+forest", packed.device):
            return self.predict_binned(self.binned(self.matrix(full)))


def drop_shift_features(names: Sequence[str], X: Optional[torch.Tensor] = None):
    """v92d's columns: the v34a names without ``SHIFT_FEATURES`` (and the
    matching columns of X when given)."""
    keep = [i for i, n in enumerate(names) if n not in SHIFT_FEATURES]
    kept = [names[i] for i in keep]
    if X is None:
        return kept
    return X[:, keep], kept
