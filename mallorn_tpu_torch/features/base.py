"""Feature-layer plumbing (port of ``mallorn_tpu.features.base``).

A feature module exposes ``extract(packed, ...) -> FeatureSet``, an
ordered ``{name: [N] tensor}`` dict. Where the JAX package wrapped a
per-object kernel in ``vmap``, the port's kernels take the whole batch:
the object axis is written out as the leading axis of every tensor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

FeatureSet = Dict[str, torch.Tensor]


def feature_matrix(features: FeatureSet, names: Optional[Sequence[str]] = None
                   ) -> Tuple[torch.Tensor, List[str]]:
    """Stack a FeatureSet into an [N, F] float32 matrix + column names
    (on the features' device)."""
    if names is None:
        names = list(features.keys())
    X = torch.stack([features[n].to(torch.float32) for n in names], dim=1)
    return X, list(names)


def merge(*feature_sets: FeatureSet, pandas_suffix: bool = False) -> FeatureSet:
    """Left-to-right merge of feature sets.

    With ``pandas_suffix=True`` a name collision renames the earlier
    column ``_x`` (moved to the end) and the new one ``_y``, exactly as
    the reference's pandas merges and the JAX package do. Without it,
    collisions raise.
    """
    out: FeatureSet = {}
    for fs in feature_sets:
        for k, v in fs.items():
            if k in out:
                if not pandas_suffix:
                    raise ValueError(f"duplicate feature name across modules: {k}")
                out[f"{k}_x"] = out.pop(k)
                out[f"{k}_y"] = v
            else:
                out[k] = v
    return out


def sorted_features(feats: FeatureSet) -> FeatureSet:
    """Columns in sorted-name order: the JAX package's families return the
    dict a jitted function produced, whose keys come back sorted, and the
    column order (hence the merged v34a names) follows from that."""
    return {k: feats[k] for k in sorted(feats)}


def per_object(x, packed, dtype=torch.float32) -> torch.Tensor:
    """A per-object host array (redshift, extinction) as an [N] tensor on
    the packed data's device."""
    return torch.as_tensor(x, dtype=dtype).to(packed.device)
