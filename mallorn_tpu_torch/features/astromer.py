"""ASTROMER embedding features from the pretrained encoder, v26 (port of
``mallorn_tpu.features.astromer``).

For each of g, r, i, z: flux to standardised relative magnitudes
(``models.astromer.normalize_band``), the pretrained ``SingleBandEncoder``,
a masked mean + max pool of the sequence embedding, the first 32 pooled
dims and 4 summary statistics of the pooled vector; then two cross-band
mean ratios: 146 columns in the JAX package's order, NaN where a band
has fewer than 5 valid points. Every (object, band) sequence is encoded
in one batched forward on the packed lightcurves' device.

The weights are the in-repo self-supervised artifact, not the original
MACHO-trained ASTROMER (``pretrained_origin`` says which); without them
``extract`` warns and returns the 146 columns all NaN, the reference's
model-unavailable surface.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict

import torch

from mallorn_tpu_torch.features.base import FeatureSet

# the reference's bands and their indices in the u..y = 0..5 packing order
ASTROMER_BANDS = ("g", "r", "i", "z")
_BAND_IDX = (1, 2, 3, 4)
_N_EMB = 32  # pooled dims kept per band
_MIN_POINTS = 5


def available(weights_path=None) -> bool:
    """Whether pretrained encoder weights are present (the in-repo
    artifact by default)."""
    from mallorn_tpu_torch.models.astromer import DEFAULT_WEIGHTS

    return os.path.exists(weights_path if weights_path is not None else DEFAULT_WEIGHTS)


def pretrained_origin() -> str:
    """Provenance of the weights ``extract`` uses."""
    if available():
        return ("in-repo self-supervised (masked-reconstruction on the "
                "synthetic corpus; tools/pretrain_astromer.py)")
    return "unavailable"


def feature_names() -> list:
    """The 146 astromer column names, in order."""
    names = []
    for band in ASTROMER_BANDS:
        names += [f"{band}_astromer_emb_{i}" for i in range(_N_EMB)]
        names += [f"{band}_astromer_emb_{s}" for s in ("mean", "std", "max", "min")]
    return names + ["astromer_gr_mean_ratio", "astromer_ri_mean_ratio"]


def _pool(emb: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked mean + max pool [B, T, D] -> [B, 2 D]."""
    v = valid[..., None]
    n = v.sum(dim=1).clamp_min(1).to(emb.dtype)
    mean = torch.where(v, emb, 0.0).sum(dim=1) / n
    mx = torch.where(v, emb, -torch.inf).amax(dim=1)
    return torch.cat([mean, mx], dim=-1)


def extract(packed, meta=None, weights_path=None) -> FeatureSet:
    """The 146 astromer columns {band}_astromer_emb_* and the two ratios,
    [N] float32 tensors on the packed lightcurves' device. The ratios
    divide by the r / i band mean guarded away from 0 with its sign kept
    (m >= 0: max(m, 1e-6); else min(m, -1e-6))."""
    from mallorn_tpu_torch.models.astromer import load_pretrained, normalize_band

    n = packed.n_objects
    dev = packed.device
    if not available(weights_path):
        warnings.warn(
            "no pretrained astromer weights found; emitting the all-NaN 146-feature "
            "surface (reference model-unavailable behavior). Run "
            "tools/pretrain_astromer.py to produce the artifact, or call "
            "extract_learned_embeddings() for supervised embeddings.", stacklevel=2)
        nan = torch.full((n,), float("nan"), device=dev)
        return {name: nan.clone() for name in feature_names()}

    _, model, _ = load_pretrained(weights_path, device=dev)
    idx = list(_BAND_IDX)
    t, f, e, m = (getattr(packed, a)[:, idx].reshape(n * 4, -1)
                  for a in ("band_time", "band_flux", "band_err", "band_mask"))
    seqs = normalize_band(t, f, e, m)
    with torch.no_grad():
        emb, _ = model(seqs.times, seqs.mags, seqs.errs, seqs.mask)
    vec = _pool(emb, seqs.mask).view(n, 4, -1)  # [N, 4, 2 D]
    ok = (seqs.n_valid >= _MIN_POINTS).view(n, 4)

    out: Dict[str, torch.Tensor] = {}
    band_means = {}
    for bi, band in enumerate(ASTROMER_BANDS):
        v, good = vec[:, bi], ok[:, bi]
        for i in range(min(_N_EMB, v.shape[1])):
            out[f"{band}_astromer_emb_{i}"] = torch.where(good, v[:, i], torch.nan)
        stats = {"mean": v.mean(dim=1), "std": v.std(dim=1, correction=0),
                 "max": v.amax(dim=1), "min": v.amin(dim=1)}
        for s, arr in stats.items():
            out[f"{band}_astromer_emb_{s}"] = torch.where(good, arr, torch.nan)
        band_means[band] = out[f"{band}_astromer_emb_mean"]

    for b1, b2 in (("g", "r"), ("r", "i")):
        m1, m2 = band_means[b1], band_means[b2]
        denom = torch.where(m2 >= 0, m2.clamp_min(1e-6), m2.clamp_max(-1e-6))
        both = ~torch.isnan(m1) & ~torch.isnan(m2)
        out[f"astromer_{b1}{b2}_mean_ratio"] = torch.where(both, m1 / denom, torch.nan)
    return out


def extract_learned_embeddings(packed, meta, d_model: int = 32, n_epochs: int = 100,
                               seed: int = 0) -> FeatureSet:
    """Supervised fallback: train the time-series transformer briefly on
    the given objects (labels from ``meta``) and return its CLS embeddings
    {emb_0 .. emb_{d-1}}."""
    from mallorn_tpu_torch.models.data import make_sequence_batch
    from mallorn_tpu_torch.models.train_dl import train_model
    from mallorn_tpu_torch.models.transformer import TransformerClassifier

    batch = make_sequence_batch(packed, meta)
    model = TransformerClassifier(d_model=d_model, n_layers=2, seed=seed, device=packed.device)
    train_model(model, batch, n_epochs=n_epochs, seed=seed)
    with torch.no_grad():
        emb = model(batch, return_embedding=True)
    return {f"emb_{i}": emb[:, i] for i in range(emb.shape[1])}
