"""Sequence batches for the DL models (port of ``mallorn_tpu.models.data``).

The packed all-band view is already the padded per-object sequence the
models read: a batch is masked tensor arithmetic on the packed
lightcurves' device, with no per-object loop. Per step: normalised flux,
normalised error and the time step (``make_sequence_batch``), or
normalised flux, time / 100 and normalised error per band
(``make_band_batch``, the v27 GRU's view); per object the metadata
(Z, EBV) and the label.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mallorn_tpu_torch.data.packing import Metadata, PackedLightcurves


class SequenceBatch(NamedTuple):
    features: torch.Tensor  # [N, T, 3] (norm flux, norm err, dt)
    band: torch.Tensor  # [N, T] int64 band index (0 for padding)
    times: torch.Tensor  # [N, T] days since first observation
    mask: torch.Tensor  # [N, T] bool
    meta: torch.Tensor  # [N, 2] (Z, EBV)
    label: Optional[torch.Tensor]  # [N] or None


class BandBatch(NamedTuple):
    """Per-band padded view for the band-parallel encoder (v27 GRU)."""

    features: torch.Tensor  # [N, 6, T, 3] (norm flux, rel time / 100, norm err)
    mask: torch.Tensor  # [N, 6, T] bool
    meta: torch.Tensor  # [N, 2] (Z, EBV)
    label: Optional[torch.Tensor]  # [N] or None


def take(batch, ix):
    """The rows ``ix`` of a batch (any of its tensors; None stays None)."""
    ix = torch.as_tensor(np.asarray(ix), device=batch.mask.device)
    return type(batch)(*(None if v is None else v[ix] for v in batch))


def _meta(packed: PackedLightcurves, meta: Optional[Metadata]):
    dev = packed.device
    if meta is None:
        return torch.zeros(packed.n_objects, 2, device=dev), None
    md = torch.as_tensor(np.stack([np.asarray(meta.z, np.float32),
                                   np.asarray(meta.ebv, np.float32)], axis=1), device=dev)
    label = None if meta.target is None else torch.as_tensor(np.asarray(meta.target),
                                                             device=dev)
    return md, label


def _normalise(f, e, m, dims):
    """Flux and error over the object's valid points: (f - mean) / std and
    e / std (std 1 when it is 0), 0 on padding."""
    n = m.sum(dim=dims).clamp_min(1)
    mu = torch.where(m, f, 0.0).sum(dim=dims) / n
    shape = mu.shape + (1,) * len(dims)
    sd = torch.sqrt(torch.where(m, (f - mu.view(shape)) ** 2, 0.0).sum(dim=dims) / n)
    sd = torch.where(sd > 0, sd, 1.0).view(shape)
    return (torch.where(m, (f - mu.view(shape)) / sd, 0.0), torch.where(m, e / sd, 0.0))


def _first_time(t, m, dims):
    t0 = torch.where(m, t, torch.inf).amin(dim=dims)
    return torch.where(torch.isfinite(t0), t0, 0.0)


def make_band_batch(packed: PackedLightcurves, meta: Optional[Metadata] = None) -> BandBatch:
    """Band-separated sequences for the v27 GRU: flux normalised per object
    across all bands (one scale keeps the bands' amplitude ratios), time in
    days since the object's first observation / 100."""
    t, f, e, m = packed.band_time, packed.band_flux, packed.band_err, packed.band_mask
    nf, ne = _normalise(f, e, m, (1, 2))
    t0 = _first_time(t, m, (1, 2))
    rel_t = torch.where(m, (t - t0[:, None, None]) / 100.0, 0.0)
    md, label = _meta(packed, meta)
    return BandBatch(features=torch.stack([nf, rel_t, ne], dim=-1), mask=m, meta=md,
                     label=label)


def make_sequence_batch(packed: PackedLightcurves,
                        meta: Optional[Metadata] = None) -> SequenceBatch:
    t, f, e, b, m = (packed.all_time, packed.all_flux, packed.all_err, packed.all_band,
                     packed.all_mask)
    t0 = _first_time(t, m, (1,))
    rel_t = torch.where(m, t - t0[:, None], 0.0)
    nf, ne = _normalise(f, e, m, (1,))
    dt = torch.diff(rel_t, dim=1, prepend=rel_t[:, :1])
    dt = torch.where(m, dt, 0.0) / 100.0  # days -> O(1)
    band = torch.where(m, b.clamp(0, 5), 0).long()
    md, label = _meta(packed, meta)
    return SequenceBatch(features=torch.stack([nf, ne, dt], dim=-1), band=band, times=rel_t,
                         mask=m, meta=md, label=label)
