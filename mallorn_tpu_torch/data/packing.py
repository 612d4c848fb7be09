"""Ragged lightcurves -> dense padded tensors (port of
``mallorn_tpu.data.packing``).

Packing is numpy on the host (one lexsort + bincount, no loop over
objects); the finished arrays go to the device once. Two views:

- per-band ``[N, 6, T]`` (time-sorted within each band), and
- all-band ``[N, TA]`` (time-sorted across bands, with band ids),

each with a validity mask. Padding: time -> TIME_PAD (1e9), flux -> 0,
flux_err -> 1, band id -> -1.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from mallorn_tpu_torch.utils.constants import N_BANDS, TIME_PAD
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


class PackedLightcurves(NamedTuple):
    """Dense padded views of a ragged multi-band lightcurve dataset."""

    band_time: torch.Tensor  # [N, 6, T] f32
    band_flux: torch.Tensor
    band_err: torch.Tensor
    band_mask: torch.Tensor  # bool
    all_time: torch.Tensor  # [N, TA] f32
    all_flux: torch.Tensor
    all_err: torch.Tensor
    all_band: torch.Tensor  # int32, -1 for padding
    all_mask: torch.Tensor  # bool
    # global offset subtracted from all stored times (days since dataset
    # start keep float32 precise); absolute-epoch features add it back
    time_offset: float = 0.0

    @property
    def n_objects(self) -> int:
        return self.band_time.shape[0]

    @property
    def device(self) -> torch.device:
        return self.band_time.device

    def tensors(self):
        return tuple(self[:-1])

    def map(self, fn) -> "PackedLightcurves":
        """Apply ``fn`` to every tensor (e.g. an object-axis index)."""
        return PackedLightcurves(*[fn(x) for x in self.tensors()],
                                 time_offset=self.time_offset)

    def to(self, device) -> "PackedLightcurves":
        return self.map(lambda x: x.to(device))


@dataclasses.dataclass
class Metadata:
    """Host-side per-object metadata aligned with PackedLightcurves rows."""

    object_ids: Optional[np.ndarray]  # [N] str
    z: np.ndarray  # [N] f32 redshift
    ebv: np.ndarray  # [N] f32 extinction
    target: Optional[np.ndarray] = None
    spec_type: Optional[np.ndarray] = None


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def pack_lightcurves_np(object_index, time, flux, flux_err, band,
                        n_objects: int, pad_multiple: int = 8,
                        max_band_len: Optional[int] = None,
                        max_total_len: Optional[int] = None):
    """The host half of ``pack_lightcurves``: a tuple of numpy arrays in
    ``PackedLightcurves`` field order, then ``time_offset``."""
    object_index = np.asarray(object_index, dtype=np.int64)
    time = np.asarray(time, dtype=np.float64)
    time_offset = float(np.floor(time.min())) if len(time) else 0.0
    time = time - time_offset
    flux = np.asarray(flux, dtype=np.float64)
    flux_err = np.asarray(flux_err, dtype=np.float64)
    band = np.asarray(band, dtype=np.int64)

    m = len(time)
    if not (len(flux) == len(flux_err) == len(band) == len(object_index) == m):
        raise ValueError("all observation columns must have equal length")

    # ---- per-band view ------------------------------------------------
    group = object_index * N_BANDS + band
    order = np.lexsort((time, group))
    g_sorted = group[order]
    counts = np.bincount(g_sorted, minlength=n_objects * N_BANDS)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(m) - np.repeat(starts[counts > 0], counts[counts > 0])

    t_band = int(counts.max()) if m else 1
    if max_band_len is not None:
        t_band = min(t_band, max_band_len)
    t_band = _round_up(t_band, pad_multiple)

    keep = pos < t_band
    bt = np.full((n_objects * N_BANDS, t_band), TIME_PAD, dtype=np.float32)
    bf = np.zeros((n_objects * N_BANDS, t_band), dtype=np.float32)
    be = np.ones((n_objects * N_BANDS, t_band), dtype=np.float32)
    bm = np.zeros((n_objects * N_BANDS, t_band), dtype=bool)
    rows, cols = g_sorted[keep], pos[keep]
    bt[rows, cols] = time[order][keep]
    bf[rows, cols] = flux[order][keep]
    be[rows, cols] = flux_err[order][keep]
    bm[rows, cols] = True

    # ---- all-band view ------------------------------------------------
    order_a = np.lexsort((time, object_index))
    o_sorted = object_index[order_a]
    counts_a = np.bincount(o_sorted, minlength=n_objects)
    starts_a = np.concatenate([[0], np.cumsum(counts_a)[:-1]])
    pos_a = np.arange(m) - np.repeat(starts_a[counts_a > 0],
                                     counts_a[counts_a > 0])

    t_all = int(counts_a.max()) if m else 1
    if max_total_len is not None:
        t_all = min(t_all, max_total_len)
    t_all = _round_up(t_all, pad_multiple)

    keep_a = pos_a < t_all
    at = np.full((n_objects, t_all), TIME_PAD, dtype=np.float32)
    af = np.zeros((n_objects, t_all), dtype=np.float32)
    ae = np.ones((n_objects, t_all), dtype=np.float32)
    ab = np.full((n_objects, t_all), -1, dtype=np.int32)
    am = np.zeros((n_objects, t_all), dtype=bool)
    rows_a, cols_a = o_sorted[keep_a], pos_a[keep_a]
    at[rows_a, cols_a] = time[order_a][keep_a]
    af[rows_a, cols_a] = flux[order_a][keep_a]
    ae[rows_a, cols_a] = flux_err[order_a][keep_a]
    ab[rows_a, cols_a] = band[order_a][keep_a]
    am[rows_a, cols_a] = True

    shape3 = (n_objects, N_BANDS, t_band)
    return (bt.reshape(shape3), bf.reshape(shape3), be.reshape(shape3),
            bm.reshape(shape3), at, af, ae, ab, am, time_offset)


def pack_lightcurves(object_index, time, flux, flux_err, band,
                     n_objects: int, pad_multiple: int = 8,
                     max_band_len: Optional[int] = None,
                     max_total_len: Optional[int] = None,
                     device: DeviceLike = None) -> PackedLightcurves:
    """Pack flat observation arrays into dense padded tensors on ``device``
    (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    *arrays, time_offset = pack_lightcurves_np(
        object_index, time, flux, flux_err, band, n_objects,
        pad_multiple=pad_multiple, max_band_len=max_band_len,
        max_total_len=max_total_len)
    return PackedLightcurves(*[torch.from_numpy(a).to(dev) for a in arrays],
                             time_offset=time_offset)


def from_numpy(arrays, time_offset: float = 0.0,
               device: DeviceLike = None) -> PackedLightcurves:
    """Tensors from any nine arrays in ``PackedLightcurves`` field order
    (e.g. the JAX package's packed arrays, read back as numpy)."""
    dev = resolve_device(device)
    return PackedLightcurves(
        *[torch.from_numpy(np.array(a)).to(dev) for a in arrays],
        time_offset=float(time_offset))


_PAD_FILL = (TIME_PAD, 0.0, 1.0, False, TIME_PAD, 0.0, 1.0, -1, False)


def pad_objects(packed: PackedLightcurves, n_total: int) -> PackedLightcurves:
    """Pad the object axis up to ``n_total`` rows with empty objects."""
    n = packed.n_objects
    if n_total < n:
        raise ValueError(f"cannot shrink from {n} to {n_total}")
    if n_total == n:
        return packed
    extra = n_total - n
    out = []
    for x, fill in zip(packed.tensors(), _PAD_FILL):
        pad = torch.full((extra,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        out.append(torch.cat([x, pad], dim=0))
    return PackedLightcurves(*out, time_offset=packed.time_offset)


def pad_time_axes(p: PackedLightcurves, t_band: int, t_all: int) -> PackedLightcurves:
    """``p`` with its per-band time axis padded to at least ``t_band`` and
    its all-band axis to at least ``t_all`` (padding as packed)."""
    widths = (t_band,) * 4 + (t_all,) * 5
    ts = []
    for x, fill, t in zip(p.tensors(), _PAD_FILL, widths):
        extra = t - x.shape[-1]
        if extra > 0:
            pad = torch.full(tuple(x.shape[:-1]) + (extra,), fill, dtype=x.dtype,
                             device=x.device)
            x = torch.cat([x, pad], dim=-1)
        ts.append(x)
    return PackedLightcurves(*ts, time_offset=p.time_offset)


def unify_time_padding(*packs: PackedLightcurves):
    """Re-pad the time axes of several packed sets to shared lengths (each
    view to the longest of the sets), so their feature matrices come from
    equal-width views."""
    t_band = max(p.band_time.shape[-1] for p in packs)
    t_all = max(p.all_time.shape[-1] for p in packs)
    return tuple(pad_time_axes(p, t_band, t_all) for p in packs)
