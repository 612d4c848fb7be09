"""Synthetic LSST-like lightcurve generator (port of
``mallorn_tpu.data.synthetic``, numpy only).

A physically-motivated simulator of the competition's data shape: TDEs
(hot, roughly constant colour, ~t^-5/3 fallback decay), SNe Ia, II, IIn,
Ib/c, SLSN and AGN (a damped random walk, sometimes with one TDE-like
flare), with overlapping class parameters, six LSST bands, irregular
cadence, flux errors and redshift metadata at ~5% TDE prevalence. The
distribution knobs (``z_range``, ``mean_obs_per_band``, ``depth_scale``,
``noise_scale``, ``class_mix``) draw a shifted test split
(``TEST_SHIFT``, ``STRONG_TEST_SHIFT``).

The same seed gives the JAX package's arrays bit for bit: the same
``np.random.Generator`` calls in the same order. The cached bench split
(``.bench_data_v2.npz``) is ``generate_competition_splits(3054, 7124,
seed=20260816, tde_frac=0.05)``; its npz does not store the spectral
types, which ``generate_dataset(3054, seed=20260816, tde_frac=0.05)``
recovers as ``Metadata.spec_type``.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mallorn_tpu_torch.data.packing import Metadata, PackedLightcurves, pack_lightcurves
from mallorn_tpu_torch.utils.constants import LSST_BANDS, N_BANDS, WAVELENGTHS_NM
from mallorn_tpu_torch.utils.device import DeviceLike

SPEC_TYPES = ("TDE", "SN Ia", "SN II", "SN IIn", "SN Ib/c", "SLSN", "AGN")

NON_TDE_KINDS = ("SN Ia", "SN II", "SN IIn", "SN Ib/c", "SLSN", "AGN")
# default class mixture over NON_TDE_KINDS
TRAIN_CLASS_MIX = (0.38, 0.25, 0.07, 0.08, 0.04, 0.18)
# test split skews toward the TDE impostors (IIn, flaring AGN) and away
# from the easy SNe — part of the injected train/test shift
TEST_CLASS_MIX = (0.30, 0.20, 0.12, 0.08, 0.04, 0.26)

# Rough per-band color factors vs temperature: flux ~ blackbody-ish weights.
_WAVE = np.array(WAVELENGTHS_NM)


def _band_weights(temp_k: np.ndarray) -> np.ndarray:
    """Relative band fluxes for a blackbody-like SED at temp_k. [..., 6]"""
    # Wien-ish weighting: hotter -> bluer. Normalized to r band.
    lam = _WAVE[(None,) * temp_k.ndim] * 1e-9  # [..., 6] meters
    t = temp_k[..., None]
    hc_over_k = 0.0143877688  # m*K
    x = hc_over_k / (lam * np.maximum(t, 100.0))
    # Rayleigh-Jeans-corrected Planck shape (up to constants)
    w = 1.0 / (lam ** 4 * np.expm1(np.clip(x, 1e-3, 50.0)))
    return w / w[..., 2:3]  # normalize to r


def _model_flux(kind: str, t: np.ndarray, rng: np.random.Generator,
                z: float) -> Tuple[np.ndarray, np.ndarray]:
    """Rest-frame-ish lightcurve model. Returns (flux_r[t], temp_k[t]).

    Parameter ranges overlap across classes on purpose: TDE decay powers
    span ~5/3 but so do SN IIn's; TDE temperatures reach down into SLSN /
    flaring-AGN territory; some TDEs cool, some SNe barely do. Only the
    joint (color, timescale, shape, smoothness) distribution separates
    the classes — like the real data.
    """
    dil = 1.0 + z
    if kind == "TDE":
        t0 = rng.uniform(80, 180)
        rise = rng.uniform(12, 45) * dil
        peak = rng.uniform(25, 400)
        dt = t - t0
        pre = np.exp(dt / rise)
        # fallback-accretion decay: power clusters near 5/3 but scatters
        p_dec = rng.normal(5.0 / 3.0, 0.35)
        p_dec = float(np.clip(p_dec, 0.9, 2.6))
        post = (1.0 + np.maximum(dt, 0.0) / (rng.uniform(20, 70) * dil)) ** (-p_dec)
        f = peak * np.where(dt < 0, pre, post)
        # hot, *mostly* constant color; a third cool slowly
        t_base = rng.uniform(12000, 38000)
        cool = rng.uniform(250, 2000) if rng.random() < 0.35 else 1e9
        temp = t_base * np.exp(-np.maximum(dt, 0) / cool)
    elif kind == "SN Ia":
        t0 = rng.uniform(80, 180)
        rise = rng.uniform(13, 20) * dil
        fall = rng.uniform(25, 55) * dil
        peak = rng.uniform(40, 300)
        dt = t - t0
        f = peak * np.exp(-np.maximum(dt, 0) / fall) / (1 + np.exp(-dt / (rise / 3)))
        t_start = rng.uniform(9000, 13500)
        temp = t_start * np.exp(-np.maximum(dt, 0) / rng.uniform(60, 160)) + 3500.0
    elif kind == "SN II":
        t0 = rng.uniform(80, 180)
        plateau_len = rng.uniform(50, 115) * dil
        peak = rng.uniform(30, 200)
        dt = t - t0
        rise = rng.uniform(5, 14) * dil
        plat = np.where(dt < plateau_len, 1.0, np.exp(-(dt - plateau_len) / (15 * dil)))
        f = peak * plat / (1 + np.exp(-dt / (rise / 3)))
        f = np.where(dt < 0, peak * np.exp(dt / rise), f)
        t_start = rng.uniform(7500, 12500)
        temp = t_start * np.exp(-np.maximum(dt, 0) / rng.uniform(60, 140)) + 4500.0
    elif kind == "SN IIn":
        # circumstellar interaction: slow power-law decline + blue,
        # slowly-cooling continuum — the classic TDE impostor
        t0 = rng.uniform(80, 180)
        rise = rng.uniform(8, 30) * dil
        peak = rng.uniform(30, 350)
        dt = t - t0
        p_dec = rng.uniform(1.0, 2.5)  # overlaps the TDE 5/3 regime
        post = (1.0 + np.maximum(dt, 0.0) / (rng.uniform(25, 80) * dil)) ** (-p_dec)
        f = peak * np.where(dt < 0, np.exp(dt / rise), post)
        t_base = rng.uniform(9000, 22000)
        cool = rng.uniform(200, 1500) if rng.random() < 0.7 else 1e9
        temp = t_base * np.exp(-np.maximum(dt, 0) / cool)
    elif kind == "SN Ib/c":
        t0 = rng.uniform(80, 180)
        rise = rng.uniform(10, 18) * dil
        fall = rng.uniform(20, 45) * dil
        peak = rng.uniform(25, 180)
        dt = t - t0
        f = peak * np.exp(-np.maximum(dt, 0) / fall) / (1 + np.exp(-dt / (rise / 3)))
        t_start = rng.uniform(6500, 10000)
        temp = t_start * np.exp(-np.maximum(dt, 0) / rng.uniform(50, 120)) + 3800.0
    elif kind == "SLSN":
        t0 = rng.uniform(80, 180)
        rise = rng.uniform(25, 60) * dil
        fall = rng.uniform(50, 140) * dil
        peak = rng.uniform(120, 900)
        dt = t - t0
        f = peak * np.exp(-np.maximum(dt, 0) / fall) / (1 + np.exp(-dt / (rise / 3)))
        # hot and slow-cooling: overlaps the TDE color/timescale locus
        t_start = rng.uniform(10000, 22000)
        temp = t_start * np.exp(-np.maximum(dt, 0) / rng.uniform(150, 500)) + 5000.0
    else:  # AGN: damped random walk, sometimes with one TDE-like flare
        n = len(t)
        tau = rng.uniform(100, 400)
        sigma = rng.uniform(0.1, 0.4)
        level = np.zeros(n)
        x = 0.0
        tp = t[0]
        for i in range(n):
            dt_i = t[i] - tp
            tp = t[i]
            a = np.exp(-dt_i / tau)
            x = a * x + sigma * np.sqrt(max(1 - a * a, 1e-12)) * rng.standard_normal()
            level[i] = x
        base = rng.uniform(30, 150)
        f = base * np.exp(level)
        temp = 9000.0 + 2500.0 * level  # color wanders with luminosity
        if rng.random() < 0.3:
            # single accretion flare: fast rise, power-law decay, hot —
            # photometrically degenerate with a TDE in a nuclear position
            t0 = rng.uniform(60, 250)
            rise = rng.uniform(10, 40) * dil
            amp = base * rng.uniform(1.5, 8.0)
            dt = t - t0
            p_dec = rng.uniform(1.2, 2.2)
            fl = amp * np.where(
                dt < 0, np.exp(dt / rise),
                (1.0 + np.maximum(dt, 0.0) / (rng.uniform(25, 70) * dil)) ** (-p_dec))
            hot = rng.uniform(14000, 30000)
            w = fl / np.maximum(f + fl, 1e-9)
            temp = temp * (1 - w) + hot * w  # flare dominates -> hotter
            f = f + fl
    return np.maximum(f, 0.0), np.clip(temp, 3000.0, 60000.0)


def generate_dataset(
    n_objects: int,
    seed: int = 0,
    tde_frac: float = 0.05,
    mean_obs_per_band: float = 22.0,
    season_days: float = 330.0,
    z_range: Tuple[float, float] = (0.01, 0.9),
    depth_scale: float = 1.0,
    noise_scale: float = 1.0,
    class_mix: Optional[Sequence[float]] = None,
    device: DeviceLike = None,
) -> Tuple[PackedLightcurves, Metadata, Dict[str, np.ndarray]]:
    """Generate a packed synthetic dataset.

    Returns (packed, metadata, flat_columns). flat_columns carries the raw
    observation table (reference CSV schema) for loader round-trip tests.

    ``z_range`` / ``depth_scale`` / ``noise_scale`` / ``class_mix`` /
    ``mean_obs_per_band`` are the distribution-shift knobs: draw a test
    split with different values to emulate the competition's
    spectroscopic-train vs photometric-test shift. The arrays are numpy;
    only the packed tensors go to ``device`` (CUDA unless the caller asks
    for the CPU).
    """
    rng = np.random.default_rng(seed)

    mix = np.asarray(TRAIN_CLASS_MIX if class_mix is None else class_mix,
                     dtype=np.float64)
    mix = mix / mix.sum()
    n_tde = max(1, int(round(tde_frac * n_objects)))
    kinds = np.array(["TDE"] * n_tde + list(
        rng.choice(NON_TDE_KINDS, size=n_objects - n_tde, p=mix)))
    rng.shuffle(kinds)

    obj_rows, t_rows, f_rows, e_rows, b_rows = [], [], [], [], []
    zs = np.zeros(n_objects, dtype=np.float32)
    ebvs = np.zeros(n_objects, dtype=np.float32)
    targets = np.zeros(n_objects, dtype=np.int32)

    for i in range(n_objects):
        kind = kinds[i]
        z = float(rng.uniform(*z_range))
        zs[i] = z
        ebvs[i] = float(rng.gamma(2.0, 0.02))
        targets[i] = 1 if kind == "TDE" else 0
        # fainter at higher z (crude distance dimming) + split depth knob
        dim = depth_scale / (1.0 + (z / 0.5) ** 2 * 0.5)

        # one epoch stream per OBJECT: sorted uniform + strictly-increasing
        # offset enforces a >= 0.02 d gap between ANY two observations
        # (any band) — near-coincident samples make slope features
        # (|df|/dt) float32-catastrophic vs the f64 reference — and one
        # model realization shared by all bands keeps AGN variability
        # color-coherent (physical)
        n_per_band = [max(3, int(rng.poisson(mean_obs_per_band)))
                      for _ in range(N_BANDS)]
        n_tot = int(np.sum(n_per_band))
        t_all = (np.sort(rng.uniform(0.0, season_days, size=n_tot))
                 + 0.02 * np.arange(n_tot))
        band_of = rng.permutation(np.repeat(np.arange(N_BANDS), n_per_band))
        f_r, temp = _model_flux(kind, t_all, rng, z)
        w = _band_weights(temp)  # [n_tot, 6]

        for b in range(N_BANDS):
            sel = band_of == b
            n_obs = int(sel.sum())
            t = t_all[sel]
            f_band = f_r[sel] * w[sel, b] * dim
            err = noise_scale * (
                2.0 + 0.05 * np.abs(f_band) + rng.exponential(1.5, size=n_obs))
            f_obs = f_band + err * rng.standard_normal(n_obs)
            obj_rows.append(np.full(n_obs, i, dtype=np.int64))
            t_rows.append(t + 60000.0)  # MJD-like offset
            f_rows.append(f_obs)
            e_rows.append(err)
            b_rows.append(np.full(n_obs, b, dtype=np.int64))

    cols = {
        "object_index": np.concatenate(obj_rows),
        "time": np.concatenate(t_rows),
        "flux": np.concatenate(f_rows),
        "flux_err": np.concatenate(e_rows),
        "band": np.concatenate(b_rows),
    }

    packed = pack_lightcurves(
        cols["object_index"], cols["time"], cols["flux"], cols["flux_err"],
        cols["band"], n_objects, device=device)

    meta = Metadata(
        object_ids=np.array([f"SYN{i:06d}" for i in range(n_objects)]),
        z=zs,
        ebv=ebvs,
        target=targets,
        spec_type=kinds,
    )
    return packed, meta, cols


# Test-split shift: higher redshift, sparser cadence, fainter, noisier,
# more TDE impostors — the photometric-test-set analog of the reference's
# train/test shift (adversarial AUC on the real data crossed the 0.55
# "moderate shift" tier; reference: adversarial_validation.py:171-189).
TEST_SHIFT = dict(
    mean_obs_per_band=20.0,
    z_range=(0.015, 1.0),
    depth_scale=0.9,
    noise_scale=1.08,
    class_mix=TEST_CLASS_MIX,
)

# Exaggerated shift for TINY datasets: at ~100 objects the
# competition-scale TEST_SHIFT puts the adversarial AUC within seed noise of
# the 0.55 tier. Sparser cadence + deeper z + dimmer/noisier makes the
# shift unambiguous even at n~100.
STRONG_TEST_SHIFT = dict(
    mean_obs_per_band=13.0,
    z_range=(0.05, 1.4),
    depth_scale=0.7,
    noise_scale=1.35,
    class_mix=TEST_CLASS_MIX,
)


def generate_competition_splits(
    n_train: int,
    n_test: int,
    seed: int = 0,
    tde_frac: float = 0.05,
    shifted: bool = True,
    shift: Optional[Dict] = None,
    device: DeviceLike = None,
):
    """Train + (distribution-shifted) test splits at competition shape.

    Returns ((packed, meta, cols), (packed, meta, cols)). With
    ``shifted=True`` the test split is drawn from TEST_SHIFT's distribution
    so that adversarial validation detects real shift (AUC >= 0.55) and the
    0.5 + 1.5p reweighting path — the reference winner's key component — is
    actually exercised. ``shift`` overrides the shift knobs (e.g.
    STRONG_TEST_SHIFT for tiny-n smoke runs).
    """
    train = generate_dataset(n_train, seed=seed, tde_frac=tde_frac, device=device)
    test_kwargs = (TEST_SHIFT if shift is None else shift) if shifted else {}
    test = generate_dataset(n_test, seed=seed + 1, tde_frac=tde_frac, device=device,
                            **test_kwargs)
    return train, test


def csv_text(col) -> List[str]:
    """A column's CSV fields as pandas' ``to_csv`` writes them: float64 at
    Python's shortest round-trip ``repr``, float32 at float32's shortest
    repr, NaN as an empty field, anything else through ``str``. Either
    package's reader gets the column's values back bit for bit."""
    a = np.asarray(col)
    if a.dtype == np.float32:
        return ["" if v != v else str(v) for v in a]
    if a.dtype.kind == "f":
        return ["" if v != v else repr(v) for v in a.astype(np.float64).tolist()]
    return [str(v) for v in a.tolist()]


def _write_csv(path: Path, header: Sequence[str], columns: Sequence[List[str]]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(zip(*columns))


def write_reference_layout(path, packed_cols: Dict[str, np.ndarray], meta: Metadata,
                           n_splits: int = 4, split: str = "train") -> None:
    """Write a dataset in the reference's on-disk CSV layout (numpy, no
    pandas; the text of the JAX package's pandas writer).

    ``{split}_log.csv`` at the root (object_id, Z, EBV[, SpecType][, target];
    target for the train split only) and
    ``split_XX/{split}_full_lightcurves.csv`` (object_id, Time (MJD), Flux,
    Flux_err, Filter), objects sharded by ``object_index % n_splits`` with
    every row kept in its order (reference: src/utils/data_loader.py:20-62).
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    ids = np.asarray(meta.object_ids)
    header, cols = ["object_id", "Z", "EBV"], [csv_text(ids), csv_text(meta.z),
                                               csv_text(meta.ebv)]
    if meta.spec_type is not None:
        header.append("SpecType")
        cols.append(csv_text(meta.spec_type))
    if meta.target is not None and split == "train":
        header.append("target")
        cols.append(csv_text(meta.target))
    _write_csv(path / f"{split}_log.csv", header, cols)

    obj = np.asarray(packed_cols["object_index"])
    rows = {"object_id": ids[obj], "Time (MJD)": packed_cols["time"],
            "Flux": packed_cols["flux"], "Flux_err": packed_cols["flux_err"],
            "Filter": np.array(LSST_BANDS)[np.asarray(packed_cols["band"])]}
    shard = obj % n_splits
    for s in range(n_splits):
        d = path / f"split_{s + 1:02d}"
        d.mkdir(exist_ok=True)
        sel = shard == s
        _write_csv(d / f"{split}_full_lightcurves.csv", list(rows),
                   [csv_text(np.asarray(v)[sel]) for v in rows.values()])
