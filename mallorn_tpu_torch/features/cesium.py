"""Cesium-style single-band variability features, v35 (port of
``mallorn_tpu.features.cesium``).

Per band (>= 5 points, else NaN):

- Stetson J / K with the sqrt(n / (n - 1)) bias and inverse-variance
  weights;
- the fractions beyond 1 / 2 sigma (population std, 0 when std == 0);
- flux percentile ratios mid20 / 35 / 50 / 65 / 80 over the (5th, 95th)
  span;
- percent amplitude (max - median) / |median|;
- the maximum slope, a non-positive dt dividing by 1;
- the inverse-variance weighted linear trend;
- the Anderson-Darling normality statistic with estimated parameters
  (ddof 1), the standard normal's log-CDF from ``torch.special.log_ndtr``.

Across g / r / i: the Stetson J consistency (std over mean |J|), and the
mean beyond-1-sigma fraction over the valid bands.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.utils.constants import LSST_BANDS

_NAN = float("nan")
_BIG = 1.0e30

RATIOS = ((40.0, 60.0, "mid20"), (32.5, 67.5, "mid35"), (25.0, 75.0, "mid50"),
          (17.5, 82.5, "mid65"), (10.0, 90.0, "mid80"))


def _delta(f, e, mask):
    n = M.count(mask).to(f.dtype)
    mu = M.mean(f, mask)
    bias = torch.sqrt(n / torch.clamp(n - 1.0, min=1.0))
    return bias[..., None] * (f - mu[..., None]) / torch.where(e > 0, e, 1.0)


def _stetson_j(f, e, mask):
    d = _delta(f, e, mask)
    w = 1.0 / torch.where(e > 0, e * e, 1.0)
    num = torch.where(mask, w * d * torch.sign(d), 0.0).sum(dim=-1)
    den = torch.where(mask, w, 0.0).sum(dim=-1)
    ok = (M.count(mask) >= 2) & (den != 0)
    return torch.where(ok, num / torch.where(den != 0, den, 1.0), _NAN)


def _stetson_k(f, e, mask):
    d = _delta(f, e, mask)
    n = M.count(mask).clamp(min=1)
    num = torch.where(mask, torch.abs(d), 0.0).sum(dim=-1) / n
    den = torch.sqrt(torch.where(mask, d * d, 0.0).sum(dim=-1) / n)
    ok = (M.count(mask) >= 2) & (den != 0)
    return torch.where(ok, num / torch.where(den != 0, den, 1.0), _NAN)


def _pct_ratio(f, mask, lo, hi):
    den = M.quantile(f, mask, 0.95) - M.quantile(f, mask, 0.05)
    num = M.quantile(f, mask, hi / 100.0) - M.quantile(f, mask, lo / 100.0)
    ok = (M.count(mask) >= 5) & (den != 0)
    return torch.where(ok, num / torch.where(den != 0, den, 1.0), _NAN)


def _percent_amplitude(f, mask):
    med = M.median(f, mask)
    ok = (M.count(mask) >= 2) & (med != 0)
    return torch.where(ok, (M.mmax(f, mask) - med) / torch.abs(torch.where(med != 0, med, 1.0)),
                       _NAN)


def _maximum_slope(t, f, mask):
    pair = mask[..., 1:] & mask[..., :-1]
    dt = t[..., 1:] - t[..., :-1]
    dt = torch.where(dt > 0, dt, 1.0)
    sl = torch.abs(f[..., 1:] - f[..., :-1]) / dt
    v = torch.where(pair, sl, -_BIG).amax(dim=-1)
    return torch.where((M.count(mask) >= 2) & pair.any(dim=-1), v, _NAN)


def _linear_trend(t, f, e, mask):
    w = torch.where(mask, 1.0 / torch.where(e > 0, e * e, 1.0), 0.0)
    ws = w.sum(dim=-1)
    ws_ = torch.where(ws > 0, ws, 1.0)
    tm = t - M.mean(t, mask)[..., None]
    tw = (w * tm).sum(dim=-1) / ws_
    fw = (w * f).sum(dim=-1) / ws_
    num = (w * (tm - tw[..., None]) * (f - fw[..., None])).sum(dim=-1)
    den = (w * (tm - tw[..., None]) ** 2).sum(dim=-1)
    ok = (M.count(mask) >= 3) & (den != 0)
    return torch.where(ok, num / torch.where(den != 0, den, 1.0), _NAN)


def _anderson_darling(f, mask):
    """A^2 for normality with estimated parameters (scipy.stats.anderson):
    the valid z ascending first (padding filled with _BIG), and the
    reversed order within that valid prefix."""
    n = M.count(mask)
    nf = n.to(f.dtype)[..., None]
    mu = M.mean(f, mask)
    sd = M.std(f, mask, ddof=1)
    z = (f - mu[..., None]) / torch.where(sd[..., None] > 0, sd[..., None], 1.0)
    zs = torch.sort(torch.where(mask, z, _BIG), dim=-1).values
    T = f.shape[-1]
    i = torch.arange(1, T + 1, dtype=f.dtype, device=f.device)
    valid = i <= nf
    rev_idx = torch.clamp(nf - i, 0, T - 1).long()
    zrev = torch.gather(zs, -1, rev_idx)
    s = torch.where(valid, (2.0 * i - 1.0) * (torch.special.log_ndtr(zs)
                                              + torch.special.log_ndtr(-zrev)), 0.0).sum(dim=-1)
    a2 = -nf[..., 0] - s / torch.clamp(nf[..., 0], min=1.0)
    return torch.where((n >= 5) & (sd > 0), a2, _NAN)


def extract(packed, meta=None) -> FeatureSet:
    t, f, e, mask = packed.band_time, packed.band_flux, packed.band_err, packed.band_mask
    ok5 = M.count(mask) >= 5
    bm = mask & ok5[..., None]
    n = M.count(bm)

    vals = {
        "cesium_stetson_j": _stetson_j(f, e, bm),
        "cesium_stetson_k": _stetson_k(f, e, bm),
        "cesium_beyond_1std": torch.where(n >= 3, M.beyond_nstd(f, bm, 1.0), _NAN),
        "cesium_beyond_2std": torch.where(n >= 3, M.beyond_nstd(f, bm, 2.0), _NAN),
    }
    for lo, hi, name in RATIOS:
        vals[f"cesium_flux_percentile_ratio_{name}"] = _pct_ratio(f, bm, lo, hi)
    vals["cesium_percent_amplitude"] = _percent_amplitude(f, bm)
    vals["cesium_maximum_slope"] = _maximum_slope(t, f, bm)
    vals["cesium_linear_trend"] = _linear_trend(t, f, e, bm)
    vals["cesium_anderson_darling"] = _anderson_darling(f, bm)

    feats: FeatureSet = {}
    for bi, band in enumerate(LSST_BANDS):
        for key, val in vals.items():
            feats[f"{band}_{key}"] = torch.where(ok5[:, bi], val[:, bi], _NAN)

    sj = torch.where(ok5[:, 1:4], vals["cesium_stetson_j"][:, 1:4], _NAN)
    m = ~torch.isnan(sj)
    ns = m.sum(dim=1)
    mu = torch.where(m, sj, 0.0).sum(dim=1) / ns.clamp(min=1)
    sd = torch.sqrt(torch.where(m, (sj - mu[:, None]) ** 2, 0.0).sum(dim=1) / ns.clamp(min=1))
    abs_mu = torch.where(m, torch.abs(sj), 0.0).sum(dim=1) / ns.clamp(min=1)
    feats["cesium_stetson_j_consistency"] = torch.where(ns >= 2, sd / abs_mu, _NAN)

    b1 = torch.where(ok5, vals["cesium_beyond_1std"], _NAN)
    bm1 = ~torch.isnan(b1)
    nb1 = bm1.sum(dim=1)
    feats["cesium_avg_beyond_1std"] = torch.where(
        nb1 > 0, torch.where(bm1, b1, 0.0).sum(dim=1) / nb1.clamp(min=1), _NAN)
    return sorted_features(feats)
