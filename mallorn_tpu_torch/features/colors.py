"""Color evolution features (port of ``mallorn_tpu.features.colors``).

- reference peak epoch: r-band argmax, falling back to g then i;
- colors -2.5 log10(f1/f2) for (g,r), (r,i), (u,g), (i,z) at 10 epochs
  via gap-limited (50 d) interpolation — one batched ``interp_at`` over
  [N, epochs, bands];
- instantaneous color std/range (band2 interpolated at band1's times,
  5 d gap, >= 3 pairs), peak fluxes/ratios/lags, curvature, late-time
  stability, and the empirical temperature map T = 7000/(g-r+0.6).
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.utils.constants import LSST_BANDS

_NAN = float("nan")

COLOR_PAIRS = ((1, 2, "g_r"), (2, 3, "r_i"), (0, 1, "u_g"), (3, 4, "i_z"))
EPOCHS = (("peak", 0.0), ("post_10d", 10.0), ("post_20d", 20.0),
          ("post_30d", 30.0), ("post_50d", 50.0), ("post_75d", 75.0),
          ("post_100d", 100.0), ("post_150d", 150.0), ("pre_10d", -10.0),
          ("pre_20d", -20.0))


def _color(f1, f2):
    ok = ~torch.isnan(f1) & ~torch.isnan(f2) & (f1 > 0) & (f2 > 0)
    return torch.where(ok, -2.5 * torch.log10(torch.where(ok, f1, 1.0)
                                              / torch.where(ok, f2, 1.0)), _NAN)


def _temp_from_gr(c):
    t = 7000.0 / (c + 0.6)
    t = torch.where(c < -0.5, 50000.0, t)
    t = torch.where(c > 2.0, 3000.0, t)
    return torch.where(torch.isnan(c), _NAN, t)


def _nan_stats(vals):
    m = ~torch.isnan(vals)
    n = m.sum(dim=-1)
    mu = torch.where(m, vals, 0.0).sum(-1) / n.clamp(min=1)
    var = torch.where(m, (vals - mu.unsqueeze(-1)) ** 2, 0.0).sum(-1) / n.clamp(min=1)
    return mu, torch.sqrt(var), n


def _peak_t_f(t, f, mask):
    idx = M.argmax(f, mask)
    pt, pf = M.take(t, idx), M.take(f, idx)
    any_ = M.count(mask) > 0
    return torch.where(any_, pt, _NAN), torch.where(any_, pf, _NAN)


def _nan_unless(ok, x):
    return torch.where(ok, x, _NAN)


def extract(packed, meta=None) -> FeatureSet:
    feats: FeatureSet = {}
    t, f, mask = packed.band_time, packed.band_flux, packed.band_mask
    nb = M.count(mask)  # [N, 6]

    pt, _ = _peak_t_f(t, f, mask)

    def band_peak(bi):
        return _nan_unless(nb[:, bi] > 0, pt[:, bi])

    ref_peak = band_peak(2)
    ref_peak = torch.where(torch.isnan(ref_peak), band_peak(1), ref_peak)
    ref_peak = torch.where(torch.isnan(ref_peak), band_peak(3), ref_peak)
    feats["peak_mjd"] = ref_peak + packed.time_offset

    offsets = torch.tensor([dt for _, dt in EPOCHS], dtype=torch.float32,
                           device=t.device)
    targets = ref_peak[:, None] + offsets[None, :]  # [N, E]
    fl_all = M.interp_at(t[:, None], f[:, None], mask[:, None],
                         targets[:, :, None], max_gap=50.0)  # [N, E, 6]
    for ei, (name, _) in enumerate(EPOCHS):
        fl = fl_all[:, ei]
        for b1, b2, pname in COLOR_PAIRS:
            feats[f"{pname}_{name}"] = _color(fl[:, b1], fl[:, b2])

    for b1, b2, pname in COLOR_PAIRS:
        cp = feats[f"{pname}_peak"]
        c50 = feats[f"{pname}_post_50d"]
        c100 = feats[f"{pname}_post_100d"]
        feats[f"{pname}_slope_50d"] = _nan_unless(
            ~torch.isnan(cp) & ~torch.isnan(c50), (c50 - cp) / 50.0)
        feats[f"{pname}_slope_100d"] = _nan_unless(
            ~torch.isnan(cp) & ~torch.isnan(c100), (c100 - cp) / 100.0)

    # instantaneous color variability: band2 interpolated at band1's times
    for b1, b2, pname in COLOR_PAIRS:
        f2 = M.interp_at(t[:, b2, None, :], f[:, b2, None, :],
                         mask[:, b2, None, :], t[:, b1], max_gap=5.0)  # [N, T]
        c = _color(torch.where(mask[:, b1], f[:, b1], _NAN), f2)
        valid = ~torch.isnan(c)
        nv = valid.sum(dim=-1)
        _, sd, _ = _nan_stats(c)
        rng_ = M.mmax(c, valid) - M.mmin(c, valid)
        ok = (nb[:, b1] > 0) & (nb[:, b2] > 0) & (nv >= 3)
        feats[f"{pname}_std"] = _nan_unless(ok, sd)
        feats[f"{pname}_range"] = _nan_unless(ok, rng_)

    pf = M.mmax(f, mask)  # [N, 6]
    for bi, band in enumerate(LSST_BANDS):
        feats[f"{band}_peak_flux"] = pf[:, bi]
    for b1, b2, pname in COLOR_PAIRS:
        ok = ~torch.isnan(pf[:, b1]) & (pf[:, b2] > 0)
        feats[f"{pname}_peak_flux_ratio"] = _nan_unless(
            ok, pf[:, b1] / torch.where(ok, pf[:, b2], 1.0))

    for b1, b2, pname in ((1, 2, "g_r"), (2, 3, "r_i")):
        ok = (nb[:, b1] > 0) & (nb[:, b2] > 0)
        feats[f"{pname}_peak_lag"] = _nan_unless(ok, pt[:, b1] - pt[:, b2])

    for _, _, pname in ((1, 2, "g_r"), (2, 3, "r_i")):
        cp = feats[f"{pname}_peak"]
        c30 = feats[f"{pname}_post_30d"]
        c75 = feats[f"{pname}_post_75d"]
        ok = ~(torch.isnan(cp) | torch.isnan(c30) | torch.isnan(c75))
        s1 = (c30 - cp) / 30.0
        s2 = (c75 - c30) / 45.0
        feats[f"{pname}_curvature"] = _nan_unless(ok, (s2 - s1) / 37.5)

    for _, _, pname in ((1, 2, "g_r"), (2, 3, "r_i")):
        late = torch.stack([feats[f"{pname}_post_50d"], feats[f"{pname}_post_75d"],
                            feats[f"{pname}_post_100d"],
                            feats[f"{pname}_post_150d"]], dim=-1)
        mu, sd, n = _nan_stats(late)
        feats[f"{pname}_late_stability"] = _nan_unless(n >= 2, sd)
        feats[f"{pname}_late_mean"] = _nan_unless(n >= 2, mu)

    temps = []
    for ep in ("peak", "post_30d", "post_75d", "post_150d"):
        tp = _temp_from_gr(feats[f"g_r_{ep}"])
        feats[f"temp_{ep}"] = tp
        temps.append(tp)
    t_peak, t30, t75, t150 = temps
    feats["temp_slope_early"] = _nan_unless(
        ~torch.isnan(t_peak) & ~torch.isnan(t30), (t30 - t_peak) / 30.0)
    feats["temp_slope_mid"] = _nan_unless(
        ~torch.isnan(t30) & ~torch.isnan(t75), (t75 - t30) / 45.0)
    feats["temp_slope_late"] = _nan_unless(
        ~torch.isnan(t75) & ~torch.isnan(t150), (t150 - t75) / 75.0)
    mu, sd, n = _nan_stats(torch.stack(temps, dim=-1))
    feats["temp_stability"] = _nan_unless(n >= 2, sd / mu)
    return sorted_features(feats)
