"""TDE-specific physics features (port of ``mallorn_tpu.features.tde``).

Color variance/range/trend on <= 5 d matched (g,r)/(r,i) pairs, late-time
(> peak + 50 d) decay on g/r/i, rise shape and rate on g/r, temperature
stability from <= 3 d matched g-r pairs, and the r-band power-law decay.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.features.physics import _nearest
from mallorn_tpu_torch.ops import masked as M

_NAN = float("nan")


def _matched_colors(t1, f1, m1, t2, f2, m2, max_dt):
    j, dmin = _nearest(t1, t2, m2)
    f2n = torch.gather(f2, 1, j)
    pair = m1 & (dmin < max_dt) & (f1 > 0) & (f2n > 0)
    c = -2.5 * torch.log10(torch.where(pair, f1, 1.0) / torch.where(pair, f2n, 1.0))
    return torch.where(pair, c, _NAN), pair


def extract(packed, meta=None) -> FeatureSet:
    feats: FeatureSet = {}
    t, f, mask = packed.band_time, packed.band_flux, packed.band_mask
    nb = M.count(mask)
    idx = torch.arange(t.shape[-1], device=t.device)[None, :]

    # --- color variance / range / trend ---------------------------------
    for b1, b2, pname in ((1, 2, "g_r"), (2, 3, "r_i")):
        c, pair = _matched_colors(t[:, b1], f[:, b1], mask[:, b1],
                                  t[:, b2], f[:, b2], mask[:, b2], 5.0)
        ok = (nb[:, b1] >= 3) & (nb[:, b2] >= 3) & (pair.sum(dim=1) >= 3)
        feats[f"{pname}_color_var"] = torch.where(ok, M.var(c, pair, 0), _NAN)
        feats[f"{pname}_color_range"] = torch.where(
            ok, M.mmax(c, pair) - M.mmin(c, pair), _NAN)
        slope, _ = M.linfit(t[:, b1], c, pair)
        feats[f"{pname}_color_trend"] = torch.where(ok, slope * 100.0, _NAN)

    # --- late-time behaviour --------------------------------------------
    for bi, band in ((1, "g"), (2, "r"), (3, "i")):
        tb, fb, mb = t[:, bi], f[:, bi], mask[:, bi]
        peak_idx = M.argmax(fb, mb)
        pt = M.take(tb, peak_idx)
        pf = M.take(fb, peak_idx)
        late = mb & (tb > (pt + 50.0)[:, None])
        ok = (nb[:, bi] >= 5) & (late.sum(dim=1) >= 3) & (pf > 0)

        log_t = torch.log10(torch.where(late, tb - pt[:, None] + 1.0, 1.0))
        log_f = torch.log10(torch.clamp(torch.where(late, fb, 1.0), min=1e-10))
        t_std = M.std(log_t, late, 0)
        slope, _ = M.linfit(log_t, log_f, late)
        feats[f"{band}_late_slope"] = torch.where(ok & (t_std > 0), slope, _NAN)
        lmean = M.mean(fb, late)
        feats[f"{band}_late_flux_ratio"] = torch.where(
            ok, lmean / torch.where(pf > 0, pf, 1.0), _NAN)
        lmax = M.mmax(fb, late)
        reb = torch.where(lmean > 0, lmax / torch.where(lmean > 0, lmean, 1.0), 1.0)
        feats[f"{band}_rebrightening"] = torch.where(ok, reb, _NAN)

    # --- rise characteristics -------------------------------------------
    for bi, band in ((1, "g"), (2, "r")):
        tb, fb, mb = t[:, bi], f[:, bi], mask[:, bi]
        peak_idx = M.argmax(fb, mb)
        pf = M.take(fb, peak_idx)
        rise_m = mb & (idx <= peak_idx[:, None])
        nr = rise_m.sum(dim=1)
        t_first = M.mmin(tb, rise_m)
        t_last = M.mmax(tb, rise_m)
        ok = (nb[:, bi] >= 5) & (nr >= 3) & (pf > 0)

        norm_f = torch.where(rise_m, fb / torch.where(pf > 0, pf, 1.0)[:, None], 0.0)
        norm_t = torch.where(
            rise_m, (tb - t_first[:, None]) / (t_last - t_first + 1e-6)[:, None], 0.0)
        mean_nf = norm_f.sum(dim=1) / nr.clamp(min=1)
        mean_nt = norm_t.sum(dim=1) / nr.clamp(min=1)
        shape = torch.where(mean_nt > 0,
                            mean_nf / torch.where(mean_nt > 0, mean_nt, 1.0), 1.0)
        feats[f"{band}_rise_shape"] = torch.where(ok, shape, _NAN)
        rate = torch.where(t_last > t_first, pf / (t_last - t_first), _NAN)
        feats[f"{band}_rise_rate"] = torch.where(ok, rate, _NAN)

    # --- temperature stability ------------------------------------------
    g_ok = (nb[:, 1] >= 3) & (nb[:, 2] >= 3)
    j, dmin = _nearest(t[:, 1], t[:, 2], mask[:, 2])
    r_f = torch.gather(f[:, 2], 1, j)
    pair = mask[:, 1] & (dmin < 3.0) & (f[:, 1] > 0) & (r_f > 0)
    g_r = -2.5 * torch.log10(torch.where(pair, f[:, 1], 1.0)
                             / torch.where(pair, r_f, 1.0))
    temp = 7000.0 / (g_r + 0.5)
    temp = torch.where(g_r < -0.5, 40000.0, temp)
    temp = torch.where(g_r > 1.5, 5000.0, temp)
    nt = pair.sum(dim=1)
    ok3 = g_ok & (nt >= 3)

    t_mu = M.mean(temp, pair)
    t_sd = M.std(temp, pair, 0)
    feats["temp_stability"] = torch.where(ok3, t_sd / t_mu, _NAN)
    slope, _ = M.linfit(t[:, 1], torch.where(pair, temp, 0.0), pair)
    feats["temp_trend"] = torch.where(ok3, slope * 100.0, _NAN)

    pos = torch.cumsum(pair.to(torch.int64), dim=1) - 1
    peak_n = torch.clamp(nt // 4, min=2)[:, None]
    early_m = pair & (pos < peak_n)
    late_m = pair & (pos >= (nt - 3)[:, None])
    ratio = M.mean(temp, late_m) / M.mean(temp, early_m)
    feats["temp_late_vs_peak"] = torch.where(ok3 & (nt > 4), ratio, _NAN)

    # --- power-law decay (r band) ---------------------------------------
    tb, fb, mb = t[:, 2], f[:, 2], mask[:, 2]
    peak_idx = M.argmax(fb, mb)
    pt = M.take(tb, peak_idx)
    pf = M.take(fb, peak_idx)
    post = mb & (tb > pt[:, None])
    dt = torch.clamp(torch.where(post, tb - pt[:, None], 1.0), min=1.0)
    valid = post & (fb > 0)
    ok = ((nb[:, 2] >= 5) & (post.sum(dim=1) >= 4) & (pf > 0)
          & (valid.sum(dim=1) >= 3))

    log_t = torch.log10(dt)
    log_f = torch.log10(torch.where(valid, fb, 1.0))
    slope, intercept = M.linfit(log_t, log_f, valid)
    pred = slope[:, None] * log_t + intercept[:, None]
    resid_sd = M.std(log_f - pred, valid, 0)
    feats["r_decay_alpha"] = torch.where(ok, slope, _NAN)
    feats["r_decay_residual"] = torch.where(ok, resid_sd, _NAN)

    late_valid = valid & (dt > 50.0)
    slope_l, _ = M.linfit(log_t, log_f, late_valid)
    feats["r_decay_alpha_late"] = torch.where(
        ok & (late_valid.sum(dim=1) >= 3), slope_l, _NAN)
    return sorted_features(feats)
