"""High-S/N physics features, v66 (port of ``mallorn_tpu.features.high_snr``).

- structure functions of the magnitudes -2.5 log10 max(f, 1e-10) in r and
  g (>= 10 points) at taus 1 / 5 / 10 / 20 / 50 / 100 d over the pairs
  with 0.5 tau < dt < 1.5 tau (>= 3), the log-log slope and amplitude
  over >= 3 valid taus, and the DRW tau: the first valid tau whose SF
  derivative drops below 0.01 (>= 4 valid taus, compacted by a stable
  argsort);
- color-magnitude relation over <= 3 d matched g / r pairs (>= 5):
  correlation, slope, bluer-when-brighter strength, scatter;
- decline consistency over g / r / i: the post-peak linear decline of
  the peak-normalised flux, its cross-band CV, smoothness and ratios;
- TDE power-law deviation in r (>= 8 points): the log-log slope > 10 d
  after the peak, |alpha + 5/3|, |alpha + 5/12| and its chi^2;
- flux stability in r and g (>= 10 points): point-to-point scatter,
  monotonicity, noise ratio and a 3-point-smooth score.

The pairwise sums run on [N, T, T] pair masks.
"""

from __future__ import annotations

import math

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.features.physics import _nearest
from mallorn_tpu_torch.ops import masked as M

_NAN = float("nan")
SF_TAUS = (1.0, 5.0, 10.0, 20.0, 50.0, 100.0)


def _sf_block(t, f, mask, nb, band_name):
    """Rows [N, T] -> the band's SF columns."""
    out = {}
    ok = nb >= 10
    mags = -2.5 * torch.log10(torch.clamp(f, min=1e-10))
    T = t.shape[-1]
    upper = torch.ones(T, T, dtype=torch.bool, device=t.device).triu(1)
    pair = mask[:, :, None] & mask[:, None, :] & upper
    dt = t[:, None, :] - t[:, :, None]
    dm2 = (mags[:, None, :] - mags[:, :, None]) ** 2

    sfs = []
    for tau in SF_TAUS:
        sel = pair & (dt > 0.5 * tau) & (dt < 1.5 * tau)
        ns = sel.sum(dim=(1, 2))
        sf = torch.sqrt(torch.where(sel, dm2, 0.0).sum(dim=(1, 2)) / ns.clamp(min=1))
        sf = torch.where(ok & (ns >= 3), sf, _NAN)
        out[f"{band_name}_sf_tau_{int(tau)}"] = sf
        sfs.append(sf)

    sfv = torch.stack(sfs, dim=1)
    taus = torch.tensor(SF_TAUS, dtype=torch.float32, device=t.device)
    valid = ~torch.isnan(sfv)
    nv = valid.sum(dim=1)
    slope, intercept = M.linfit(torch.log10(taus),
                                torch.log10(torch.clamp(torch.where(valid, sfv, 1.0), min=1e-10)),
                                valid)
    out[f"{band_name}_sf_slope"] = torch.where(nv >= 3, slope, _NAN)
    out[f"{band_name}_sf_amplitude"] = torch.where(nv >= 3, 10.0 ** intercept, _NAN)

    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    sf_c = torch.gather(sfv, 1, order)
    tau_c = taus[order]
    dsf = (sf_c[:, 1:] - sf_c[:, :-1]) / torch.clamp(tau_c[:, 1:] - tau_c[:, :-1], min=1e-10)
    kmask = torch.arange(len(SF_TAUS) - 1, device=t.device)[None, :] < (nv - 1)[:, None]
    flat = kmask & (dsf < 0.01)
    drw = M.take(tau_c, M.first_true(flat))
    out[f"{band_name}_sf_drw_tau"] = torch.where((nv >= 4) & flat.any(dim=1), drw, _NAN)
    return out


def _linfit_block(t, f, mask, nb):
    """Post-peak decline of one band's rows [N, T]: (rate, residual std)."""
    idx_t = torch.arange(t.shape[-1], device=t.device)[None, :]
    pk = M.argmax(f, mask)
    post = mask & (idx_t >= pk[:, None])
    pflux, pt = M.take(f, pk), M.take(t, pk)
    norm = torch.where(post, f / torch.where(pflux > 0, pflux, 1.0)[:, None], 0.0)
    relt = torch.where(post, t - pt[:, None], 0.0)
    vmask = post & (norm > 0)
    slope, ic = M.linfit(relt, norm, vmask)
    pred = slope[:, None] * relt + ic[:, None]
    res_sd = M.std(torch.where(vmask, norm - pred, 0.0), vmask, 0)
    good = (nb >= 5) & (post.sum(dim=1) >= 4) & (pflux > 0) & (vmask.sum(dim=1) >= 3)
    return torch.where(good, slope, _NAN), torch.where(good, res_sd, _NAN)


def extract(packed, meta=None) -> FeatureSet:
    feats: FeatureSet = {}
    t, f, e, mask = packed.band_time, packed.band_flux, packed.band_err, packed.band_mask
    nb = M.count(mask)
    T = t.shape[-1]
    idx_t = torch.arange(T, device=t.device)[None, :]

    for bi, bname in ((2, "r"), (1, "g")):
        feats.update(_sf_block(t[:, bi], f[:, bi], mask[:, bi], nb[:, bi], bname))

    # --- color-magnitude (bluer-when-brighter) ---------------------------
    ok_cm = (nb[:, 1] >= 5) & (nb[:, 2] >= 5)
    j, dmin = _nearest(t[:, 1], t[:, 2], mask[:, 2])
    rf = torch.gather(f[:, 2], 1, j)
    pairm = mask[:, 1] & (dmin < 3.0) & (f[:, 1] > 0) & (rf > 0)
    col = -2.5 * torch.log10(torch.where(pairm, f[:, 1], 1.0) / torch.where(pairm, rf, 1.0))
    rmag = -2.5 * torch.log10(torch.where(pairm, rf, 1.0))
    npair = pairm.sum(dim=1)
    okp = ok_cm & (npair >= 5)
    cmu, mmu = M.mean(col, pairm), M.mean(rmag, pairm)
    csd, msd = M.std(col, pairm, 0), M.std(rmag, pairm, 0)
    cov = torch.where(pairm, (col - cmu[:, None]) * (rmag - mmu[:, None]), 0.0).sum(dim=1) \
        / npair.clamp(min=1)
    corr = cov / torch.clamp(csd * msd, min=1e-30)
    slope, intercept = M.linfit(rmag, col, pairm)
    resid = torch.where(pairm, col - (slope[:, None] * rmag + intercept[:, None]), 0.0)
    feats["color_mag_correlation"] = torch.where(okp, corr, _NAN)
    feats["color_mag_slope"] = torch.where(okp, slope, _NAN)
    feats["bwb_strength"] = torch.where(okp, -slope, _NAN)
    feats["color_mag_scatter"] = torch.where(okp, M.std(resid, pairm, 0), _NAN)

    # --- decline consistency ---------------------------------------------
    rates, resids = zip(*[_linfit_block(t[:, bi], f[:, bi], mask[:, bi], nb[:, bi])
                          for bi in (1, 2, 3)])
    rv, dv = torch.stack(rates, dim=1), torch.stack(resids, dim=1)
    rm = ~torch.isnan(rv)
    nrb = rm.sum(dim=1)
    rmu = torch.where(rm, rv, 0.0).sum(dim=1) / nrb.clamp(min=1)
    rsd = torch.sqrt(torch.where(rm, (rv - rmu[:, None]) ** 2, 0.0).sum(dim=1) / nrb.clamp(min=1))
    cv = torch.where(rmu != 0, rsd / torch.abs(rmu), _NAN)
    feats["decline_rate_cv"] = torch.where(nrb >= 2, cv, _NAN)
    dm = ~torch.isnan(dv)
    ndb = dm.sum(dim=1)
    feats["decline_smoothness_avg"] = torch.where(
        (nrb >= 2) & (ndb >= 2), torch.where(dm, dv, 0.0).sum(dim=1) / ndb.clamp(min=1), _NAN)
    g_r = torch.where(rv[:, 1] != 0, rv[:, 0] / torch.where(rv[:, 1] != 0, rv[:, 1], 1.0), _NAN)
    feats["decline_ratio_g_r"] = torch.where((nrb >= 2) & rm[:, 0] & rm[:, 1], g_r, _NAN)
    r_i = torch.where(rv[:, 2] != 0, rv[:, 1] / torch.where(rv[:, 2] != 0, rv[:, 2], 1.0), _NAN)
    feats["decline_ratio_r_i"] = torch.where((nrb >= 2) & rm[:, 1] & rm[:, 2], r_i, _NAN)

    # --- TDE power-law deviation (r) -------------------------------------
    tr, fr, mr = t[:, 2], f[:, 2], mask[:, 2]
    pk = M.argmax(fr, mr)
    pt, pf = M.take(tr, pk)[:, None], M.take(fr, pk)
    post = mr & (tr > pt + 10.0)
    valid = post & (fr > 0)
    log_dt = torch.log10(torch.clamp(torch.where(valid, tr - pt, 1.0), min=1e-10))
    log_f = torch.log10(torch.clamp(torch.where(valid, fr, 1.0), min=1e-10))
    alpha, ic = M.linfit(log_dt, log_f, valid)
    chi2 = M.mean((log_f - (alpha[:, None] * log_dt + ic[:, None])) ** 2, valid)
    good = (nb[:, 2] >= 8) & (post.sum(dim=1) >= 5) & (pf > 0) & (valid.sum(dim=1) >= 4)
    feats["r_tde_deviation_53"] = torch.where(good, torch.abs(alpha + 5.0 / 3.0), _NAN)
    feats["r_tde_deviation_512"] = torch.where(good, torch.abs(alpha + 5.0 / 12.0), _NAN)
    feats["r_best_power_law"] = torch.where(good, alpha, _NAN)
    feats["r_power_law_chi2"] = torch.where(good, chi2, _NAN)

    # --- flux stability (r, g) -------------------------------------------
    for bi, bname in ((2, "r"), (1, "g")):
        tb, fb, eb, mb = t[:, bi], f[:, bi], e[:, bi], mask[:, bi]
        pk = M.argmax(fb, mb)
        post = mb & (idx_t >= pk[:, None])
        good = (nb[:, bi] >= 10) & (post.sum(dim=1) >= 5)

        pair = post[:, 1:] & post[:, :-1]
        diffs = torch.where(pair, fb[:, 1:] - fb[:, :-1], 0.0)
        d_sd = M.std(diffs, pair, 0)
        mean_f = M.mean(fb, post)
        feats[f"{bname}_pt_scatter"] = torch.where(
            good & (mean_f > 0), d_sd / torch.where(mean_f > 0, mean_f, 1.0), _NAN)
        ndec = torch.where(pair, (diffs < 0).to(fb.dtype), 0.0).sum(dim=1)
        feats[f"{bname}_monotonicity"] = torch.where(
            good, ndec / pair.sum(dim=1).clamp(min=1), _NAN)
        exp_sc = torch.sqrt(M.mean(eb ** 2, post))
        feats[f"{bname}_noise_ratio"] = torch.where(
            good & (exp_sc > 0),
            d_sd / math.sqrt(2.0) / torch.where(exp_sc > 0, exp_sc, 1.0), _NAN)

        # 3-point moving average with edges clamped to the post suffix
        lo, hi = pk[:, None], (M.count(mb) - 1)[:, None]
        il = torch.minimum(torch.maximum(idx_t - 1, lo), hi) % T
        ir = torch.minimum(torch.maximum(idx_t + 1, lo), hi) % T
        sm = (torch.gather(fb, 1, il) + fb + torch.gather(fb, 1, ir)) / 3.0
        res = torch.where(post, fb - sm, 0.0)
        f_sd = M.std(fb, post, 0)
        score = 1.0 - M.std(res, post, 0) / torch.where(f_sd > 0, f_sd, 1.0)
        feats[f"{bname}_smooth_score"] = torch.where(good & (f_sd > 0), score, _NAN)
    return sorted_features(feats)
