"""v30 advanced-physics features: multi-epoch Planck SED temperatures and
cooling curves, late-time colors, cross-band asymmetry (port of
``mallorn_tpu.features.advanced_physics``).

- SED temperature: a 2-parameter Planck fit (``_sed_model``, the
  blackbody family's ``_planck`` with its analytic d/dT) over the g/r/i/z
  medians within +-10 d of each epoch (>= 3 positive bands,
  median-normalised, T in [3000, 1e5], logA in [-20, 10], three starts),
  at epochs 0/20/50/75/100/150/200 d after the r-band peak (>= 3 r
  points); cooling rates overall / early / late over the compacted
  valid-temperature sequence (a stable sort), dispersions, the SED
  quality's mean and trend;
- late colors at 100/150/200 d (+-15 d medians of the all-band arrays):
  per-epoch g-r / r-i, slopes x100 per day, dispersion, the exact
  3-point quadratic acceleration;
- cross-band asymmetry: full-span rise / fade ratios, their dispersion
  and differences, peak lags, the rise-time dispersion.

Columns come in the JAX package's order.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.data.packing import PackedLightcurves
from mallorn_tpu_torch.features.base import FeatureSet
from mallorn_tpu_torch.features.blackbody import _bb_model
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.ops.lm import lm_fit_batched

_NAN = float("nan")

SED_WAVES = (4825.0, 6222.0, 7545.0, 8691.0)  # g, r, i, z
TEMP_EPOCHS = (0.0, 20.0, 50.0, 75.0, 100.0, 150.0, 200.0)
LATE_EPOCHS = (100.0, 150.0, 200.0)

# 10^logA B_lambda(T), theta = (T, logA): the blackbody family's model
_sed_model = _bb_model


def _fit_sed(flux4):
    """[L, 4] band fluxes -> (T, reduced chi^2); >= 3 positive bands."""
    valid = torch.isfinite(flux4) & (flux4 > 0)
    nv = valid.sum(dim=1)
    med = M.median(flux4, valid)
    ok = (nv >= 3) & (med > 0)
    obs = torch.where(valid, flux4 / torch.where(med > 0, med, 1.0)[:, None], 0.0)

    L = flux4.shape[0]
    lam = torch.tensor(SED_WAVES, dtype=obs.dtype, device=obs.device).expand(L, 4)
    ones = torch.ones(L, dtype=obs.dtype, device=obs.device)
    lb = torch.stack([3000.0 * ones, -20.0 * ones], 1)
    ub = torch.stack([100000.0 * ones, 10.0 * ones], 1)
    starts = torch.stack([torch.stack([T0 * ones, -16.0 * ones], 1)
                          for T0 in (8000.0, 15000.0, 30000.0)])
    res = lm_fit_batched(_sed_model, lam, obs, torch.ones_like(obs), valid, starts, lb, ub,
                         n_iters=50)
    dof = nv - 2
    red = torch.where(dof > 0, res.cost / torch.clamp(dof, min=1), _NAN)
    ok = ok & res.valid
    return torch.where(ok, res.theta[:, 0], _NAN), torch.where(ok, red, _NAN)


def _epoch_band_median(at, af, ab, am, target, window, band_idx):
    """[N] median flux of one band within +-window of target (NaN if none)."""
    sel = am & ((at - target[:, None]).abs() < window) & (ab == band_idx)
    return M.median(af, sel)


def _compact_fit(x, y, valid):
    """Masked linear fit over the valid entries: (slope, std of y)."""
    y0 = torch.where(valid, y, 0.0)
    slope, _ = M.linfit(x.expand_as(y), y0, valid)
    return slope, M.std(y0, valid, 0)


def _argmax_time(t, f, mask):
    return M.take(t, M.argmax(f, mask))


def extract(packed: PackedLightcurves, meta=None) -> FeatureSet:
    N = packed.n_objects
    t, f, mask = packed.band_time, packed.band_flux, packed.band_mask
    at, af, ab, am = packed.all_time, packed.all_flux, packed.all_band, packed.all_mask
    nb = M.count(mask)
    dev, dtype = t.device, t.dtype

    feats: FeatureSet = {}
    r_ok = nb[:, 2] >= 3
    peak_time = _argmax_time(t[:, 2], f[:, 2], mask[:, 2])

    # ---- multi-epoch SED temperatures --------------------------------
    E = len(TEMP_EPOCHS)
    flux4 = torch.stack([
        torch.stack([_epoch_band_median(at, af, ab, am, peak_time + ep, 10.0, b)
                     for b in (1, 2, 3, 4)], 1)
        for ep in TEMP_EPOCHS], 1)  # [N, E, 4]
    T_fit, chi2 = _fit_sed(flux4.reshape(N * E, 4))
    T_fit = torch.where(r_ok[:, None], T_fit.reshape(N, E), _NAN)
    chi2 = torch.where(r_ok[:, None], chi2.reshape(N, E), _NAN)

    for ei, ep in enumerate(TEMP_EPOCHS):
        feats[f"temp_epoch_{int(ep)}d"] = T_fit[:, ei]
        feats[f"temp_chi2_epoch_{int(ep)}d"] = chi2[:, ei]

    ep_arr = torch.tensor(TEMP_EPOCHS, dtype=dtype, device=dev)
    valid_t = ~torch.isnan(T_fit)
    n_t = valid_t.sum(dim=1)
    ok3 = r_ok & (n_t >= 3)

    s_all, _ = _compact_fit(ep_arr, T_fit, valid_t)
    feats["cooling_rate_overall"] = torch.where(ok3, s_all, _NAN)

    # early = the first half of the VALID subsequence, late = the rest
    order = torch.sort((~valid_t).to(torch.uint8), dim=1, stable=True).indices
    T_c = torch.gather(T_fit, 1, order)
    e_c = torch.gather(ep_arr.expand_as(T_fit), 1, order)
    pos = torch.arange(E, device=dev)
    mid = n_t // 2
    early_m = pos[None, :] < mid[:, None]
    late_m = (pos[None, :] >= mid[:, None]) & (pos[None, :] < n_t[:, None])

    s_early, sd_early = _compact_fit(e_c, T_c, early_m)
    s_late, sd_late = _compact_fit(e_c, T_c, late_m)
    ok_e = ok3 & (mid >= 2)
    ok_l = ok3 & (n_t - mid >= 2)
    feats["cooling_rate_early"] = torch.where(ok_e, s_early, _NAN)
    feats["temp_dispersion_early"] = torch.where(ok_e, sd_early, _NAN)
    feats["cooling_rate_late"] = torch.where(ok_l, s_late, _NAN)
    feats["temp_dispersion_late"] = torch.where(ok_l, sd_late, _NAN)

    chi0 = torch.where(valid_t, torch.where(torch.isnan(chi2), 0.0, chi2), 0.0)
    mean_chi = chi0.sum(dim=1) / torch.clamp(n_t, min=1)
    s_chi, _ = _compact_fit(ep_arr, chi0, valid_t)
    feats["sed_quality_mean"] = torch.where(ok3, mean_chi, _NAN)
    feats["sed_quality_trend"] = torch.where(ok3, s_chi, _NAN)

    # ---- late-time colors --------------------------------------------
    def mag_diff(a, b):
        okc = r_ok & (a > 0) & (b > 0)
        return torch.where(okc, -2.5 * torch.log10(torch.where(okc, a, 1.0)
                                                   / torch.where(okc, b, 1.0)), _NAN)

    gr_list, ri_list = [], []
    for ep in LATE_EPOCHS:
        target = peak_time + ep
        g, r, i = (_epoch_band_median(at, af, ab, am, target, 15.0, b) for b in (1, 2, 3))
        gr, ri = mag_diff(g, r), mag_diff(r, i)
        feats[f"g_r_late_{int(ep)}d"] = gr
        feats[f"r_i_late_{int(ep)}d"] = ri
        gr_list.append(gr)
        ri_list.append(ri)

    le = torch.tensor(LATE_EPOCHS, dtype=dtype, device=dev)
    gr = torch.stack(gr_list, 1)
    ri = torch.stack(ri_list, 1)
    gv = ~torch.isnan(gr)
    rv = ~torch.isnan(ri)
    ng, nr = gv.sum(dim=1), rv.sum(dim=1)

    s_gr, sd_gr = _compact_fit(le, gr, gv)
    feats["g_r_late_slope"] = torch.where(r_ok & (ng >= 2), s_gr * 100.0, _NAN)
    feats["g_r_late_dispersion"] = torch.where(r_ok & (ng >= 2), sd_gr, _NAN)
    s_ri, _ = _compact_fit(le, ri, rv)
    feats["r_i_late_slope"] = torch.where(r_ok & (nr >= 2), s_ri * 100.0, _NAN)

    # the exact 3-point quadratic coefficient (only the all-valid case)
    x1, x2, x3 = LATE_EPOCHS
    y1, y2, y3 = gr.unbind(1)
    a = ((y3 - y1) / (x3 - x1) - (y2 - y1) / (x2 - x1)) / (x3 - x2)
    feats["color_accel_g_r"] = torch.where(r_ok & (ng >= 3), a * 10000.0, _NAN)

    # ---- cross-band asymmetry ----------------------------------------
    asyms, rises, pks, has5 = [], [], [], []
    for bi in (1, 2, 3):
        n = nb[:, bi]
        ok5 = n >= 5
        pk = M.argmax(f[:, bi], mask[:, bi])
        pt = M.take(t[:, bi], pk)
        rise = torch.where(ok5 & (pk > 0), pt - M.mmin(t[:, bi], mask[:, bi]), _NAN)
        fade = torch.where(ok5 & (pk < n - 1), M.mmax(t[:, bi], mask[:, bi]) - pt, _NAN)
        asym = torch.where(~torch.isnan(rise) & ~torch.isnan(fade) & (fade > 0),
                           rise / torch.where(fade > 0, fade, 1.0), _NAN)
        asyms.append(asym)
        rises.append(rise)
        pks.append(torch.where(ok5, pt, _NAN))
        has5.append(ok5)

    for band, asym in zip("gri", asyms):
        feats[f"{band}_asymmetry"] = asym

    def spread(vals, m):
        """(mean, population std, count) over the entries in ``m``."""
        cnt = m.sum(dim=1)
        mu = torch.where(m, vals, 0.0).sum(dim=1) / torch.clamp(cnt, min=1)
        sd = torch.sqrt(torch.where(m, (vals - mu[:, None]) ** 2, 0.0).sum(dim=1)
                        / torch.clamp(cnt, min=1))
        return mu, sd, cnt

    av = torch.stack(asyms, 1)
    avm = ~torch.isnan(av)
    _, sd, na = spread(av, avm)
    feats["asymmetry_dispersion"] = torch.where(na >= 2, sd, _NAN)
    feats["asymmetry_diff_g_r"] = torch.where((na >= 2) & avm[:, 0] & avm[:, 1],
                                              av[:, 0] - av[:, 1], _NAN)
    feats["asymmetry_diff_r_i"] = torch.where((na >= 2) & avm[:, 1] & avm[:, 2],
                                              av[:, 1] - av[:, 2], _NAN)

    pk_arr = torch.stack(pks, 1)
    h5 = torch.stack(has5, 1)
    n_pk = h5.sum(dim=1)
    feats["peak_lag_g_r"] = torch.where((n_pk >= 2) & h5[:, 0] & h5[:, 1],
                                        pk_arr[:, 0] - pk_arr[:, 1], _NAN)
    feats["peak_lag_r_i"] = torch.where((n_pk >= 2) & h5[:, 1] & h5[:, 2],
                                        pk_arr[:, 1] - pk_arr[:, 2], _NAN)
    # dispersion over the asymmetry-valid bands' peak times
    _, psd, npv = spread(pk_arr, avm & h5)
    feats["peak_time_dispersion"] = torch.where((n_pk >= 2) & (npv >= 2), psd, _NAN)

    rv_arr = torch.stack(rises, 1)
    rmu, rsd, nrv = spread(rv_arr, ~torch.isnan(rv_arr))
    feats["rise_time_dispersion"] = torch.where((nrv >= 2) & (rmu > 0), rsd / rmu, _NAN)
    return feats
