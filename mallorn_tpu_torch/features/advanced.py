"""Advanced features of the v20 / v30 era (port of
``mallorn_tpu.features.advanced``). Bands take part with >= 3 points.

- absolute magnitudes (g, r, i; peak and mean): m_AB from microJy, a
  flat-LCDM luminosity distance (cz / H0 below z = 0.1, a 65-point
  Simpson rule above), the distance modulus and a flat-spectrum
  K-correction;
- pairwise MHPS (r, g): sqrt of the mean over pairs with dt / scale < 5
  of (f2 - f1)^2 |ricker(dt / scale)| on mean-normalised flux, scales
  10 / 30 / 100 / 365 d, on [N, T, T] pair masks, and two ratios;
- FLEET (r, g): exponential rise / fall timescales from log-flux lines
  (slope < 0 -> tau = -1 / slope), width and asymmetry; fleet_chi2 is
  always NaN, as in the reference;
- pre-peak colors: <= 5 d matched pairs before the r-band peak;
- autocorrelation (r): ``np.interp`` onto a 1-day grid of up to 1,024
  points ([N, 1024]), ACF at lags 10 and 30 d and their ratio;
- early / late thirds' flux and variance ratios (g, r, i);
- higher-order statistics (all fluxes, g, r): skewness, excess kurtosis
  and the biweight midvariance;
- g - r and r - i peak lags and peak flux ratios.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, per_object, sorted_features
from mallorn_tpu_torch.features.physics import _nearest
from mallorn_tpu_torch.features.research import _np_interp
from mallorn_tpu_torch.ops import masked as M

_NAN = float("nan")
_BIG = 1.0e30
H0, C_KM = 70.0, 299792.458
MHPS_SCALES = (10.0, 30.0, 100.0, 365.0)
GRID_LEN = 1024
_N_GRID = 64


def _lum_dist(z):
    """Flat-LCDM D_L [N]: cz / H0 below 0.1, Simpson-integrated above."""
    frac = torch.linspace(0.0, 1.0, _N_GRID + 1, device=z.device)
    zz = z[:, None] * frac[None, :]
    integrand = 1.0 / torch.sqrt(0.3 * (1.0 + zz) ** 3 + 0.7)
    h = z / _N_GRID
    w = torch.ones(_N_GRID + 1, device=z.device)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    integral = h / 3.0 * (w * integrand).sum(dim=1)
    d_hi = (C_KM / H0) * (1.0 + z) * integral
    d_lo = C_KM * z / H0
    return torch.where(z < 0.1, d_lo, d_hi)


def _abs_mag(flux, z):
    ok = (flux > 0) & ~torch.isnan(flux) & ~torch.isnan(z) & (z > 0)
    m_ab = -2.5 * torch.log10(torch.where(ok, flux, 1.0) * 1e-6) + 8.90
    d_l = _lum_dist(torch.clamp(z, min=1e-6))
    mu = 5.0 * torch.log10(torch.clamp(d_l, min=1e-10)) + 25.0
    k = -2.5 * torch.log10(1.0 + z)
    return torch.where(ok & (d_l > 0), m_ab - mu - k, _NAN)


def _mhps_pairwise(t, f, mask, scale):
    """Rows [N, T] -> [N]."""
    n = M.count(mask)
    mu = M.mean(f, mask)
    ok = (n >= 5) & (mu != 0)
    nf = (f - mu[:, None]) / torch.where(mu != 0, mu, 1.0)[:, None]
    T = t.shape[-1]
    upper = torch.ones(T, T, dtype=torch.bool, device=t.device).triu(1)
    pair = mask[:, :, None] & mask[:, None, :] & upper
    tn = torch.abs(t[:, None, :] - t[:, :, None]) / scale
    sel = pair & (tn < 5.0)
    kern = torch.abs((1.0 - tn * tn) * torch.exp(-tn * tn / 2.0))
    df2 = (nf[:, None, :] - nf[:, :, None]) ** 2
    npair = sel.sum(dim=(1, 2))
    val = torch.sqrt(torch.where(sel, df2 * kern, 0.0).sum(dim=(1, 2)) / npair.clamp(min=1))
    return torch.where(ok & (npair > 0), val, _NAN)


def _fleet(t, f, mask):
    n = M.count(mask)
    pk = M.argmax(f, mask)
    pt, pf = M.take(t, pk)[:, None], M.take(f, pk)
    ok = (n >= 5) & (pf > 0)
    pf_ = torch.where(pf > 0, pf, 1.0)[:, None]

    def tau_of(seg_mask, dt):
        valid = seg_mask & (f > 0)
        log_ratio = torch.log(torch.clamp(torch.where(valid, f, 1.0) / pf_, min=1e-30))
        d_std = M.std(torch.where(valid, dt, 0.0), valid, 0)
        slope, _ = M.linfit(dt, log_ratio, valid)
        good = ((seg_mask.sum(dim=1) >= 3) & (valid.sum(dim=1) >= 3) & (d_std > 0)
                & (slope < 0))
        return torch.where(good, -1.0 / torch.where(slope < 0, slope, -1.0), _NAN)

    rise_tau = tau_of(mask & (t < pt), pt - t)
    fall_tau = tau_of(mask & (t > pt), t - pt)
    both = ~torch.isnan(rise_tau) & ~torch.isnan(fall_tau)
    width = torch.where(both, (rise_tau + fall_tau) / 2.0,
                        torch.where(~torch.isnan(fall_tau), fall_tau, rise_tau))
    asym = torch.where(both & (rise_tau > 0),
                       fall_tau / torch.where(rise_tau > 0, rise_tau, 1.0), _NAN)
    return torch.where(ok, width, _NAN), torch.where(ok, asym, _NAN)


def _acf(t, f, mask):
    n = M.count(mask)
    t0, t1 = M.mmin(t, mask), M.mmax(t, mask)
    span = t1 - t0
    # jnp's float -> int32 cast of NaN is 0, clipped to 1
    g_len = torch.nan_to_num(torch.ceil(span), nan=0.0).clamp(1, GRID_LEN).to(torch.int32)
    ok = (n >= 10) & (span >= 30.0) & (g_len >= 20)
    pos = torch.arange(GRID_LEN, device=t.device)
    grid = t0[:, None] + pos.to(torch.float32)[None, :]
    x = _np_interp(grid, t, f, mask)
    gm = pos[None, :] < g_len[:, None]
    gl = g_len.clamp(min=1)
    mu = torch.where(gm, x, 0.0).sum(dim=1) / gl
    sd = torch.sqrt(torch.where(gm, (x - mu[:, None]) ** 2, 0.0).sum(dim=1) / gl)
    x = torch.where(gm, (x - mu[:, None]) / (sd[:, None] + 1e-10), 0.0)

    def lag(k):
        prod = x * torch.roll(x, -k, dims=1)
        valid = gm & ((pos + k)[None, :] < g_len[:, None])
        return torch.where(valid, prod, 0.0).sum(dim=1) / gl

    a10 = torch.where(ok & (g_len > 11), lag(10), _NAN)
    a30 = torch.where(ok & (g_len > 31), lag(30), _NAN)
    big30 = torch.abs(a30) > 0.01
    ratio = torch.where(~torch.isnan(a10) & ~torch.isnan(a30) & big30,
                        a10 / torch.where(big30, a30, 1.0), _NAN)
    return a10, a30, ratio


def _hos(f, mask):
    n = M.count(mask)
    ok = n >= 5
    mu = M.mean(f, mask)
    m2 = M.var(f, mask, 0)
    d = torch.where(mask, f - mu[:, None], 0.0)
    m3 = (d ** 3).sum(dim=-1) / n.clamp(min=1)
    m4 = (d ** 4).sum(dim=-1) / n.clamp(min=1)
    m2_ = torch.where(m2 > 0, m2, 1.0)
    skew = torch.where(m2 > 0, m3 / m2_ ** 1.5, _NAN)
    kurt = torch.where(m2 > 0, m4 / m2_ ** 2 - 3.0, _NAN)

    med = M.median(f, mask)
    mad = M.median(torch.abs(f - med[:, None]), mask)
    u = (f - med[:, None]) / torch.where(mad > 0, 9.0 * mad, 1.0)[:, None]
    valid = mask & (torch.abs(u) < 1.0)
    nv = valid.sum(dim=1)
    num = torch.where(valid, (f - med[:, None]) ** 2 * (1.0 - u * u) ** 4, 0.0).sum(dim=-1)
    den = torch.where(valid, (1.0 - u * u) * (1.0 - 5.0 * u * u), 0.0).sum(dim=-1) ** 2
    biw = torch.where((mad > 0) & (nv >= 3) & (den > 0),
                      n * num / torch.where(den > 0, den, 1.0), _NAN)
    return (torch.where(ok, skew, _NAN), torch.where(ok, kurt, _NAN),
            torch.where(ok, biw, _NAN))


def _nan_unless(ok, x):
    return torch.where(ok, x, _NAN)


def extract(packed, meta) -> FeatureSet:
    z = (per_object(meta.z, packed) if meta is not None
         else torch.full((packed.n_objects,), _NAN, device=packed.device))
    feats: FeatureSet = {}
    t, f, mask = packed.band_time, packed.band_flux, packed.band_mask
    nb = M.count(mask)
    bok = nb >= 3
    bm = mask & bok[..., None]

    for bi, band in ((1, "g"), (2, "r"), (3, "i")):
        pkf = M.mmax(f[:, bi], bm[:, bi])
        muf = M.mean(f[:, bi], bm[:, bi])
        feats[f"{band}_abs_mag_peak"] = _nan_unless(bok[:, bi], _abs_mag(pkf, z))
        feats[f"{band}_abs_mag_mean"] = _nan_unless(bok[:, bi], _abs_mag(muf, z))

    for bi, band in ((2, "r"), (1, "g")):
        vals = {}
        for s in MHPS_SCALES:
            vals[s] = _nan_unless(bok[:, bi], _mhps_pairwise(t[:, bi], f[:, bi], bm[:, bi], s))
            feats[f"{band}_mhps_{int(s)}"] = vals[s]
        for a, b, name in ((10.0, 100.0, "10_100"), (30.0, 365.0, "30_365")):
            okr = ~torch.isnan(vals[a]) & ~torch.isnan(vals[b]) & (vals[b] > 0)
            feats[f"{band}_mhps_ratio_{name}"] = torch.where(
                okr, vals[a] / torch.where(vals[b] > 0, vals[b], 1.0), _NAN)

    for bi, band in ((2, "r"), (1, "g")):
        w, a = _fleet(t[:, bi], f[:, bi], bm[:, bi])
        feats[f"{band}_fleet_width"] = _nan_unless(bok[:, bi], w)
        feats[f"{band}_fleet_asymmetry"] = _nan_unless(bok[:, bi], a)
        feats[f"{band}_fleet_chi2"] = torch.full_like(w, _NAN)

    r_peak = _nan_unless(bok[:, 2], M.take(t[:, 2], M.argmax(f[:, 2], bm[:, 2])))
    for b1, b2, pname in ((1, 2, "g_r"), (2, 3, "r_i")):
        pre1 = mask[:, b1] & (t[:, b1] < r_peak[:, None])
        pre2 = mask[:, b2] & (t[:, b2] < r_peak[:, None])
        enough = (pre1.sum(dim=1) >= 2) & (pre2.sum(dim=1) >= 2) & ~torch.isnan(r_peak)
        j, dmin = _nearest(t[:, b1], t[:, b2], pre2)
        f1, f2 = f[:, b1], torch.gather(f[:, b2], 1, j)
        pairm = pre1 & (dmin < 5.0) & (f1 > 0) & (f2 > 0)
        c = -2.5 * torch.log10(torch.where(pairm, f1, 1.0) / torch.where(pairm, f2, 1.0))
        nc = pairm.sum(dim=1)
        mu_c = torch.where(pairm, c, 0.0).sum(dim=1) / nc.clamp(min=1)
        feats[f"pre_peak_{pname}_mean"] = _nan_unless(enough & (nc >= 2), mu_c)
        slope, _ = M.linfit(t[:, b1], c, pairm)
        feats[f"pre_peak_{pname}_slope"] = _nan_unless(enough & (nc >= 3), slope * 10.0)

    a10, a30, ar = _acf(t[:, 2], f[:, 2], bm[:, 2])
    feats["r_acf_10d"] = _nan_unless(bok[:, 2], a10)
    feats["r_acf_30d"] = _nan_unless(bok[:, 2], a30)
    feats["r_acf_ratio"] = _nan_unless(bok[:, 2], ar)

    n_all = M.count(packed.all_mask)
    t_min = M.mmin(packed.all_time, packed.all_mask)[:, None]
    t_max = M.mmax(packed.all_time, packed.all_mask)[:, None]
    third = (t_max - t_min) / 3.0
    for bi, band in ((1, "g"), (2, "r"), (3, "i")):
        early = mask[:, bi] & (t[:, bi] < t_min + third)
        late = mask[:, bi] & (t[:, bi] > t_max - third)
        okb = ((n_all >= 10) & (nb[:, bi] >= 5) & (early.sum(dim=1) >= 2)
               & (late.sum(dim=1) >= 2))
        e_mu, l_mu = M.mean(f[:, bi], early), M.mean(f[:, bi], late)
        feats[f"{band}_early_late_flux_ratio"] = torch.where(
            okb & (e_mu > 0), l_mu / torch.where(e_mu > 0, e_mu, 1.0), _NAN)
        e_v, l_v = M.var(f[:, bi], early, 0), M.var(f[:, bi], late, 0)
        feats[f"{band}_early_late_var_ratio"] = torch.where(
            okb & (e_v > 0), l_v / torch.where(e_v > 0, e_v, 1.0), _NAN)

    sk, ku, bw = _hos(packed.all_flux, packed.all_mask)
    feats["flux_skewness"] = sk
    feats["flux_kurtosis"] = ku
    feats["flux_biweight"] = bw
    for bi, band in ((1, "g"), (2, "r")):
        sk, ku, bw = _hos(f[:, bi], bm[:, bi])
        feats[f"{band}_flux_skewness"] = _nan_unless(bok[:, bi], sk)
        feats[f"{band}_flux_kurtosis"] = _nan_unless(bok[:, bi], ku)
        feats[f"{band}_flux_biweight"] = _nan_unless(bok[:, bi], bw)

    pt = [M.take(t[:, b], M.argmax(f[:, b], bm[:, b])) for b in (1, 2, 3)]
    feats["peak_lag_g_r"] = _nan_unless(bok[:, 1] & bok[:, 2], pt[0] - pt[1])
    feats["peak_lag_r_i"] = _nan_unless(bok[:, 2] & bok[:, 3], pt[1] - pt[2])
    g_pk, r_pk, i_pk = (M.mmax(f[:, b], bm[:, b]) for b in (1, 2, 3))
    feats["peak_flux_ratio_g_r"] = torch.where(
        bok[:, 1] & bok[:, 2] & (r_pk > 0), g_pk / torch.where(r_pk > 0, r_pk, 1.0), _NAN)
    feats["peak_flux_ratio_r_i"] = torch.where(
        bok[:, 2] & bok[:, 3] & (i_pk > 0), r_pk / torch.where(i_pk > 0, i_pk, 1.0), _NAN)
    return sorted_features(feats)
