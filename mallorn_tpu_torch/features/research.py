"""Research-literature features, the v115c family (port of
``mallorn_tpu.features.research``): power-law decay quality, nuclear
proxies, color at peak, Mexican-hat power spectra (MHPS) and luminosity.

One batched pass computes every column over the packed views (objects on
the leading axis of every tensor, the JAX package's per-object kernel
written out):

- power law (g, r, i): a log-log line through the points > 10 d after
  the band's peak with positive flux (band >= 5 points, >= 4 such
  points), its deviations from -5/3 and -5/12, residual std, an
  approximate log-space chi^2 with clipped errors, a fit flag, and the
  optical mean / std / mean deviation of the three slopes;
- nuclear proxies (r band, >= 10 points): smoothness, concentration
  (peak over the 10th percentile, or over the median |flux| + 1), the
  short / long variability ratio over 5-point windows with the
  reference's i + 5 time gate, and their combined score;
- color at peak: the nearest g/r (r/i) points within 10 d of the r-band
  (else g-band) peak, and the mean color change to late (> 50 d) pairs
  matched within 5 d;
- MHPS (r band): ``np.interp`` onto a 1-day grid (clamped at both ends),
  mean removed, Ricker wavelets of 10 / 30 / 100 d with length
  min(5 scale, grid // 2) and ``np.linspace``'s odd-length endpoints,
  ``convolve(..., 'same')`` through an FFT of length 2 ``GRID_LEN``, power
  = sum(conv^2) / grid length, two ratios and the dominant scale;
- luminosity: a piecewise flat-LCDM luminosity distance, the optical
  (g/r/i) rows' peak, amplitude and mean luminosity, and the log-space
  decline rate after the peak x 100.

The FFT is a library call, as XLA computed it outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from mallorn_tpu_torch.features.base import FeatureSet, per_object, sorted_features
from mallorn_tpu_torch.features.physics import _nearest
from mallorn_tpu_torch.ops import masked as M

_NAN = float("nan")
_BIG = 1.0e30
GRID_LEN = 1024  # 1-day grid buffer (spans beyond any LSST season window)
WAVELET_LEN = 512
H0, C_KM_S = 70.0, 299792.458
OMEGA_M, OMEGA_L = 0.3, 0.7
MHPS_SCALES = (10.0, 30.0, 100.0)


def _mean_over(x, keep, n):
    return torch.where(keep, x, 0.0).sum(dim=-1) / n.clamp(min=1)


def _np_interp(grid, times, values, mask, fused: bool = False):
    """``np.interp`` of each row's masked, time-sorted series at ``grid``
    [N, G]: clamped at both ends. ``fused`` rounds f1 + w (f2 - f1) once,
    as XLA:CPU fuses it into a multiply-add (float64 holds the float32
    product exactly), for callers that need the JAX package's bits."""
    t = torch.where(mask, times, _BIG).contiguous()
    idx = torch.searchsorted(t, grid.contiguous(), right=True) - 1
    top = (mask.sum(dim=-1) - 1).clamp(min=0)[:, None]
    lo = torch.minimum(idx.clamp(min=0), top)
    hi = torch.minimum((idx + 1).clamp(min=0), top)
    t1, t2 = torch.gather(t, 1, lo), torch.gather(t, 1, hi)
    f1, f2 = torch.gather(values, 1, lo), torch.gather(values, 1, hi)
    dt = t2 - t1
    w = torch.where(dt > 0, (grid - t1) / torch.where(dt > 0, dt, 1.0), 0.0).clamp(0.0, 1.0)
    if fused:
        return (f1.double() + w.double() * (f2 - f1).double()).to(values.dtype)
    return f1 + w * (f2 - f1)


def _powerlaw_block(t, f, e, mask, nb):
    """Per band ([N, 6, T] inputs, [N, 6] outputs)."""
    pk = M.argmax(f, mask)
    pt = M.take(t, pk)[..., None]
    post = mask & (t > pt + 10.0) & (f > 0)
    n_post = post.sum(dim=-1)
    ok = (nb >= 5) & (n_post >= 4)

    dt = torch.where(post, t - pt, 1.0)
    log_t = torch.log10(dt.clamp(min=1e-10))
    log_f = torch.log10(torch.where(post, f, 1.0).clamp(min=1e-10))
    slope, intercept = M.linfit(log_t, log_f, post)
    resid = torch.where(post, log_f - (slope[..., None] * log_t + intercept[..., None]), 0.0)
    resid_std = M.std(resid, post, 0)
    log_errs = torch.where(post, e, 1.0) / (torch.where(post, f, 1.0) * math.log(10.0) + 1e-10)
    log_errs = log_errs.clamp(0.01, 1.0)
    chi2 = torch.where(post, (resid / log_errs) ** 2, 0.0).sum(dim=-1)
    red_chi2 = chi2 / (n_post - 2).clamp(min=1)
    return {
        "powerlaw_alpha": torch.where(ok, slope, _NAN),
        "powerlaw_alpha_deviation_53": torch.where(ok, torch.abs(slope + 5.0 / 3.0), _NAN),
        "powerlaw_alpha_deviation_512": torch.where(ok, torch.abs(slope + 5.0 / 12.0), _NAN),
        "powerlaw_chi2": torch.where(ok & (n_post > 2), red_chi2, _NAN),
        "powerlaw_residual_std": torch.where(ok, resid_std, _NAN),
        # NaN when the band has < 5 points, else 0 / 1
        "powerlaw_fit_success": torch.where(nb >= 5, ok.to(t.dtype), _NAN),
    }


def _ricker(scale, length, buf_len):
    """Ricker wavelets [N, buf_len] of ``length`` [N] points, unit energy,
    on ``np.linspace(-L//2, L//2, L)`` (whose lower end is -ceil(L/2))."""
    k = torch.arange(buf_len, dtype=torch.float32, device=length.device)[None, :]
    L = length[:, None]
    lo = -torch.ceil(L / 2.0)
    hi = torch.floor(L / 2.0)
    step = torch.where(L > 1, (hi - lo) / torch.clamp(L - 1.0, min=1.0), 0.0)
    nt = (lo + k * step) / scale
    w = torch.where(k < L, (1.0 - nt * nt) * torch.exp(-nt * nt / 2.0), 0.0)
    energy = torch.sqrt((w * w).sum(dim=-1, keepdim=True))
    return w / energy.clamp(min=1e-20)


def _conv_same(f, w, g_len, w_len, buf):
    """``scipy.signal.convolve(f, w, 'same')`` of masked fixed buffers
    (f [N, buf], w [N, WAVELET_LEN]) through a length-2 buf FFT."""
    n_fft = 2 * buf
    full = torch.fft.irfft(torch.fft.rfft(f, n_fft) * torch.fft.rfft(w, n_fft), n_fft)
    start = torch.floor((w_len - 1.0) / 2.0).to(torch.long)[:, None]
    pos = torch.arange(buf, device=f.device)[None, :]
    out = torch.gather(full, 1, (start + pos).clamp(0, n_fft - 1))
    return torch.where(pos < g_len[:, None], out, 0.0)


def _mhps_block(t, f, mask, nb):
    """MHPS of one band ([N, T] inputs)."""
    t0, t1 = M.mmin(t, mask), M.mmax(t, mask)
    span = t1 - t0
    ok = (nb >= 20) & (span >= 50.0)
    # the grid np.arange(t0, t1, 1): ceil(span) points, in [1, GRID_LEN]
    g_len = torch.nan_to_num(torch.ceil(span), nan=1.0).clamp(1, GRID_LEN).to(torch.int32)
    pos = torch.arange(GRID_LEN, device=t.device)
    grid = t0[:, None] + pos.to(torch.float32)[None, :]
    fr = _np_interp(grid, t, f, mask)
    gmask = pos[None, :] < g_len[:, None]
    mu = torch.where(gmask, fr, 0.0).sum(dim=-1) / g_len.clamp(min=1)
    fr = torch.where(gmask, fr - mu[:, None], 0.0)

    out, powers = {}, []
    for s in MHPS_SCALES:
        w_len = torch.minimum(torch.tensor(5.0 * s, device=t.device),
                              torch.floor(g_len / 2.0)).to(torch.int32).to(torch.float32)
        conv = _conv_same(fr, _ricker(s, w_len, WAVELET_LEN), g_len, w_len, GRID_LEN)
        power = (conv * conv).sum(dim=-1) / g_len.clamp(min=1)
        p = torch.where(ok & (w_len >= 5), power, _NAN)
        powers.append(p)
        out[f"mhps_{int(s)}d"] = p
    p10, p30, p100 = powers
    ok100 = ~torch.isnan(p100) & (p100 > 0)
    out["mhps_10_100_ratio"] = torch.where(~torch.isnan(p10) & ok100, p10 / p100, _NAN)
    out["mhps_30_100_ratio"] = torch.where(~torch.isnan(p30) & ok100, p30 / p100, _NAN)
    stacked = torch.stack([torch.where(torch.isnan(p), -torch.inf, p) for p in powers])
    dom = torch.tensor(MHPS_SCALES, device=t.device)[torch.argmax(stacked, dim=0)]
    out["mhps_dominant_scale"] = torch.where(torch.isfinite(stacked).any(dim=0), dom, _NAN)
    return out


def _lum_distance(z):
    dl_low = (C_KM_S / H0) * z * (1.0 + z / 2.0)
    q0 = 0.5 * OMEGA_M - OMEGA_L
    dl_mid = (C_KM_S / H0) * z * (1.0 + 0.5 * (1.0 - q0) * z)
    dl = torch.where(z < 0.1, dl_low, dl_mid)
    return torch.where((z > 0) & ~torch.isnan(z), dl, _NAN)


def _nuclear(feats, t, f, e, mask, nr):
    """Nuclear-transient proxies of the r band ([N, T] inputs)."""
    ok10 = nr >= 10
    rate_m = mask[:, 1:] & mask[:, :-1]
    rate = torch.where(rate_m, torch.abs(f[:, 1:] - f[:, :-1]) / (t[:, 1:] - t[:, :-1] + 0.1),
                       0.0)
    med_rate = M.median(rate, rate_m)
    med_err = M.median(e, mask)
    smooth = 1.0 / (1.0 + med_rate / torch.where(med_err > 0, med_err, 1.0))
    feats["nuclear_smoothness"] = torch.where(ok10 & (med_err > 0), smooth, _NAN)

    pk = M.mmax(f, mask)
    base = M.quantile(f, mask, 0.10)
    med_abs = M.median(torch.abs(f) + 1.0, mask)
    conc = torch.where(base > 0, pk / torch.where(base > 0, base, 1.0),
                       torch.where(pk > 0, pk / med_abs, _NAN))
    feats["nuclear_concentration"] = torch.where(ok10, conc, _NAN)

    # 5-point window stds, gated by the reference's i + 5 time quirk
    T = f.shape[-1]
    idx = torch.arange(max(T - 5, 1), device=f.device)
    nr1 = nr[:, None]
    gate = ((idx + 5 < nr1) & (idx < nr1 - 5)
            & (t[:, (idx + 5).clamp(0, T - 1)] - t[:, idx.clamp(0, T - 1)] < 15.0))
    starts = idx.clamp(0, max(T - 5, 0))
    w = f.unfold(-1, 5, 1)[:, starts]  # [N, windows, 5]
    wm = mask.unfold(-1, 5, 1)[:, starts]
    n = wm.sum(dim=-1)
    mu = _mean_over(w, wm, n)
    stds = torch.sqrt(_mean_over((w - mu[..., None]) ** 2, wm, n))
    n_w = gate.sum(dim=-1)
    short = _mean_over(stds, gate, n_w)
    long_var = M.std(f, mask, 0)
    vr = short / torch.where(long_var > 0, long_var, 1.0)
    feats["nuclear_variability_ratio"] = torch.where(
        ok10 & (nr >= 20) & (n_w > 0) & (long_var > 0), vr, _NAN)

    parts = torch.stack([feats["nuclear_smoothness"],
                         torch.clamp(feats["nuclear_concentration"] / 100.0, max=1.0),
                         1.0 - torch.clamp(feats["nuclear_variability_ratio"], max=1.0)], dim=1)
    pm = ~torch.isnan(parts)
    n_p = pm.sum(dim=1)
    feats["nuclear_position_score"] = torch.where(n_p > 0, _mean_over(parts, pm, n_p), _NAN)


def _colors_at_peak(feats, t, f, mask, nb):
    r_ok, g_ok = nb[:, 2] >= 3, nb[:, 1] >= 3
    peak_r = M.take(t[:, 2], M.argmax(f[:, 2], mask[:, 2]))
    peak_g = M.take(t[:, 1], M.argmax(f[:, 1], mask[:, 1]))
    peak = torch.where(r_ok, peak_r, peak_g)
    have_peak = r_ok | g_ok
    for b1, b2, pname in ((1, 2, "g_r"), (2, 3, "r_i")):
        both = (nb[:, b1] >= 2) & (nb[:, b2] >= 2)
        near = [M.value_at_nearest(t[:, b], f[:, b],
                                   mask[:, b] & (torch.abs(t[:, b] - peak[:, None]) < 10.0),
                                   peak, 10.0) for b in (b1, b2)]
        okc = have_peak & both & (near[0] > 0) & (near[1] > 0)
        cap = torch.where(okc, -2.5 * torch.log10(torch.where(okc, near[0], 1.0)
                                                  / torch.where(okc, near[1], 1.0)), _NAN)
        feats[f"{pname}_color_at_peak"] = cap

        # late band-1 points matched to the nearest late band-2 point
        late1 = mask[:, b1] & (t[:, b1] > peak[:, None] + 50.0)
        late2 = mask[:, b2] & (t[:, b2] > peak[:, None] + 50.0)
        j, dmin = _nearest(t[:, b1], t[:, b2], late2)
        f1, f2l = f[:, b1], torch.gather(f[:, b2], 1, j)
        pairs = late1 & (dmin < 5.0) & (f1 > 0) & (f2l > 0)
        cl = -2.5 * torch.log10(torch.where(pairs, f1, 1.0) / torch.where(pairs, f2l, 1.0))
        ncl = pairs.sum(dim=-1)
        feats[f"{pname}_color_peak_to_late"] = torch.where(
            okc & (ncl > 0), _mean_over(cl, pairs, ncl) - cap, _NAN)


def _luminosity(feats, packed, z):
    dl = _lum_distance(z)
    opt = packed.all_mask & (packed.all_band >= 1) & (packed.all_band <= 3)
    n_opt = opt.sum(dim=-1)
    ok = ~torch.isnan(dl) & (n_opt >= 5)
    lum = packed.all_flux * dl[:, None] * dl[:, None]
    peak = M.mmax(lum, opt)
    feats["luminosity_distance_mpc"] = dl
    feats["peak_luminosity"] = torch.where(ok, peak, _NAN)
    feats["luminosity_amplitude"] = torch.where(ok, peak - M.quantile(lum, opt, 0.10), _NAN)
    feats["mean_luminosity"] = torch.where(ok, M.mean(lum, opt), _NAN)

    pos = torch.cumsum(opt.to(torch.int32), dim=-1) - 1
    pk_pos = M.take(pos, M.argmax(lum, opt))
    post = opt & (pos >= pk_pos[:, None])
    all_pos = (torch.where(post, lum, 1.0) > 0).all(dim=-1)
    dtp = torch.where(post, packed.all_time, 0.0)
    log_lum = torch.log10(torch.where(post, lum, 1.0).clamp(min=1e-30))
    slope, _ = M.linfit(dtp, log_lum, post)
    decline_ok = (ok & (pk_pos < n_opt - 5) & (post.sum(dim=-1) >= 3) & all_pos
                  & (M.std(dtp, post, 0) > 0))
    feats["luminosity_decline_rate"] = torch.where(decline_ok, slope * 100.0, _NAN)


def extract(packed, meta=None) -> FeatureSet:
    """Every column of the research family, sorted by name as the JAX
    package's jitted dict returns them."""
    feats: FeatureSet = {}
    t, f, e, mask = packed.band_time, packed.band_flux, packed.band_err, packed.band_mask
    nb = M.count(mask)

    pl = _powerlaw_block(t, f, e, mask, nb)
    for bi, band in ((1, "g"), (2, "r"), (3, "i")):
        for key, val in pl.items():
            feats[f"{band}_{key}"] = torch.where(nb[:, bi] >= 5, val[:, bi], _NAN)
    alphas = torch.stack([feats[f"{b}_powerlaw_alpha"] for b in "gri"], dim=1)
    am = ~torch.isnan(alphas)
    na = am.sum(dim=1)
    mu = _mean_over(alphas, am, na)
    sd = torch.sqrt(_mean_over((alphas - mu[:, None]) ** 2, am, na))
    dev = _mean_over(torch.abs(alphas + 5.0 / 3.0), am, na)
    feats["optical_mean_powerlaw_alpha"] = torch.where(na >= 1, mu, _NAN)
    feats["optical_std_powerlaw_alpha"] = torch.where(na >= 2, sd, _NAN)
    feats["optical_mean_deviation_53"] = torch.where(na >= 1, dev, _NAN)

    _nuclear(feats, t[:, 2], f[:, 2], e[:, 2], mask[:, 2], nb[:, 2])
    _colors_at_peak(feats, t, f, mask, nb)
    feats.update(_mhps_block(t[:, 2], f[:, 2], mask[:, 2], nb[:, 2]))
    z = (per_object(meta.z, packed) if meta is not None and meta.z is not None
         else torch.full((packed.n_objects,), _NAN, device=packed.device))
    _luminosity(feats, packed, z)
    return sorted_features(feats)
