"""Physics-based features (port of ``mallorn_tpu.features.physics``).

Bands take part with >= 3 observations: Stetson J between band pairs
(nearest neighbour within 0.5 d) and Stetson K per band, the r-band
structure function and its log-log slope, rest-frame durations divided
by (1+z), blackbody-proxy temperatures at peak and +50 d, Bazin-like
approximations on the r band without fitting, SNR and excess variance.
"""

from __future__ import annotations

import math

import torch

from mallorn_tpu_torch.features.base import FeatureSet, per_object, sorted_features
from mallorn_tpu_torch.ops import masked as M

_BIG = 1.0e30
_NAN = float("nan")
SF_TAUS = (1.0, 5.0, 10.0, 30.0, 100.0)


def _nearest(t1, t2, m2):
    """For each point of t1 [N, T1], the index of and distance to the
    nearest valid point of t2 [N, T2]."""
    d = torch.abs(t2[:, None, :] - t1[:, :, None])
    d = torch.where(m2[:, None, :], d, _BIG)
    j = torch.argmin(d, dim=2)
    return j, M.take(d, j)


def _stetson_j(t1, f1, e1, m1, t2, f2, e2, m2, max_dt=0.5):
    mean1 = M.mean(f1, m1)
    mean2 = M.mean(f2, m2)
    std1 = M.std(f1, m1, 0)
    std2 = M.std(f2, m2, 0)

    j2, dmin = _nearest(t1, t2, m2)
    f2n = torch.gather(f2, 1, j2)
    e2n = torch.gather(e2, 1, j2)

    pair = m1 & (dmin <= max_dt) & (e1 > 0) & (e2n > 0)
    d1 = (f1 - mean1[:, None]) / torch.where(e1 > 0, e1, 1.0)
    d2 = (f2n - mean2[:, None]) / torch.where(e2n > 0, e2n, 1.0)
    prod = d1 * d2
    contrib = torch.sign(prod) * torch.sqrt(torch.abs(prod))
    n_pairs = pair.sum(dim=1)
    j = torch.where(pair, contrib, 0.0).sum(dim=1) / n_pairs.clamp(min=1)
    j = torch.where(n_pairs > 0, j, _NAN)
    j = torch.where((std1 == 0) | (std2 == 0), 0.0, j)
    ok = (M.count(m1) >= 3) & (M.count(m2) >= 3)
    return torch.where(ok, j, _NAN)


def _stetson_k(f, e, m):
    n = M.count(m)
    mean_f = M.mean(f, m)
    valid = m & (e > 0)
    nv = valid.sum(dim=1)
    delta = torch.abs(f - mean_f[:, None]) / torch.where(e > 0, e, 1.0)
    s1 = torch.where(valid, delta, 0.0).sum(dim=1)
    s2 = torch.where(valid, delta * delta, 0.0).sum(dim=1)
    k = s1 / torch.sqrt(s2) / torch.sqrt(n.to(f.dtype))
    return torch.where((n >= 4) & (nv >= 4), k, _NAN)


def _structure_function(t, f, m):
    out = {}
    n = M.count(m)
    T = t.shape[1]
    iu = torch.ones(T, T, dtype=torch.bool, device=t.device).triu(diagonal=1)
    pair = m[:, :, None] & m[:, None, :] & iu
    dt = torch.abs(t[:, None, :] - t[:, :, None])
    df2 = (f[:, None, :] - f[:, :, None]) ** 2

    sf_vals = []
    for tau in SF_TAUS:
        sel = pair & (dt >= 0.5 * tau) & (dt <= 1.5 * tau)
        ns = sel.sum(dim=(1, 2))
        sf = torch.sqrt(torch.where(sel, df2, 0.0).sum(dim=(1, 2)) / ns.clamp(min=1))
        sf = torch.where((ns >= 3) & (n >= 5), sf, _NAN)
        out[f"sf_tau_{int(tau)}"] = sf
        sf_vals.append(sf)

    sfv = torch.stack(sf_vals, dim=-1)
    taus = torch.log10(torch.tensor(SF_TAUS, dtype=torch.float32, device=t.device))
    valid = ~torch.isnan(sfv) & (sfv > 0)
    logsf = torch.log10(torch.where(valid, sfv, 1.0))
    slope, _ = M.linfit(taus, logsf, valid)
    out["sf_slope"] = torch.where(valid.sum(dim=-1) >= 3, slope, _NAN)
    return out


def _estimate_temperature(g, r, i):
    ok = (g > 0) & (r > 0) & (i > 0) & ~(torch.isnan(g) | torch.isnan(r) | torch.isnan(i))
    c = -2.5 * torch.log10(torch.where(ok, g, 1.0) / torch.where(ok, r, 1.0))
    temp = 7000.0 / (c + 0.6)
    temp = torch.where(c < -0.5, 50000.0, temp)
    temp = torch.where(c > 2.0, 3000.0, temp)
    return torch.where(ok, torch.clamp(temp, 3000.0, 100000.0), _NAN)


def _bazin_simple(t, f, m):
    """fit_bazin_simple on the time-sorted r band [N, T]."""
    out = {}
    n = M.count(m)
    ok5 = n >= 5
    peak_idx = M.argmax(f, m)
    pf = M.take(f, peak_idx)
    ptime = M.take(t, peak_idx)
    out["bazin_amplitude"] = torch.where(ok5, pf, _NAN)
    out["bazin_t0"] = torch.where(ok5, ptime, _NAN)

    idx = torch.arange(f.shape[1], device=f.device)[None, :]
    pk = peak_idx[:, None]
    pre = m & (idx <= pk)
    n_pre = pre.sum(dim=1)

    # reference loop quirk: t_10 = first above-10% point with index >= 1,
    # scanned only up to the first above-90% point; fallback times[0]
    above90 = pre & (f >= 0.9 * pf[:, None])
    has90 = above90.any(dim=1)
    b90 = torch.where(has90, M.first_true(above90), peak_idx)
    t90 = torch.where(has90, M.take(t, b90), ptime)
    above10 = pre & (f >= 0.1 * pf[:, None]) & (idx >= 1) & (idx <= b90[:, None])
    has10 = above10.any(dim=1)
    t10 = torch.where(has10, M.take(t, M.first_true(above10)), t[:, 0])
    out["bazin_rise_approx"] = torch.where(ok5 & (n_pre >= 2), t90 - t10, _NAN)

    post = m & (idx >= pk)
    n_post = post.sum(dim=1)
    below = post & (f <= (pf / math.e)[:, None])
    has_below = below.any(dim=1)
    t_below = M.take(t, M.first_true(below))
    last_i = (n - 1).clamp(min=0)
    t_last = M.take(t, last_i)
    f_last = M.take(f, last_i)
    fall_extrap = (t_last - ptime) * pf / (pf - f_last + 1e-6)
    fall = torch.where(has_below, t_below - ptime,
                       torch.where(n_post > 1, fall_extrap, _NAN))
    out["bazin_fall_approx"] = torch.where(ok5 & (n_post >= 3), fall, _NAN)

    post_pos = torch.cumsum(post.to(torch.int64), dim=1) - 1
    mid = (n_post // 2)[:, None]
    early = M.mean(f, post & (post_pos < mid))
    late = M.mean(f, post & (post_pos >= mid))
    plat = torch.where(early > 0, late / early, _NAN)
    out["bazin_plateau"] = torch.where(ok5 & (n_post >= 5), plat, _NAN)
    return out


def extract(packed, meta) -> FeatureSet:
    """Physics features; r_bazin_t0 is an absolute epoch (offset added)."""
    feats: FeatureSet = {}
    t, f, e, mask = packed.band_time, packed.band_flux, packed.band_err, packed.band_mask
    nb = M.count(mask)
    bok = nb >= 3
    bm = mask & bok.unsqueeze(-1)
    if meta is not None:
        z = per_object(meta.z, packed)
    else:
        z = torch.zeros(packed.n_objects, device=packed.device)

    for b1, b2, name in ((1, 2, "gr"), (2, 3, "ri"), (1, 3, "gi")):
        feats[f"stetson_j_{name}"] = _stetson_j(
            t[:, b1], f[:, b1], e[:, b1], bm[:, b1],
            t[:, b2], f[:, b2], e[:, b2], bm[:, b2])

    for bi, band in ((1, "g"), (2, "r"), (3, "i")):
        k = _stetson_k(f[:, bi], e[:, bi], bm[:, bi])
        feats[f"stetson_k_{band}"] = torch.where(bok[:, bi], k, _NAN)

    sf = _structure_function(t[:, 2], f[:, 2], bm[:, 2])
    for kname, val in sf.items():
        feats[f"r_{kname}"] = torch.where(bok[:, 2], val, _NAN)

    zz = torch.where(torch.isnan(z), 0.0, z)
    for bi, band in ((1, "g"), (2, "r"), (3, "i")):
        tb, fb, mb = t[:, bi], f[:, bi], bm[:, bi]
        t0 = M.mmin(tb, mb)
        t1 = M.mmax(tb, mb)
        peak_idx = M.argmax(fb, mb)
        t_peak = M.take(tb, peak_idx)
        n = M.count(mb)
        ok = bok[:, bi]
        feats[f"{band}_rest_duration"] = torch.where(ok, (t1 - t0) / (1.0 + zz), _NAN)
        feats[f"{band}_rest_rise"] = torch.where(
            ok & (peak_idx > 0), (t_peak - t0) / (1.0 + zz), _NAN)
        feats[f"{band}_rest_fade"] = torch.where(
            ok & (peak_idx < n - 1), (t1 - t_peak) / (1.0 + zz), _NAN)

    has_gri = bok[:, 1] & bok[:, 2] & bok[:, 3]
    gp = M.mmax(f[:, 1], bm[:, 1])
    rp = M.mmax(f[:, 2], bm[:, 2])
    ip = M.mmax(f[:, 3], bm[:, 3])
    feats["temp_at_peak"] = torch.where(has_gri, _estimate_temperature(gp, rp, ip), _NAN)

    r_peak_t = M.take(t[:, 2], M.argmax(f[:, 2], bm[:, 2]))
    target = r_peak_t + 50.0
    late = [M.value_at_nearest(t[:, b], f[:, b], bm[:, b], target, 20.0)
            for b in (1, 2, 3)]
    feats["temp_post_50d"] = torch.where(has_gri, _estimate_temperature(*late), _NAN)
    both = ~torch.isnan(feats["temp_at_peak"]) & ~torch.isnan(feats["temp_post_50d"])
    feats["temp_evolution"] = torch.where(
        both, (feats["temp_post_50d"] - feats["temp_at_peak"]) / 50.0, _NAN)

    bz = _bazin_simple(t[:, 2], f[:, 2], bm[:, 2])
    for kname, val in bz.items():
        feats[f"r_{kname}"] = torch.where(bok[:, 2], val, _NAN)

    af, ae, am = packed.all_flux, packed.all_err, packed.all_mask
    valid = am & (ae > 0) & (af > 0)
    nv = valid.sum(dim=1)
    snr = af / torch.where(ae > 0, ae, 1.0)
    feats["mean_snr"] = M.mean(snr, valid)
    feats["median_snr"] = M.median(snr, valid)
    mean_flux = M.mean(af, valid)
    var_flux = M.var(af, valid, 0)
    mean_var_noise = M.mean(ae * ae, valid)
    excess = (var_flux - mean_var_noise) / (mean_flux * mean_flux)
    feats["excess_variance"] = torch.where(nv > 0, torch.clamp(excess, min=0.0), _NAN)

    feats["r_bazin_t0"] = feats["r_bazin_t0"] + packed.time_offset
    return sorted_features(feats)
