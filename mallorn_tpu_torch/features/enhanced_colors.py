"""Enhanced colors, v47 (port of ``mallorn_tpu.features.enhanced_colors``):
4 band pairs x 8 epochs of windowed colors, their dispersions, and a
cross-color correlation.

- the peak epoch is the g-band argmax, else the r-band's;
- the flux at an epoch: the points within +-5 d (>= 2), linearly
  interpolated, NaN outside that window's span;
- per pair: dispersion, range and mean over >= 3 finite epoch colors;
- the g-r / r-i correlation pairs the k-th finite g-r color with the
  k-th finite r-i color by position (the finite lists are zipped, not
  matched by epoch).
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M

_NAN = float("nan")
OFFSETS = (0.0, 10.0, 20.0, 30.0, 50.0, 75.0, 100.0, 150.0)
PAIRS = ((0, 1, "ug"), (1, 2, "gr"), (2, 3, "ri"), (3, 4, "iz"))


def _flux_at(t, f, mask, target):
    """[N, 6] fluxes at ``target`` [N]."""
    win = mask & (t >= (target - 5.0)[:, None, None]) & (t <= (target + 5.0)[:, None, None])
    v = M.interp_at(t, f, win, target[:, None], max_gap=torch.inf)
    return torch.where(win.sum(dim=-1) >= 2, v, _NAN)


def _compact(vals):
    """Finite values moved to the front (stable) of [N, E], and their count."""
    finite = torch.isfinite(vals)
    order = torch.sort((~finite).to(torch.uint8), dim=1, stable=True).indices
    return torch.gather(vals, 1, order), finite.sum(dim=1)


def extract(packed, meta=None) -> FeatureSet:
    t, f, mask = packed.band_time, packed.band_flux, packed.band_mask
    nb = M.count(mask)
    g_peak = M.take(t[:, 1], M.argmax(f[:, 1], mask[:, 1]))
    r_peak = M.take(t[:, 2], M.argmax(f[:, 2], mask[:, 2]))
    peak = torch.where(nb[:, 1] > 0, g_peak, torch.where(nb[:, 2] > 0, r_peak, _NAN))

    feats: FeatureSet = {}
    colors = {}
    for off in OFFSETS:
        fl = _flux_at(t, f, mask, peak + off)
        for b1, b2, pname in PAIRS:
            f1, f2 = fl[:, b1], fl[:, b2]
            ok = (f1 > 0) & (f2 > 0) & torch.isfinite(f1) & torch.isfinite(f2)
            c = torch.where(ok, -2.5 * torch.log10(torch.where(ok, f1, 1.0)
                                                   / torch.where(ok, f2, 1.0)), _NAN)
            feats[f"{pname}_color_{int(off)}d"] = c
            colors.setdefault(pname, []).append(c)

    for _, _, pname in PAIRS:
        cv = torch.stack(colors[pname], dim=1)
        m = torch.isfinite(cv)
        n = m.sum(dim=1)
        mu = torch.where(m, cv, 0.0).sum(dim=1) / n.clamp(min=1)
        sd = torch.sqrt(torch.where(m, (cv - mu[:, None]) ** 2, 0.0).sum(dim=1) / n.clamp(min=1))
        rng = M.mmax(cv, m) - M.mmin(cv, m)
        feats[f"{pname}_color_dispersion"] = torch.where(n >= 3, sd, _NAN)
        feats[f"{pname}_color_range"] = torch.where(n >= 3, rng, _NAN)
        feats[f"{pname}_color_mean"] = torch.where(n >= 3, mu, _NAN)

    gr_c, n_gr = _compact(torch.stack(colors["gr"], dim=1))
    ri_c, n_ri = _compact(torch.stack(colors["ri"], dim=1))
    npair = torch.minimum(n_gr, n_ri)
    pm = torch.arange(len(OFFSETS), device=t.device)[None, :] < npair[:, None]
    gx, rx = torch.where(pm, gr_c, 0.0), torch.where(pm, ri_c, 0.0)
    nf = npair.clamp(min=1)
    gmu, rmu = gx.sum(dim=1) / nf, rx.sum(dim=1) / nf
    cov = torch.where(pm, (gx - gmu[:, None]) * (rx - rmu[:, None]), 0.0).sum(dim=1)
    gsd = torch.sqrt(torch.where(pm, (gx - gmu[:, None]) ** 2, 0.0).sum(dim=1))
    rsd = torch.sqrt(torch.where(pm, (rx - rmu[:, None]) ** 2, 0.0).sum(dim=1))
    corr = cov / torch.clamp(gsd * rsd, min=1e-30)
    ok = (n_gr >= 2) & (n_ri >= 2) & (npair >= 3)
    feats["gr_ri_color_correlation"] = torch.where(ok, corr, _NAN)
    return sorted_features(feats)
