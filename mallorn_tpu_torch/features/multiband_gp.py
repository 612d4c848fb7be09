"""Multi-band 2D GP features (port of ``mallorn_tpu.features.multiband_gp``).

- data prep: points with finite flux and err > 0, >= 10 required; times
  zeroed at the filtered minimum; flux/err normalised by the median
  |flux| of nonzero fluxes (fallback 1.0);
- objects go in valid-count-sorted chunks of 2048, and each chunk's time
  axis is compacted (valid points to the front) to its max count rounded
  up to a multiple of 64, so a chunk of sparse objects pays (T_c/T)^3 of
  the Cholesky cost;
- the two-phase gate is decided once for the whole dataset: phase 1 runs
  the full Adam schedule at ``_T_COARSE = 64`` on a strided subset of each
  object's valid points, phase 2 refines at full resolution for
  ``max(n_steps // 6, 8)`` steps from that warm start;
- features: gp2d_amplitude/time_scale/wave_scale/log_likelihood/
  time_wave_ratio, and GP-interpolated g/r/i fluxes at 0/20/50/100 d after
  the r-band peak with the gp_gr/gp_ri colors and gr slopes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mallorn_tpu_torch.data.packing import PackedLightcurves
from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.ops.gp import fit_gp_batched, gp_predict
from mallorn_tpu_torch.utils.constants import WAVELENGTHS_A

_NAN = float("nan")
EPOCHS = (0, 20, 50, 100)
PRED_BANDS = ((1, "g"), (2, "r"), (3, "i"))
_T_COARSE = 64


def _use_mask(packed: PackedLightcurves) -> torch.Tensor:
    af, ae = packed.all_flux, packed.all_err
    return packed.all_mask & torch.isfinite(af) & torch.isfinite(ae) & (ae > 0)


def compact_width(max_count: int, T: int) -> int:
    """The compacted time width: max valid count (at least 32) rounded up
    to a multiple of 64, capped at T."""
    return min(T, int(math.ceil(max(int(max_count), 32) / 64) * 64))


def _two_phase_gate(tc_global: int, n_steps: int) -> bool:
    return bool(tc_global > 1.5 * _T_COARSE and n_steps >= 30)


def serving_config(packed: PackedLightcurves, n_steps: int):
    """(t_compact, two_phase) fixed once from a dataset, as a server holds
    them: every request is then fitted at that width and on that path, so
    an object's features never depend on which objects share its request."""
    counts = _use_mask(packed).sum(dim=1).cpu().numpy()
    tc = compact_width(counts.max(initial=1), packed.all_time.shape[1])
    return tc, _two_phase_gate(tc, n_steps)


def gp_schedule(counts: np.ndarray, T: int, n_steps: int,
                chunk_size: int = 2048):
    """(two_phase, [t_compact of each chunk]) for valid counts [N]: the
    chunks of ``extract`` (count-sorted) and their compacted widths. The
    two-phase gate is decided once from the dataset-global width, so chunk
    membership never changes which optimisation path an object takes."""
    tc_global = compact_width(counts.max(initial=1), T)
    two_phase = _two_phase_gate(tc_global, n_steps)
    if len(counts) <= chunk_size:
        return two_phase, [tc_global]
    order = np.argsort(counts, kind="stable")
    widths = [compact_width(counts[order[s: s + chunk_size]].max(), T)
              for s in range(0, len(counts), chunk_size)]
    return two_phase, widths


def extract(packed: PackedLightcurves, meta=None, n_steps: int = 100,
            chunk_size: int = 2048) -> FeatureSet:
    n = packed.n_objects
    counts = _use_mask(packed).sum(dim=1).cpu().numpy()
    two_phase, widths = gp_schedule(counts, packed.all_time.shape[1], n_steps,
                                    chunk_size)
    if n <= chunk_size:
        return _extract_chunk(packed, n_steps, widths[0], two_phase)

    order = np.argsort(counts, kind="stable")
    outs = []
    for s, tc in zip(range(0, n, chunk_size), widths):
        tidx = torch.from_numpy(order[s: s + chunk_size]).to(packed.device)
        outs.append(_extract_chunk(packed.map(lambda x: x[tidx]), n_steps, tc,
                                   two_phase))
    inv = torch.from_numpy(np.argsort(order)).to(packed.device)
    return {k: torch.cat([o[k] for o in outs])[inv] for k in outs[0]}


def _extract_chunk(packed: PackedLightcurves, n_steps: int, t_compact: int,
                   two_phase: bool) -> FeatureSet:
    at, af, ae, ab, am = (packed.all_time, packed.all_flux, packed.all_err,
                          packed.all_band, packed.all_mask)
    n_obj = packed.n_objects
    dev = at.device

    use = _use_mask(packed)
    n_use = use.sum(dim=1)
    ok = n_use >= 10

    t0f = M.mmin(at, use)
    t = torch.where(use, at - t0f[:, None], 0.0)

    lam_table = torch.tensor(WAVELENGTHS_A, dtype=torch.float32, device=dev)
    lam = torch.where(use, lam_table[ab.clamp(0, 5).long()], 0.0)

    nz = use & (af != 0)
    scale = M.median(torch.abs(af), nz)
    scale = torch.where(torch.isnan(scale) | (scale == 0), 1.0, scale)
    y = torch.where(use, af / scale[:, None], 0.0)
    yerr = torch.where(use, ae / scale[:, None], 1.0)

    if t_compact < t.shape[1]:
        # valid points to the front (stable keeps time order), truncated
        perm = torch.argsort(torch.where(use, 0, 1), dim=1,
                             stable=True)[:, :t_compact]
        t, lam, y, yerr, use = (torch.gather(a, 1, perm)
                                for a in (t, lam, y, yerr, use))

    if two_phase:
        pos = (torch.arange(_T_COARSE, device=dev)[None, :]
               * n_use.clamp(min=1)[:, None]) // _T_COARSE  # [N, 64]
        first = torch.cat([torch.ones(n_obj, 1, dtype=torch.bool, device=dev),
                           pos[:, 1:] != pos[:, :-1]], dim=1)

        def gat(a):
            return torch.gather(a, 1, pos)

        use_c = gat(use) & first  # dedupe when a lane has < 64 points
        fit1 = fit_gp_batched(gat(t), gat(lam), gat(y), gat(yerr), use_c,
                              n_steps=n_steps)
        fit = fit_gp_batched(t, lam, y, yerr, use,
                             n_steps=max(n_steps // 6, 8),
                             lr=0.05, lr_final=0.01, params0=fit1.params)
    else:
        fit = fit_gp_batched(t, lam, y, yerr, use, n_steps=n_steps)
    ok = ok & fit.valid

    p = fit.params
    amp = torch.exp(p[:, 1])
    ts_ = torch.sqrt(torch.exp(p[:, 2]))
    ws_ = torch.sqrt(torch.exp(p[:, 3]))

    def keep(x):
        return torch.where(ok, x, _NAN)

    feats: FeatureSet = {
        "gp2d_amplitude": keep(amp),
        "gp2d_time_scale": keep(ts_),
        "gp2d_wave_scale": keep(ws_),
        "gp2d_log_likelihood": keep(fit.log_likelihood),
        "gp2d_time_wave_ratio": keep(ts_ / (ws_ / 1000.0)),
    }

    # peak anchor: r-band argmax time minus the RAW min time
    rt, rf, rm = packed.band_time[:, 2], packed.band_flux[:, 2], packed.band_mask[:, 2]
    has_r = M.count(rm) > 0
    r_peak_t = M.take(rt, M.argmax(rf, rm))
    g_peak_t = M.take(at, M.argmax(af, am))
    raw_min = M.mmin(at, am)
    peak_time = torch.where(has_r, r_peak_t, g_peak_t) - raw_min
    peak_in_gp = peak_time + raw_min - t0f  # the GP's (filtered-min) frame

    epochs = torch.tensor(EPOCHS, dtype=torch.float32, device=dev)
    t_star = (peak_in_gp[:, None] + epochs[None, :]).repeat_interleave(
        len(PRED_BANDS), dim=1)  # [N, 4*3] epoch-major
    lam_star = torch.stack([lam_table[b] for b, _ in PRED_BANDS]).repeat(
        n_obj, len(EPOCHS))
    mu = gp_predict(p, t, lam, y, yerr, use, t_star, lam_star) * scale[:, None]

    flux = {}
    for ei, epoch in enumerate(EPOCHS):
        for pi, (_, bname) in enumerate(PRED_BANDS):
            v = mu[:, ei * len(PRED_BANDS) + pi]
            flux[(bname, epoch)] = v
            feats[f"gp_flux_{bname}_{epoch}d"] = keep(v)
        g, r, i = flux[("g", epoch)], flux[("r", epoch)], flux[("i", epoch)]
        gr_ok = ok & (g > 0) & (r > 0)
        ri_ok = ok & (r > 0) & (i > 0)
        feats[f"gp_gr_color_{epoch}d"] = torch.where(
            gr_ok, -2.5 * torch.log10(torch.where(gr_ok, g, 1.0)
                                      / torch.where(gr_ok, r, 1.0)), _NAN)
        feats[f"gp_ri_color_{epoch}d"] = torch.where(
            ri_ok, -2.5 * torch.log10(torch.where(ri_ok, r, 1.0)
                                      / torch.where(ri_ok, i, 1.0)), _NAN)

    gr0, gr50, gr100 = (feats["gp_gr_color_0d"], feats["gp_gr_color_50d"],
                        feats["gp_gr_color_100d"])
    feats["gp_gr_slope_50d"] = torch.where(
        ~torch.isnan(gr0) & ~torch.isnan(gr50), (gr50 - gr0) / 50.0, _NAN)
    feats["gp_gr_slope_100d"] = torch.where(
        ~torch.isnan(gr0) & ~torch.isnan(gr100), (gr100 - gr0) / 100.0, _NAN)
    return sorted_features(feats)
