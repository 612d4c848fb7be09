"""DTW template-distance features, v9 (port of ``mallorn_tpu.features.dtw``).

- every band row is shape-normalised to [0, 1] x [0, 1] and resampled to
  N_POINTS = 50 points (``np.interp``); rows with < 2 points or no time
  span are 0;
- templates are the per-band medians of the labelled training curves
  (bands with >= 5 points), TDE and non-TDE, 0 where a class and band has
  no curve;
- each (object, band) row is compared with the band's two templates by
  the exact O(P^2) DTW dynamic programme, D[i, j] = |x_i - y_j| +
  min(min(D[i, j-1], D[i-1, j]), D[i-1, j-1]), and a greedy backtrack
  gives the warping amount.

The JAX package scans the table cell by cell (49 x 50 dependent steps per
lane). Here the programme walks the anti-diagonals instead, each one step
over all lanes of a [L, P + 1, P + 1] table padded with _INF; every cell
is the same float32 expression of the same operands, so D is the
cell-by-cell recursion's bit for bit. Its first row is the running sum
of the first cost row in ``jnp.cumsum``'s order on XLA:CPU (blocks of
16, then the blocks' offsets), which the JAX package's table starts from.
The backtrack takes 2P steps over all lanes, ties to the first of (diag,
up, left) as ``argmin`` does.

Columns keep the JAX package's insertion order (its dict is built in
Python, not returned by a jitted function).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mallorn_tpu_torch.features.base import FeatureSet
from mallorn_tpu_torch.features.research import _np_interp
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.utils.constants import LSST_BANDS, N_BANDS

_NAN = float("nan")
N_POINTS = 50
_INF = 1.0e30


def _grid(device) -> torch.Tensor:
    """``jnp.linspace(0, 1, N_POINTS)`` as XLA:CPU computes it: k times
    the float32 reciprocal of P - 1, then 1."""
    g = np.arange(N_POINTS, dtype=np.float32) * np.float32(1.0 / (N_POINTS - 1))
    g[-1] = 1.0
    return torch.from_numpy(g).to(device)


def resample(t, f, mask) -> torch.Tensor:
    """Shape-normalised curves [..., P] of rows [..., T]."""
    lead = t.shape[:-1]
    t, f, mask = (x.reshape(-1, x.shape[-1]) for x in (t, f, mask))
    n = M.count(mask)
    t0, t1 = M.mmin(t, mask)[:, None], M.mmax(t, mask)[:, None]
    f0, f1 = M.mmin(f, mask)[:, None], M.mmax(f, mask)[:, None]
    tspan = torch.where(t1 > t0, t1 - t0, 1.0)
    fspan = torch.where(f1 > f0, f1 - f0, 1.0)
    tn = torch.where(mask, (t - t0) / tspan, 0.0)
    fn = torch.where(mask, (f - f0) / fspan, 0.0)
    fn = torch.where(f1 > f0, fn, 0.0)
    grid = _grid(t.device).expand(t.shape[0], N_POINTS)
    curve = _np_interp(grid, tn, fn, mask, fused=True)
    ok = (n >= 2) & (t1[:, 0] > t0[:, 0])
    return torch.where(ok[:, None], curve, 0.0).reshape(*lead, N_POINTS)


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis in XLA:CPU's order for
    ``jnp.cumsum``: zero-padded blocks of 16 summed left to right, plus the
    left-to-right running sum of the earlier blocks' totals."""
    n = x.shape[-1]
    nb = -(-n // 16)
    blocks = torch.nn.functional.pad(x, (0, nb * 16 - n)).reshape(*x.shape[:-1], nb, 16)
    inner = torch.empty_like(blocks)
    inner[..., 0] = blocks[..., 0]
    for j in range(1, 16):
        inner[..., j] = inner[..., j - 1] + blocks[..., j]
    offset = torch.zeros_like(inner[..., 0])
    for b in range(1, nb):
        offset[..., b] = offset[..., b - 1] + inner[..., b - 1, 15]
    return (inner + offset[..., None]).reshape(*x.shape[:-1], nb * 16)[..., :n]


def _diagonals(P: int, device):
    """Per anti-diagonal d = 1 .. 2P - 2, for its cells below the first
    row, the flat indices into the padded [P + 1, P + 1] table of each
    cell, its left, up and diagonal neighbours, and into the [P, P] cost."""
    W = P + 1
    out = []
    for d in range(1, 2 * P - 1):
        i = np.arange(max(1, d - P + 1), min(d, P - 1) + 1)
        j = d - i
        cell = (i + 1) * W + (j + 1)
        idx = np.stack([cell, cell - 1, cell - W, cell - W - 1, i * P + j])
        out.append(torch.from_numpy(idx).to(device))
    return out


def dtw_table(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The DTW table D [L, P, P] of curves x, y [L, P]."""
    L, P = x.shape
    c = torch.abs(x[:, :, None] - y[:, None, :]).reshape(L, P * P)
    Dp = torch.full((L, (P + 1) * (P + 1)), _INF, dtype=x.dtype, device=x.device)
    Dp[:, P + 2:2 * P + 2] = running_sum(c[:, :P])
    for cell, left, up, diag, ci in _diagonals(P, x.device):
        Dp[:, cell] = c[:, ci] + torch.minimum(torch.minimum(Dp[:, left], Dp[:, up]),
                                               Dp[:, diag])
    return Dp.reshape(L, P + 1, P + 1)[:, 1:, 1:]


def dtw(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact DTW distance and warping fraction of curve pairs [L, P]."""
    L, P = x.shape
    D = dtw_table(x, y).reshape(L, P * P)
    dist = D[:, -1]
    i = torch.full((L,), P - 1, dtype=torch.long, device=x.device)
    j = i.clone()
    acc = torch.zeros(L, dtype=torch.int32, device=x.device)
    cnt = torch.ones(L, dtype=torch.int32, device=x.device)
    for _ in range(2 * P):
        at_origin = (i == 0) & (j == 0)
        cand_i = torch.stack([i - 1, i - 1, i], dim=1)
        cand_j = torch.stack([j - 1, j, j - 1], dim=1)
        valid = (cand_i >= 0) & (cand_j >= 0)
        vals = torch.gather(D, 1, cand_i.clamp(min=0) * P + cand_j.clamp(min=0))
        k = torch.argmin(torch.where(valid, vals, _INF), dim=1, keepdim=True)
        ni = torch.where(at_origin, i, torch.gather(cand_i, 1, k)[:, 0])
        nj = torch.where(at_origin, j, torch.gather(cand_j, 1, k)[:, 0])
        step = (~at_origin).to(torch.int32)
        acc = acc + step * torch.abs(ni - nj).to(torch.int32)
        cnt = cnt + step
        i, j = ni, nj
    # XLA:CPU divides by the constant P as a product with its reciprocal
    warp = acc.to(x.dtype) / cnt.to(x.dtype) * np.float32(1.0 / P).item()
    return dist, warp


def build_templates(packed, targets) -> torch.Tensor:
    """[2, 6, P] median templates (0 = TDE, 1 = non-TDE); 0 where a class
    and band has no curve."""
    curves = resample(packed.band_time, packed.band_flux, packed.band_mask)  # [N, 6, P]
    usable = M.count(packed.band_mask) >= 5
    y = torch.as_tensor(np.asarray(targets)).to(packed.device)
    vals = curves.permute(1, 2, 0)  # [6, P, N]
    out = []
    for cls_val in (1, 0):
        sel = (usable & (y[:, None] == cls_val)).T[:, None, :].expand_as(vals)
        med = M.median(vals, sel)
        out.append(torch.where(torch.isnan(med), 0.0, med))
    return torch.stack(out)


def extract(packed, templates: torch.Tensor, meta=None) -> FeatureSet:
    """DTW features against precomputed templates [2, 6, P]."""
    N = packed.n_objects
    curves = resample(packed.band_time, packed.band_flux, packed.band_mask)
    ok = (M.count(packed.band_mask) >= 5).reshape(-1)
    flat = curves.reshape(N * N_BANDS, N_POINTS)
    templates = templates.to(packed.device)

    def against(tpl):
        d, w = dtw(flat, tpl.repeat(N, 1))
        return (torch.where(ok, d, _NAN).reshape(N, N_BANDS),
                torch.where(ok, w, _NAN).reshape(N, N_BANDS))

    d_tde, w_tde = against(templates[0])
    d_non, w_non = against(templates[1])
    ratio_ok = (d_non > 0) & ~torch.isnan(d_tde) & ~torch.isnan(d_non)
    ratio = torch.where(ratio_ok, d_tde / torch.where(d_non > 0, d_non, 1.0), _NAN)

    feats: FeatureSet = {}
    for bi, band in enumerate(LSST_BANDS):
        feats[f"{band}_dtw_tde"] = d_tde[:, bi]
        feats[f"{band}_dtw_non_tde"] = d_non[:, bi]
        feats[f"{band}_dtw_ratio"] = ratio[:, bi]
        feats[f"{band}_dtw_warp_tde"] = w_tde[:, bi]
        feats[f"{band}_dtw_warp_non_tde"] = w_non[:, bi]
        wd_ok = ~torch.isnan(w_tde[:, bi]) & ~torch.isnan(w_non[:, bi])
        feats[f"{band}_warp_diff"] = torch.where(wd_ok, w_tde[:, bi] - w_non[:, bi], _NAN)

    n_bands = ratio_ok.sum(dim=1)
    tde_tot = torch.where(ratio_ok, d_tde, 0.0).sum(dim=1)
    non_tot = torch.where(ratio_ok, d_non, 0.0).sum(dim=1)
    feats["dtw_tde_mean"] = torch.where(n_bands > 0, tde_tot / n_bands.clamp(min=1), _NAN)
    feats["dtw_non_tde_mean"] = torch.where(n_bands > 0, non_tot / n_bands.clamp(min=1), _NAN)
    feats["dtw_ratio_mean"] = torch.where(
        n_bands > 0, tde_tot / torch.where(non_tot > 0, non_tot, 1.0), _NAN)
    return feats
