"""Fourier features, v40 (port of ``mallorn_tpu.features.fourier``):
dominant frequency and power, power ratio and spectral entropy per band
(>= 10 points).

Each band row is resampled with ``np.interp`` onto S = min(n, 128)
uniform points over its span, the mean removed, a Hann window applied
(0.5 - 0.5 cos(2 pi k / (S - 1))), and its S-point DFT taken as explicit
[128, 128] cos / sin matrices per row, masked to the row's S (a batched
float32 product; TF32 must be off on the card). The power spectrum runs
over the positive frequencies 1 <= j < S // 2; the entropy is normalised
by log2 of the number of bins whose normalised power exceeds 1e-10.
"""

from __future__ import annotations

import math

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.features.research import _np_interp
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.utils.constants import LSST_BANDS

_NAN = float("nan")
S_MAX = 128
FEATURE_KEYS = ("fourier_dominant_freq", "fourier_dominant_power",
                "fourier_power_ratio", "fourier_spectral_entropy")


def _band_fourier(t, f, mask):
    """Rows [L, T] -> four [L] columns."""
    n = M.count(mask)
    S = torch.clamp(n, max=S_MAX).to(torch.float32)[:, None]
    ok = n >= 10
    t0, t1 = M.mmin(t, mask)[:, None], M.mmax(t, mask)[:, None]
    k = torch.arange(S_MAX, dtype=torch.float32, device=t.device)[None, :]
    Sm1 = torch.clamp(S - 1.0, min=1.0)
    grid = t0 + k * (t1 - t0) / Sm1
    x = _np_interp(grid, t, f, mask)
    kmask = k < S
    mu = torch.where(kmask, x, 0.0).sum(dim=1, keepdim=True) / torch.clamp(S, min=1.0)
    x = torch.where(kmask, x - mu, 0.0)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / Sm1)
    x = x * torch.where(kmask, window, 0.0)

    j = k[0]
    ang = 2.0 * math.pi * (j[:, None] * j[None, :])[None] / torch.clamp(S, min=1.0)[:, :, None]
    re = torch.matmul(torch.cos(ang), x[:, :, None])[..., 0]
    im = torch.matmul(-torch.sin(ang), x[:, :, None])[..., 0]
    power = re * re + im * im

    half = torch.floor(S / 2.0)
    jmask = (k >= 1) & (k < half)
    any_j = jmask.any(dim=1) & (torch.where(jmask, power, 0.0).amax(dim=1) > 0)
    dt = (t1 - t0) / Sm1
    freqs = k / (S * torch.clamp(dt, min=1e-10))
    dom = torch.argmax(torch.where(jmask, power, -torch.inf), dim=1)
    dominant_freq = torch.abs(M.take(freqs, dom))
    dominant_power = M.take(power, dom)
    nj = jmask.sum(dim=1)
    psum = torch.where(jmask, power, 0.0).sum(dim=1)
    mean_power = psum / nj.clamp(min=1)
    power_ratio = dominant_power / (mean_power + 1e-10)

    pn = torch.where(jmask, power, 0.0) / (psum[:, None] + 1e-10)
    nz = jmask & (pn > 1e-10)
    ent = -torch.where(nz, pn * torch.log2(pn + 1e-10), 0.0).sum(dim=1)
    max_ent = torch.log2(torch.clamp(nz.sum(dim=1).to(torch.float32), min=1.0))
    entropy = torch.where(max_ent > 0, ent / max_ent, ent)

    valid = ok & any_j
    return [torch.where(valid, v, _NAN)
            for v in (dominant_freq, dominant_power, power_ratio, entropy)]


def extract(packed, meta=None) -> FeatureSet:
    N, B, T = packed.band_time.shape
    cols = _band_fourier(packed.band_time.reshape(N * B, T),
                         packed.band_flux.reshape(N * B, T),
                         packed.band_mask.reshape(N * B, T))
    feats: FeatureSet = {}
    for bi, band in enumerate(LSST_BANDS):
        for key, col in zip(FEATURE_KEYS, cols):
            feats[f"{band}_{key}"] = col.reshape(N, B)[:, bi]
    return sorted_features(feats)
