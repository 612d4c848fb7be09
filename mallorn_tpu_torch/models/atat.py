"""ATAT, the Astronomical Transformer for time series And Tabular data
(port of ``mallorn_tpu.models.atat``): a Fourier time-modulation encoding
of the lightcurve, a per-feature tokenizer for the tabular features,
twin transformer encoders, each with a CLS token, and a fused head.
Without a tabular matrix the tabular tower reads the metadata (Z, EBV).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mallorn_tpu_torch.models.data import SequenceBatch
from mallorn_tpu_torch.models.layers import (Dense, Embed, LayerNorm, dropout, gelu,
                                             init_params, token)
from mallorn_tpu_torch.models.transformer import encoder_blocks
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


class TimeModulation(nn.Module):
    """Learnable Fourier temporal encoding: a projection of (flux, sin and
    cos of H harmonics of the time), scaled and shifted per band."""

    def __init__(self, embed_dim: int = 32, n_harmonics: int = 8, max_time: float = 1000.0,
                 n_bands: int = 6):
        super().__init__()
        # float32 as the JAX package computes it: 2 pi (h + 1), then / max_time
        w = (np.float32(2.0 * np.pi) * (np.arange(n_harmonics, dtype=np.float32) + 1)) \
            / np.float32(max_time)
        self.register_buffer("w", torch.as_tensor(w), persistent=False)
        self.Dense_0 = Dense(1 + 2 * n_harmonics, embed_dim)
        self.Embed_0 = Embed(n_bands, embed_dim)  # band scale
        self.Embed_1 = Embed(n_bands, embed_dim)  # band shift

    def forward(self, flux, times, band):
        ang = times[..., None] * self.w
        x = torch.cat([flux[..., None], torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.Dense_0(x) * (1.0 + self.Embed_0(band)) + self.Embed_1(band)


class QuantileFeatureTokenizer(nn.Module):
    """Tabular features [N, F] -> tokens [N, F, D]: value x a learned
    per-feature direction + a per-feature bias."""

    def __init__(self, n_features: int, embed_dim: int = 32):
        super().__init__()
        self.weight = token(n_features, embed_dim)
        self.bias = nn.Parameter(torch.zeros(n_features, embed_dim))

    def forward(self, feats):
        return feats[..., None] * self.weight + self.bias


class ATAT(nn.Module):
    """``n_tabular``: the width of the tabular matrix ``forward`` gets (2,
    the metadata, when it gets none)."""

    def __init__(self, embed_dim: int = 32, n_heads: int = 4, n_lc_layers: int = 2,
                 n_tab_layers: int = 2, dropout: float = 0.2, n_tabular: int = 2,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.dropout_rate = dropout
        self.TimeModulation_0 = TimeModulation(embed_dim)
        self.lc_cls = token(1, 1, embed_dim)
        self.lc_blocks = encoder_blocks(self, n_lc_layers, embed_dim, n_heads, dropout)
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.QuantileFeatureTokenizer_0 = QuantileFeatureTokenizer(n_tabular, embed_dim)
        self.tab_cls = token(1, 1, embed_dim)
        self.tab_blocks = encoder_blocks(self, n_tab_layers, embed_dim, n_heads, dropout,
                                         start=n_lc_layers)
        self.LayerNorm_1 = LayerNorm(embed_dim)
        self.Dense_0 = Dense(2 * embed_dim, 2 * embed_dim)
        self.Dense_1 = Dense(2 * embed_dim, 1)
        init_params(self, seed).to(resolve_device(device))

    @staticmethod
    def _with_cls(cls, x, mask):
        n = x.shape[0]
        ones = torch.ones(n, 1, dtype=torch.bool, device=x.device)
        return torch.cat([cls.expand(n, 1, -1), x], dim=1), torch.cat([ones, mask], dim=1)

    def forward(self, batch: SequenceBatch, tabular: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lc = self.TimeModulation_0(batch.features[..., 0], batch.times, batch.band)
        lc = torch.where(batch.mask[..., None], lc, 0.0)
        lc, lc_mask = self._with_cls(self.lc_cls, lc, batch.mask)
        for block in self.lc_blocks:
            lc = block(lc, lc_mask, generator)
        lc_repr = self.LayerNorm_0(lc[:, 0])

        tokens = self.QuantileFeatureTokenizer_0(batch.meta if tabular is None else tabular)
        tokens, tmask = self._with_cls(self.tab_cls, tokens,
                                       torch.ones(tokens.shape[:2], dtype=torch.bool,
                                                  device=tokens.device))
        for block in self.tab_blocks:
            tokens = block(tokens, tmask, generator)
        tab_repr = self.LayerNorm_1(tokens[:, 0])

        h = gelu(self.Dense_0(torch.cat([lc_repr, tab_repr], dim=-1)))
        h = dropout(h, self.dropout_rate, self.training, generator)
        return self.Dense_1(h)[..., 0]
