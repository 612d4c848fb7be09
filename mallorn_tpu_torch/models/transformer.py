"""Transformer encoder classifier with a sinusoidal time-value encoding
(port of ``mallorn_tpu.models.transformer``): feature embedding, band
embedding, continuous-time sinusoidal encoding, a CLS token, pre-norm
encoder blocks and a metadata-fused head."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mallorn_tpu_torch.models.data import SequenceBatch
from mallorn_tpu_torch.models.layers import (Dense, Embed, LayerNorm,
                                             MultiHeadDotProductAttention, dropout, gelu,
                                             init_params, token)
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


def time_encoding(times: torch.Tensor, d_model: int, max_time: float = 1000.0) -> torch.Tensor:
    """Sinusoidal encoding of continuous observation times [N, T] -> [N, T,
    D]: sin and cos of t * exp(-2i ln(1e4) / D). The frequencies are the
    float32 argument's exponential rounded once to float32, as XLA folds
    the constant."""
    half = d_model // 2
    arg = (np.arange(half, dtype=np.float32) * np.float32(2.0)) \
        * np.float32(-np.log(10000.0) / d_model)
    div = torch.as_tensor(np.exp(arg.astype(np.float64)).astype(np.float32),
                          device=times.device)
    ang = times[..., None] * div
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if pe.shape[-1] < d_model:
        pe = nn.functional.pad(pe, (0, d_model - pe.shape[-1]))
    return pe


class EncoderBlock(nn.Module):
    """Pre-norm block: x + attention(LN(x)), then x + MLP(LN(x)) with a
    tanh-GELU hidden layer of 4 D and dropout on its output."""

    def __init__(self, d_model: int, n_heads: int, dropout_rate: float):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d_model)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, n_heads, dropout_rate)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, 4 * d_model)
        self.Dense_1 = Dense(4 * d_model, d_model)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), mask, generator)
        x = x + h
        h = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + dropout(h, self.dropout_rate, self.training, generator)


def encoder_blocks(module: nn.Module, n: int, d_model: int, n_heads: int, dropout_rate: float,
                   start: int = 0) -> list:
    """``n`` EncoderBlocks registered on ``module`` as ``EncoderBlock_<i>``
    (flax's auto-names), numbered from ``start``."""
    blocks = []
    for i in range(start, start + n):
        blocks.append(EncoderBlock(d_model, n_heads, dropout_rate))
        module.add_module(f"EncoderBlock_{i}", blocks[-1])
    return blocks


class TransformerClassifier(nn.Module):
    def __init__(self, d_model: int = 64, n_heads: int = 4, n_layers: int = 3,
                 n_bands: int = 6, dropout: float = 0.2, max_time: float = 1000.0,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.d_model, self.dropout_rate, self.max_time = d_model, dropout, max_time
        self.Dense_0 = Dense(3, d_model)
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Embed_0 = Embed(n_bands, d_model)
        self.cls = token(1, 1, d_model)
        self.blocks = encoder_blocks(self, n_layers, d_model, n_heads, dropout)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_1 = Dense(d_model + 2, d_model)
        self.Dense_2 = Dense(d_model, 1)
        init_params(self, seed).to(resolve_device(device))

    def forward(self, batch: SequenceBatch, generator: Optional[torch.Generator] = None,
                return_embedding: bool = False) -> torch.Tensor:
        """Logits [N], or with ``return_embedding`` the normalised CLS
        representation [N, d_model] (astromer's supervised fallback)."""
        x = torch.relu(self.LayerNorm_0(self.Dense_0(batch.features)))
        x = dropout(x, self.dropout_rate, self.training, generator)
        x = x + self.Embed_0(batch.band)
        x = x + time_encoding(batch.times, self.d_model, self.max_time)
        x = torch.where(batch.mask[..., None], x, 0.0)

        n = x.shape[0]
        x = torch.cat([self.cls.expand(n, 1, -1), x], dim=1)
        mask = torch.cat([torch.ones(n, 1, dtype=torch.bool, device=x.device), batch.mask],
                         dim=1)
        for block in self.blocks:
            x = block(x, mask, generator)

        h = self.LayerNorm_1(x[:, 0])
        if return_embedding:
            return h
        h = torch.relu(self.Dense_1(torch.cat([h, batch.meta], dim=-1)))
        return self.Dense_2(h)[..., 0]
