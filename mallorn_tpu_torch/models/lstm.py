"""BiLSTM + additive attention classifier (port of
``mallorn_tpu.models.lstm``): band embeddings, stacked bidirectional
LSTM layers with dropout after each, additive attention pooling and a
metadata-fused head.

Each direction of each layer is one ``OptimizedLSTMCell_<k>`` (k = 2 x
layer + direction) holding flax's eight Dense kernels: input side
``ii``/``if``/``ig``/``io`` without bias, hidden side ``hi``/``hf``/``hg``/
``ho`` with one. The recurrence runs as one bidirectional cuDNN LSTM call
per layer (``torch._VF.lstm``, what ``nn.LSTM`` calls) on weights stacked
in torch's gate order i, f, g, o, with the input-side bias 0. Like the
JAX model, the reverse direction runs over the whole padded sequence.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import _VF, nn

from mallorn_tpu_torch.models.data import SequenceBatch
from mallorn_tpu_torch.models.layers import Dense, Embed, dropout, init_params
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


class AdditiveAttention(nn.Module):
    """Attention pooling: score = v . tanh(W h + b), masked with -1e9,
    softmax over time, weighted sum of h."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.Dense_0 = Dense(hidden_dim, hidden_dim // 2)
        self.Dense_1 = Dense(hidden_dim // 2, 1, use_bias=False)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        score = self.Dense_1(torch.tanh(self.Dense_0(h)))[..., 0]
        w = torch.softmax(torch.where(mask, score, -1e9), dim=-1)
        return torch.einsum("nt,nth->nh", w, h)


class RNNCell(nn.Module):
    """A flax LSTM or GRU cell's Dense kernels (``gates`` in torch's gate
    order; the input side biased where flax biases it, the hidden side
    orthogonally initialised) and their stacking into cuDNN's weights
    (w_ih [G H, in], w_hh [G H, H], b_ih, b_hh)."""

    def __init__(self, d_in: int, hidden: int, gates: str, input_bias: bool,
                 hidden_bias: str):
        super().__init__()
        self.gates, self.hidden = gates, hidden
        for g in gates:
            self.add_module(f"i{g}", Dense(d_in, hidden, use_bias=input_bias))
            self.add_module(f"h{g}", Dense(hidden, hidden, use_bias=g in hidden_bias,
                                           recurrent=True))

    def _bias(self, side: str) -> torch.Tensor:
        parts = []
        for g in self.gates:
            d = getattr(self, f"{side}{g}")
            parts.append(torch.zeros_like(d.kernel[0]) if d.bias is None else d.bias)
        return torch.cat(parts)

    def weights(self) -> list:
        w_ih = torch.cat([getattr(self, f"i{g}").kernel for g in self.gates], dim=1).T
        w_hh = torch.cat([getattr(self, f"h{g}").kernel for g in self.gates], dim=1).T
        w_ih, w_hh = w_ih.contiguous(), w_hh.contiguous()
        return [w_ih, w_hh, self._bias("i"), self._bias("h")]


def cells(module: nn.Module, name: str, n_layers: int, d_in: int, hidden: int, **kw) -> list:
    """[(forward cell, backward cell)] per layer, registered on ``module``
    as ``<name>_<2 layer + direction>``; layer l > 0 reads 2 x hidden."""
    pairs = []
    for layer in range(n_layers):
        pair = []
        for d in range(2):
            cell = RNNCell(d_in if layer == 0 else 2 * hidden, hidden, **kw)
            module.add_module(f"{name}_{2 * layer + d}", cell)
            pair.append(cell)
        pairs.append(tuple(pair))
    return pairs


def bilstm(x: torch.Tensor, pair, training: bool) -> torch.Tensor:
    """One bidirectional LSTM layer over [N, T, in] -> [N, T, 2 H], zero
    initial state."""
    h0 = x.new_zeros(2, x.shape[0], pair[0].hidden)
    out, _, _ = _VF.lstm(x, (h0, h0), pair[0].weights() + pair[1].weights(), True, 1, 0.0,
                         training, True, True)
    return out


class LSTMClassifier(nn.Module):
    def __init__(self, band_embed_dim: int = 8, hidden_dim: int = 64, n_layers: int = 2,
                 n_bands: int = 6, dropout: float = 0.3, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.dropout_rate = dropout
        self.Embed_0 = Embed(n_bands, band_embed_dim)
        self.layers = cells(self, "OptimizedLSTMCell", n_layers, 3 + band_embed_dim, hidden_dim,
                            gates="ifgo", input_bias=False, hidden_bias="ifgo")
        self.AdditiveAttention_0 = AdditiveAttention(2 * hidden_dim)
        self.Dense_0 = Dense(2 * hidden_dim + 2, hidden_dim)
        self.Dense_1 = Dense(hidden_dim, 1)
        init_params(self, seed).to(resolve_device(device))

    def forward(self, batch: SequenceBatch,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.cat([batch.features, self.Embed_0(batch.band)], dim=-1)
        x = torch.where(batch.mask[..., None], x, 0.0)
        for pair in self.layers:
            x = dropout(bilstm(x, pair, self.training), self.dropout_rate, self.training,
                        generator)
        ctx = self.AdditiveAttention_0(x, batch.mask)
        h = torch.relu(self.Dense_0(torch.cat([ctx, batch.meta], dim=-1)))
        h = dropout(h, self.dropout_rate, self.training, generator)
        return self.Dense_1(h)[..., 0]  # logits
