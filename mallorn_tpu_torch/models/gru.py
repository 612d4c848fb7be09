"""Band-parallel attention-GRU classifier, v27 (port of
``mallorn_tpu.models.gru``): one bidirectional GRU shared across bands
encodes each band's sequence, additive attention pools each band, the
band representations concatenate into an aggregation MLP and a
metadata-fused head; ``return_features`` returns the aggregation layer
(the GBDT hybrid's features).

Bands fold into the batch ([N, 6, T, F] -> [N 6, T, F]), so one GRU call
per layer and direction covers every band. Each direction of each layer
is one ``GRUCell_<k>`` (k = 2 x layer + direction) with flax's kernels:
input side ``ir``/``iz``/``in`` biased, hidden side ``hr``/``hz``/``hn``
with a bias on ``hn`` alone, stacked in torch's gate order r, z, n (so
b_hh is [0, 0, b_hn]). As in the JAX model (flax's ``seq_lengths``), the
reverse direction starts at each band's last valid point: it runs a
forward cuDNN GRU over the sequence with every row's valid prefix
reversed (``flip_valid``, flax's ``flip_sequences``) and flips its
outputs back; every padded step is zeroed after each layer. (A packed
sequence gives the same valid outputs, but its packing and unpacking
cost ~6,000 device copies per training step at the bench split's
width.)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import _VF, nn

from mallorn_tpu_torch.models.data import BandBatch
from mallorn_tpu_torch.models.layers import Dense, Embed, dropout, init_params
from mallorn_tpu_torch.models.lstm import AdditiveAttention, cells
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


def flip_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row of [B, T, F] with its first ``lengths[b]`` steps reversed
    and its padding after them reversed too (step t <- (T - 1 - t + L) mod
    T, flax's ``flip_sequences``); its own inverse."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    idx = (T - 1 - t[None, :] + lengths[:, None]) % T
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def bigru(x: torch.Tensor, lengths: torch.Tensor, pair, training: bool) -> torch.Tensor:
    """One bidirectional GRU layer over [B, T, in] -> [B, T, 2 H], zero
    initial state, the reverse direction over each row's valid prefix."""
    h0 = x.new_zeros(1, x.shape[0], pair[0].hidden)
    fwd, _ = _VF.gru(x, h0, pair[0].weights(), True, 1, 0.0, training, False, True)
    bwd, _ = _VF.gru(flip_valid(x, lengths), h0, pair[1].weights(), True, 1, 0.0, training,
                     False, True)
    return torch.cat([fwd, flip_valid(bwd, lengths)], dim=-1)


class GRUClassifier(nn.Module):
    def __init__(self, band_embed_dim: int = 16, hidden_dim: int = 64, n_layers: int = 2,
                 n_bands: int = 6, dropout: float = 0.3, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.dropout_rate, self.hidden_dim = dropout, hidden_dim
        self.Embed_0 = Embed(n_bands, band_embed_dim)
        self.layers = cells(self, "GRUCell", n_layers, 3 + band_embed_dim, hidden_dim,
                            gates="rzn", input_bias=True, hidden_bias="n")
        self.AdditiveAttention_0 = AdditiveAttention(2 * hidden_dim)
        self.Dense_0 = Dense(n_bands * 2 * hidden_dim, 2 * hidden_dim)
        self.Dense_1 = Dense(2 * hidden_dim + 2, hidden_dim)
        self.Dense_2 = Dense(hidden_dim, 1)
        init_params(self, seed).to(resolve_device(device))

    def forward(self, batch: BandBatch, generator: Optional[torch.Generator] = None,
                return_features: bool = False) -> torch.Tensor:
        n, nb, t, _ = batch.features.shape
        be = self.Embed_0(torch.arange(nb, device=batch.mask.device))
        be = be[None, :, None, :].expand(n, nb, t, -1)
        x = torch.cat([batch.features, be], dim=-1)
        x = torch.where(batch.mask[..., None], x, 0.0)

        x = x.reshape(n * nb, t, x.shape[-1])
        mask = batch.mask.reshape(n * nb, t)
        lengths = mask.sum(dim=1)
        for pair in self.layers:
            x = torch.where(mask[..., None], bigru(x, lengths, pair, self.training), 0.0)
            x = dropout(x, self.dropout_rate, self.training, generator)

        # per-band attention pooling; a band with no point -> zeros
        rep = self.AdditiveAttention_0(x, mask)
        rep = torch.where(mask.any(dim=1)[:, None], rep, 0.0)
        h = torch.relu(self.Dense_0(rep.reshape(n, nb * 2 * self.hidden_dim)))
        h = dropout(h, self.dropout_rate, self.training, generator)
        if return_features:
            return h
        h = torch.relu(self.Dense_1(torch.cat([h, batch.meta], dim=-1)))
        return self.Dense_2(h)[..., 0]  # logits
