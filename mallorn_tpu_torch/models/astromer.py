"""ASTROMER-style single-band lightcurve encoder with self-supervised
masked-reconstruction pretraining (port of ``mallorn_tpu.models.astromer``).

A transformer over one band's (time, magnitude, error) sequence, the
encoder blocks and time encoding of ``models.transformer``, pretrained
to predict the magnitudes of probed (hidden) observations from the
visible ones (Donoso-Oliva et al. 2022: of the probed half of the valid
points 80% hidden, 10% given another magnitude of the sequence, 10%
left). Everything is fixed-shape batched [B, T] masked arithmetic.

The probe masks and the pretraining minibatches are drawn on the host
with ``utils/prng``, bit for bit the JAX package's ``jax.random`` draws
for the same key; only the initial weights differ (torch's generator).

The pretrained weights ship with the package
(``artifacts/astromer_selfsup_synthetic.npz``, byte for byte the JAX
package's artifact, written by its ``tools/pretrain_astromer.py``): an
npz of the parameters under their flax names plus a JSON ``__config__``.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mallorn_tpu_torch.models.layers import (Dense, LayerNorm, init_params, state_from_flax,
                                             state_to_flax)
from mallorn_tpu_torch.models.transformer import encoder_blocks, time_encoding
from mallorn_tpu_torch.utils import prng
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device

_LN10 = float(np.log(np.float32(10.0)))
DEFAULT_WEIGHTS = Path(__file__).resolve().parent.parent / "artifacts" / \
    "astromer_selfsup_synthetic.npz"


class SingleBandEncoder(nn.Module):
    """(times, mags, errs, mask [B, T], probe [B, T] bool: magnitudes
    hidden from the encoder) -> (embedding [B, T, D], reconstructed
    magnitude [B, T])."""

    def __init__(self, d_model: int = 48, n_heads: int = 4, n_layers: int = 2,
                 dropout: float = 0.0, max_time: float = 1000.0, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.d_model, self.max_time = d_model, max_time
        self.Dense_0 = Dense(3, d_model)
        self.blocks = encoder_blocks(self, n_layers, d_model, n_heads, dropout)
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_1 = Dense(d_model, 1)
        init_params(self, seed).to(resolve_device(device))

    def forward(self, times, mags, errs, mask, probe=None,
                generator: Optional[torch.Generator] = None):
        if probe is None:
            probe = torch.zeros_like(mask)
        visible = mask & ~probe
        x = torch.stack([torch.where(visible, mags, 0.0), torch.where(visible, errs, 0.0),
                         probe.to(torch.float32)], dim=-1)  # probe: "magnitude hidden"
        x = self.Dense_0(x) + time_encoding(times, self.d_model, self.max_time)
        x = torch.where(mask[..., None], x, 0.0)
        for block in self.blocks:
            x = block(x, mask, generator)
        h = self.LayerNorm_0(x)
        return h, self.Dense_1(h)[..., 0]


class BandSequences(NamedTuple):
    """A batch of single-band, per-sequence-normalised lightcurves."""

    times: torch.Tensor  # [B, T] days since the first valid observation
    mags: torch.Tensor  # [B, T] normalised relative magnitude
    errs: torch.Tensor  # [B, T] normalised magnitude error
    mask: torch.Tensor  # [B, T] bool valid
    n_valid: torch.Tensor  # [B] int


def normalize_band(time, flux, err, mask) -> BandSequences:
    """Flux -> per-sequence standardised relative magnitudes, batched: the
    points with flux > 0 and err > 0, mag = -2.5 log10(flux), dm = 2.5 /
    ln 10 err / flux, time from the first such point."""
    time, flux, err = (torch.as_tensor(a, dtype=torch.float32) for a in (time, flux, err))
    valid = torch.as_tensor(mask, dtype=torch.bool) & (flux > 0) & (err > 0)

    safe_f = torch.where(valid, flux, 1.0)
    mag = -2.5 * (torch.log(safe_f) / _LN10)  # jnp.log10 is log(x) / log(10)
    dmag = float(np.float32(2.5) / np.float32(_LN10)) * torch.where(valid, err, 0.0) / safe_f

    n_valid = valid.sum(dim=1)
    n = n_valid.clamp_min(1)
    mu = torch.where(valid, mag, 0.0).sum(dim=1) / n
    sd = torch.sqrt(torch.where(valid, (mag - mu[:, None]) ** 2, 0.0).sum(dim=1) / n)
    sd = torch.where(sd > 1e-6, sd, 1.0)
    mag = torch.where(valid, (mag - mu[:, None]) / sd[:, None], 0.0)
    dmag = torch.where(valid, dmag / sd[:, None], 0.0)

    t0 = torch.where(valid, time, torch.inf).amin(dim=1)
    t0 = torch.where(torch.isfinite(t0), t0, 0.0)
    rel_t = torch.where(valid, time - t0[:, None], 0.0)
    return BandSequences(times=rel_t, mags=mag, errs=dmag, mask=valid, n_valid=n_valid)


def make_probe_masks(key: np.ndarray, mask: torch.Tensor, probe_frac: float = 0.5,
                     hide_frac: float = 0.8, random_frac: float = 0.1):
    """BERT-style probe selection, ``jax.random``'s draws for ``key``:
    ``probe_frac`` of the valid positions carry the loss; of those,
    ``hide_frac`` are hidden from the encoder, ``random_frac`` get the
    magnitude at ``swap_idx`` (a uniform position of the same row) and
    the rest stay visible. Returns (probe, hidden, swapped, swap_idx),
    [B, T] tensors on ``mask``'s device."""
    k1, k2, k3 = prng.split(key, 3)
    shape = tuple(mask.shape)
    dev = mask.device
    u = torch.as_tensor(prng.uniform(k1, shape), device=dev)
    v = torch.as_tensor(prng.uniform(k2, shape), device=dev)
    probe = mask & (u < np.float32(probe_frac))
    hidden = probe & (v < np.float32(hide_frac))
    swapped = probe & (v >= np.float32(hide_frac)) & (v < np.float32(hide_frac + random_frac))
    swap_idx = torch.as_tensor(prng.randint(k3, shape, 0, shape[1]), device=dev)
    return probe, hidden, swapped, swap_idx


def pretrain_loss(model: SingleBandEncoder, batch: BandSequences, key: np.ndarray):
    """Mean squared reconstruction error over the probed positions."""
    probe, hidden, swapped, swap_idx = make_probe_masks(key, batch.mask)
    swap_vals = torch.gather(batch.mags, 1, swap_idx.long())
    mags_in = torch.where(swapped, swap_vals, batch.mags)
    _, recon = model(batch.times, mags_in, batch.errs, batch.mask, probe=hidden)
    w = probe.to(torch.float32)
    return torch.sum((recon - batch.mags) ** 2 * w) / torch.sum(w).clamp_min(1.0)


def pretrain(seqs: BandSequences, d_model: int = 48, n_layers: int = 2, n_heads: int = 4,
             n_steps: int = 1200, batch_size: int = 256, lr: float = 1e-3, seed: int = 0,
             eval_every: int = 100, device: DeviceLike = None
             ) -> Tuple[dict, SingleBandEncoder, list]:
    """Masked-reconstruction pretraining, one Adam step per minibatch of
    ``batch_size`` sequences drawn with replacement. The key schedule is
    the JAX package's: ``key, k_init = split(PRNGKey(seed))``, then per
    step ``key, k_batch, k_mask = split(key, 3)``.

    Returns (state dict, model, [(step, loss), ...] every ``eval_every``
    steps and at the last)."""
    dev = resolve_device(device)
    seqs = BandSequences(*(torch.as_tensor(a).to(dev) for a in seqs))
    model = SingleBandEncoder(d_model=d_model, n_heads=n_heads, n_layers=n_layers, seed=seed,
                              device=dev)
    key, _ = prng.split(prng.PRNGKey(seed))
    n = seqs.times.shape[0]
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    history = []
    for i in range(n_steps):
        key, k_batch, k_mask = prng.split(key, 3)
        idx = torch.as_tensor(prng.randint(k_batch, (min(batch_size, n),), 0, n),
                              device=dev).long()
        loss = pretrain_loss(model, BandSequences(*(a[idx] for a in seqs)), k_mask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % eval_every == 0 or i == n_steps - 1:
            history.append((i, loss.item()))
    model.eval()
    return model.state_dict(), model, history


# ---------------------------------------------------------------- artifact IO

def save_pretrained(path, model: SingleBandEncoder, config: Dict) -> None:
    """The encoder's parameters under their flax names + a JSON config
    entry, in one npz (atomic write)."""
    flat = state_to_flax(model)
    flat["__config__"] = np.frombuffer(json.dumps(config).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:  # a file handle: savez adds no suffix
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_pretrained(path=None, device: DeviceLike = None
                    ) -> Tuple[dict, SingleBandEncoder, Dict]:
    """(state dict, encoder in eval mode, config) from an npz (default: the
    shipped artifact)."""
    path = Path(path) if path is not None else DEFAULT_WEIGHTS
    with np.load(path) as z:
        config = json.loads(bytes(z["__config__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__config__"}
    model = SingleBandEncoder(d_model=config["d_model"], n_heads=config["n_heads"],
                              n_layers=config["n_layers"], device=device)
    model.load_state_dict(state_from_flax(flat))
    model.eval()
    return model.state_dict(), model, config
