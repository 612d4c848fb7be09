"""Training harness for the DL models (port of
``mallorn_tpu.models.train_dl``): focal and weighted-BCE losses,
full-batch Adam, the F1 threshold sweep on a validation batch, and
parameter files.

A model is an ``nn.Module`` built (and initialised from its ``seed``) on
its device; ``train_model`` trains it in place, drawing every dropout
mask from one ``torch.Generator`` on that device seeded ``seed``.
Parameter files are an ``.npz`` of the parameters under their flax path
names (``"Dense_0/kernel"``), the JAX package's ``save_pretrained``
layout: the JAX package's parameter trees and the port's modules share
them (``models.layers``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mallorn_tpu_torch.models.layers import state_from_flax, state_to_flax
from mallorn_tpu_torch.train.cv import threshold_sweep


def focal_loss(logits, labels, gamma: float = 2.0, alpha: float = 0.85):
    """Binary focal loss: mean of alpha_t (1 - p_t)^gamma (-log p_t), p_t
    clipped to [1e-7, 1]."""
    p = torch.sigmoid(logits)
    pos = labels > 0.5
    pt = torch.where(pos, p, 1.0 - p)
    alpha_t = torch.where(pos, alpha, 1.0 - alpha)
    ce = -torch.log(pt.clamp(1e-7, 1.0))
    return torch.mean(alpha_t * (1.0 - pt) ** gamma * ce)


def weighted_bce(logits, labels, pos_weight: float = 10.0):
    """Mean sigmoid cross-entropy, positives weighted ``pos_weight``
    (optax's -y log s(x) - (1 - y) log s(-x))."""
    ce = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
    return torch.mean(torch.where(labels > 0.5, pos_weight, 1.0) * ce)


def save_params(path, model: torch.nn.Module) -> str:
    """``model``'s parameters as an npz under their flax names (atomic)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:  # a file handle: savez adds no suffix
        np.savez(f, **state_to_flax(model))
    os.replace(tmp, path)
    return str(path)


def load_params(path, model: Optional[torch.nn.Module] = None):
    """The {flax name: array} of a parameter file; loaded into ``model``
    (and ``model`` returned) when one is given."""
    with np.load(Path(path)) as z:
        flat = {k: z[k] for k in z.files if k != "__config__"}
    if model is None:
        return flat
    model.load_state_dict(state_from_flax(flat))
    return model


@dataclasses.dataclass
class DLResult:
    params: dict  # the trained model's state dict
    val_probs: Optional[np.ndarray]
    val_f1: float
    threshold: float
    losses: np.ndarray


def _apply(model, batch, tabular, generator=None):
    if tabular is None:
        return model(batch, generator=generator)
    return model(batch, tabular, generator=generator)


def train_model(model: torch.nn.Module, batch, val_batch=None, loss_fn: Callable = focal_loss,
                n_epochs: int = 100, lr: float = 1e-3, seed: int = 0, tabular=None,
                val_tabular=None) -> DLResult:
    """Full-batch Adam on ``batch`` (one step per epoch; the datasets are
    thousands of objects, one device batch), then the validation sweep.
    ``tabular`` / ``val_tabular`` go to ATAT's tabular tower."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    y = batch.label.float()
    losses = []
    model.train()
    for _ in range(n_epochs):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(_apply(model, batch, tabular, gen), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    model.eval()

    val_probs, f1, thresh = None, float("nan"), 0.5
    if val_batch is not None and val_batch.label is not None:
        with torch.no_grad():
            val_probs = torch.sigmoid(_apply(model, val_batch, val_tabular)).cpu().numpy()
        f1, thresh = threshold_sweep(val_batch.label.cpu().numpy(), val_probs)
    return DLResult(params=model.state_dict(), val_probs=val_probs, val_f1=f1,
                    threshold=thresh, losses=np.asarray(losses))
