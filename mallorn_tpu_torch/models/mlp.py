"""Residual MLP on engineered features, v14 (port of
``mallorn_tpu.models.mlp``): a projected input, LayerNorm + tanh-GELU
residual hidden stack, a skip projection of the input concatenated
before the head; trained full batch per fold with AdamW on a cosine
schedule and weighted BCE, inputs standardised per fold on the host.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mallorn_tpu_torch.models.layers import Dense, LayerNorm, dropout, gelu, init_params
from mallorn_tpu_torch.models.train_dl import weighted_bce
from mallorn_tpu_torch.train.cv import stratified_kfold, threshold_sweep
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


class ResidualMLP(nn.Module):
    def __init__(self, n_features: int, hidden_dims: Sequence[int] = (128, 64, 32),
                 dropout: float = 0.3, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.dropout_rate = dropout
        dims = tuple(hidden_dims)
        self.Dense_0 = Dense(n_features, dims[0])
        self.hidden = []
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            dense, norm = Dense(a, b), LayerNorm(b)
            self.add_module(f"Dense_{i + 1}", dense)
            self.add_module(f"LayerNorm_{i}", norm)
            self.hidden.append((dense, norm))
        # the skip projection, the combining layer and the head
        self.tail = [Dense(n_features, dims[-1]), Dense(2 * dims[-1], dims[-1]),
                     Dense(dims[-1], 1)]
        for i, m in enumerate(self.tail):
            self.add_module(f"Dense_{len(dims) + i}", m)
        init_params(self, seed).to(resolve_device(device))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = torch.relu(self.Dense_0(x))
        for dense, norm in self.hidden:
            h = dropout(gelu(norm(dense(h))), self.dropout_rate, self.training, generator)
        skip, combine, head = self.tail
        o = gelu(combine(torch.cat([h, skip(x)], dim=-1)))
        o = dropout(o, self.dropout_rate, self.training, generator)
        return head(o)[..., 0]  # logits


def adamw_cosine(model: nn.Module, lr: float, n_steps: int, weight_decay: float):
    """``optax.adamw(cosine_decay_schedule(lr, n_steps), weight_decay)``:
    AdamW (decay scaled by the scheduled rate, eps 1e-8) with the rate
    lr (1 + cos(pi min(t, n) / n)) / 2 at step t."""
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, n_steps) / n_steps)))
    return opt, sched


def train_mlp_cv(X, y, X_test=None, n_folds: int = 5, n_epochs: int = 400,
                 lr: float = 3e-3, weight_decay: float = 1e-4,
                 hidden_dims: Sequence[int] = (128, 64, 32), dropout: float = 0.3,
                 seed: int = 42, pos_weight: float = 10.0,
                 device: DeviceLike = None) -> dict:
    """CV of the residual MLP on a feature matrix: stratified folds
    (``stratified_kfold(y, n_folds, seed)``, scikit-learn's), per-fold
    standardisation, ``n_epochs`` full-batch AdamW steps on weighted BCE
    (fold f initialised and dropped out from seed + f), the OOF threshold
    sweep and fold-averaged test probabilities.

    Returns {oof, best_f1, threshold, test_preds}."""
    dev = resolve_device(device)
    X = np.nan_to_num(np.asarray(X, np.float32), nan=0.0, posinf=0.0, neginf=0.0)
    y = np.asarray(y, np.float32)
    Xt = None if X_test is None else np.nan_to_num(np.asarray(X_test, np.float32), nan=0.0,
                                                   posinf=0.0, neginf=0.0)
    oof = np.zeros(len(y), np.float32)
    test_sum = None

    for fi, (tr, va) in enumerate(stratified_kfold(y, n_folds, seed)):
        mu = X[tr].mean(0)
        sd = X[tr].std(0)
        sd = np.where(sd > 0, sd, 1.0)

        def S(A):
            return torch.as_tensor((A - mu) / sd, dtype=torch.float32, device=dev)

        model = ResidualMLP(X.shape[1], hidden_dims, dropout, seed=seed + fi, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + fi)
        opt, sched = adamw_cosine(model, lr, n_epochs, weight_decay)
        Xtr, ytr = S(X[tr]), torch.as_tensor(y[tr], device=dev)
        model.train()
        for _ in range(n_epochs):
            opt.zero_grad(set_to_none=True)
            weighted_bce(model(Xtr, gen), ytr, pos_weight).backward()
            opt.step()
            sched.step()
        model.eval()
        with torch.no_grad():
            oof[va] = torch.sigmoid(model(S(X[va]))).cpu().numpy()
            if Xt is not None:
                p = torch.sigmoid(model(S(Xt))).cpu().numpy()
                test_sum = p if test_sum is None else test_sum + p

    best_f1, threshold = threshold_sweep(y, oof)
    return {"oof": oof, "best_f1": float(best_f1), "threshold": float(threshold),
            "test_preds": None if test_sum is None else test_sum / n_folds}
