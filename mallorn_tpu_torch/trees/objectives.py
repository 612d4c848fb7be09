"""Gradient/hessian objectives for the GBDT (port of
``mallorn_tpu.trees.objectives``).

An objective is ``fn(margin, label, weight) -> (grad, hess)`` on raw
margins (pre-sigmoid); ``weight`` already holds the per-sample weights
(the adversarial weights of v92d) times ``scale_pos_weight``. The focal
loss repeats the reference's custom XGBoost objective algebra term by
term, so the trees agree. ``squarederror`` is the soft-label runners'
regression objective.
"""

from __future__ import annotations

import functools

import torch

from mallorn_tpu_torch.trees.xla_cpu import exp


def logistic(margin, label, weight):
    """binary:logistic: grad = w (p - y), hess = w p (1 - p)."""
    p = 1.0 / (1.0 + exp(-margin))
    return weight * (p - label), weight * p * (1.0 - p)


@functools.lru_cache(maxsize=None)
def make_focal(gamma: float, alpha: float):
    """Focal-loss objective (the reference v92 Adversarial_Focal_Loss):
    alpha-balanced per label, ``weight`` carries the sample weights."""

    def robust_pow(base, power):
        return torch.sign(base) * torch.abs(base) ** power

    def focal(margin, label, weight):
        p = 1.0 / (1.0 + exp(-margin))
        alpha_t = label * alpha + (1.0 - label) * (1.0 - alpha)
        sign = torch.pow(-1.0, label)  # +1 for label 0, -1 for label 1
        g1 = p * (1.0 - p)
        g2 = label + sign * p
        g3 = p + label - 1.0
        g4 = 1.0 - label - sign * p
        g5 = label + sign * p
        log_g4 = torch.log(g4 + 1e-9)
        grad = weight * alpha_t * (
            gamma * g3 * robust_pow(g2, gamma) * log_g4
            + sign * robust_pow(g5, gamma + 1.0))
        hess_1 = robust_pow(g2, gamma) + gamma * sign * g3 * robust_pow(g2, gamma - 1.0)
        hess_2 = sign * g3 * robust_pow(g2, gamma) / (g4 + 1e-9)
        hess = weight * alpha_t * (
            (hess_1 * log_g4 - hess_2) * gamma
            + (gamma + 1.0) * robust_pow(g5, gamma)) * g1
        return grad, hess

    focal.__qualname__ = f"focal_g{gamma}_a{alpha}"
    return focal


def squarederror(margin, label, weight):
    """reg:squarederror: grad = w (margin - y), hess = w. The soft-label
    runners (v102, v97, v108, v106) regress on float targets with it, at
    ``GBDTParams(base_score=0.5, eval_metric="rmse")``; their predictions
    are the raw margins."""
    return weight * (margin - label), weight * torch.ones_like(margin)


def logloss_metric(margin, label):
    """Unweighted binary logloss (XGBoost eval_metric='logloss')."""
    p = 1.0 / (1.0 + torch.exp(-margin))
    p = torch.clamp(p, 1e-16, 1.0 - 1e-16)
    return -torch.mean(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
