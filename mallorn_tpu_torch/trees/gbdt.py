"""Depthwise GBDT, predict side (port of ``mallorn_tpu.trees.gbdt``).

A ``Forest`` stacks fixed-shape heap trees: R rounds, I = 2^D - 1
internal slots, H = 2^(D+1) - 1 heap nodes. Routing follows
``_predict_tree``: the missing bin goes to ``default_left``, otherwise a
row goes left when ``bin <= split_bin``; an early leaf (``is_leaf``) stops
the row there. Every tree of every fold routes at once, one level at a
time, over a [folds, N, R] node tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class GBDTParams(NamedTuple):
    """The fields of the JAX package's ``GBDTParams`` that the forest's
    shape and prediction depend on (training options join with the
    training port)."""

    n_rounds: int = 500
    max_depth: int = 5
    learning_rate: float = 0.025
    n_bins: int = 256
    base_score: float = 0.0


# The v21/v34a/v92 shape (reference: scripts/train_v34a_bazin.py:134-148).
V34A_PARAMS = GBDTParams(n_rounds=500, max_depth=5, learning_rate=0.025)


class Forest(NamedTuple):
    feature: torch.Tensor  # [..., R, I] int32
    split_bin: torch.Tensor  # [..., R, I] int32
    default_left: torch.Tensor  # [..., R, I] bool
    is_leaf: torch.Tensor  # [..., R, I] bool
    leaf_value: torch.Tensor  # [..., R, H] float32 (eta applied)


def stack_forests(forests: Sequence[Forest]) -> Forest:
    """K same-shape forests -> one Forest with a leading fold axis."""
    return Forest(*[torch.stack(a) for a in zip(*forests)])


def predict_margin_folds(forest: Forest, binned: torch.Tensor,
                         n_trees: torch.Tensor, missing_id: int, depth: int,
                         base_score: float = 0.0) -> torch.Tensor:
    """Margins [K, N] of K stacked fold forests ([K, R, ...]) on a binned
    matrix, shared [N, F] or one per fold [K, N, F]. Tree r of fold k
    counts only when r < n_trees[k] (the early-stopping
    ``best_iteration + 1`` truncation)."""
    K, R, n_internal = forest.feature.shape
    N = binned.shape[-2]
    dev = binned.device
    b = binned.long()
    if b.dim() == 2:
        b = b.unsqueeze(0).expand(K, N, -1)
    kk = torch.arange(K, device=dev)[:, None, None]
    rr = torch.arange(R, device=dev)[None, None, :]
    node = torch.zeros(K, N, R, dtype=torch.long, device=dev)
    for _ in range(depth + 1):
        cn = node.clamp(0, n_internal - 1)
        feat = forest.feature[kk, rr, cn].long()  # [K, N, R]
        bv = torch.gather(b, 2, feat)
        go_left = torch.where(bv == missing_id, forest.default_left[kk, rr, cn],
                              bv <= forest.split_bin[kk, rr, cn])
        child = 2 * node + torch.where(go_left, 1, 2)
        stays = (node >= n_internal) | forest.is_leaf[kk, rr, cn]
        node = torch.where(stays, node, child)
    leaf = forest.leaf_value[kk, rr, node]  # [K, N, R]
    live = torch.arange(R, device=dev)[None, :] < n_trees.to(dev)[:, None]  # [K, R]
    leaf = torch.where(live[:, None, :], leaf, 0.0)
    return base_score + leaf.sum(dim=2)
