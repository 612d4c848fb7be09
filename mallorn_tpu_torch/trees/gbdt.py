"""Depthwise histogram GBDT (port of ``mallorn_tpu.trees.gbdt``): training
and prediction, every fold of a CV as one batched fit.

A ``Forest`` stacks fixed-shape heap trees: R rounds, I = 2^D - 1
internal slots, H = 2^(D+1) - 1 heap nodes. Routing follows
``_predict_tree``: the missing bin goes to ``default_left``, otherwise a
row goes left when ``bin <= split_bin``; an early leaf (``is_leaf``) stops
the row there.

Training (``train_gbdt``, ``train_gbdt_folds``) is XGBoost's depthwise
``hist`` algorithm as the JAX package computes it: per round, logistic
(or a custom) grad/hess times the sample weights, a row subsample keyed
by (round key, row position) and a column sample from the round key,
then one tree grown level by level. Each level builds (grad, hess)
histograms over (fold, feature, node, bin) through the Hopper kernel K1
(``ops.hist_cuda``); from level 1 on only left children are built and a
right child is its parent minus its sibling. The split search is an
argmax over (feature, bin, default direction) per node, taking the first
index on ties. Every tensor carries a leading fold axis K: the folds of a
CV train together, with K1 covering all of them in one launch.

Early stopping reproduces the JAX package's batched ``while_loop``: a
fold stops ``early_stopping_rounds`` rounds past its best validation
metric, its state is frozen from then on, and the loop runs until every
fold has stopped (one host sync per round learns that). Rounds a fold
never ran keep all-zero trees and a +inf metric.

The random bits (round keys, column permutations) are the JAX package's
own, computed on the host (``utils.prng``) once per fit.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.trees import objectives, xla_cpu
from mallorn_tpu_torch.trees.binning import (BinSpec, apply_bins,
                                             apply_bins_folds_gather, fit_bins,
                                             fit_bins_folds)
from mallorn_tpu_torch.utils import prng
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device

Objective = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                     tuple]
HistFn = Callable[..., torch.Tensor]


class GBDTParams(NamedTuple):
    """The JAX package's ``GBDTParams`` for depthwise binary training,
    without its TPU-only knobs (``use_pallas_hist``, ``use_binlane_hist``,
    ``hist_dtype``, ``route``, ``stub_hist``)."""

    n_rounds: int = 500
    max_depth: int = 5
    learning_rate: float = 0.025
    subsample: float = 0.8
    colsample_bytree: float = 0.8
    min_child_weight: float = 3.0
    reg_alpha: float = 0.2
    reg_lambda: float = 1.5
    n_bins: int = 256
    min_split_gain: float = 1e-6
    seed: int = 42
    base_score: float = 0.0
    # validation metric for early stopping (the port computes "logloss")
    eval_metric: str = "logloss"
    # build left children only from level 1 on; right = parent - left
    hist_subtract: bool = True


# The v21/v34a/v92 shape (reference: scripts/train_v34a_bazin.py:134-148).
V34A_PARAMS = GBDTParams(n_rounds=500, max_depth=5, learning_rate=0.025,
                         subsample=0.8, colsample_bytree=0.8,
                         min_child_weight=3.0, reg_alpha=0.2, reg_lambda=1.5)


class Forest(NamedTuple):
    feature: torch.Tensor  # [..., R, I] int32
    split_bin: torch.Tensor  # [..., R, I] int32
    default_left: torch.Tensor  # [..., R, I] bool
    is_leaf: torch.Tensor  # [..., R, I] bool
    leaf_value: torch.Tensor  # [..., R, H] float32 (eta applied)


class GBDTModel(NamedTuple):
    forest: Forest
    bin_spec: BinSpec
    params: GBDTParams
    best_iteration: int  # -1 when the fit did not early-stop
    importance_gain: Optional[np.ndarray] = None  # [F] summed split gains
    eval_history: Optional[np.ndarray] = None  # [R] validation metric
    # validation margins at best_iteration, tracked inside an early-stopped fit
    val_margin: Optional[np.ndarray] = None

    @property
    def n_trees(self) -> int:
        """Trees that count at prediction (best_iteration + 1, or all)."""
        if self.best_iteration >= 0:
            return self.best_iteration + 1
        return self.forest.feature.shape[0]


def stack_forests(forests: Sequence[Forest]) -> Forest:
    """K same-shape forests -> one Forest with a leading fold axis."""
    return Forest(*[torch.stack(a) for a in zip(*forests)])


# ---------------------------------------------------------------------------
# tree arithmetic
# ---------------------------------------------------------------------------

def _shrink(g, alpha):
    """XGBoost L1 thresholding of the gradient sum (the identity, bit for
    bit, when alpha is 0)."""
    if not alpha:
        return g
    return torch.sign(g) * torch.clamp(torch.abs(g) - alpha, min=0.0)


def _leaf_weight(g, h, alpha, lam, eta):
    return -eta * _shrink(g, alpha) / (h + lam)


def _score(g, h, alpha, lam):
    s = _shrink(g, alpha)
    return s * s / (h + lam)


def _row_subsample_mask(key: torch.Tensor, row_ids: torch.Tensor,
                        rate: float) -> torch.Tensor:
    """Per-row Bernoulli(rate) of a murmur3-style mix of the round key
    ([K, 2], uint32 values in int64) and the row's position ([K, N]): the
    JAX package's bits, in int64 arithmetic masked to 32 bits."""
    M = 0xFFFFFFFF

    def mul(x, c):  # (x * c) mod 2^32 without leaving int64
        return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M

    kd0, kd1 = key[:, 0:1], key[:, 1:2]
    x = row_ids.long() & M
    x = (mul(x, 0x9E3779B9) + kd0) & M
    x = mul(x ^ (x >> 16), 0x85EBCA6B)
    x = mul(x ^ (x >> 13), 0xC2B2AE35) ^ kd1
    x = x ^ (x >> 16)
    u = x.to(torch.float32) * (1.0 / 4294967296.0)
    return u < torch.tensor(rate, dtype=torch.float32, device=u.device)


def _best_splits(hist: torch.Tensor, col_mask: torch.Tensor, p: GBDTParams):
    """Best split per (fold, node) from [K, F, C, B+1, 2] histograms.

    Returns (gain, feature, bin, default_left, the node's leaf weight),
    each [K, C]. The node totals are the sums over features and bins
    times 1/F: the JAX package's fit compiles its division by F to that
    product, and fuses the product into the node's denominator h_tot +
    lambda (``xla_cpu.mul_add``)."""
    K, n_f, n_nodes = hist.shape[:3]
    missing_id = p.n_bins
    dev = hist.device
    hg, hh = hist[..., 0].contiguous(), hist[..., 1].contiguous()  # [K, F, C, B+1]
    inv_f = torch.tensor(np.float32(1) / np.float32(n_f), device=dev)
    g_sum = xla_cpu.node_totals(hg).to(dev)  # [K, C]
    h_sum = xla_cpu.node_totals(hh).to(dev)
    g_tot = g_sum * inv_f
    parent_den = xla_cpu.mul_add(h_sum, inv_f, p.reg_lambda)
    s = _shrink(g_tot, p.reg_alpha)
    leaf = -p.learning_rate * s / parent_den
    g_miss = hg[..., missing_id:missing_id + 1]
    h_miss = hh[..., missing_id:missing_id + 1]
    cg = xla_cpu.bin_cumsum(hg[..., :missing_id].contiguous())  # [K, F, C, B]
    ch = xla_cpu.bin_cumsum(hh[..., :missing_id].contiguous())
    parent = (s * s / parent_den)[:, None, :, None]
    gt, ht = g_tot[:, None, :, None], (h_sum * inv_f)[:, None, :, None]
    cols = col_mask[:, :, None, None]

    def split_gain(gl, hl):
        gr, hr = gt - gl, ht - hl
        gain = 0.5 * (_score(gl, hl, p.reg_alpha, p.reg_lambda)
                      + _score(gr, hr, p.reg_alpha, p.reg_lambda) - parent)
        ok = (hl >= p.min_child_weight) & (hr >= p.min_child_weight) & cols
        return torch.where(ok, gain, -torch.inf)

    gain_right = split_gain(cg, ch)  # missing goes right
    gain_left = split_gain(cg + g_miss, ch + h_miss)
    gain_fb = torch.maximum(gain_right, gain_left)
    flat = gain_fb.transpose(1, 2).reshape(K, n_nodes, -1)  # [K, C, F*B]
    best_idx = torch.argmax(flat, dim=-1)  # first index on ties
    best_gain = torch.gather(flat, 2, best_idx[..., None])[..., 0]
    dleft = (gain_left > gain_right).transpose(1, 2).reshape(K, n_nodes, -1)
    best_dl = torch.gather(dleft, 2, best_idx[..., None])[..., 0]
    best_f = torch.div(best_idx, missing_id, rounding_mode="floor")
    best_b = best_idx % missing_id
    return best_gain, best_f, best_b, best_dl, leaf


def _train_tree(binned_T: torch.Tensor, gh: torch.Tensor, col_mask: torch.Tensor,
                p: GBDTParams, hist_fn: HistFn):
    """Grow one depthwise tree per fold.

    binned_T [K, F, N] int16, gh [K, N, 2] float32, col_mask [K, F] bool.
    Returns ((feature, split_bin, default_left, is_leaf, leaf_value), each
    [K, ...]; per-feature split gains [K, F]; final heap node [K, N])."""
    K, n_f, n = binned_T.shape
    dev = binned_T.device
    depth = p.max_depth
    n_internal = 2 ** depth - 1
    n_bins_tot = p.n_bins + 1
    missing_id = p.n_bins

    feature = torch.zeros(K, n_internal, dtype=torch.int32, device=dev)
    split_bin = torch.full((K, n_internal), -1, dtype=torch.int32, device=dev)
    default_left = torch.zeros(K, n_internal, dtype=torch.bool, device=dev)
    is_leaf = torch.zeros(K, n_internal, dtype=torch.bool, device=dev)
    leaf_value = torch.zeros(K, 2 ** (depth + 1) - 1, dtype=torch.float32, device=dev)
    gain_pf = torch.zeros(K, n_f, dtype=torch.float32, device=dev)
    feat_ids = torch.arange(n_f, device=dev)
    rows = torch.arange(n, device=dev)
    flat_bins = binned_T.reshape(K, n_f * n)

    node = torch.zeros(K, n, dtype=torch.long, device=dev)
    prev_hist = prev_split = None
    for d in range(depth):
        n_nodes = 2 ** d
        level_start = n_nodes - 1
        local = node - level_start
        in_level = ((local >= 0) & (local < n_nodes)
                    & ~torch.gather(is_leaf, 1, node.clamp(0, n_internal - 1)))
        subtract = p.hist_subtract and d > 0
        if subtract:
            # only left children (local 2q -> q); a leaf parent's left child
            # gets no rows, and its "right" is zeroed through prev_split
            k_nodes = n_nodes // 2
            node_q = torch.where(in_level & (local % 2 == 0), local // 2, k_nodes)
        else:
            k_nodes = n_nodes
            node_q = torch.where(in_level, local, n_nodes)
        hist = hist_fn(binned_T, node_q.to(torch.int32), gh, k_nodes, n_bins_tot)
        if subtract:
            right = torch.where(prev_split[:, None, :, None, None], prev_hist - hist, 0.0)
            hist = torch.stack([hist, right], dim=3).reshape(K, n_f, n_nodes, n_bins_tot, 2)
        best_gain, best_f, best_b, best_dl, node_leaf = _best_splits(hist, col_mask, p)

        make_leaf = best_gain <= p.min_split_gain  # covers -inf / empty nodes
        if p.hist_subtract and d + 1 < depth:
            prev_hist, prev_split = hist, ~make_leaf
        ids = slice(level_start, level_start + n_nodes)
        feature[:, ids] = torch.where(make_leaf, 0, best_f).to(torch.int32)
        split_bin[:, ids] = torch.where(make_leaf, -1, best_b).to(torch.int32)
        default_left[:, ids] = best_dl & ~make_leaf
        is_leaf[:, ids] = make_leaf
        leaf_value[:, ids] = torch.where(make_leaf, node_leaf, 0.0)
        split_gain = torch.where(make_leaf, 0.0, best_gain)
        gain_pf = gain_pf + torch.where(best_f[..., None] == feat_ids, split_gain[..., None],
                                        0.0).sum(dim=1)

        # route this level's rows to their children (the split column of
        # each row's own node)
        lc = local.clamp(0, n_nodes - 1)
        bv = torch.gather(flat_bins, 1, torch.gather(best_f, 1, lc) * n + rows).long()
        go_left = torch.where(bv == missing_id, torch.gather(best_dl, 1, lc),
                              bv <= torch.gather(best_b, 1, lc))
        moves = in_level & ~torch.gather(make_leaf, 1, lc)
        node = torch.where(moves, 2 * node + torch.where(go_left, 1, 2), node)

    # terminal leaves: per-leaf (g, h) sums as a masked, ordered reduction
    # (the same result from run to run)
    leaf_start = 2 ** depth - 1
    local = node - leaf_start
    at_leaf = (local >= 0) & (local < 2 ** depth)
    onehot = (local[..., None] == torch.arange(2 ** depth, device=dev)) & at_leaf[..., None]
    sums = xla_cpu.row_sums(torch.where(onehot[..., None], gh[:, :, None, :], 0.0))
    lv = _leaf_weight(sums[..., 0], sums[..., 1], p.reg_alpha, p.reg_lambda,
                      p.learning_rate)
    leaf_value[:, leaf_start:] = torch.where(sums[..., 1] > 0, lv, 0.0)
    return (feature, split_bin, default_left, is_leaf, leaf_value), gain_pf, node


def _predict_tree(tree, binned_T: torch.Tensor, missing_id: int, depth: int) -> torch.Tensor:
    """Leaf value [K, N] of one tree per fold on binned_T [K, F, N]."""
    feature, split_bin, default_left, is_leaf, leaf_value = tree
    K, n_f, n = binned_T.shape
    n_internal = feature.shape[1]
    flat = binned_T.reshape(K, n_f * n)
    rows = torch.arange(n, device=binned_T.device)
    node = torch.zeros(K, n, dtype=torch.long, device=binned_T.device)
    for _ in range(depth):
        cn = node.clamp(0, n_internal - 1)
        feat = torch.gather(feature, 1, cn).long()
        bv = torch.gather(flat, 1, feat * n + rows).long()
        go_left = torch.where(bv == missing_id, torch.gather(default_left, 1, cn),
                              bv <= torch.gather(split_bin, 1, cn))
        stays = (node >= n_internal) | torch.gather(is_leaf, 1, cn)
        node = torch.where(stays, node, 2 * node + torch.where(go_left, 1, 2))
    return torch.gather(leaf_value, 1, node)


# ---------------------------------------------------------------------------
# the boosting loop
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _round_randomness(seed: int, n_rounds: int, n_features: int, colsample: float):
    """(k_sub [R, 2] int64, column masks [R, F] bool) of a fit, on the host."""
    k_sub, k_col = prng.round_subkeys(prng.round_keys(seed, n_rounds))
    return k_sub.astype(np.int64), prng.column_masks(k_col, n_features, colsample)


def _val_logloss(margin_val, yv, vmask):
    """[K] masked validation logloss."""
    den = vmask.to(torch.float32).sum(dim=1)
    p = torch.sigmoid(margin_val)
    eps = 1e-16
    ll = -(yv * torch.log(torch.clamp(p, eps, 1.0))
           + (1 - yv) * torch.log(torch.clamp(1 - p, eps, 1.0)))
    return torch.where(vmask, ll, 0.0).sum(dim=1) / den


def _fit_impl(binned_T, y, w, row_ids, binned_val_T, yv, vmask, seeds: Sequence[int],
              p: GBDTParams, objective, early_stop: int, hist_fn: HistFn):
    """K batched fits. binned_T [K, F, N] int16; y, w [K, N] f32; row_ids
    [K, N]; validation binned_val_T [K, F, Nv], yv [K, Nv], vmask [K, Nv]
    bool (None without a validation set); seeds [K].

    Returns (Forest of [K, R, ...] buffers, gains [K, F], metrics [K, R]
    numpy, best-iteration validation margins [K, Nv] numpy (NaN when the
    fit did not early-stop))."""
    if p.eval_metric != "logloss":
        raise ValueError(f"eval_metric {p.eval_metric!r}: the port evaluates logloss only")
    K, n_f, n = binned_T.shape
    dev = binned_T.device
    R, depth = p.n_rounds, p.max_depth
    n_int, n_heap = 2 ** depth - 1, 2 ** (depth + 1) - 1
    has_val = binned_val_T is not None
    nv = binned_val_T.shape[2] if has_val else 1

    rand = [_round_randomness(int(s), R, n_f, float(p.colsample_bytree)) for s in seeds]
    k_sub = torch.from_numpy(np.stack([r[0] for r in rand])).to(dev)  # [K, R, 2]
    col_masks = torch.from_numpy(np.stack([r[1] for r in rand])).to(dev)  # [K, R, F]

    bufs = [torch.zeros(K, R, n_int, dtype=torch.int32, device=dev),
            torch.full((K, R, n_int), -1, dtype=torch.int32, device=dev),
            torch.zeros(K, R, n_int, dtype=torch.bool, device=dev),
            torch.zeros(K, R, n_int, dtype=torch.bool, device=dev),
            torch.zeros(K, R, n_heap, dtype=torch.float32, device=dev)]
    metrics = torch.full((K, R), torch.inf if has_val else torch.nan, device=dev)
    gain_sum = torch.zeros(K, n_f, dtype=torch.float32, device=dev)
    margin = torch.full((K, n), p.base_score, dtype=torch.float32, device=dev)
    margin_val = torch.full((K, nv), p.base_score, dtype=torch.float32, device=dev)
    early = has_val and early_stop > 0
    i = torch.zeros(K, dtype=torch.long, device=dev)
    best_i = torch.zeros(K, dtype=torch.long, device=dev)
    best_m = torch.full((K,), torch.inf, device=dev)
    best_mv = torch.zeros(K, nv, dtype=torch.float32, device=dev)
    stopped = torch.zeros(K, dtype=torch.bool, device=dev)

    for r in range(R):
        if early:
            # the batched while_loop's cond, per fold; the loop runs while
            # any fold's holds (the one host sync of a round)
            active = (i < R) & (i - best_i <= early_stop)
            if not bool(active.any()):
                break
        else:
            active = torch.ones(K, dtype=torch.bool, device=dev)

        grad, hess = objective(margin, y, w)
        if p.subsample < 1.0:
            m = _row_subsample_mask(k_sub[:, r], row_ids, p.subsample)
            grad = torch.where(m, grad, 0.0)
            hess = torch.where(m, hess, 0.0)
        gh = torch.stack([grad, hess], dim=-1).contiguous()
        tree, gains, node = _train_tree(binned_T, gh, col_masks[:, r], p, hist_fn)
        new_margin = margin + torch.gather(tree[4], 1, node)

        a1 = active[:, None]
        margin = torch.where(a1, new_margin, margin)
        for buf, t in zip(bufs, tree):
            buf[:, r] = torch.where(a1, t, buf[:, r])
        gain_sum = torch.where(a1, gain_sum + gains, gain_sum)
        if not has_val:
            continue
        new_mv = margin_val + _predict_tree(tree, binned_val_T, p.n_bins, depth + 1)
        metric = _val_logloss(new_mv, yv, vmask)
        margin_val = torch.where(a1, new_mv, margin_val)
        metrics[:, r] = torch.where(active, metric, metrics[:, r])
        if early:
            # XGBoost first-stop semantics, frozen per fold
            better = (metric < best_m) & ~stopped & active
            stopped = torch.where(active, stopped | (~better & (i - best_i >= early_stop)),
                                  stopped)
            best_m = torch.where(better, metric, best_m)
            best_i = torch.where(better, i, best_i)
            best_mv = torch.where(better[:, None], new_mv, best_mv)
            i = torch.where(active, i + 1, i)

    if not early:
        best_mv = torch.full_like(best_mv, torch.nan)
    return Forest(*bufs), gain_sum, metrics.cpu().numpy(), best_mv.cpu().numpy()


def _best_iteration(h: np.ndarray, early_stopping_rounds: Optional[int]) -> int:
    """XGBoost's best iteration from a metric history: the first stop
    ``early_stopping_rounds`` past the best, or the argmin."""
    if not early_stopping_rounds:
        return int(np.argmin(h))
    best, best_i = np.inf, 0
    for j, v in enumerate(h):
        if v < best:
            best, best_i = v, j
        elif j - best_i >= early_stopping_rounds:
            break
    return best_i


def _models_from_fit(forest: Forest, gains, metrics, best_mv, specs, params,
                     has_val: bool, early_stopping_rounds) -> List[GBDTModel]:
    gains = gains.cpu().numpy()
    models = []
    for k, spec in enumerate(specs):
        best_it, val_margin = -1, None
        if has_val:
            best_it = _best_iteration(metrics[k], early_stopping_rounds)
            if early_stopping_rounds and np.isfinite(best_mv[k]).all():
                val_margin = best_mv[k]
        models.append(GBDTModel(
            forest=Forest(*[a[k] for a in forest]), bin_spec=spec, params=params,
            best_iteration=best_it, importance_gain=gains[k],
            eval_history=metrics[k], val_margin=val_margin))
    return models


def _pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """Pad the first axis of ``a`` to ``n`` rows with zeros."""
    pad = torch.zeros((n - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


def train_gbdt(X_train: np.ndarray, y_train: np.ndarray,
               params: GBDTParams = GBDTParams(),
               sample_weight: Optional[np.ndarray] = None,
               scale_pos_weight: float = 1.0, objective: Optional[Objective] = None,
               X_val: Optional[np.ndarray] = None, y_val: Optional[np.ndarray] = None,
               early_stopping_rounds: Optional[int] = None, device: DeviceLike = None,
               hist_fn: HistFn = hist_cuda.build_histograms) -> GBDTModel:
    """Fit one boosted-tree model (``xgb.train`` with the reference's
    parameter surface). ``hist_fn`` builds the level histograms: the K1
    wrapper, or a plain version to compare the fit against."""
    dev = resolve_device(device)
    objective = objective or objectives.logistic
    X_train = np.asarray(X_train, np.float32)
    n_real = len(X_train)
    y = torch.as_tensor(np.asarray(y_train, np.float32), device=dev)
    w_base = (np.ones(n_real, np.float32) if sample_weight is None
              else np.asarray(sample_weight, np.float32))
    spw = torch.tensor(scale_pos_weight, dtype=torch.float32, device=dev)
    w = torch.as_tensor(w_base, device=dev) * torch.where(y > 0.5, spw, 1.0)
    # DMatrix-style weights shift the edges; scale_pos_weight does not
    bin_spec = fit_bins(X_train, params.n_bins, sample_weight=w_base, device=dev)

    def binned_of(X):
        return apply_bins(bin_spec, torch.as_tensor(X, device=dev)).to(torch.int16)

    binned_T = binned_of(X_train).T.contiguous()[None]
    y, w = y[None], w[None]
    has_val = X_val is not None
    binned_val_T = yv = vmask = None
    if has_val:
        X_val = np.asarray(X_val, np.float32)
        binned_val_T = binned_of(X_val).T.contiguous()[None]
        yv = torch.as_tensor(np.asarray(y_val, np.float32), device=dev)[None]
        vmask = torch.ones_like(yv, dtype=torch.bool)
    row_ids = torch.arange(n_real, device=dev)[None]
    es = int(early_stopping_rounds or 0)
    forest, gains, metrics, best_mv = _fit_impl(
        binned_T, y, w, row_ids, binned_val_T, yv, vmask, [params.seed], params,
        objective, es, hist_fn)
    return _models_from_fit(forest, gains, metrics, best_mv, [bin_spec], params,
                            has_val, early_stopping_rounds)[0]


def _stack_folds(folds, params: GBDTParams, pad_rows_to: int, pad_val_rows_to: int,
                 dev: torch.device):
    """Bin every fold and stack them on a leading fold axis, padded to
    shared row counts (zero weight / masked). Folds that are row subsets of
    one shared parent matrix (``X_parent``, ``tr_idx``, ``va_idx``) bin
    from one global sort and one device gather; others bin on their own.

    Returns (dict of [K, ...] tensors, bin specs)."""
    K = len(folds)
    parents = [f.get("X_parent") for f in folds]
    shared = (all(f.get(k) is not None for f in folds for k in ("X_parent", "tr_idx", "va_idx"))
              and all(p is parents[0] for p in parents)
              and all(len(np.unique(f["tr_idx"])) == len(f["tr_idx"]) for f in folds))
    w_bases = [np.ones(len(f["y"]), np.float32) if f.get("w") is None
               else np.asarray(f["w"], np.float32) for f in folds]
    if shared:
        Xp = np.asarray(parents[0], np.float32)
        specs = fit_bins_folds(Xp, [f["tr_idx"] for f in folds], params.n_bins,
                               sample_weights=w_bases, device=dev)
        idx = np.full((K, pad_rows_to + pad_val_rows_to), -1, np.int64)
        for k, f in enumerate(folds):
            idx[k, :len(f["tr_idx"])] = f["tr_idx"]
            idx[k, pad_rows_to:pad_rows_to + len(f["va_idx"])] = f["va_idx"]
        binned = apply_bins_folds_gather(
            torch.as_tensor(Xp, device=dev), torch.stack([s.edges for s in specs]),
            torch.as_tensor(idx, device=dev), params.n_bins)
        binned_tr, binned_va = binned[:, :pad_rows_to], binned[:, pad_rows_to:]
    else:
        specs, tr, va = [], [], []
        for f, wb in zip(folds, w_bases):
            spec = fit_bins(np.asarray(f["X"], np.float32), params.n_bins,
                            sample_weight=wb, device=dev)
            specs.append(spec)
            for X, n_to, out in ((f["X"], pad_rows_to, tr), (f["X_val"], pad_val_rows_to, va)):
                b = apply_bins(spec, torch.as_tensor(np.asarray(X, np.float32), device=dev))
                out.append(_pad_rows(b.to(torch.int16), n_to))
        binned_tr, binned_va = torch.stack(tr), torch.stack(va)

    def stack(key, n_to, fill=0.0, dtype=np.float32):
        return torch.as_tensor(np.stack([
            np.concatenate([v, np.full(n_to - len(v), fill, dtype)])
            for v in key]), device=dev)

    # scale_pos_weight enters the objective through the weights, not the
    # bin edges (float64 on the host, then float32, as the JAX package)
    ws = [(wb * np.where(np.asarray(f["y"], np.float32) > 0.5, f.get("spw", 1.0), 1.0)
           ).astype(np.float32) for f, wb in zip(folds, w_bases)]
    arrs = {
        "binned_T": binned_tr.transpose(1, 2).contiguous(),
        "binned_val_T": binned_va.transpose(1, 2).contiguous(),
        "y": stack([np.asarray(f["y"], np.float32) for f in folds], pad_rows_to),
        "w": stack(ws, pad_rows_to),
        "yv": stack([np.asarray(f["y_val"], np.float32) for f in folds], pad_val_rows_to),
        "vmask": stack([np.ones(len(f["y_val"]), bool) for f in folds], pad_val_rows_to,
                       False, bool),
        "row_ids": torch.arange(pad_rows_to, device=dev).expand(K, pad_rows_to),
    }
    return arrs, specs


def train_gbdt_folds(folds, params: GBDTParams, objective: Optional[Objective] = None,
                     early_stopping_rounds: Optional[int] = None,
                     pad_rows_to: Optional[int] = None,
                     pad_val_rows_to: Optional[int] = None, device: DeviceLike = None,
                     hist_fn: HistFn = hist_cuda.build_histograms) -> List[GBDTModel]:
    """Train every CV fold as ONE batched fit (a leading fold axis on every
    tensor; one K1 launch per level covers all folds).

    ``folds``: dicts with y, w (optional), y_val, spw, seed (optional) and
    either X / X_val or a shared X_parent with tr_idx / va_idx (X may then
    be omitted). Rows pad to the largest fold. Returns one model per fold."""
    dev = resolve_device(device)
    objective = objective or objectives.logistic
    pad_rows_to = pad_rows_to or max(len(f["y"]) for f in folds)
    pad_val_rows_to = pad_val_rows_to or max(len(f["y_val"]) for f in folds)
    arrs, specs = _stack_folds(folds, params, pad_rows_to, pad_val_rows_to, dev)
    es = int(early_stopping_rounds or 0)
    forest, gains, metrics, best_mv = _fit_impl(
        arrs["binned_T"], arrs["y"], arrs["w"], arrs["row_ids"], arrs["binned_val_T"],
        arrs["yv"], arrs["vmask"], [f.get("seed", params.seed) for f in folds], params,
        objective, es, hist_fn)
    return _models_from_fit(forest, gains, metrics, best_mv, specs, params, True,
                            early_stopping_rounds)


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------

def predict_margin_folds(forest: Forest, binned: torch.Tensor,
                         n_trees: torch.Tensor, missing_id: int, depth: int,
                         base_score: float = 0.0) -> torch.Tensor:
    """Margins [K, N] of K stacked fold forests ([K, R, ...]) on a binned
    matrix, shared [N, F] or one per fold [K, N, F]. Tree r of fold k
    counts only when r < n_trees[k] (the early-stopping
    ``best_iteration + 1`` truncation). Every tree of every fold routes at
    once, one level at a time, over a [K, N, R] node tensor."""
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


# rows per prediction chunk: the routing holds [K, chunk, R] node tensors
PREDICT_CHUNK = 2048


def predict_margin_models(models: Sequence[GBDTModel], X: torch.Tensor) -> torch.Tensor:
    """Margins [K, N] of K same-config fold models on one float matrix
    [N, F] (each fold bins it with its own edges), in row chunks."""
    p = models[0].params
    forest = stack_forests([m.forest for m in models])
    n_trees = torch.tensor([m.n_trees for m in models])
    out = []
    for s in range(0, X.shape[0], PREDICT_CHUNK):
        Xc = X[s:s + PREDICT_CHUNK]
        binned = torch.stack([apply_bins(m.bin_spec, Xc) for m in models])
        out.append(predict_margin_folds(forest, binned, n_trees, p.n_bins, p.max_depth,
                                        p.base_score))
    return torch.cat(out, dim=1)
