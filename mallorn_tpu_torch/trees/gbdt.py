"""Histogram GBDT (port of ``mallorn_tpu.trees.gbdt``): depthwise,
symmetric and leaf-wise training, DART, multiclass, and prediction, every
fold of a CV as one batched fit.

A ``Forest`` stacks fixed-shape heap trees: R rounds, I = 2^D - 1
internal slots, H = 2^(D+1) - 1 heap nodes (a multiclass forest holds one
tree per class and round: [R, C, ...]). Routing follows
``_predict_tree``: the missing bin goes to ``default_left``, otherwise a
row goes left when ``bin <= split_bin``; an early leaf (``is_leaf``) stops
the row there. An ``LGForest`` (``grow_policy="lossguide"``) stacks
leaf-wise trees of M = 2 max_leaves - 1 node slots with explicit child
pointers (``left``, ``right``), routed by pointer chasing.

Training (``train_gbdt``, ``train_gbdt_folds``) is XGBoost's depthwise
``hist`` algorithm as the JAX package computes it: per round, logistic
(or a custom) grad/hess times the sample weights, a row subsample keyed
by (round key, row position) and a column sample from the round key,
then one tree grown level by level. Each level builds (grad, hess)
histograms over (fold, feature, node, bin) through a Hopper kernel of
``ops.hist_cuda`` chosen by ``GBDTParams.hist_dtype``: K1 (exact sums,
"i8full", the default), K4 (bf16 digits, "bf16" / "i8bf16") or K5 (int8
fixed-point digits, "int8"); from level 1 on only left children are built
and a right child is its parent minus its sibling. The split search is an
argmax over (feature, bin, default direction) per node, taking the first
index on ties. Every tensor carries a leading fold axis K: the folds of a
CV train together, with one kernel launch covering all of them.

Early stopping reproduces the JAX package's batched ``while_loop``: a
fold stops ``early_stopping_rounds`` rounds past its best validation
metric, its state is frozen from then on, and the loop runs until every
fold has stopped (one host sync per round learns that). Rounds a fold
never ran keep all-zero trees and a +inf metric.

Leaf-wise trees (``_train_tree_lossguide``, LightGBM's policy) split,
max_leaves - 1 times, the leaf whose cached best split gains most, each
lane choosing its own leaf; every step builds the chosen leaf's two
children's histograms through the Hopper kernel K3
(``hist_cuda.build_seg_histograms``), and the root one more. The steps
run as a Python loop over [K, M] state tensors, with no host sync inside
a tree.

Symmetric trees (``grow_policy="symmetric"``, CatBoost's oblivious
trees) grow as depthwise ones, but every node of a level shares one split:
the (feature, bin, default direction) whose positive gains, summed over
the level's nodes, are largest.

DART (``dart_rate > 0``, any policy) keeps every tree's contribution to
every row ([K, R, N]) and a scale per tree; each round drops earlier trees
at random, fits against the rest, and renormalises. It runs every round
(no early stop); the final scales are folded into the stored leaves.

Multiclass (``num_class = C >= 2``, XGBoost's multi:softprob, depthwise
only) grows C trees per round on softmax gradients taken at the round's
start, so a round's class trees are independent: they grow as extra lanes
(lane = fold x C + class), one histogram launch per level for all of them.

The random bits (round keys, column permutations, DART's drop draws) are
the JAX package's own, computed on the host (``utils.prng``) once per fit.

A mesh enters the fit through hooks of ``_fit_impl``, not a second fit
(``parallel.sharded_train``): each rank passes its block of rows,
``hist_fn`` / ``seg_hist_fn`` that all-reduce K1's / K3's exact int64 sums
at one global scale, and ``gather_rows`` / ``gather_val``, which bring the
few other row sums' terms to every rank in row order: the rows' terminal
leaf and (g, h), and each validation row's loss. Those sums then run on
the single-device rows in the single-device order (float32 sums of
partials would differ in the last bit, and a near-tie split with them), so
every rank grows the single-device trees bit for bit and takes the same
early-stopping branch.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

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
SegHistFn = Callable[..., torch.Tensor]
GROW_POLICIES = ("depthwise", "lossguide", "symmetric")
# the depthwise fit's level-histogram kernel per GBDTParams.hist_dtype
HIST_DTYPE_FNS = {"i8full": hist_cuda.build_histograms,
                  "bf16": hist_cuda.build_histograms_bf16,
                  "i8bf16": hist_cuda.build_histograms_bf16,
                  "int8": hist_cuda.build_histograms_i8}


class GBDTParams(NamedTuple):
    """The JAX package's ``GBDTParams``, without its TPU-only knobs
    (``use_pallas_hist``, ``use_binlane_hist``, ``route``, ``stub_hist``)."""

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
    # validation metric for early stopping: "logloss" (binary), "rmse"
    # (the squarederror runners) or "mlogloss" (a fit with num_class >= 2
    # always uses it); the port computes no other
    eval_metric: str = "logloss"
    # build left children only from level 1 on; right = parent - left
    hist_subtract: bool = True
    # "depthwise" (XGBoost), "lossguide" (LightGBM leaf-wise: up to
    # max_leaves leaves, max_depth the joint depth cap, <= 0 = no cap) or
    # "symmetric" (CatBoost oblivious trees: one split per level)
    grow_policy: str = "depthwise"
    max_leaves: int = 31
    # the depthwise level histogram's arithmetic (a leaf-wise fit ignores
    # it): "i8full" exact sums (K1), "bf16" / "i8bf16" float32 sums of bf16
    # digits (K4, one mode here; the JAX package's two differ only in how
    # the TPU streams the one-hot), "int8" 26-bit fixed-point digits (K5)
    hist_dtype: str = "i8full"
    # DART: each round drops every earlier tree with this probability
    # (LightGBM's drop_rate); 0 = plain boosting
    dart_rate: float = 0.0
    # C >= 2: multi:softprob over class ids 0..C-1, one tree per class and
    # round; 0 = binary
    num_class: int = 0


# The v21/v34a/v92 shape (reference: scripts/train_v34a_bazin.py:134-148).
V34A_PARAMS = GBDTParams(n_rounds=500, max_depth=5, learning_rate=0.025,
                         subsample=0.8, colsample_bytree=0.8,
                         min_child_weight=3.0, reg_alpha=0.2, reg_lambda=1.5)


class Forest(NamedTuple):
    # a multiclass forest has a class axis after R: [..., R, C, I]
    feature: torch.Tensor  # [..., R, I] int32
    split_bin: torch.Tensor  # [..., R, I] int32
    default_left: torch.Tensor  # [..., R, I] bool
    is_leaf: torch.Tensor  # [..., R, I] bool
    leaf_value: torch.Tensor  # [..., R, H] float32 (eta applied)


class LGForest(NamedTuple):
    """Stacked leaf-wise trees: M = 2 max_leaves - 1 node slots, explicit
    child pointers (a leaf-wise tree is not a heap)."""

    feature: torch.Tensor  # [..., R, M] int32
    split_bin: torch.Tensor  # [..., R, M] int32
    default_left: torch.Tensor  # [..., R, M] bool
    is_leaf: torch.Tensor  # [..., R, M] bool
    left: torch.Tensor  # [..., R, M] int32
    right: torch.Tensor  # [..., R, M] int32
    leaf_value: torch.Tensor  # [..., R, M] float32 (eta applied)


class GBDTModel(NamedTuple):
    forest: Union[Forest, LGForest]
    bin_spec: BinSpec
    params: GBDTParams
    best_iteration: int  # -1 when the fit did not early-stop
    importance_gain: Optional[np.ndarray] = None  # [F] summed split gains
    eval_history: Optional[np.ndarray] = None  # [R] validation metric
    # validation margins at best_iteration, tracked inside an early-stopped fit
    # ([C, Nv] for a multiclass fit)
    val_margin: Optional[np.ndarray] = None

    @property
    def n_trees(self) -> int:
        """Trees that count at prediction (best_iteration + 1, or all)."""
        if self.best_iteration >= 0:
            return self.best_iteration + 1
        return self.forest.feature.shape[0]


def stack_forests(forests: Sequence[Forest]) -> Forest:
    """K same-shape forests (of one kind) -> one with a leading fold axis."""
    return type(forests[0])(*[torch.stack(a) for a in zip(*forests)])


def lossguide_steps(params: GBDTParams) -> int:
    """Pointer-chasing steps that route a leaf-wise tree:
    min(max_depth, max_leaves), max_depth <= 0 meaning no cap (the JAX
    package's ``lg_steps`` and ``route_depth``)."""
    cap = params.max_depth if params.max_depth > 0 else params.max_leaves
    return min(cap, params.max_leaves)


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


def _best_splits(hist: torch.Tensor, col_mask: torch.Tensor, p: GBDTParams,
                 symmetric: bool = False):
    """Best split per (fold, node) from [K, F, C, B+1, 2] histograms.

    Returns (gain, feature, bin, default_left, the node's leaf weight,
    g_tot, h_tot), each [K, C]. The node totals are the sums over features
    and bins times 1/F: the JAX package's fit compiles its division by F to
    that product, and fuses the product into the node's denominator h_tot +
    lambda (``xla_cpu.mul_add``).

    ``symmetric``: one split for the whole level, the (feature, bin,
    default direction) whose positive node gains sum highest (a node's -inf
    or non-positive gain adds 0; first index on ties), replicated over the
    nodes with the gain divided by C (so that the nodes' gains sum to the
    level's total)."""
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
    h_tot = h_sum * inv_f
    gt, ht = g_tot[:, None, :, None], h_tot[:, None, :, None]
    cols = col_mask[:, :, None, None]

    def split_gain(gl, hl):
        gr, hr = gt - gl, ht - hl
        gain = 0.5 * (_score(gl, hl, p.reg_alpha, p.reg_lambda)
                      + _score(gr, hr, p.reg_alpha, p.reg_lambda) - parent)
        ok = (hl >= p.min_child_weight) & (hr >= p.min_child_weight) & cols
        return torch.where(ok, gain, -torch.inf)

    gain_right = split_gain(cg, ch)  # missing goes right
    gain_left = split_gain(cg + g_miss, ch + h_miss)
    if symmetric:
        tot_r = xla_cpu.level_sum(torch.where(gain_right > 0, gain_right, 0.0))  # [K, F, B]
        tot_l = xla_cpu.level_sum(torch.where(gain_left > 0, gain_left, 0.0))
        flat = torch.maximum(tot_r, tot_l).reshape(K, -1)
        idx = torch.argmax(flat, dim=1)  # first index on ties
        bg = torch.gather(flat, 1, idx[:, None])[:, 0] / n_nodes
        bdl = torch.gather((tot_l > tot_r).reshape(K, -1), 1, idx[:, None])[:, 0]

        def rep(x):
            return x[:, None].expand(K, n_nodes)

        bf = torch.div(idx, missing_id, rounding_mode="floor")
        return rep(bg), rep(bf), rep(idx % missing_id), rep(bdl), leaf, g_tot, h_tot
    gain_fb = torch.maximum(gain_right, gain_left)
    flat = gain_fb.transpose(1, 2).reshape(K, n_nodes, -1)  # [K, C, F*B]
    best_idx = torch.argmax(flat, dim=-1)  # first index on ties
    best_gain = torch.gather(flat, 2, best_idx[..., None])[..., 0]
    dleft = (gain_left > gain_right).transpose(1, 2).reshape(K, n_nodes, -1)
    best_dl = torch.gather(dleft, 2, best_idx[..., None])[..., 0]
    best_f = torch.div(best_idx, missing_id, rounding_mode="floor")
    best_b = best_idx % missing_id
    return best_gain, best_f, best_b, best_dl, leaf, g_tot, h_tot


def _train_tree(binned_T: torch.Tensor, gh: torch.Tensor, col_mask: torch.Tensor,
                p: GBDTParams, hist_fn: HistFn, symmetric: bool = False,
                gather_rows: Optional[Callable] = None):
    """Grow one depthwise tree per fold (``symmetric``: one oblivious tree,
    every node of a level on the level's shared split). ``gather_rows``: a
    mesh's [K, rank rows, ...] tensors -> [K, fit rows, ...] (several in
    one collective), for the terminal leaves' sums over every row.

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
        best_gain, best_f, best_b, best_dl, node_leaf, _, _ = _best_splits(
            hist, col_mask, p, symmetric)

        if symmetric:
            # the level's undivided total against min_split_gain
            make_leaf = best_gain * n_nodes <= p.min_split_gain
        else:
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
    if gather_rows is not None:  # every rank's rows, in the single-device order
        local, gh = gather_rows(local.to(torch.int32), gh)
        local = local.long()
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


def _train_tree_lossguide(binned_T: torch.Tensor, gh: torch.Tensor, col_mask: torch.Tensor,
                          p: GBDTParams, seg_hist_fn: SegHistFn):
    """Grow one leaf-wise tree per lane (the JAX package's
    ``_train_tree_lossguide``): max_leaves - 1 split steps, each splitting
    the leaf with the highest cached gain (first on ties; -inf marks leaves
    that cannot split and unallocated slots) when that gain exceeds
    min_split_gain, routing its rows and building its two children's
    histograms (one K3 launch); the root's histogram is one more launch.
    Every lane takes its own leaf and its own ``do`` decision as tensors.

    binned_T [K, F, N] int16, gh [K, N, 2] float32, col_mask [K, F] bool.
    Returns ((feature, split_bin, default_left, is_leaf, left, right,
    leaf_value), each [K, M]; per-feature split gains [K, F]; final node
    [K, N])."""
    K, n_f, n = binned_T.shape
    dev = binned_T.device
    L = p.max_leaves
    M = 2 * L - 1
    nbt = p.n_bins + 1
    missing_id = p.n_bins
    depth_cap = p.max_depth if p.max_depth > 0 else L

    def best(seg_base, n_nodes):
        hist = seg_hist_fn(binned_T, seg_base, gh, n_nodes * nbt)
        return _best_splits(hist.view(K, n_f, n_nodes, nbt, 2), col_mask, p)

    g0, f0, b0, dl0, _, gt0, ht0 = best(torch.zeros(K, n, dtype=torch.int32, device=dev), 1)

    def slot0(val, fill, dtype):
        a = torch.full((K, M), fill, dtype=dtype, device=dev)
        a[:, 0] = val
        return a

    feature = torch.zeros(K, M, dtype=torch.long, device=dev)
    split_bin = torch.full((K, M), -1, dtype=torch.long, device=dev)
    default_left = torch.zeros(K, M, dtype=torch.bool, device=dev)
    is_leaf = torch.ones(K, M, dtype=torch.bool, device=dev)
    left = torch.zeros(K, M, dtype=torch.long, device=dev)
    right = torch.zeros(K, M, dtype=torch.long, device=dev)
    depth = torch.zeros(K, M, dtype=torch.long, device=dev)
    node_g = slot0(gt0[:, 0], 0.0, torch.float32)
    node_h = slot0(ht0[:, 0], 0.0, torch.float32)
    # best-split cache per leaf
    bg = slot0(g0[:, 0] if depth_cap > 0 else -torch.inf, -torch.inf, torch.float32)
    bf = slot0(f0[:, 0], 0, torch.long)
    bb = slot0(b0[:, 0], 0, torch.long)
    bdl = slot0(dl0[:, 0], False, torch.bool)
    node = torch.zeros(K, n, dtype=torch.long, device=dev)
    n_nodes = torch.ones(K, dtype=torch.long, device=dev)
    gain_pf = torch.zeros(K, n_f, dtype=torch.float32, device=dev)

    def at(a, idx):
        return torch.gather(a, 1, idx[:, None])[:, 0]

    for _ in range(L - 1):
        l = torch.argmax(bg, dim=1)  # first maximum
        bg_l = at(bg, l)
        do = bg_l > p.min_split_gain
        li, ri = n_nodes, n_nodes + 1
        fl, bl, dll = at(bf, l), at(bb, l), at(bdl, l)

        def upd(a, idx, val):
            return a.scatter(1, idx[:, None], torch.where(do, val, at(a, idx))[:, None])

        feature = upd(feature, l, fl)
        split_bin = upd(split_bin, l, bl)
        default_left = upd(default_left, l, dll)
        is_leaf = upd(is_leaf, l, torch.zeros_like(do))
        left = upd(left, l, li)
        right = upd(right, l, ri)
        child_depth = at(depth, l) + 1
        depth = upd(upd(depth, li, child_depth), ri, child_depth)
        gain_pf = gain_pf.scatter_add(1, fl[:, None], torch.where(do, bg_l, 0.0)[:, None])

        # route the chosen leaf's rows, then its children's histograms
        at_l = (node == l[:, None]) & do[:, None]
        bv = torch.gather(binned_T, 1, fl[:, None, None].expand(K, 1, n))[:, 0].long()
        go_left = torch.where(bv == missing_id, dll[:, None], bv <= bl[:, None])
        node = torch.where(at_l, torch.where(go_left, li[:, None], ri[:, None]), node)
        seg_base = torch.where(at_l, torch.where(node == ri[:, None], nbt, 0), 2 * nbt)
        cg, cf, cb, cdl, _, cgt, cht = best(seg_base.to(torch.int32), 2)
        can_split = do & (child_depth < depth_cap)
        cg = torch.where(can_split[:, None], cg, -torch.inf)

        node_g = upd(upd(node_g, li, cgt[:, 0]), ri, cgt[:, 1])
        node_h = upd(upd(node_h, li, cht[:, 0]), ri, cht[:, 1])
        bg = bg.scatter(1, l[:, None], torch.where(do, -torch.inf, bg_l)[:, None])
        bg = bg.scatter(1, li[:, None], cg[:, :1]).scatter(1, ri[:, None], cg[:, 1:])
        bf = upd(upd(bf, li, cf[:, 0]), ri, cf[:, 1])
        bb = upd(upd(bb, li, cb[:, 0]), ri, cb[:, 1])
        bdl = upd(upd(bdl, li, cdl[:, 0]), ri, cdl[:, 1])
        n_nodes = n_nodes + torch.where(do, 2, 0)

    allocated = torch.arange(M, device=dev)[None, :] < n_nodes[:, None]
    lv = _leaf_weight(node_g, node_h, p.reg_alpha, p.reg_lambda, p.learning_rate)
    leaf_value = torch.where(is_leaf & allocated & (node_h > 0), lv, 0.0)
    i32 = torch.int32
    tree = (feature.to(i32), split_bin.to(i32), default_left, is_leaf, left.to(i32),
            right.to(i32), leaf_value)
    return tree, gain_pf, node


def _predict_tree_lossguide(tree, binned_T: torch.Tensor, missing_id: int,
                            n_steps: int) -> torch.Tensor:
    """Leaf value [K, N] of one leaf-wise tree per lane on binned_T [K, F, N]
    (pointer chasing, ``n_steps`` steps)."""
    feature, split_bin, default_left, is_leaf, left, right, leaf_value = tree
    K, n_f, n = binned_T.shape
    flat = binned_T.reshape(K, n_f * n)
    rows = torch.arange(n, device=binned_T.device)
    node = torch.zeros(K, n, dtype=torch.long, device=binned_T.device)
    for _ in range(n_steps):
        bv = torch.gather(flat, 1, torch.gather(feature, 1, node).long() * n + rows).long()
        go_left = torch.where(bv == missing_id, torch.gather(default_left, 1, node),
                              bv <= torch.gather(split_bin, 1, node))
        child = torch.where(go_left, torch.gather(left, 1, node), torch.gather(right, 1, node))
        node = torch.where(torch.gather(is_leaf, 1, node), node, child.long())
    return torch.gather(leaf_value, 1, node)


# ---------------------------------------------------------------------------
# the boosting loop
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _round_randomness(seed: int, n_rounds: int, n_features: int, colsample: float,
                      n_class: int = 0, dart_rate: float = 0.0):
    """(k_sub [R, 2] int64, column masks [R, F] bool ([R, C, F] with
    n_class >= 2), DART's drop candidates [R, R] bool or None) of a fit, on
    the host. A DART round key splits three ways (k_drop, k_sub, k_col), a
    plain one two; tree t is a drop candidate in round r when
    ``uniform(k_drop[r], (R,))[t] < dart_rate``."""
    keys = prng.round_keys(seed, n_rounds)
    if dart_rate > 0.0:
        k_drop, k_sub, k_col = prng.round_subkeys(keys, 3)
        rate = np.float32(dart_rate)
        drop = np.stack([prng.uniform(k, (n_rounds,)) < rate for k in k_drop])
    else:
        (k_sub, k_col), drop = prng.round_subkeys(keys), None
    return (k_sub.astype(np.int64), prng.column_masks(k_col, n_features, colsample, n_class),
            drop)


def _num_den(per_row, vmask, gather):
    """(numerator, denominator) [K] of a masked mean of ``per_row`` [K, Nv]:
    the masked sum and the mask's count, over every rank's rows in row
    order when ``gather`` (a mesh's row gather, the terms beside the mask
    in one collective) is given."""
    if gather is not None:
        per_row, vmask = gather(per_row, vmask)
    return torch.where(vmask, per_row, 0.0).sum(dim=1), vmask.to(torch.float32).sum(dim=1)


def _val_logloss(margin_val, yv, vmask, gather=None):
    """[K] masked validation logloss."""
    p = torch.sigmoid(margin_val)
    eps = 1e-16
    ll = -(yv * torch.log(torch.clamp(p, eps, 1.0))
           + (1 - yv) * torch.log(torch.clamp(1 - p, eps, 1.0)))
    num, den = _num_den(ll, vmask, gather)
    return num / den


def _val_rmse(margin_val, yv, vmask, gather=None):
    """[K] masked validation rmse of the raw margins."""
    d = margin_val - yv
    num, den = _num_den(d * d, vmask, gather)
    return torch.sqrt(num / den)


def _val_mlogloss(margin_val, yv, vmask, gather=None):
    """[K] masked validation multiclass logloss, -log softmax(margin)[y], of
    margins [K, C, Nv] and class ids yv [K, Nv]."""
    logp = torch.log_softmax(margin_val, dim=1)
    yk = yv.long()[:, None, :] == torch.arange(margin_val.shape[1], device=yv.device)[:, None]
    num, den = _num_den(-torch.where(yk, logp, 0.0).sum(dim=1), vmask, gather)
    return num / den


# the validation metric of early stopping per GBDTParams.eval_metric
VAL_METRICS = {"logloss": _val_logloss, "rmse": _val_rmse, "mlogloss": _val_mlogloss}


def _softmax_grad_hess(margin, y, w):
    """multi:softprob's (grad, hess) [K, C, N] of margins [K, C, N], class
    ids y [K, N] and weights w [K, N]: p = softmax over classes (``exp(m -
    max) / sum``, the sum in class order), grad = w (p - 1{y = c}), hess =
    w max(2 p (1 - p), 1e-16)."""
    e = xla_cpu.exp(margin - margin.max(dim=1, keepdim=True).values)
    tot = e[:, 0]
    for c in range(1, e.shape[1]):
        tot = tot + e[:, c]
    p = e / tot[:, None]
    yk = y.long()[:, None, :] == torch.arange(e.shape[1], device=y.device)[:, None]
    wc = w[:, None]
    return wc * (p - yk.to(torch.float32)), wc * torch.clamp(2.0 * p * (1.0 - p), min=1e-16)


def level_hist_fn(p: GBDTParams) -> HistFn:
    """The depthwise fit's level-histogram wrapper for ``p.hist_dtype``;
    an unknown mode raises."""
    if p.hist_dtype not in HIST_DTYPE_FNS:
        raise ValueError(f"hist_dtype {p.hist_dtype!r}: expected one of "
                         f"{tuple(HIST_DTYPE_FNS)}")
    return HIST_DTYPE_FNS[p.hist_dtype]


def _check_params(p: GBDTParams) -> None:
    """Raise on a metric or policy the port does not know, and on the
    combinations the JAX package refuses."""
    if p.eval_metric not in VAL_METRICS:
        raise ValueError(f"eval_metric {p.eval_metric!r}: the port evaluates "
                         f"{tuple(VAL_METRICS)}")
    if p.grow_policy not in GROW_POLICIES:
        raise ValueError(f"grow_policy {p.grow_policy!r}: the port grows {GROW_POLICIES}")
    if p.num_class >= 2 and (p.grow_policy != "depthwise" or p.dart_rate > 0.0):
        raise ValueError("num_class >= 2 requires depthwise growth without DART "
                         "(XGBoost multi:softprob semantics)")
    if p.eval_metric == "mlogloss" and p.num_class < 2:
        raise ValueError("eval_metric 'mlogloss' requires num_class >= 2")
    level_hist_fn(p)  # an unknown hist_dtype raises in every fit


def _tree_fns(p: GBDTParams, hist_fn: HistFn, seg_hist_fn: SegHistFn,
              gather_rows: Optional[Callable] = None):
    """(grow, predict, buffers) of ``p.grow_policy``: ``grow(binned_T, gh,
    col_mask)`` -> (tree, gains [L, F], node [L, N]) over L lanes,
    ``predict(tree, binned_val_T)`` -> [L, Nv], ``buffers(L, R, dev)`` the
    empty [L, R, ...] forest of the fit. ``gather_rows``: a mesh's row
    gather for a depthwise tree's leaf sums (a leaf-wise tree reads its
    sums from K3's histograms, which ``seg_hist_fn`` reduces)."""
    if p.grow_policy == "lossguide":
        M, steps = 2 * p.max_leaves - 1, lossguide_steps(p)

        def buffers(L, R, dev):
            i32 = dict(dtype=torch.int32, device=dev)
            return [torch.zeros(L, R, M, **i32), torch.full((L, R, M), -1, **i32),
                    torch.zeros(L, R, M, dtype=torch.bool, device=dev),
                    torch.ones(L, R, M, dtype=torch.bool, device=dev),
                    torch.zeros(L, R, M, **i32), torch.zeros(L, R, M, **i32),
                    torch.zeros(L, R, M, dtype=torch.float32, device=dev)]

        return (lambda b, gh, cm: _train_tree_lossguide(b, gh, cm, p, seg_hist_fn),
                lambda t, bv: _predict_tree_lossguide(t, bv, p.n_bins, steps), buffers)
    symmetric = p.grow_policy == "symmetric"
    n_int, n_heap = 2 ** p.max_depth - 1, 2 ** (p.max_depth + 1) - 1

    def buffers(L, R, dev):
        return [torch.zeros(L, R, n_int, dtype=torch.int32, device=dev),
                torch.full((L, R, n_int), -1, dtype=torch.int32, device=dev),
                torch.zeros(L, R, n_int, dtype=torch.bool, device=dev),
                torch.zeros(L, R, n_int, dtype=torch.bool, device=dev),
                torch.zeros(L, R, n_heap, dtype=torch.float32, device=dev)]

    return (lambda b, gh, cm: _train_tree(b, gh, cm, p, hist_fn, symmetric, gather_rows),
            lambda t, bv: _predict_tree(t, bv, p.n_bins, p.max_depth + 1), buffers)


def _fit_impl(binned_T, y, w, row_ids, binned_val_T, yv, vmask, seeds: Sequence[int],
              p: GBDTParams, objective, early_stop: int, hist_fn: Optional[HistFn],
              seg_hist_fn: SegHistFn, gather_rows: Optional[Callable] = None,
              gather_val: Optional[Callable] = None):
    """K batched fits. binned_T [K, F, N] int16; y, w [K, N] f32 (class ids
    in y with num_class >= 2); row_ids [K, N]; validation binned_val_T [K,
    F, Nv], yv [K, Nv], vmask [K, Nv] bool (None without a validation set);
    seeds [K]. ``hist_fn`` builds a depthwise or symmetric fit's level
    histograms (None: ``p.hist_dtype``'s kernel), ``seg_hist_fn`` a
    leaf-wise fit's. On a mesh, the arrays are this rank's block of rows
    (``row_ids`` their global ids), the histogram functions reduce over
    the ranks, and ``gather_rows`` / ``gather_val`` turn a rank's [K,
    rows, ...] training / validation terms (several tensors in one
    collective) into the fit's rows in row order, for the leaf sums and
    the validation metrics.

    Returns (Forest or LGForest of [K, R, ...] buffers ([K, R, C, ...] with
    C = num_class >= 2), gains [K, F], metrics [K, R] numpy, best-iteration
    validation margins [K, Nv] ([K, C, Nv]) numpy (NaN when the fit did not
    early-stop))."""
    _check_params(p)
    grow, predict, buffers = _tree_fns(p, hist_fn or level_hist_fn(p), seg_hist_fn, gather_rows)
    K, n_f, n = binned_T.shape
    dev = binned_T.device
    R = p.n_rounds
    C = p.num_class if p.num_class >= 2 else 1
    has_val = binned_val_T is not None
    nv = binned_val_T.shape[2] if has_val else 1

    rand = [_round_randomness(int(s), R, n_f, float(p.colsample_bytree), int(p.num_class),
                              float(p.dart_rate)) for s in seeds]
    k_sub = torch.from_numpy(np.stack([r[0] for r in rand])).to(dev)  # [K, R, 2]
    # [K x C lanes, R, F]: a multiclass lane is (fold, class)
    col_masks = torch.from_numpy(np.stack([
        r[1] if C == 1 else r[1].transpose(1, 0, 2) for r in rand]).reshape(K * C, R, n_f)
    ).to(dev)
    if p.dart_rate > 0.0:
        drop = torch.from_numpy(np.stack([r[2] for r in rand])).to(dev)  # [K, R, R]
        return _fit_dart(binned_T, y, w, row_ids, binned_val_T, yv, vmask, p, objective,
                         k_sub, col_masks, drop, grow, predict, buffers, gather_val)
    if C > 1:
        # one copy per fit of each fold's bins for its class lanes
        binned_T = binned_T.repeat_interleave(C, dim=0)
        if has_val:
            binned_val_T = binned_val_T.repeat_interleave(C, dim=0)
    L = K * C
    val_metric = VAL_METRICS["mlogloss" if C > 1 else p.eval_metric]

    bufs = buffers(L, R, dev)
    metrics = torch.full((K, R), torch.inf if has_val else torch.nan, device=dev)
    gain_sum = torch.zeros(K, n_f, dtype=torch.float32, device=dev)
    margin = torch.full((L, n), p.base_score, dtype=torch.float32, device=dev)
    margin_val = torch.full((L, nv), p.base_score, dtype=torch.float32, device=dev)
    early = has_val and early_stop > 0
    i = torch.zeros(K, dtype=torch.long, device=dev)
    best_i = torch.zeros(K, dtype=torch.long, device=dev)
    best_m = torch.full((K,), torch.inf, device=dev)
    best_mv = torch.zeros(L, nv, dtype=torch.float32, device=dev)
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

        if C > 1:
            grad, hess = _softmax_grad_hess(margin.view(K, C, n), y, w)
        else:
            grad, hess = objective(margin, y, w)
        if p.subsample < 1.0:
            # one row sample per fold, shared by its class trees
            m = _row_subsample_mask(k_sub[:, r], row_ids, p.subsample)
            m = m[:, None] if C > 1 else m
            grad = torch.where(m, grad, 0.0)
            hess = torch.where(m, hess, 0.0)
        gh = torch.stack([grad, hess], dim=-1).reshape(L, n, 2)
        tree, gains, node = grow(binned_T, gh, col_masks[:, r])
        new_margin = margin + torch.gather(tree[-1], 1, node)

        a1 = active.repeat_interleave(C)[:, None]
        margin = torch.where(a1, new_margin, margin)
        for buf, t in zip(bufs, tree):
            buf[:, r] = torch.where(a1, t, buf[:, r])
        if C > 1:  # the class trees' gains, added in class order
            gains = gains.view(K, C, n_f)
            gains = functools.reduce(torch.add, gains.unbind(1))
        gain_sum = torch.where(active[:, None], gain_sum + gains, gain_sum)
        if not has_val:
            continue
        new_mv = margin_val + predict(tree, binned_val_T)
        metric = val_metric(new_mv.view(K, C, nv) if C > 1 else new_mv, yv, vmask, gather_val)
        margin_val = torch.where(a1, new_mv, margin_val)
        metrics[:, r] = torch.where(active, metric, metrics[:, r])
        if early:
            # XGBoost first-stop semantics, frozen per fold
            better = (metric < best_m) & ~stopped & active
            stopped = torch.where(active, stopped | (~better & (i - best_i >= early_stop)),
                                  stopped)
            best_m = torch.where(better, metric, best_m)
            best_i = torch.where(better, i, best_i)
            best_mv = torch.where(better.repeat_interleave(C)[:, None], new_mv, best_mv)
            i = torch.where(active, i + 1, i)

    if not early:
        best_mv = torch.full_like(best_mv, torch.nan)
    if C > 1:  # lanes back to [K, R, C, ...] (and [K, C, Nv])
        bufs = [b.view(K, C, *b.shape[1:]).transpose(1, 2).contiguous() for b in bufs]
        best_mv = best_mv.view(K, C, nv)
    forest = LGForest(*bufs) if p.grow_policy == "lossguide" else Forest(*bufs)
    return forest, gain_sum, metrics.cpu().numpy(), best_mv.cpu().numpy()


def _fit_dart(binned_T, y, w, row_ids, binned_val_T, yv, vmask, p: GBDTParams, objective,
              k_sub, col_masks, drop_cand, grow, predict, buffers, gather_val=None):
    """DART over K lanes (the JAX package's ``_fit_dart``): per-tree
    contributions c_train [K, R, N] and c_val [K, R, Nv] and a scale per
    tree [K, R]. Round r drops each earlier tree that ``drop_cand`` [K, R,
    R] marks, fits against ``keep_scale . c_train + base_score``, then
    scales the k dropped trees by k / (k + 1) and gives the new tree 1 / (k
    + 1). Every round runs; the metric is the validation logloss of the
    full scaled sum; the final scales are folded into the leaves. Returns
    what ``_fit_impl`` returns, with NaN validation margins."""
    K, n_f, n = binned_T.shape
    dev = binned_T.device
    R = p.n_rounds
    has_val = binned_val_T is not None
    nv = binned_val_T.shape[2] if has_val else 1
    bufs = buffers(K, R, dev)
    c_train = torch.zeros(K, R, n, dtype=torch.float32, device=dev)
    c_val = torch.zeros(K, R, nv, dtype=torch.float32, device=dev)
    scale = torch.zeros(K, R, dtype=torch.float32, device=dev)
    metrics = torch.full((K, R), torch.nan, device=dev)
    gain_sum = torch.zeros(K, n_f, dtype=torch.float32, device=dev)
    for r in range(R):
        # only trees < r can drop, and only they contribute
        drop = drop_cand[:, r, :r]
        k = drop.sum(dim=1).to(torch.float32)[:, None]
        keep_scale = torch.where(drop, 0.0, scale[:, :r])
        margin = xla_cpu.scaled_sum(keep_scale, c_train[:, :r]) + p.base_score
        grad, hess = objective(margin, y, w)
        if p.subsample < 1.0:
            m = _row_subsample_mask(k_sub[:, r], row_ids, p.subsample)
            grad = torch.where(m, grad, 0.0)
            hess = torch.where(m, hess, 0.0)
        gh = torch.stack([grad, hess], dim=-1).contiguous()
        tree, gains, node = grow(binned_T, gh, col_masks[:, r])

        scale[:, :r] = torch.where(drop, scale[:, :r] * k / (k + 1.0), scale[:, :r])
        scale[:, r] = 1.0 / (k[:, 0] + 1.0)
        c_train[:, r] = torch.gather(tree[-1], 1, node)
        for buf, t in zip(bufs, tree):
            buf[:, r] = t
        gain_sum = gain_sum + gains
        if has_val:
            c_val[:, r] = predict(tree, binned_val_T)
            full_val = xla_cpu.scaled_sum(scale[:, :r + 1], c_val[:, :r + 1]) + p.base_score
            metrics[:, r] = _val_logloss(full_val, yv, vmask, gather_val)
    bufs[-1] = bufs[-1] * scale[:, :, None]
    forest = LGForest(*bufs) if p.grow_policy == "lossguide" else Forest(*bufs)
    best_mv = np.full((K, nv), np.nan, np.float32)
    return forest, gain_sum, metrics.cpu().numpy(), best_mv


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
            forest=type(forest)(*[a[k] for a in forest]), bin_spec=spec, params=params,
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
               hist_fn: Optional[HistFn] = None,
               seg_hist_fn: SegHistFn = hist_cuda.build_seg_histograms) -> GBDTModel:
    """Fit one boosted-tree model (``xgb.train`` with the reference's
    parameter surface). ``hist_fn`` builds a depthwise fit's level
    histograms (None: the wrapper ``params.hist_dtype`` names, K1 by
    default), ``seg_hist_fn`` a leaf-wise fit's (the K3 wrapper); either
    may be a plain version to compare the fit against."""
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
        objective, es, hist_fn, seg_hist_fn)
    return _models_from_fit(forest, gains, metrics, best_mv, [bin_spec], params,
                            has_val, early_stopping_rounds)[0]


def _stack_folds(folds, params: GBDTParams, pad_rows_to: int, pad_val_rows_to: int,
                 dev: torch.device, block: Optional[tuple] = None):
    """Bin every fold and stack them on a leading fold axis, padded to
    shared row counts (zero weight / masked). Folds that are row subsets of
    one shared parent matrix (``X_parent``, ``tr_idx``, ``va_idx``) bin
    from one global sort and one device gather; others bin on their own.

    ``block`` = (lo, hi, vlo, vhi): keep only the padded training rows
    [lo, hi) and validation rows [vlo, vhi) (a rank's block of a mesh;
    the bin edges still come from every row of the fold, and ``row_ids``
    are the global ones).

    Returns (dict of [K, ...] tensors, bin specs)."""
    K = len(folds)
    lo, hi, vlo, vhi = block or (0, pad_rows_to, 0, pad_val_rows_to)
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
        if block is not None:  # this rank's rows alone
            idx = np.concatenate([idx[:, lo:hi], idx[:, pad_rows_to + vlo:pad_rows_to + vhi]], 1)
        binned = apply_bins_folds_gather(
            torch.as_tensor(Xp, device=dev), torch.stack([s.edges for s in specs]),
            torch.as_tensor(idx, device=dev), params.n_bins)
        binned_tr, binned_va = binned[:, :hi - lo], binned[:, hi - lo:]
    else:
        specs, tr, va = [], [], []
        for f, wb in zip(folds, w_bases):
            spec = fit_bins(np.asarray(f["X"], np.float32), params.n_bins,
                            sample_weight=wb, device=dev)
            specs.append(spec)
            for X, a, b, out in ((f["X"], lo, hi, tr), (f["X_val"], vlo, vhi, va)):
                Xb = np.asarray(X, np.float32)[a:b]
                binned = apply_bins(spec, torch.as_tensor(Xb, device=dev))
                out.append(_pad_rows(binned.to(torch.int16), b - a))
        binned_tr, binned_va = torch.stack(tr), torch.stack(va)

    def stack(key, n_to, a, b, fill=0.0, dtype=np.float32):
        return torch.as_tensor(np.stack([
            np.concatenate([v, np.full(n_to - len(v), fill, dtype)])[a:b]
            for v in key]), device=dev)

    # scale_pos_weight enters the objective through the weights, not the
    # bin edges (float64 on the host, then float32, as the JAX package)
    ws = [(wb * np.where(np.asarray(f["y"], np.float32) > 0.5, f.get("spw", 1.0), 1.0)
           ).astype(np.float32) for f, wb in zip(folds, w_bases)]
    arrs = {
        "binned_T": binned_tr.transpose(1, 2).contiguous(),
        "binned_val_T": binned_va.transpose(1, 2).contiguous(),
        "y": stack([np.asarray(f["y"], np.float32) for f in folds], pad_rows_to, lo, hi),
        "w": stack(ws, pad_rows_to, lo, hi),
        "yv": stack([np.asarray(f["y_val"], np.float32) for f in folds], pad_val_rows_to,
                    vlo, vhi),
        "vmask": stack([np.ones(len(f["y_val"]), bool) for f in folds], pad_val_rows_to,
                       vlo, vhi, False, bool),
        "row_ids": torch.arange(lo, hi, device=dev).expand(K, hi - lo),
    }
    return arrs, specs


def train_gbdt_folds(folds, params: GBDTParams, objective: Optional[Objective] = None,
                     early_stopping_rounds: Optional[int] = None,
                     pad_rows_to: Optional[int] = None,
                     pad_val_rows_to: Optional[int] = None, device: DeviceLike = None,
                     hist_fn: Optional[HistFn] = None,
                     seg_hist_fn: SegHistFn = hist_cuda.build_seg_histograms
                     ) -> List[GBDTModel]:
    """Train every CV fold as ONE batched fit (a leading fold axis on every
    tensor; one level-histogram launch per level, or one K3 launch per
    leaf-wise split step, covers all folds). ``hist_fn`` as in
    ``train_gbdt``.

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
        objective, es, hist_fn, seg_hist_fn)
    return _models_from_fit(forest, gains, metrics, best_mv, specs, params, True,
                            early_stopping_rounds)


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------

def predict_margin_folds(forest, binned: torch.Tensor,
                         n_trees: torch.Tensor, missing_id: int, depth: int,
                         base_score: float = 0.0) -> torch.Tensor:
    """Margins [K, N] of K stacked fold forests ([K, R, ...]) on a binned
    matrix, shared [N, F] or one per fold [K, N, F]. Tree r of fold k
    counts only when r < n_trees[k] (the early-stopping
    ``best_iteration + 1`` truncation). Every tree of every fold routes at
    once, one level at a time, over a [K, N, R] node tensor: ``depth`` + 1
    heap levels of a ``Forest`` (depth = max_depth), ``depth``
    pointer-chasing steps of an ``LGForest`` (depth = ``lossguide_steps``).

    A multiclass forest ([K, R, C, ...]) routes its classes as lanes and
    returns [K, N, C]."""
    if forest.feature.dim() == 4:
        K, R, C = forest.feature.shape[:3]
        lanes = type(forest)(*[a.transpose(1, 2).reshape(K * C, R, *a.shape[3:])
                               for a in forest])
        b = binned if binned.dim() == 2 else binned.repeat_interleave(C, dim=0)
        m = predict_margin_folds(lanes, b, n_trees.repeat_interleave(C), missing_id, depth,
                                 base_score)
        return m.view(K, C, -1).transpose(1, 2)
    K, R, n_internal = forest.feature.shape
    N = binned.shape[-2]
    dev = binned.device
    b = binned.long()
    if b.dim() == 2:
        b = b.unsqueeze(0).expand(K, N, -1)
    kk = torch.arange(K, device=dev)[:, None, None]
    rr = torch.arange(R, device=dev)[None, None, :]
    node = torch.zeros(K, N, R, dtype=torch.long, device=dev)
    lossguide = isinstance(forest, LGForest)
    for _ in range(depth if lossguide else depth + 1):
        cn = node if lossguide else node.clamp(0, n_internal - 1)
        feat = forest.feature[kk, rr, cn].long()  # [K, N, R]
        bv = torch.gather(b, 2, feat)
        go_left = torch.where(bv == missing_id, forest.default_left[kk, rr, cn],
                              bv <= forest.split_bin[kk, rr, cn])
        if lossguide:
            child = torch.where(go_left, forest.left[kk, rr, cn],
                                forest.right[kk, rr, cn]).long()
            stays = forest.is_leaf[kk, rr, cn]
        else:
            child = 2 * node + torch.where(go_left, 1, 2)
            stays = (node >= n_internal) | forest.is_leaf[kk, rr, cn]
        node = torch.where(stays, node, child)
    leaf = forest.leaf_value[kk, rr, node]  # [K, N, R]
    live = torch.arange(R, device=dev)[None, :] < n_trees.to(dev)[:, None]  # [K, R]
    leaf = torch.where(live[:, None, :], leaf, 0.0)
    return base_score + leaf.sum(dim=2)


# rows per prediction chunk: the routing holds [K, chunk, R] node tensors
PREDICT_CHUNK = 2048


def predict_margin_models(models: Sequence[GBDTModel], X) -> torch.Tensor:
    """Margins [K, N] ([K, N, C] for multiclass models) of K same-config
    fold models on one float matrix [N, F], or on one matrix per fold (a
    sequence of [N_k, F], padded to the longest with NaN rows), each fold
    binning with its own edges, in row chunks."""
    p = models[0].params
    forest = stack_forests([m.forest for m in models])
    n_trees = torch.tensor([m.n_trees for m in models])
    depth = lossguide_steps(p) if isinstance(forest, LGForest) else p.max_depth
    if not torch.is_tensor(X):
        n_max = max(x.shape[0] for x in X)
        X = torch.stack([torch.cat([x, x.new_full((n_max - x.shape[0], x.shape[1]),
                                                  float("nan"))]) for x in X])
    out = []
    for s in range(0, X.shape[-2], PREDICT_CHUNK):
        Xc = X[..., s:s + PREDICT_CHUNK, :]
        binned = torch.stack([apply_bins(m.bin_spec, Xc if Xc.dim() == 2 else Xc[k])
                              for k, m in enumerate(models)])
        out.append(predict_margin_folds(forest, binned, n_trees, p.n_bins, depth,
                                        p.base_score))
    return torch.cat(out, dim=1)


def predict_proba(model: GBDTModel, X, n_trees: Optional[int] = None) -> torch.Tensor:
    """[N] sigmoid probabilities, or [N, C] softmax ones for a multiclass
    model, on a float matrix [N, F]; ``n_trees`` overrides the model's
    best-iteration truncation."""
    if n_trees is not None:
        model = model._replace(best_iteration=n_trees - 1)
    if not torch.is_tensor(X):
        X = torch.as_tensor(np.asarray(X, np.float32), device=model.bin_spec.edges.device)
    m = predict_margin_models([model], X)[0]
    if model.params.num_class >= 2:
        return torch.softmax(m, dim=-1)
    return torch.sigmoid(m)


def predict_proba_folds(models: Sequence[GBDTModel], X) -> np.ndarray:
    """[K, N] sigmoid probabilities of K same-config binary fold models on
    one float matrix [N, F] (numpy, or a tensor on the models' device),
    as a host array."""
    if not torch.is_tensor(X):
        X = torch.as_tensor(np.asarray(X, np.float32),
                            device=models[0].bin_spec.edges.device)
    return torch.sigmoid(predict_margin_models(models, X)).cpu().numpy()
