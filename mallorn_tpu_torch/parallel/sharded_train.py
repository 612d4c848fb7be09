"""GBDT training with rows split over the ranks of a mesh (port of
``mallorn_tpu.parallel.sharded_train``).

The contract is the JAX package's, kept bit for bit: the same trees as
single-device training. Every rank bins with the global edges
(``fit_bins`` over every row of a fold), keeps its contiguous block of
rows, and runs the port's one fit (``trees.gbdt._fit_impl``) through its
hooks (``mesh_fit_fns``), one collective for each of the JAX package's
``_psum`` sites (``mallorn_tpu/trees/gbdt.py:179-180``):

- level and segment histograms (K1, K3): the per-lane max |g| and max |h|
  are max-reduced over the ranks (a non-finite lane as +inf; once a tree,
  since every level and leaf-wise step takes the same (g, h)), each rank
  runs the kernel's external-scale entry on its rows at that global scale
  and the global row count, the int64 sums are sum-reduced (exact, in any
  order) and converted once. The histograms are then the single-device
  ones bit for bit, on every rank, and so are histogram subtraction, the
  splits and a leaf-wise tree's node sums, which come from K3's
  histograms;
- a depthwise tree's terminal leaf sums and each validation metric's sum:
  the JAX package psums float32 partial sums, whose last bits depend on
  the split of the rows, and a near-tie split then flips (on an H100 in
  the v92d CV within 50 rounds). Here each rank's terms (the rows' leaf
  beside their (g, h), the validation rows' losses beside their mask) are
  all-gathered, one collective for each pair, a few bytes
  a row against the histograms' hundreds of kilobytes a feature, and
  summed over the single-device rows in the single-device order, so
  early stopping's one host sync per round reads the same value, and
  takes the same branch, on every rank.

Row subsampling is keyed by the global row id, so subsample < 1 draws the
single-device rows. Validation rows split like training rows; the
best-iteration margins are gathered back in row order.

The histogram modes K4 / K5 (``hist_dtype`` "bf16", "i8bf16", "int8")
find per-fold digit scales that a mesh would have to agree on too; under a
mesh they raise.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.parallel.mesh import Mesh
from mallorn_tpu_torch.trees import objectives
from mallorn_tpu_torch.trees.binning import BinSpec, apply_bins, fit_bins
from mallorn_tpu_torch.trees.gbdt import (GBDTModel, GBDTParams, _fit_impl, _models_from_fit,
                                          _stack_folds, _train_tree)


def check_mesh_params(params: GBDTParams) -> None:
    """Raise on a fit the mesh does not run: a depthwise or symmetric fit
    in a histogram mode other than "i8full" (K1)."""
    if params.grow_policy != "lossguide" and params.hist_dtype != "i8full":
        raise ValueError(f"hist_dtype {params.hist_dtype!r} does not run on a mesh: its "
                         f"per-fold digit scales are not agreed over ranks; use 'i8full'")


def gather_fn(mesh: Mesh, n: int) -> Callable:
    """``gather(*ts)``: each of a rank's [K, rows, ...] tensors -> every
    rank's rows in row order, the first ``n`` (the single-device count)
    [K, n, ...], contiguous (a reduction's order follows the memory
    layout). The tensors (float32, int32 or bool) travel in one
    all-gather, side by side as 32-bit words (a float32 bit-cast, a bool
    widened), and come back bit for bit in their own dtypes."""

    def gather(*ts):
        if any(t.dtype not in (torch.float32, torch.int32, torch.bool) for t in ts):
            raise TypeError(f"gather: float32, int32 or bool, got {[t.dtype for t in ts]}")
        cols = [t.reshape(t.shape[0], t.shape[1], -1) for t in ts]
        words = torch.cat([c.view(torch.int32) if c.dtype == torch.float32 else c.to(torch.int32)
                           for c in cols], dim=-1)
        got = mesh.all_gather(words.transpose(0, 1).contiguous()).transpose(0, 1)[:, :n]
        out, at = [], 0
        for t, c in zip(ts, cols):
            w = got[..., at:at + c.shape[-1]].contiguous()
            at += c.shape[-1]
            w = w.view(torch.float32) if t.dtype == torch.float32 else w.to(t.dtype)
            out.append(w.reshape((t.shape[0], n) + tuple(t.shape[2:])))
        return out[0] if len(out) == 1 else tuple(out)

    return gather


def mesh_fit_fns(mesh: Mesh, n_rows: int, n_val: int = 0):
    """(hist_fn, seg_hist_fn, gather_rows, gather_val) of a fit whose
    ``n_rows`` training and ``n_val`` validation rows (the single-device
    counts) are split over ``mesh``: K1 and K3 through their external-scale
    int64 entries at the global scale, reduced over the ranks, and the row
    gathers of the leaf sums and the validation metrics."""
    last = []  # [gh, its version, its lanes' global maxima]

    def scale(gh):
        # gh is the same tensor at every level of a tree and every step of
        # a leaf-wise one: its lanes' maxima are reduced once a tree
        if not last or last[0] is not gh or last[1] != gh._version:
            last[:] = gh, gh._version, mesh.all_reduce(hist_cuda.lane_maxabs(gh).contiguous(),
                                                       "max")
        return last[2]

    def hist_fn(binned_T, node_q, gh, k_nodes, n_bins_tot):
        m = scale(gh)
        s = hist_cuda.build_histograms_i64(binned_T, node_q, gh, k_nodes, n_bins_tot, m, n_rows)
        return hist_cuda.from_fixed_sums(mesh.all_reduce(s), m, n_rows)

    def seg_hist_fn(binned_T, seg_base, gh, n_seg):
        m = scale(gh)
        s = hist_cuda.build_seg_histograms_i64(binned_T, seg_base, gh, n_seg, m, n_rows)
        return hist_cuda.from_fixed_sums(mesh.all_reduce(s), m, n_rows)

    return hist_fn, seg_hist_fn, gather_fn(mesh, n_rows), gather_fn(mesh, n_val)


def _block(a: np.ndarray, lo: int, hi: int, fill) -> np.ndarray:
    """Rows [lo, hi) of ``a``, padded with ``fill`` past its end."""
    part = a[lo:hi]
    pad = np.full((hi - lo - len(part),) + a.shape[1:], fill, a.dtype)
    return np.concatenate([part, pad])


def make_sharded_training_step(mesh: Mesh, params: GBDTParams, feature_names,
                               bin_spec: BinSpec) -> Callable:
    """Returns ``step(packed, y, w, margin) -> (tree, new_margin)``: one
    distributed boosting round. ``packed``, ``y`` and ``w`` are the whole
    set, as every rank holds it; ``margin`` and ``new_margin`` are this
    rank's block of objects (``mesh.block``). Shard-local statistical
    features and binning, histograms reduced over the mesh, the same tree
    on every rank, a shard-local margin update."""
    from mallorn_tpu_torch.features import statistical
    from mallorn_tpu_torch.features.base import feature_matrix

    check_mesh_params(params)
    dev = mesh.device

    def step(packed, y, w, margin):
        n = packed.n_objects
        lo, hi, _ = mesh.block(n)
        idx = torch.arange(lo, hi, device=dev)
        real = idx < n
        sub = packed.map(lambda x: x[idx.clamp(max=n - 1).to(x.device)].to(dev))
        X, _ = feature_matrix(statistical.extract(sub), list(feature_names))
        binned_T = apply_bins(bin_spec, X).to(torch.int16).T.contiguous()[None]
        yb = torch.as_tensor(y, dtype=torch.float32, device=dev)[idx.clamp(max=n - 1)]
        wb = torch.where(real, torch.as_tensor(w, dtype=torch.float32,
                                               device=dev)[idx.clamp(max=n - 1)], 0.0)
        grad, hess = objectives.logistic(margin[None], yb[None], wb[None])
        gh = torch.stack([grad, hess], dim=-1).contiguous()
        col_mask = torch.ones(1, binned_T.shape[1], dtype=torch.bool, device=dev)
        hist_fn, _, gather_rows, _ = mesh_fit_fns(mesh, n)
        tree, _, node = _train_tree(binned_T, gh, col_mask, params, hist_fn,
                                    params.grow_policy == "symmetric", gather_rows)
        new_margin = margin + torch.gather(tree[-1], 1, node)[0]
        return tuple(t[0] for t in tree), new_margin

    return step


def train_gbdt_sharded(mesh: Mesh, X, y, params: GBDTParams,
                       sample_weight: Optional[np.ndarray] = None,
                       scale_pos_weight: float = 1.0) -> GBDTModel:
    """``train_gbdt`` with its rows split over the mesh: global bin edges,
    histograms reduced over the ranks, the same model on every rank, equal
    to single-device training bit for bit."""
    check_mesh_params(params)
    dev = mesh.device
    X = np.asarray(X, np.float32)
    n = len(X)
    lo, hi, _ = mesh.block(n)
    y = np.asarray(y, np.float32)
    w_base = (np.ones(n, np.float32) if sample_weight is None
              else np.asarray(sample_weight, np.float32))
    bin_spec = fit_bins(X, params.n_bins, sample_weight=w_base, device=dev)
    yb = torch.as_tensor(_block(y, lo, hi, 0.0), device=dev)
    spw = torch.tensor(scale_pos_weight, dtype=torch.float32, device=dev)
    wb = torch.as_tensor(_block(w_base, lo, hi, 0.0), device=dev) * torch.where(yb > 0.5, spw, 1.0)
    Xb = torch.as_tensor(_block(X, lo, hi, np.nan), device=dev)
    binned_T = apply_bins(bin_spec, Xb).to(torch.int16).T.contiguous()[None]
    row_ids = torch.arange(lo, hi, device=dev)[None]
    forest, gains, metrics, best_mv = _fit_impl(
        binned_T, yb[None], wb[None], row_ids, None, None, None, [params.seed], params,
        objectives.logistic, 0, *mesh_fit_fns(mesh, n))
    return _models_from_fit(forest, gains, metrics, best_mv, [bin_spec], params, False,
                            None)[0]


def train_gbdt_folds_sharded(mesh: Mesh, folds, params: GBDTParams, objective=None,
                             early_stopping_rounds: Optional[int] = None,
                             pad_rows_to: Optional[int] = None,
                             pad_val_rows_to: Optional[int] = None):
    """``train_gbdt_folds`` with every fold's rows split over the mesh
    (the folds still one batched fit on each rank): global bin edges per
    fold, each rank binning its block of training and validation rows,
    histograms and metrics reduced over the ranks, the best-iteration
    validation margins gathered back in row order. Returns one model per
    fold, equal to ``train_gbdt_folds``'s bit for bit."""
    check_mesh_params(params)
    dev = mesh.device
    objective = objective or objectives.logistic
    pr = pad_rows_to or max(len(f["y"]) for f in folds)
    pv = pad_val_rows_to or max(len(f["y_val"]) for f in folds)
    lo, hi, pr_mesh = mesh.block(pr)
    vlo, vhi, pv_mesh = mesh.block(pv)
    arrs, specs = _stack_folds(folds, params, pr_mesh, pv_mesh, dev, block=(lo, hi, vlo, vhi))
    es = int(early_stopping_rounds or 0)
    forest, gains, metrics, best_mv = _fit_impl(
        arrs["binned_T"], arrs["y"], arrs["w"], arrs["row_ids"], arrs["binned_val_T"],
        arrs["yv"], arrs["vmask"], [f.get("seed", params.seed) for f in folds], params,
        objective, es, *mesh_fit_fns(mesh, pr, pv))
    if es:  # each rank's block of validation rows, back in row order
        mv = torch.from_numpy(best_mv).to(dev).movedim(-1, 0).contiguous()
        best_mv = mesh.all_gather(mv)[:pv].movedim(0, -1).cpu().numpy()
    return _models_from_fit(forest, gains, metrics, best_mv, specs, params, True,
                            early_stopping_rounds)


# ------------------------------------------------------- comm observability

def comm_volume_report(mesh: Mesh, n_rows: int, n_features: int,
                       params: GBDTParams) -> dict:
    """The collectives of one boosting round of a sharded fit, measured by
    running a one-round ``train_gbdt_sharded`` on random rows under the
    mesh's call log (the JAX package parses them from compiled HLO).

    Returns {collectives: [(kind, "dtype[shape]", bytes)],
    psum_bytes_per_round: the bytes of every all-reduce of the round,
    gathered_bytes_per_round: those of every all-gather (the leaf sums'
    rows), rows_resharded: whether any collective carried a row-length
    tensor, n_devices}."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    lo, hi, n_pad = mesh.block(n_rows)
    with mesh.record() as calls:
        train_gbdt_sharded(mesh, X, y, params._replace(n_rounds=1))
    row_dims = {n_rows, n_pad, hi - lo}
    resharded = any(int(d) in row_dims for _, s, _ in calls
                    for d in s[s.index("[") + 1:-1].split(",") if d)
    return {"collectives": list(calls),
            "psum_bytes_per_round": sum(b for k, _, b in calls if k.startswith("all_reduce")),
            "gathered_bytes_per_round": sum(b for k, _, b in calls if k == "all_gather"),
            "rows_resharded": resharded, "n_devices": mesh.size}
