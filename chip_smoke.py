#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mallorn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its wall time on its own line:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: every CUDA source of the port, with plain ``nvcc``;
3. kernel checks: the Cholesky-inverse kernel against its plain PyTorch
   version (float32 and float64) at B=2048, T=64/128/160/192 and a ragged
   B=2047, T=72, a non-SPD matrix giving NaN, and times (kernel, plain,
   a two-call library yardstick, the roofline bound);
4. serving: the 7,124-object test split of ``.bench_data_v2.npz`` through
   ``V92dServer`` at full v92d width (5 folds x 500 trees of depth 5 over
   222 columns, random weights from a fixed seed, bin edges fitted on the
   served matrix), as 4 requests of <= 2048 objects with 100 GP steps;
   the kernel's launch count must equal the GP schedule's prediction;
5. reference: 128 of those objects through the server's feature
   families on the CPU (the kernels' plain versions) and through bin +
   forest on both devices; each column must agree within its family's
   stated gate;
6. histogram kernel checks: the depthwise level-histogram kernel (K1)
   against its plain version (float32 and float64, and bit for bit against
   its fixed-point arithmetic in plain PyTorch) at the three fit shapes of
   training and every node count they use, a ragged row count with
   inactive rows, two launches of each bit for bit equal, and times
   (kernel, plain, a one-call ``scatter_add_`` yardstick, the bound);
7. kernel against plain in training: a 600 x 30 fixture (NaNs, subsample
   and colsample 0.8, 20 rounds of depth 5) fitted with K1 twice and once
   with the kernel's fixed-point arithmetic in plain PyTorch: the three
   forests bit for bit equal;
8. training: the 10,178-object v92d workload of ``.bench_data_v2.npz``
   (``train_v92d``: features of both splits, the top-120 selection CV,
   assembly, adversarial weights, the 5-fold v92d CV, the threshold sweep)
   with the seconds of each stage; OOF F1 must reach 0.633 and the K1
   launch count must equal the rounds each fit ran times its depth.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. With no CUDA device, or without the
``mallorn_tpu_torch`` package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mallorn_tpu_torch.data.packing import Metadata, pack_lightcurves, unify_time_padding
from mallorn_tpu_torch.features import multiband_gp
from mallorn_tpu_torch.io.model_store import GBDTModel, forest_from_numpy
from mallorn_tpu_torch.ops import chol_cuda, hist_cuda
from mallorn_tpu_torch.features.base import merge
from mallorn_tpu_torch.serving import (SHIFT_FEATURES, V92dServer,
                                       assemble_v34a_matrix, drop_shift_features,
                                       extract_bundle)
from mallorn_tpu_torch.train.adversarial import ADV_PARAMS
from mallorn_tpu_torch.train.pipelines import train_v92d
from mallorn_tpu_torch.trees.binning import fit_bins
from mallorn_tpu_torch.trees.gbdt import V34A_PARAMS, GBDTParams, train_gbdt
from mallorn_tpu_torch.utils import cuda_build
from mallorn_tpu_torch.utils.constants import LSST_BANDS

ROOT = Path(__file__).resolve().parent
DATA = ROOT / ".bench_data_v2.npz"
WATCHDOG_S = 1100  # a hang dumps its stack and exits non-zero

# H100 SXM data sheet: HBM rate and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

N_FOLDS, N_TREES, DEPTH, N_COLS, N_SELECTED = 5, 500, 5, 222, 120
GP_STEPS = 100
REQUEST = 2048  # objects per served request
SEED = 92

# tolerances: the JAX package's own bars for this kernel
# (tests/test_chol_pallas.py), |a - b| <= atol + rtol |b| elementwise
TOL = {"linv": (5e-5, 5e-5), "logdet": (1e-5, 1e-4), "kinv": (1e-4, 1e-5),
       "alpha": (1e-4, 1e-4)}

# the level histogram (K1): the JAX package's bar for its histogram
# kernels (tests/test_hist_pallas.py:56), rtol / atol
HIST_TOL = (1e-5, 1e-4)
N_BINS_TOT = V34A_PARAMS.n_bins + 1
# training's fit shapes, all 5 folds in one launch: (fit, K, F, N padded
# fold rows, node counts of the levels built with subtraction)
HIST_SHAPES = (("selection", 5, 307, 2444, (1, 1, 2, 4, 8)),
               ("adversarial", 5, 222, 8143, (1, 1, 2)),
               ("v92d", 5, 222, 2444, (1, 1, 2, 4, 8)))
# OOF F1 gate: the JAX package's lowest recorded OOF F1 on this data
# (0.6702) less the reference's fold-F1 std (0.0375)
F1_GATE = 0.633


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        log(f"== phase {self.name}: {time.perf_counter() - self.t0:.3f} s")
        return False


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def close(a, b, rtol, atol):
    """(max |a-b|, max |a-b|/max|b|, within tolerance) over finite b."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    ok = bool((d <= atol + rtol * b.abs()).all())
    return d.max().item(), (d.max() / b.abs().max().clamp(min=1e-30)).item(), ok


def spd_batch(B: int, T: int, seed: int) -> torch.Tensor:
    """Seeded SPD [B, T, T] float64 (A A^T / T + I) with the last 0..T/4
    rows and columns of each matrix identity-padded, as the GP's masks do."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(B, T, T, generator=g, device="cuda", dtype=torch.float64)
    K = A @ A.transpose(1, 2) / T + torch.eye(T, device="cuda", dtype=torch.float64)
    n_pad = torch.randint(0, T // 4 + 1, (B,), generator=g, device="cuda")
    keep = torch.arange(T, device="cuda")[None, :] < (T - n_pad)[:, None]
    mm = keep[:, :, None] & keep[:, None, :]
    eye = torch.eye(T, device="cuda", dtype=torch.float64).expand(B, T, T)
    return torch.where(mm, K, eye)


def check_kernel(B: int, T: int, seed: int) -> dict:
    K64 = spd_batch(B, T, seed)
    K = K64.float().contiguous()
    r = torch.randn(B, T, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                    device="cuda", dtype=torch.float32)
    Linv, ld = chol_cuda.chol_inv(K)
    torch.cuda.synchronize()
    Lp, ldp = chol_cuda.chol_inv_plain(K)
    L64, ld64 = chol_cuda.chol_inv_plain(K.double())
    Kinv = torch.matmul(Linv.transpose(1, 2), Linv)
    Kinv64 = torch.matmul(L64.transpose(1, 2), L64)
    alpha = torch.matmul(Kinv, r.unsqueeze(-1)).squeeze(-1)
    alpha64 = torch.matmul(Kinv64, r.double().unsqueeze(-1)).squeeze(-1)
    rows = {
        "linv_vs_plain": close(Linv, Lp, *TOL["linv"]),
        "linv_vs_f64": close(Linv, L64, *TOL["linv"]),
        "logdet_vs_plain": close(ld, ldp, *TOL["logdet"]),
        "logdet_vs_f64": close(ld, ld64, *TOL["logdet"]),
        "kinv_vs_f64": close(Kinv, Kinv64, *TOL["kinv"]),
        "alpha_vs_f64": close(alpha, alpha64, *TOL["alpha"]),
    }
    for name, (abs_e, rel_e, ok) in rows.items():
        tol = TOL[name.split("_")[0]]
        log(f"  B={B} T={T} {name}: max_abs={abs_e:.3e} max_rel={rel_e:.3e} "
            f"(rtol={tol[0]:g}, atol={tol[1]:g}) {'ok' if ok else 'FAIL'}")
    bad = [n for n, (_, _, ok) in rows.items() if not ok]
    if bad:
        raise AssertionError(f"chol_inv B={B} T={T} outside tolerance: {bad}")

    eye = torch.eye(T, device="cuda").expand(B, T, T)

    def library():
        L, _ = torch.linalg.cholesky_ex(K)
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        return Li, 2.0 * torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)

    ms = cuda_ms(lambda: chol_cuda.chol_inv(K), reps=20)
    plain_ms = cuda_ms(lambda: chol_cuda.chol_inv_plain(K), reps=2, warmup=1)
    library_ms = cuda_ms(library, reps=10)
    # K's lower triangle in (all the kernel reads), Linv and logdet out
    n_bytes = B * (T * (T + 1) // 2 + T * T) * 4 + B * 4
    n_flop = B * 2.0 * T ** 3 / 3.0  # Cholesky T^3/3 + triangular inverse T^3/3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flop = n_flop / F32_FLOP_PER_S * 1e3
    res = {"B": B, "T": T, "max_abs_err": rows["linv_vs_plain"][0], "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_flop),
           "bound_by": "bytes" if t_bytes >= t_flop else "operations"}
    log(f"  B={B} T={T} times: kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.4f} (cholesky_ex + solve_triangular against I: "
        f"a two-call yardstick the port never calls) bound_ms={res['bound_ms']:.4f} "
        f"({res['bound_by']}: {n_bytes / 1e6:.1f} MB, {n_flop / 1e9:.2f} GFLOP)")
    return res


def check_non_spd() -> None:
    K = spd_batch(4, 64, 7).float()
    K[1, 10, 10] = -1.0
    Linv, ld = chol_cuda.chol_inv(K.contiguous())
    torch.cuda.synchronize()
    Lp, ldp = chol_cuda.chol_inv_plain(K)
    nan_k = torch.isnan(ld).tolist()
    log(f"  non-SPD matrix 1 of 4: logdet={ld.tolist()} Linv has NaN: "
        f"{bool(torch.isnan(Linv[1]).any())}")
    if nan_k != [False, True, False, False] or not bool(torch.isnan(Linv[1]).any()):
        raise AssertionError("a non-positive pivot must give NaN in that matrix only")
    if torch.isnan(ldp).tolist() != nan_k:
        raise AssertionError("plain version disagrees on the NaN lanes")


def column_agreement(got: dict, want: dict, rtol: float) -> dict:
    """{column: share of its cells where the card and the CPU agree}: both
    NaN, or |a - b| <= rtol (|b| + the median |b| of the column's finite
    CPU cells)."""
    out = {}
    for k in want:
        a, b = got[k].cpu().double(), want[k].double()
        fin = b[torch.isfinite(b)].abs()
        typical = fin.median().item() if fin.numel() else 0.0
        close = (a - b).abs() <= rtol * (b.abs() + typical)
        close |= torch.isnan(a) & torch.isnan(b)
        out[k] = close.double().mean().item()
    return out


def load_test_split(device):
    with np.load(DATA, allow_pickle=False) as z:
        cols = {k: z[f"te_{k}"] for k in ("object_index", "time", "flux", "flux_err", "band")}
        n = len(z["te_object_ids"])
        zz, ebv = z["te_z"], z["te_ebv"]
    packed = pack_lightcurves(cols["object_index"], cols["time"], cols["flux"],
                              cols["flux_err"], cols["band"], n, device=device)
    return packed, zz, ebv


def requests(n: int):
    return [(s, min(s + REQUEST, n)) for s in range(0, n, REQUEST)]


def random_models(rng: np.random.Generator, X: np.ndarray, device) -> list:
    """5 v92d-shaped folds with random trees; each fold's bin edges are
    fitted (``fit_bins``) on a random 80% of the served matrix's rows."""
    n_int, n_heap = 2 ** DEPTH - 1, 2 ** (DEPTH + 1) - 1
    models = []
    for k in range(N_FOLDS):
        rows = rng.permutation(len(X))[: int(0.8 * len(X))]
        spec = fit_bins(X[rows], n_bins=V34A_PARAMS.n_bins, device=device)
        forest = forest_from_numpy(
            feature=rng.integers(0, N_COLS, (N_TREES, n_int)),
            split_bin=rng.integers(0, V34A_PARAMS.n_bins, (N_TREES, n_int)),
            default_left=rng.random((N_TREES, n_int)) < 0.5,
            is_leaf=rng.random((N_TREES, n_int)) < 0.03,
            leaf_value=rng.normal(0.0, V34A_PARAMS.learning_rate, (N_TREES, n_heap)),
            device=device)
        best = -1 if k % 2 == 0 else N_TREES - 1 - 37 * k  # early-stopped folds
        models.append(GBDTModel(forest=forest, bin_spec=spec, params=V34A_PARAMS,
                                best_iteration=best))
    return models


def expected_launches(n_objects: int, server) -> int:
    """K2 launches the GP schedule predicts for serving ``n_objects`` as the
    smoke run's requests: per request, gp_steps Adam steps + the final NLL,
    (phase 2: max(gp_steps // 6, 8) steps + its final NLL), + the predict."""
    n = server.gp_steps
    per_request = n + 1 + 1 + ((max(n // 6, 8) + 1) if server.gp_two_phase else 0)
    return per_request * len(requests(n_objects))


# (rtol, least share of each column's cells, least mean share over the
# family's columns). Closed-form families: the parity tests' rtol 1e-4 and
# the JAX package's per-column gate for them (tests/test_sharded_pipeline.py:
# 0.98; a value exactly at a threshold, such as interp_at's gap limit, can
# flip to NaN under last-digit differences). The 2D-GP (116 Adam steps) is
# an iterative fit whose float32 summation order moves some lanes: the GP
# family's gates of tests/test_torch_gp.py. Bazin's 40 LM iterations end
# on either side of a fit bifurcation for some lanes, and its cross-band
# consistency columns amplify one flipped band: its values are held at the
# JAX package's own gates for that (tests/test_sharded_pipeline.py), and
# its fits by their quality (``check_bazin_fit_quality``).
GATES = {"features_v4": (1e-4, 0.98, 0.98), "tde_physics": (1e-4, 0.98, 0.98),
         "multiband_gp": (2e-3, 0.90, 0.97), "bazin": (1e-3, 0.60, 0.90)}


def check_bazin_fit_quality(got: dict, want: dict) -> None:
    """The card's Bazin fits are as good as the CPU's, by the bar the port's
    parity test holds them to against the JAX package
    (tests/test_torch_features.py): per band, on >= 98% of the lanes the
    CPU fitted, the card's reduced chi^2 <= 1.05 x the CPU's + 0.5; the
    median ratio over all bands within [0.99, 1.01]."""
    ratios = []
    for band in LSST_BANDS:
        a = want[f"{band}_bazin_fit_chi2"].double()
        b = got[f"{band}_bazin_fit_chi2"].cpu().double()
        fit = torch.isfinite(a)
        share = (b[fit] <= a[fit] * 1.05 + 0.5).double().mean().item() if bool(fit.any()) else 1.0
        ratios.append(b[fit] / a[fit].clamp(min=1e-9))
        log(f"  bazin {band}: {int(fit.sum())} fitted lanes, {share:.4f} with the "
            f"card's chi^2 <= 1.05 x the CPU's + 0.5 (needs 0.98)")
        if share < 0.98:
            raise AssertionError(f"Bazin fits on the card are worse than the CPU's in {band}")
    med = torch.cat(ratios).median().item()
    log(f"  bazin: median chi^2 ratio card / CPU {med:.5f} (needs 0.99..1.01)")
    if not 0.99 <= med <= 1.01:
        raise AssertionError("Bazin fit quality on the card differs from the CPU's")


def reference_check(server, models, names, selected, packed, zz, ebv, m=128):
    """``m`` served objects through the server's feature families on the
    card and on the CPU (the kernels' plain versions), each column held
    to its family's gate (``GATES``), then the card's matrix through bin +
    forest on both devices."""
    cpu_server = V92dServer(models, names, selected, gp_steps=server.gp_steps,
                            gp_t_compact=server.gp_t_compact,
                            gp_two_phase=server.gp_two_phase, device="cpu")
    sub = packed.map(lambda x: x[:m])
    got_b = server.bundle(sub, zz[:m], ebv[:m])
    want_b = cpu_server.bundle(sub.to("cpu"), zz[:m], ebv[:m])
    for fam, (rtol, col_need, mean_need) in GATES.items():
        got, want = got_b[fam], want_b[fam]
        fracs = column_agreement(got, want, rtol)
        worst = sorted(fracs, key=fracs.get)[:3]
        mean = float(np.mean(list(fracs.values())))
        log(f"  {fam}: {len(fracs)} columns, mean {mean:.4f} of cells within "
            f"rtol {rtol:g} of the CPU (needs {mean_need:g}); worst columns "
            + ", ".join(f"{k} {fracs[k]:.4f}" for k in worst)
            + f" (each needs {col_need:g})")
        if list(got) != list(want) or fracs[worst[0]] < col_need or mean < mean_need:
            raise AssertionError(f"{fam} on the card disagrees with the CPU reference")
    check_bazin_fit_quality(got_b["bazin"], want_b["bazin"])
    # the same matrix through bin + forest on both devices
    full = merge({k: got_b["features_v4"][k] for k in selected}, got_b["tde_physics"],
                 got_b["multiband_gp"], got_b["bazin"], pandas_suffix=True)
    mat = server.matrix(full)
    bin_g = server.binned(mat)
    bin_c = cpu_server.binned(mat.cpu())
    dp = (server.predict_binned(bin_g).cpu() - cpu_server.predict_binned(bin_c)).abs()
    log(f"  bin + forest: binned matrices equal: {bool((bin_g.cpu() == bin_c).all())}; "
        f"max |p_gpu - p_cpu| {dp.max().item():.3e} (needs <= 1e-5)")
    if not bool((bin_g.cpu() == bin_c).all()) or dp.max().item() > 1e-5:
        raise AssertionError("bin + forest on the card disagrees with the CPU reference")


def hist_inputs(K: int, F: int, N: int, k_nodes: int, seed: int, inactive: float = 0.0):
    """Seeded K1 inputs: int16 bins [K, F, N] over all 257 bins, int32 node
    ids [K, N] in [0, k_nodes] (k_nodes = inactive, plus a share
    ``inactive`` of rows forced inactive), float32 (g, h) [K, N, 2] shaped
    like logistic gradients."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    binned = torch.randint(0, N_BINS_TOT, (K, F, N), generator=g, device="cuda").to(torch.int16)
    node_q = torch.randint(0, k_nodes + 1, (K, N), generator=g, device="cuda")
    node_q[torch.rand(K, N, generator=g, device="cuda") < inactive] = k_nodes
    p = torch.rand(K, N, generator=g, device="cuda")
    y = (torch.rand(K, N, generator=g, device="cuda") < 0.1).float()
    w = 0.5 + 1.5 * torch.rand(K, N, generator=g, device="cuda")
    gh = torch.stack([w * (p - y), w * p * (1 - p)], dim=-1).contiguous()
    return binned.contiguous(), node_q.to(torch.int32).contiguous(), gh


def check_hist(fit: str, K: int, F: int, N: int, k_nodes: int, seed: int,
               inactive: float = 0.0) -> dict:
    binned, node_q, gh = hist_inputs(K, F, N, k_nodes, seed, inactive)
    a = hist_cuda.build_histograms(binned, node_q, gh, k_nodes, N_BINS_TOT)
    b = hist_cuda.build_histograms(binned, node_q, gh, k_nodes, N_BINS_TOT)
    torch.cuda.synchronize()
    repeat_equal = bool(torch.equal(a, b))
    fixed_equal = bool(torch.equal(a, hist_cuda.build_histograms_fixed(
        binned, node_q, gh, k_nodes, N_BINS_TOT)))
    plain = hist_cuda.build_histograms_plain(binned, node_q, gh, k_nodes, N_BINS_TOT)
    f64 = hist_cuda.build_histograms_plain(binned, node_q, gh.double(), k_nodes, N_BINS_TOT)
    rows = {"vs_plain": close(a, plain, *HIST_TOL), "vs_f64": close(a, f64, *HIST_TOL)}
    tag = f"{fit} K={K} F={F} N={N} nodes={k_nodes}"
    for name, (abs_e, rel_e, ok) in rows.items():
        log(f"  {tag} {name}: max_abs={abs_e:.3e} max_rel={rel_e:.3e} "
            f"(rtol={HIST_TOL[0]:g}, atol={HIST_TOL[1]:g}) {'ok' if ok else 'FAIL'}")
    log(f"  {tag} two launches bit for bit equal: {repeat_equal}; equal to its "
        f"fixed-point arithmetic in plain PyTorch: {fixed_equal}")
    if not (repeat_equal and fixed_equal) or not all(ok for _, _, ok in rows.values()):
        raise AssertionError(f"K1 {tag} failed its checks")

    # the yardstick: one scatter_add_ over every (fold, feature, node, bin)
    # segment (the segment ids and the expanded values are set-up, untimed)
    nq = node_q.long()
    active = nq < k_nodes
    n_seg = K * F * k_nodes * N_BINS_TOT
    kf = (torch.arange(K, device="cuda")[:, None] * F + torch.arange(F, device="cuda")[None, :])
    seg = (kf[:, :, None] * k_nodes + nq[:, None, :]) * N_BINS_TOT + binned.long()
    seg = torch.where(active[:, None, :], seg, n_seg).reshape(-1, 1).expand(-1, 2)
    vals = gh[:, None, :, :].expand(K, F, N, 2).reshape(-1, 2)
    sink = torch.zeros(n_seg + 1, 2, device="cuda")

    ms = cuda_ms(lambda: hist_cuda.build_histograms(binned, node_q, gh, k_nodes, N_BINS_TOT),
                 reps=50)
    plain_ms = cuda_ms(lambda: hist_cuda.build_histograms_plain(binned, node_q, gh, k_nodes,
                                                                N_BINS_TOT), reps=3, warmup=1)
    library_ms = cuda_ms(lambda: sink.scatter_add_(0, seg, vals), reps=20)
    # bins, node ids and (g, h) in, the histograms out; two adds per active
    # (row, feature)
    n_bytes = K * F * N * 2 + K * N * 4 + K * N * 8 + K * F * k_nodes * N_BINS_TOT * 2 * 4
    n_ops = 2.0 * F * float(active.sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    res = {"fit": fit, "K": K, "F": F, "N": N, "nodes": k_nodes,
           "max_abs_err": rows["vs_plain"][0], "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"  {tag} times: kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.4f} (one scatter_add_, a yardstick the port never "
        f"calls) bound_ms={res['bound_ms']:.4f} ({res['bound_by']}: "
        f"{n_bytes / 1e6:.2f} MB, {n_ops / 1e6:.1f} M adds)")
    return res


def check_training_kernel_vs_plain(device) -> None:
    """A small fit with K1 twice and once with the kernel's arithmetic in
    plain PyTorch (``build_histograms_fixed``): the three forests must be
    identical, bit for bit. The float32 plain version on the card adds with
    atomics in a varying order, so its last bits, and the exact ties they
    decide, change from run to run: its fit is reported, not held to
    identity."""
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(600, 30)).astype(np.float32)
    y = (0.8 * X[:, 3] - 0.5 * X[:, 11] + 0.5 * rng.normal(size=600) > 0.6).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    p = GBDTParams(n_rounds=20, max_depth=5, learning_rate=0.1, subsample=0.8,
                   colsample_bytree=0.8)
    spw = float((y == 0).sum() / (y == 1).sum())

    def fit(hist_fn):
        return train_gbdt(X, y, p, scale_pos_weight=spw, device=device,
                          hist_fn=hist_fn).forest

    k1 = [fit(hist_cuda.build_histograms) for _ in range(2)]
    plain = fit(hist_cuda.build_histograms_fixed)
    plain32 = fit(hist_cuda.build_histograms_plain)
    same_k1 = all(torch.equal(a, b) for a, b in zip(*k1))
    same_plain = all(torch.equal(a, b) for a, b in zip(k1[0], plain))
    n_split = int((~k1[0].is_leaf & (k1[0].split_bin >= 0)).sum())
    diff32 = int(((k1[0].feature != plain32.feature) | (k1[0].split_bin != plain32.split_bin)
                  | (k1[0].default_left != plain32.default_left)).sum())
    log(f"  600 x 30, 20 rounds, depth 5: {n_split} splits; K1 twice bit for bit equal: "
        f"{same_k1}; K1 vs its arithmetic in plain PyTorch: forests bit for bit equal "
        f"{same_plain}; float32 plain (atomic order): {diff32} of "
        f"{k1[0].feature.numel()} split slots differ")
    if not (same_k1 and same_plain):
        raise AssertionError("training with K1 and with the plain histogram disagree")


def load_split(tag: str, device):
    with np.load(DATA, allow_pickle=False) as z:
        cols = {k: z[f"{tag}_{k}"] for k in ("object_index", "time", "flux", "flux_err", "band")}
        meta = Metadata(object_ids=z[f"{tag}_object_ids"], z=z[f"{tag}_z"],
                        ebv=z[f"{tag}_ebv"], target=z[f"{tag}_target"])
    packed = pack_lightcurves(cols["object_index"], cols["time"], cols["flux"],
                              cols["flux_err"], cols["band"], len(meta.z), device=device)
    return packed, meta


def expected_training_chol(tr_packed, te_packed, gp_steps: int) -> int:
    """K2 launches of training's GP features: per count-sorted chunk of each
    split, gp_steps Adam steps + the final NLL (+ phase 2's steps and final
    NLL) + the predict, as ``multiband_gp.extract`` schedules them."""
    total = 0
    for packed in unify_time_padding(tr_packed, te_packed):
        counts = multiband_gp._use_mask(packed).sum(dim=1).cpu().numpy()
        two_phase, widths = multiband_gp.gp_schedule(counts, packed.all_time.shape[1],
                                                     gp_steps)
        per_chunk = gp_steps + 1 + 1 + ((max(gp_steps // 6, 8) + 1) if two_phase else 0)
        total += per_chunk * len(widths)
    return total


def run_training(device) -> dict:
    tr_packed, tr_meta = load_split("tr", device)
    te_packed, te_meta = load_split("te", device)
    log(f"train split {tr_packed.n_objects} objects ({int(tr_meta.target.sum())} TDEs), "
        f"test split {te_packed.n_objects} ({int(te_meta.target.sum())} TDEs)")
    hist_cuda.reset_launches()
    chol_cuda.reset_launches()
    out = train_v92d(tr_packed, tr_meta, te_packed, te_meta, gp_steps=GP_STEPS,
                     selection_cache=None, device=device)
    torch.cuda.synchronize()
    launches, chol_launches = hist_cuda.launches, chol_cuda.launches
    log("training stages (s): " + ", ".join(f"{k}={v:.3f}" for k, v in out.timings.items()))
    depth = {"selection": V34A_PARAMS.max_depth, "adversarial": ADV_PARAMS.max_depth,
             "v92d": V34A_PARAMS.max_depth}
    want = sum(out.rounds_run[k] * depth[k] for k in depth)
    log("rounds run: " + ", ".join(f"{k}={v}" for k, v in out.rounds_run.items())
        + f"; K1 launches {launches} (rounds x depth predicts {want})")
    want_chol = expected_training_chol(tr_packed, te_packed, GP_STEPS)
    log(f"chol_inv launches in training {chol_launches} (GP schedule predicts {want_chol})")
    if launches != want or launches == 0 or chol_launches != want_chol:
        raise AssertionError("training's kernel launch counts disagree with the prediction")

    adv, win = out.adversarial, out.winner
    w = adv.sample_weights
    log(f"selection: {len(out.selection.selected)} of 307 features_v4 columns; "
        f"v92d matrix {len(out.feature_names)} columns")
    log(f"adversarial AUC {adv.auc:.4f} (shift {adv.distribution_shift}), weights "
        f"[{w.min():.3f}, {w.max():.3f}] std {w.std():.3f}")
    log(f"v92d OOF F1 {win.best_f1:.4f} @ {win.best_threshold:.3f}; fold F1 "
        + ", ".join(f"{f:.4f}" for f in win.fold_f1s)
        + f"; best iterations {[m.best_iteration for m in win.models]}")
    log(f"TEST F1 under shift {out.test_f1:.4f} ({int(te_meta.target.sum())} TDEs in test)")
    oof, test = win.oof_preds, win.test_preds
    if (oof.shape != (tr_packed.n_objects,) or test.shape != (te_packed.n_objects,)
            or not (np.isfinite(oof).all() and np.isfinite(test).all())
            or min(oof.min(), test.min()) < 0 or max(oof.max(), test.max()) > 1):
        raise AssertionError("training produced malformed probabilities")
    ref = json.loads((ROOT / "REFBASE.json").read_text())["hgb_oracle"]
    d_f1 = win.best_f1 - ref["oof_f1"]
    log(f"[oracle] sklearn HGB (REFBASE.json): OOF F1={ref['oof_f1']:.4f} @ "
        f"{ref['threshold']:.3f} | ours {win.best_f1:.4f} (dF1={d_f1:+.4f}; "
        f"gate ours >= oracle-0.02: {'PASS' if d_f1 >= -0.02 else 'FAIL'})")
    log(f"OOF F1 gate: {win.best_f1:.4f} >= {F1_GATE} "
        f"{'ok' if win.best_f1 >= F1_GATE else 'FAIL'}")
    if win.best_f1 < F1_GATE:
        raise AssertionError(f"v92d OOF F1 {win.best_f1:.4f} below the gate {F1_GATE}")
    return {"launches": launches, "chol_launches": chol_launches, "oof_f1": win.best_f1,
            "total_s": out.timings["total"]}


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kernels = []

    with Phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        log(smi)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    with Phase("build"):
        t0 = time.perf_counter()
        so = cuda_build.build(verbose=True)
        cuda_build.load()
        log(f"build: {time.perf_counter() - t0:.3f} s -> {so.relative_to(ROOT)}")

    with Phase("kernel checks"):
        results = [check_kernel(B, T, seed=1000 + T)
                   for B, T in ((2048, 64), (2048, 128), (2048, 160), (2048, 192), (2047, 72))]
        check_non_spd()

    with Phase("serving data + model"):
        packed, zz, ebv = load_test_split(dev)
        n = packed.n_objects
        # the GP's width and path are model state, fixed from the served set
        gp_tc, gp_two_phase = multiband_gp.serving_config(packed, GP_STEPS)
        log(f"test split: {n} objects, band view {tuple(packed.band_time.shape)}, "
            f"all-band view {tuple(packed.all_time.shape)}; GP width {gp_tc}, "
            f"two-phase {gp_two_phase}")
        # one feature pass over the served data, to fit the bin edges on the
        # served matrix and to draw the selected-120 from its names
        parts = [extract_bundle(packed.map(lambda x: x[s:e]), zz[s:e], ebv[s:e],
                                GP_STEPS, gp_tc, gp_two_phase)
                 for s, e in requests(n)]
        bundle = {fam: {k: torch.cat([p[fam][k] for p in parts]) for k in parts[0][fam]}
                  for fam in parts[0]}
        rng = np.random.default_rng(SEED)
        # v92d's selection holds both shift features, which it then drops
        v4_names = [k for k in bundle["features_v4"] if k not in SHIFT_FEATURES]
        picks = rng.choice(len(v4_names), N_SELECTED - len(SHIFT_FEATURES), replace=False)
        selected = list(SHIFT_FEATURES) + [v4_names[i] for i in picks]
        X224, names224 = assemble_v34a_matrix(bundle, selected)
        X, names = drop_shift_features(names224, X224)
        if len(names) != N_COLS:
            raise AssertionError(f"v92d matrix has {len(names)} columns, expected {N_COLS}")
        models = random_models(rng, X.cpu().numpy(), dev)
        server = V92dServer(models, names, selected, gp_steps=GP_STEPS,
                            gp_t_compact=gp_tc, gp_two_phase=gp_two_phase, device=dev)
        del parts, bundle, X224, X

    with Phase("serving"):
        chol_cuda.reset_launches()
        hist_cuda.reset_launches()
        timings: dict = {}
        t0 = time.perf_counter()
        probs = []
        for s, e in requests(n):
            sub = packed.map(lambda x: x[s:e])
            probs.append(server(sub, zz[s:e], ebv[s:e], timings=timings))
        probs = torch.cat(probs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = chol_cuda.launches
        want = expected_launches(n, server)
        log(f"serving: {n} objects in {len(requests(n))} requests, {wall:.3f} s, "
            f"{n / wall:.1f} objects/s")
        log("serving phases (s): " + ", ".join(f"{k}={v:.3f}" for k, v in timings.items()))
        log(f"chol_inv launches: {launches} (GP schedule predicts {want})")
        if launches != want or launches == 0:
            raise AssertionError(f"chol_inv launched {launches} times, expected {want}")
        p = probs.cpu().numpy()
        if p.shape != (n,) or not np.isfinite(p).all() or p.min() < 0 or p.max() > 1:
            raise AssertionError(f"bad probabilities: shape {p.shape}, "
                                 f"finite {np.isfinite(p).all()}, range [{p.min()}, {p.max()}]")
        log(f"probabilities: {n} finite in [{p.min():.4f}, {p.max():.4f}], mean {p.mean():.4f}")

    with Phase("reference on the CPU"):
        reference_check(server, models, names, selected, packed, zz, ebv)
        del server, models, packed

    with Phase("histogram kernel checks"):
        hist_results = [check_hist(fit, K, F, N, k, seed=2000 + 17 * i + k)
                        for i, (fit, K, F, N, nodes) in enumerate(HIST_SHAPES)
                        for k in sorted(set(nodes))]
        check_hist("ragged", 5, 222, 2443, 4, seed=2999, inactive=0.3)

    with Phase("kernel against plain in training"):
        check_training_kernel_vs_plain(dev)

    with Phase("training"):
        trained = run_training(dev)

    # the kernel's row: the shape of the GP's full-width launches
    main_shape = next(r for r in results if (r["B"], r["T"]) == (REQUEST, gp_tc))
    kernels.append({
        "name": "chol_inv", "route": "cuda",
        "source": "mallorn_tpu_torch/csrc/chol_inv.cu",
        "replaces": "mallorn_tpu/ops/chol_pallas.py:60",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"], "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": main_shape["library_ms"],
        "shape": [REQUEST, gp_tc, gp_tc],
    })
    # the histogram kernel's row: the v92d CV's deepest level
    main_hist = next(r for r in hist_results if (r["fit"], r["nodes"]) == ("v92d", 8))
    kernels.append({
        "name": "hist", "route": "cuda",
        "source": "mallorn_tpu_torch/csrc/hist.cu",
        "replaces": "mallorn_tpu/ops/hist_pallas.py:508",
        "launches": trained["launches"],
        "max_abs_err": main_hist["max_abs_err"], "ms": main_hist["ms"],
        "plain_ms": main_hist["plain_ms"], "bound_ms": main_hist["bound_ms"],
        "bound_by": main_hist["bound_by"], "library_ms": main_hist["library_ms"],
        "shape": [main_hist["K"], main_hist["F"], main_hist["N"], main_hist["nodes"]],
    })
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
