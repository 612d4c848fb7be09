"""Times K1, the port's depthwise level histogram
(``mallorn_tpu_torch.ops.hist_cuda.build_histograms``), of one or more
checkouts on one CUDA card, in turns, and holds their outputs bit for bit
equal.

    python3 tools/time_hist.py [--layouts] [--fits] [--slots] DIR [DIR ...]

Each DIR is the root of a checkout of this repository: ``.`` for this one,
or an unpacked ``git archive`` of another commit in a gitignored folder
(``.scratch_parent``). Each DIR runs in a process of its own, in the order
given, so ``.scratch_parent . . .scratch_parent`` times two commits in
turns. Every process builds its checkout's CUDA sources and takes the same
seeded inputs: ``chip_smoke.py``'s K1 shapes (``HIST_SHAPES``: the
selection, adversarial, v92d and ensemble fits at every node count of
their levels, with its seeds), its ragged shape (2,443 rows, 30% of rows
inactive) and depth 8's last levels (``WIDE_SHAPES``: K = 5, F = 222,
N = 2,444 at 64 and 128 nodes, wider than one CTA holds). Per shape it
times, by CUDA events over 50 calls, the wrapper and the launch alone:
the checkout's ``hist_cuda.launch_hist_kernel``, or, in a checkout from
before that function, its entry point of that time, which took the folds'
max |g|, |h| from the caller (computed once, untimed). At the wide shapes
it also times the external-scale entry (``build_histograms_i64`` and its
launch alone at the folds' own maxima), and, in a checkout with the wide
path (``wide_plan``), its prep kernel and histogram kernel alone; and once
per run each wide shape's bound (bytes: bins, ids and (g, h) in, the
output out, over 3.35 TB/s) and one ``scatter_add_`` over every (fold,
feature, node, bin) cell (a yardstick the port never calls). With
``--layouts``, each checkout that has ``hist_layout`` also times the launch
alone with G = 1, 2, 4, 8 features per CTA and 256-, 512- and 1,024-row
tiles (those that fit) at 1, 2, 4, 8 and 16 nodes, at the v92d fit's shape
(K = 5, F = 222, N = 2,444), the adversarial fit's (N = 8,143) and the
ensemble's (K = 25, F = 224), and each with ``wide_plan`` the wide path
(prep and histogram kernel) with G = 1, 2, 4 and 6-22 nodes per chunk
(those that fit) at 17-128 nodes of the v92d CV's shape, beside the
one-CTA kernel at the levels it holds (in two passes, the mean), each
layout's output held bit for bit to the wrapper's. With ``--fits``, each
checkout also trains depth-8 CVs (``train_cv``: 5 folds, 100 rounds,
min_child_weight 1e-3, with and without subtraction, so their last levels
run K1 at 64 and 128 nodes) on one seeded synthetic matrix of the v92d CV's
width (3,054 x 222, NaNs included) and reports each CV's forests' sha256,
rounds, OOF F1 and K1 launches by level width, which must agree across the
checkouts; with it, the v92d CV (V34A_PARAMS, early-stopped) on the same
matrix in each ``hist_dtype`` mode, each one's forests' sha256,
rounds, OOF F1, seconds and launches of the mode kernel (and of the
digits' prep kernel where the checkout has it), which must agree across
the checkouts but for the seconds and the prep launches. In a checkout
with the histogram modes' ``launch_mode_kernel``, it also times K4 and K5
at the v92d CV's deepest level (8 nodes; ``chip_smoke.py``'s seed 6,042)
and at ``chip_smoke.py``'s windowed shapes (1 x 8,193, 8 x 1,025 and 2 x
32,768 bins; its ``BINS_SHAPES`` seeds): the (g, h) wrapper, the call a
fit makes per level (``fit_call_ms``: with ``prepare_digits``, the level
on the tree's prepared digits; before it, the wrapper, which the fit
called at every level), the launch alone on prepared digits and the prep
alone, each output held bit for bit equal across the checkouts too, and
the external-scale entry (a mesh's level on digits prepared at every
rank's scale, here the rows' own) and its launch alone, beside zeros + one
``scatter_add_``; at the v92d shape also the device time alone of the mode
kernel (both entries) and of the prep kernel (``torch.profiler``), apart
from the host's share of a call. At K1's shapes beyond 7,264 bins a node
(``NODE_SHAPES``: chip_smoke.py's 32 x 16,385 at F = 16 and its crowded
2 x 16,385 level) it times both entries, the wrapper and the launch alone,
beside their bounds and zeros + one ``scatter_add_`` (float32, and int64
of the fixed-point values); with ``--slots``, in a checkout with the
per-node kernel (``wide_node_plan``), that kernel alone in both entries at
1,024-8,192 slots. With ``--fits`` the mode CVs run in "int8", "i8bf16"
and "bf16".

Prints one line per run and shape, the card's name and power limit, and
last one JSON object of every run. Exits non-zero with no CUDA device or
when two checkouts' outputs differ.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

N_BINS_TOT = 257
# chip_smoke.py's HIST_SHAPES: (fit, K, F, N, node counts), seeds
# 2000 + 17 i + k; and its ragged shape, seed 2999
HIST_SHAPES = (("selection", 5, 307, 2444, (1, 2, 4, 8)),
               ("adversarial", 5, 222, 8143, (1, 2)),
               ("v92d", 5, 222, 2444, (1, 2, 4, 8)),
               ("kaggle", 25, 224, 2444, (1, 2, 4, 8)))
RAGGED = ("ragged", 5, 222, 2443, 4, 2999, 0.3)
# chip_smoke.py's FAMILY_HIST_SHAPES (depth 8's last level with and without
# subtraction), seeds 2900 + k
WIDE_SHAPES = (("depth8", 5, 222, 2444, (64, 128)),)
# the wide path's layout sweep at the v92d CV's shape: levels (those of at
# most 54 nodes also on the one-CTA kernel, to place the switch between the
# two paths), features per CTA and nodes per chunk
WIDE_SWEEP_LEVELS = (17, 24, 32, 43, 54, 64, 100, 128)
WIDE_SWEEP_GROUPS = (1, 2, 4)
WIDE_SWEEP_NODES = (6, 8, 11, 16, 22)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# the layout sweep: (name, K, F, N), node counts, G and tile rows
SWEEP_SHAPES = (("v92d", 5, 222, 2444), ("adversarial", 5, 222, 8143), ("kaggle", 25, 224, 2444))
SWEEP_NODES = (1, 2, 4, 8, 16)
SWEEP_GROUPS = (1, 2, 4, 8)
SWEEP_ROWS = (256, 512, 1024)


def shapes():
    """(name, K, F, N, k_nodes, seed, inactive) of every timed shape."""
    out = [(f"{fit} nodes={k}", K, F, N, k, 2000 + 17 * i + k, 0.0)
           for i, (fit, K, F, N, nodes) in enumerate(HIST_SHAPES) for k in nodes]
    name, K, F, N, k, seed, inactive = RAGGED
    out.append((f"{name} nodes={k}", K, F, N, k, seed, inactive))
    return out + [(f"{fit} nodes={k}", K, F, N, k, 2900 + k, 0.0)
                  for fit, K, F, N, nodes in WIDE_SHAPES for k in nodes]


# K4 and K5 at the v92d CV's deepest level, chip_smoke.py's mode check
# there (seed 6000 + 17 x 2 + 8), and at chip_smoke.py's windowed shapes
# (BINS_SHAPES, seeds 12000 + i): (kernel, K, F, N, nodes, bins, seed)
MODE_SHAPE = ("v92d", 5, 222, 2444, 8, 6042)
MODE_BINS_SHAPES = (("K4", 5, 16, 2444, 1, 8193, 12000), ("K4", 5, 222, 2444, 8, 1025, 12001),
                    ("K4", 5, 16, 2444, 2, 32768, 12002), ("K5", 5, 16, 2444, 1, 8193, 12003),
                    ("K5", 5, 222, 2444, 8, 1025, 12004), ("K5", 5, 16, 2444, 2, 32768, 12005))


# K1's wide path beyond 7,264 bins a node: chip_smoke.py's BINS_SHAPES K1
# shapes (its seeds 12,006-7): 32 nodes, and a crowded level whose node 0
# holds all but 400 of a fold's 8,143 rows (more rows than the per-node
# kernel's slots: its bins in windows); with ``--slots`` the per-node
# kernel alone at each of NODE_SWEEP_SLOTS slots
NODE_SHAPES = (("K1 F=16 nodes=32 bins=16385", 5, 16, 2444, 32, 16385, 12006, False),
               ("K1 F=16 nodes=2 bins=16385 crowded", 5, 16, 8143, 2, 16385, 12007, True))
NODE_SWEEP_SLOTS = (1024, 2048, 4096, 5952, 8192)


def node_names():
    return [s[0] for s in NODE_SHAPES]


def mode_shapes():
    """(name, int8, K, F, N, nodes, bins, seed, windowed) of every K4 / K5
    shape."""
    _, K, F, N, k_nodes, seed = MODE_SHAPE
    out = [(f"{kernel} {MODE_SHAPE[0]} nodes={k_nodes}", kernel == "K5", K, F, N, k_nodes,
            N_BINS_TOT, seed, False) for kernel in ("K4", "K5")]
    return out + [(f"{kernel} F={F} nodes={k} bins={b}", kernel == "K5", K, F, N, k, b, seed,
                   True) for kernel, K, F, N, k, b, seed in MODE_BINS_SHAPES]


def mode_names():
    return [m[0] for m in mode_shapes()]


def wide_names():
    return [f"{fit} nodes={k}" for fit, _, _, _, nodes in WIDE_SHAPES for k in nodes]


def bins_inputs(torch, K: int, F: int, N: int, k_nodes: int, nbt: int, seed: int):
    """chip_smoke.py's ``bins_inputs``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    binned = torch.randint(0, nbt, (K, F, N), generator=g, device="cuda").to(torch.int16)
    binned[:, :, ::7] = nbt - 1
    node_q = torch.randint(0, k_nodes + 1, (K, N), generator=g, device="cuda").to(torch.int32)
    p = torch.rand(K, N, generator=g, device="cuda")
    y = (torch.rand(K, N, generator=g, device="cuda") < 0.1).float()
    w = 0.5 + 1.5 * torch.rand(K, N, generator=g, device="cuda")
    gh = torch.stack([w * (p - y), w * p * (1 - p)], dim=-1).contiguous()
    return binned.contiguous(), node_q.contiguous(), gh


def hist_inputs(torch, K: int, F: int, N: int, k_nodes: int, seed: int, inactive: float = 0.0):
    """chip_smoke.py's ``hist_inputs``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    binned = torch.randint(0, N_BINS_TOT, (K, F, N), generator=g, device="cuda").to(torch.int16)
    node_q = torch.randint(0, k_nodes + 1, (K, N), generator=g, device="cuda")
    node_q[torch.rand(K, N, generator=g, device="cuda") < inactive] = k_nodes
    p = torch.rand(K, N, generator=g, device="cuda")
    y = (torch.rand(K, N, generator=g, device="cuda") < 0.1).float()
    w = 0.5 + 1.5 * torch.rand(K, N, generator=g, device="cuda")
    gh = torch.stack([w * (p - y), w * p * (1 - p)], dim=-1).contiguous()
    return binned.contiguous(), node_q.to(torch.int32).contiguous(), gh


def time_checkout(layouts: bool, fits: bool = False, slots: bool = False) -> dict:
    """Times the K1 of the checkout first on ``sys.path``."""
    import torch
    from mallorn_tpu_torch.ops import hist_cuda
    from mallorn_tpu_torch.utils import cuda_build

    def ms(fn, reps=50, warmup=3):
        for _ in range(warmup):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    lib = cuda_build.load()
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name, K, F, N, k_nodes, seed, inactive in shapes():
        binned, node_q, gh = hist_inputs(torch, K, F, N, k_nodes, seed, inactive)
        out = torch.empty(K, F, k_nodes, N_BINS_TOT, 2, device="cuda")
        if hasattr(hist_cuda, "launch_hist_kernel"):
            def launch():
                hist_cuda.launch_hist_kernel(binned, node_q, gh, out, k_nodes, N_BINS_TOT)
        else:  # one CTA per (fold, feature), the folds' scale from the caller
            maxabs = gh.abs().amax(dim=1).contiguous()

            def launch():
                cuda_build.check(lib.mallorn_hist(
                    binned.data_ptr(), node_q.data_ptr(), gh.data_ptr(), maxabs.data_ptr(),
                    out.data_ptr(), K, F, N, k_nodes, N_BINS_TOT, stream), "mallorn_hist")
        want = hist_cuda.build_histograms(binned, node_q, gh, k_nodes, N_BINS_TOT)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name}: the launch alone disagrees with the wrapper")
        res[name] = {
            "wrapper_ms": ms(lambda: hist_cuda.build_histograms(binned, node_q, gh, k_nodes,
                                                                N_BINS_TOT)),
            "launch_ms": ms(launch),
            "sha256": hashlib.sha256(want.cpu().numpy().tobytes()).hexdigest()}
        if hasattr(hist_cuda, "hist_plan"):
            res[name]["layout"] = list(hist_cuda.hist_plan(k_nodes, N_BINS_TOT)[:4])
        elif hasattr(hist_cuda, "hist_layout"):
            res[name]["layout"] = list(hist_cuda.hist_layout(k_nodes, N_BINS_TOT)[:2])
        if name in wide_names():
            res[name].update(time_wide(torch, hist_cuda, ms, binned, node_q, gh, k_nodes))
    if hasattr(hist_cuda, "launch_mode_kernel"):
        res.update(time_modes(torch, hist_cuda, ms))
    if hasattr(hist_cuda, "MAX_NODE_BINS"):
        res.update(time_nodes(torch, hist_cuda, ms, slots))
    if layouts and hasattr(hist_cuda, "hist_layout"):
        res["sweep"] = sweep(torch, hist_cuda, cuda_build, stream, ms)
    if layouts and hasattr(hist_cuda, "wide_plan"):
        res["wide_sweep"] = wide_sweep(torch, hist_cuda, ms)
    if fits:
        res["fits"] = {**depth8_fits(torch, hist_cuda), **mode_fits(torch, hist_cuda)}
    return res


def scatter_yardsticks(torch, ms, binned, node_q, gh, k_nodes, nbt, ints=None) -> dict:
    """Zeros + one ``scatter_add_`` into every (fold, feature, node, bin)
    cell of the output (the kernels write every cell): of (g, h) in
    float32 and, given ``ints`` [K, N, C], of those integers in int64 (a
    yardstick the port never calls; the ids and values are set-up, untimed)."""
    K, F, N = binned.shape
    nq = node_q.long()
    active = (nq >= 0) & (nq < k_nodes)
    n_cells = K * F * k_nodes * nbt
    kf = torch.arange(K * F, device="cuda").view(K, F, 1) * (k_nodes * nbt)
    cell = torch.where(active[:, None, :], kf + nq[:, None, :] * nbt + binned.long(),
                       n_cells).reshape(-1, 1)
    vals = gh[:, None, :, :].expand(K, F, N, 2).reshape(-1, 2)
    res = {"library_ms": ms(lambda: torch.zeros(n_cells + 1, 2, device="cuda").scatter_add_(
        0, cell.expand(-1, 2), vals), reps=10)}
    if ints is not None:
        C = ints.shape[2]
        ivals = ints[:, None].expand(K, F, N, C).reshape(-1, C)
        res["i64_library_ms"] = ms(lambda: torch.zeros(
            n_cells + 1, C, dtype=torch.int64, device="cuda").scatter_add_(
            0, cell.expand(-1, C), ivals), reps=10)
    return res


def time_nodes(torch, hist_cuda, ms, slots: bool) -> dict:
    """K1's wide path at NODE_SHAPES, both entries: the wrapper and the
    launch alone (``launch_hist_kernel``; the external entry at the folds'
    own maxima), their bounds (bytes: bins, ids and (g, h) in, 8 / 16 B a
    cell out, over 3.35 TB/s), zeros + ``scatter_add_`` of each, the
    outputs' sha256; with ``slots`` and a checkout with the per-node kernel
    (``wide_node_plan``), that kernel alone at each of NODE_SWEEP_SLOTS."""
    res = {}
    for name, K, F, N, k_nodes, nbt, seed, skew in NODE_SHAPES:
        binned, node_q, gh = bins_inputs(torch, K, F, N, k_nodes, nbt, seed)
        if skew:
            node_q[:, :N - 400] = 0
        m = hist_cuda.lane_maxabs(gh)
        log2n = hist_cuda._log2_ceil(N)
        want = hist_cuda.build_histograms(binned, node_q, gh, k_nodes, nbt)
        want_i = hist_cuda.build_histograms_i64(binned, node_q, gh, k_nodes, nbt, m, N)
        out, out_i = torch.empty_like(want), torch.empty_like(want_i)

        def launch():
            hist_cuda.launch_hist_kernel(binned, node_q, gh, out, k_nodes, nbt)

        def launch_i():
            hist_cuda.launch_hist_kernel(binned, node_q, gh, out_i, k_nodes, nbt, m, log2n)
        launch()
        launch_i()
        torch.cuda.synchronize()
        if not (torch.equal(out.view(torch.int32), want.view(torch.int32))
                and torch.equal(out_i, want_i)):
            raise AssertionError(f"{name}: the launch alone disagrees with the wrapper")
        n_in = K * F * N * 2 + K * N * 4 + K * N * 8
        n_cells = K * F * k_nodes * nbt
        r = {"wrapper_ms": ms(lambda: hist_cuda.build_histograms(binned, node_q, gh, k_nodes,
                                                                 nbt)),
             "launch_ms": ms(launch),
             "i64_wrapper_ms": ms(lambda: hist_cuda.build_histograms_i64(
                 binned, node_q, gh, k_nodes, nbt, m, N)),
             "i64_launch_ms": ms(launch_i),
             "bound_ms": (n_in + n_cells * 8) / HBM_BYTES_PER_S * 1e3,
             "i64_bound_ms": (n_in + n_cells * 16) / HBM_BYTES_PER_S * 1e3,
             "sha256": hashlib.sha256(want.cpu().numpy().tobytes()).hexdigest(),
             "i64_sha256": hashlib.sha256(want_i.cpu().numpy().tobytes()).hexdigest()}
        r.update(scatter_yardsticks(torch, ms, binned, node_q, gh, k_nodes, nbt,
                                    hist_cuda._fixed_point(gh, m, N)[0]))
        if slots and hasattr(hist_cuda, "wide_node_plan"):
            grouped = hist_cuda.launch_group_rows(node_q, gh, k_nodes, 1)
            grouped_i = hist_cuda.launch_group_rows(node_q, gh, k_nodes, 1, m, log2n)
            for n_slots in NODE_SWEEP_SLOTS:
                for key, g, o, w, lg in (("", grouped, out, want, None),
                                         ("i64_", grouped_i, out_i, want_i, log2n)):
                    def node(g=g, o=o, lg=lg, n_slots=n_slots):
                        hist_cuda.launch_wide_kernel(binned, g, o, k_nodes, nbt, 1, 1, lg,
                                                     slots=n_slots)
                    o.fill_(-1)
                    node()
                    torch.cuda.synchronize()
                    if not torch.equal(o, w) and not torch.equal(o.view(torch.int32),
                                                                 w.view(torch.int32)):
                        raise AssertionError(f"{name}: {n_slots} slots disagree with the wrapper")
                    r[f"{key}slots{n_slots}_ms"] = ms(node)
        res[name] = r
    return res


def time_modes(torch, hist_cuda, ms) -> dict:
    """K4 and K5 at ``mode_shapes()``: the (g, h) wrapper (what a checkout
    from before ``prepare_digits`` called at every level), the call a fit
    makes per level (``fit_call_ms``: in a checkout with ``prepare_digits``
    the level on the tree's prepared digits, ``mode_hist``; before it, the
    wrapper), the
    launch alone on prepared digits, the prep alone where the checkout
    has its kernel and, at the v92d shape, each kernel's device time
    (``device_ms``); the output's sha256."""
    res = {}
    prep = getattr(hist_cuda, "prepare_digits", None)
    for name, int8, K, F, N, k_nodes, nbt, seed, windowed in mode_shapes():
        if windowed and not hasattr(hist_cuda, "mode_plan"):
            continue
        binned, node_q, gh = (bins_inputs(torch, K, F, N, k_nodes, nbt, seed) if windowed
                              else hist_inputs(torch, K, F, N, k_nodes, seed))
        wrapper = hist_cuda.build_histograms_i8 if int8 else hist_cuda.build_histograms_bf16
        want = wrapper(binned, node_q, gh, k_nodes, nbt)
        digits, scale = prep(int8, gh) if prep else hist_cuda.launch_inputs(int8, gh)
        out = torch.empty_like(want)

        def launch():
            hist_cuda.launch_mode_kernel(int8, binned, node_q, digits, scale, out, k_nodes, nbt)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name}: the launch alone disagrees with the wrapper")
        r = {"wrapper_ms": ms(lambda: wrapper(binned, node_q, gh, k_nodes, nbt)),
             "launch_ms": ms(launch),
             "sha256": hashlib.sha256(want.cpu().numpy().tobytes()).hexdigest()}
        if prep:
            dg = prep(int8, gh)
            r["fit_call_ms"] = ms(lambda: hist_cuda.mode_hist(binned, node_q, dg, k_nodes, nbt))
            r["prep_ms"] = ms(lambda: prep(int8, gh))
            # the external-scale entry (a mesh's level) on digits prepared at
            # every rank's scale (here the rows' own), and its launch alone
            ext = (hist_cuda.amax_of(hist_cuda.amax_parts(gh)) if int8
                   else hist_cuda.digit_maxabs(gh))
            dge = prep(int8, gh, ext)
            want_e = hist_cuda.mode_hist(binned, node_q, dge, k_nodes, nbt, N)
            out_e = torch.empty_like(want_e)
            log2n = hist_cuda._log2_ceil(N)

            def launch_e():
                hist_cuda.launch_mode_kernel(int8, binned, node_q, dge.digits, dge.scale, out_e,
                                             k_nodes, nbt, log2n)
            launch_e()
            torch.cuda.synchronize()
            if not torch.equal(out_e, want_e):
                raise AssertionError(f"{name}: the external launch alone disagrees")
            r["i64_fit_call_ms"] = ms(lambda: hist_cuda.mode_hist(binned, node_q, dge, k_nodes,
                                                                  nbt, N))
            r["i64_launch_ms"] = ms(launch_e)
            r["i64_sha256"] = hashlib.sha256(want_e.cpu().numpy().tobytes()).hexdigest()
            r.update(scatter_yardsticks(torch, ms, binned, node_q, gh, k_nodes, nbt))
            if not windowed:
                t = device_ms(torch, launch_e, "mode_hist_kernel")
                if t is not None:
                    r["i64_launch_device_ms"] = t
        else:
            r["fit_call_ms"] = r["wrapper_ms"]
        if not windowed:  # the kernels' own device time, apart from the host's
            timed = [("launch_device_ms", launch, "mode_hist_kernel")]
            if prep:
                timed.append(("prep_device_ms", lambda: prep(int8, gh), "digit_prep_kernel"))
            for key, fn, kernel in timed:
                t = device_ms(torch, fn, kernel)
                if t is not None:
                    r[key] = t
        res[name] = r
    return res


def device_ms(torch, fn, kernel: str, reps: int = 50):
    """Device time per call of ``fn`` in kernels whose name holds
    ``kernel`` (``torch.profiler``, CUDA activity), or None where the
    profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
             for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3 if us else None


def mode_fits(torch, hist_cuda) -> dict:
    """The v92d CV (``train_cv`` at V34A_PARAMS: 5 folds, depth 5, early
    stopping) in ``hist_dtype`` "int8" and "i8bf16" on ``depth8_fits``'
    seeded synthetic matrix: each one's forests' sha256, rounds, OOF F1,
    seconds, the mode kernel's launches and, where the checkout has it, the
    digits' prep kernel's."""
    import time

    from mallorn_tpu_torch.train.cv import train_cv
    from mallorn_tpu_torch.trees.gbdt import V34A_PARAMS

    X, y = synthetic_matrix()
    res = {}
    for mode in ("int8", "i8bf16", "bf16"):
        hist_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv = train_cv(X, y, None, V34A_PARAMS._replace(hist_dtype=mode), device="cuda")
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for m in cv.models:
            for t in m.forest:
                h.update(t.cpu().numpy().tobytes())
        res[f"v92d {mode}"] = {
            "sha256": h.hexdigest(), "rounds": cv.rounds_run, "oof_f1": cv.best_f1,
            "s": time.perf_counter() - t0,
            "k1": hist_cuda.i8_launches if mode == "int8" else hist_cuda.bf16_launches,
            "prep": getattr(hist_cuda, "digit_prep_launches", None)}
    return res


def synthetic_matrix():
    """A seeded synthetic matrix of the v92d CV's width: 3,054 x 222, 5%
    NaN, labels from a logistic of 8 columns."""
    import numpy as np

    rng = np.random.default_rng(2025)
    X = rng.normal(size=(3054, 222)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    logit = np.nan_to_num(X[:, :8]) @ rng.normal(size=8) - 2.5
    y = (rng.random(3054) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


def depth8_fits(torch, hist_cuda) -> dict:
    """Depth-8 CVs with and without subtraction on a seeded synthetic
    matrix: each one's forests' sha256, rounds, OOF F1, seconds and K1
    launches by level width."""
    import time

    from mallorn_tpu_torch.train.cv import train_cv
    from mallorn_tpu_torch.trees.gbdt import V34A_PARAMS

    X, y = synthetic_matrix()
    res = {}
    for sub in (True, False):
        p = V34A_PARAMS._replace(n_rounds=100, max_depth=8, hist_subtract=sub,
                                 min_child_weight=1e-3)
        hist_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv = train_cv(X, y, None, p, device="cuda")
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for m in cv.models:
            for t in m.forest:
                h.update(t.cpu().numpy().tobytes())
        res[f"subtract={sub}"] = {
            "sha256": h.hexdigest(), "rounds": cv.rounds_run, "oof_f1": cv.best_f1,
            "s": time.perf_counter() - t0, "k1": hist_cuda.launches,
            "k1_by_nodes": {str(k): v for k, v in sorted(hist_cuda.launches_by_nodes.items())}}
    return res


def time_wide(torch, hist_cuda, ms, binned, node_q, gh, k_nodes) -> dict:
    """At a wide shape: the external-scale entry and its launch alone (at the
    folds' own maxima), the prep and histogram kernels alone where the
    checkout has them, the bound and one scatter_add_."""
    K, F, N = binned.shape
    m = hist_cuda.lane_maxabs(gh)
    log2n = hist_cuda._log2_ceil(N)
    want = hist_cuda.build_histograms_i64(binned, node_q, gh, k_nodes, N_BINS_TOT, m, N)
    out = torch.empty_like(want)
    hist_cuda.launch_hist_kernel(binned, node_q, gh, out, k_nodes, N_BINS_TOT, m, log2n)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(f"nodes={k_nodes}: the external launch alone disagrees")
    res = {"i64_wrapper_ms": ms(lambda: hist_cuda.build_histograms_i64(
               binned, node_q, gh, k_nodes, N_BINS_TOT, m, N)),
           "i64_launch_ms": ms(lambda: hist_cuda.launch_hist_kernel(
               binned, node_q, gh, out, k_nodes, N_BINS_TOT, m, log2n)),
           "i64_sha256": hashlib.sha256(want.cpu().numpy().tobytes()).hexdigest()}
    if hasattr(hist_cuda, "wide_plan"):
        chunk, _, group, _ = hist_cuda.wide_plan(k_nodes, N_BINS_TOT)
        own = hist_cuda.launch_group_rows(node_q, gh, k_nodes, chunk)
        ext = hist_cuda.launch_group_rows(node_q, gh, k_nodes, chunk, m, log2n)
        f32 = torch.empty(K, F, k_nodes, N_BINS_TOT, 2, device="cuda")
        res["prep_ms"] = ms(lambda: hist_cuda.launch_group_rows(node_q, gh, k_nodes, chunk))
        res["prep_i64_ms"] = ms(lambda: hist_cuda.launch_group_rows(node_q, gh, k_nodes, chunk,
                                                                    m, log2n))
        res["wide_ms"] = ms(lambda: hist_cuda.launch_wide_kernel(
            binned, own, f32, k_nodes, N_BINS_TOT, chunk, group))
        res["wide_i64_ms"] = ms(lambda: hist_cuda.launch_wide_kernel(
            binned, ext, out, k_nodes, N_BINS_TOT, chunk, group, log2n))
    # the bound (bytes; float32 and int64 out) and one scatter_add_
    n_in = K * F * N * 2 + K * N * 4 + K * N * 8
    n_cells = K * F * k_nodes * N_BINS_TOT
    res["bound_ms"] = (n_in + n_cells * 8) / HBM_BYTES_PER_S * 1e3
    res["i64_bound_ms"] = (n_in + K * 8 + n_cells * 16) / HBM_BYTES_PER_S * 1e3
    nq = node_q.long()
    kf = torch.arange(K * F, device="cuda").view(K, F, 1) * k_nodes
    seg = (kf + nq[:, None, :]) * N_BINS_TOT + binned.long()
    seg = torch.where(((nq >= 0) & (nq < k_nodes))[:, None, :], seg, n_cells)
    idx = seg.reshape(-1, 1).expand(-1, 2)
    vals = gh[:, None, :, :].expand(K, F, N, 2).reshape(-1, 2)
    sink = torch.zeros(n_cells + 1, 2, device="cuda")
    res["library_ms"] = ms(lambda: sink.scatter_add_(0, idx, vals), reps=20)
    return res


def wide_sweep(torch, hist_cuda, ms) -> dict:
    """The wide path's launch alone (prep + histogram kernel) at every
    layout of WIDE_SWEEP_GROUPS x WIDE_SWEEP_NODES that fits, and the
    one-CTA kernel's launch alone where the level fits one CTA, at each of
    WIDE_SWEEP_LEVELS at the v92d CV's shape: two passes, the second in
    reverse order, 100 calls each; the mean of the two, each output held
    bit for bit to the wrapper's."""
    _, K, F, N, _ = WIDE_SHAPES[0]
    res = {}
    for k_nodes in WIDE_SWEEP_LEVELS:
        binned, node_q, gh = hist_inputs(torch, K, F, N, k_nodes, 2900 + k_nodes)
        want = hist_cuda.build_histograms(binned, node_q, gh, k_nodes, N_BINS_TOT)
        out = torch.empty_like(want)
        launches = {}
        if k_nodes * N_BINS_TOT <= hist_cuda.SEG_MAX_SEGMENTS:
            group, rows, _ = hist_cuda.hist_layout(k_nodes, N_BINS_TOT)
            lib = hist_cuda.cuda_build.load()
            stream = torch.cuda.current_stream().cuda_stream

            def one_cta(group=group, rows=rows):
                hist_cuda.cuda_build.check(lib.mallorn_hist(
                    binned.data_ptr(), node_q.data_ptr(), gh.data_ptr(), out.data_ptr(), K, F,
                    N, k_nodes, N_BINS_TOT, group, rows, None, 0, stream), "mallorn_hist")
            launches["one_cta"] = one_cta
        for group in WIDE_SWEEP_GROUPS:
            for n in WIDE_SWEEP_NODES:
                if hist_cuda._wide_smem_bytes(n, N_BINS_TOT, group) > hist_cuda.SMEM_BYTES:
                    continue
                chunk, _, g, _ = hist_cuda.wide_plan(k_nodes, N_BINS_TOT, (group, n))

                def wide(chunk=chunk, g=g):
                    grouped = hist_cuda.launch_group_rows(node_q, gh, k_nodes, chunk)
                    hist_cuda.launch_wide_kernel(binned, grouped, out, k_nodes, N_BINS_TOT,
                                                 chunk, g)
                launches[f"G{g}_C{chunk}"] = wide
        for name, launch in launches.items():
            out.fill_(float("nan"))
            launch()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"nodes={k_nodes} {name}: disagrees with the wrapper")
        first = {name: ms(launch, reps=100) for name, launch in launches.items()}
        second = {name: ms(launch, reps=100) for name, launch in reversed(launches.items())}
        res[f"K={K} F={F} N={N} nodes={k_nodes}"] = {
            name: (first[name] + second[name]) / 2 for name in launches}
    return res


def sweep(torch, hist_cuda, cuda_build, stream, ms) -> dict:
    """Launch-alone ms of every layout that fits, by shape and node count."""
    lib = cuda_build.load()
    res = {}
    for s, (name, K, F, N) in enumerate(SWEEP_SHAPES):
        for k_nodes in SWEEP_NODES:
            binned, node_q, gh = hist_inputs(torch, K, F, N, k_nodes, 8000 + 37 * s + k_nodes)
            want = hist_cuda.build_histograms(binned, node_q, gh, k_nodes, N_BINS_TOT)
            out = torch.empty_like(want)
            times = {}
            for group in SWEEP_GROUPS:
                for rows in SWEEP_ROWS:
                    n_seg = k_nodes * N_BINS_TOT
                    if hist_cuda._seg_smem_bytes(n_seg, group, rows) > hist_cuda.SMEM_BYTES:
                        continue

                    # a checkout whose hist_plan chunked wide levels on the
                    # grid's z axis takes nodes per CTA (here all), one with the
                    # external-scale entry a null maxabs and log2n
                    chunk = ((k_nodes,) if hasattr(hist_cuda, "hist_plan")
                             and not hasattr(hist_cuda, "wide_plan") else ())
                    if hasattr(hist_cuda, "build_histograms_i64"):
                        chunk += (None, 0)

                    def launch():
                        cuda_build.check(lib.mallorn_hist(
                            binned.data_ptr(), node_q.data_ptr(), gh.data_ptr(),
                            out.data_ptr(), K, F, N, k_nodes, N_BINS_TOT, group, rows,
                            *chunk, stream), "mallorn_hist")
                    out.fill_(float("nan"))
                    launch()
                    torch.cuda.synchronize()
                    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                        raise AssertionError(f"{name} nodes={k_nodes} G={group} R={rows}: "
                                             f"disagrees with the wrapper")
                    times[f"G{group}_R{rows}"] = ms(launch)
            res[f"{name} K={K} F={F} N={N} nodes={k_nodes}"] = times
    return res


def main(argv) -> int:
    layouts, fits, slots = "--layouts" in argv, "--fits" in argv, "--slots" in argv
    dirs = [a for a in argv if a not in ("--layouts", "--fits", "--slots")]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("time_hist: no CUDA device", file=sys.stderr)
        return 1
    runs = []
    for d in dirs:
        root = Path(d).resolve()
        got = subprocess.run([sys.executable, __file__, "--child", str(root)]
                             + (["--layouts"] if layouts else []) + (["--fits"] if fits else [])
                             + (["--slots"] if slots else []),
                             capture_output=True, text=True, timeout=900, cwd=root)
        if got.returncode != 0:
            print(f"time_hist: {d} failed:\n{got.stderr[-4000:]}", file=sys.stderr)
            return 1
        res = json.loads(got.stdout.strip().splitlines()[-1])
        runs.append({"dir": d, "shapes": res})
        for name, r in res.items():
            if name in ("sweep", "wide_sweep", "fits"):
                continue
            layout = f" layout={tuple(r['layout'])}" if "layout" in r else ""
            extra = " ".join(f"{k}={v:.4f}" for k, v in r.items()
                             if k.endswith("_ms") and k not in ("launch_ms", "wrapper_ms"))
            print(f"{d} {name}: launch_ms={r['launch_ms']:.4f} "
                  f"wrapper_ms={r['wrapper_ms']:.4f}{layout} {extra}".rstrip(), flush=True)
        for key in ("sweep", "wide_sweep"):
            for shape, times in res.get(key, {}).items():
                best = min(times, key=times.get)
                print(f"{d} {key} {shape}: best {best} " +
                      " ".join(f"{k}={v:.4f}" for k, v in times.items()), flush=True)
        for fit, r in res.get("fits", {}).items():
            kind = f"depth-8 CV {fit}" if "k1_by_nodes" in r else f"{fit} CV"
            launches = (f"K1 {r['k1']} by width {r['k1_by_nodes']}" if "k1_by_nodes" in r
                        else f"mode kernel {r['k1']}, digits' prep kernel {r['prep']}")
            print(f"{d} {kind}: {r['s']:.3f} s, rounds {r['rounds']}, OOF F1 "
                  f"{r['oof_f1']:.4f}, {launches}, forests sha256 {r['sha256'][:16]}",
                  flush=True)
    # every checkout's CVs alike but for the seconds and the prep kernel's
    # launches (a checkout from before it has none)
    if fits and len({json.dumps({f: {k: v for k, v in r.items() if k not in ("s", "prep")}
                                 for f, r in run["shapes"]["fits"].items()}, sort_keys=True)
                     for run in runs}) != 1:
        print("time_hist: the checkouts' CVs differ", file=sys.stderr)
        return 1
    for name in [s[0] for s in shapes()] + mode_names() + node_names():
        for sha in ("sha256", "i64_sha256"):
            if len({r["shapes"].get(name, {}).get(sha) for r in runs}) != 1:
                print(f"time_hist: the checkouts' outputs differ at {name}", file=sys.stderr)
                return 1
    if len(runs) > 1:
        print("outputs bit for bit equal across the checkouts at every shape")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(time_checkout("--layouts" in sys.argv[3:], "--fits" in sys.argv[3:],
                                       "--slots" in sys.argv[3:])))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
