"""Times K1, the port's depthwise level histogram
(``mallorn_tpu_torch.ops.hist_cuda.build_histograms``), of one or more
checkouts on one CUDA card, in turns, and holds their outputs bit for bit
equal.

    python3 tools/time_hist.py [--layouts] DIR [DIR ...]

Each DIR is the root of a checkout of this repository: ``.`` for this one,
or an unpacked ``git archive`` of another commit in a gitignored folder
(``.scratch_parent``). Each DIR runs in a process of its own, in the order
given, so ``.scratch_parent . . .scratch_parent`` times two commits in
turns. Every process builds its checkout's CUDA sources and takes the same
seeded inputs: ``chip_smoke.py``'s K1 shapes (``HIST_SHAPES``: the
selection, adversarial, v92d and ensemble fits at every node count of
their levels, with its seeds) and its ragged shape (2,443 rows, 30% of
rows inactive). Per shape it times, by CUDA events over 50 calls, the
wrapper and the launch alone: the checkout's
``hist_cuda.launch_hist_kernel``, or, in a checkout from before that
function, its entry point of that time, which took the folds' max |g|,
|h| from the caller (computed once, untimed). With ``--layouts``, each
checkout that has ``hist_layout`` also times the launch alone with G = 1,
2, 4, 8 features per CTA and 256-, 512- and 1,024-row tiles (those that
fit) at 1, 2, 4, 8 and 16 nodes, at the v92d fit's shape (K = 5, F = 222,
N = 2,444), the adversarial fit's (N = 8,143) and the ensemble's (K = 25,
F = 224), each layout's output held bit for bit to the wrapper's.

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
    return out + [(f"{name} nodes={k}", K, F, N, k, seed, inactive)]


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


def time_checkout(layouts: bool) -> dict:
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
        if hasattr(hist_cuda, "hist_layout"):
            res[name]["layout"] = list(hist_cuda.hist_layout(k_nodes, N_BINS_TOT)[:2])
    if layouts and hasattr(hist_cuda, "hist_layout"):
        res["sweep"] = sweep(torch, hist_cuda, cuda_build, stream, ms)
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

                    # a checkout with hist_plan takes nodes per CTA (here all),
                    # one with the external-scale entry a null maxabs and log2n
                    chunk = (k_nodes,) if hasattr(hist_cuda, "hist_plan") else ()
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
    layouts = "--layouts" in argv
    dirs = [a for a in argv if a != "--layouts"]
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
                             + (["--layouts"] if layouts else []),
                             capture_output=True, text=True, timeout=900, cwd=root)
        if got.returncode != 0:
            print(f"time_hist: {d} failed:\n{got.stderr[-4000:]}", file=sys.stderr)
            return 1
        res = json.loads(got.stdout.strip().splitlines()[-1])
        runs.append({"dir": d, "shapes": res})
        for name, r in res.items():
            if name == "sweep":
                continue
            layout = f" layout(G, rows)={tuple(r['layout'])}" if "layout" in r else ""
            print(f"{d} {name}: launch_ms={r['launch_ms']:.4f} "
                  f"wrapper_ms={r['wrapper_ms']:.4f}{layout}", flush=True)
        for shape, times in res.get("sweep", {}).items():
            best = min(times, key=times.get)
            print(f"{d} sweep {shape}: best {best} " +
                  " ".join(f"{k}={v:.4f}" for k, v in times.items()), flush=True)
    for name, *_ in shapes():
        if len({r["shapes"][name]["sha256"] for r in runs}) != 1:
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
        print(json.dumps(time_checkout("--layouts" in sys.argv[3:])))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
