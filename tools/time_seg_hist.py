"""Times K3, the port's leaf-wise segment histogram
(``mallorn_tpu_torch.ops.hist_cuda.build_seg_histograms``), of one or more
checkouts on one CUDA card, in turns, and holds their outputs bit for bit
equal.

    python3 tools/time_seg_hist.py [--layouts] DIR [DIR ...]

Each DIR is the root of a checkout of this repository: ``.`` for this one,
or an unpacked ``git archive`` of another commit in a gitignored folder
(``.scratch_parent``). Each DIR runs in a process of its own, in the order
given, so ``.scratch_parent . . .scratch_parent`` times two commits in
turns. Every process builds its checkout's CUDA sources and takes the same
seeded inputs: ``chip_smoke.py``'s four K3 shapes of the v114d member (25
lanes, 228 columns; a tree's root, a pair of children, a pair with 70% of
rows inactive, a pair whose features miss half their rows). Per shape it
times, by CUDA events over 50 calls, the wrapper and the launch alone: the
checkout's ``hist_cuda.launch_seg_kernel``, or, in a checkout from before
that function, its entry point of that time, which took the lane's
max |g|, |h| from the caller. With ``--layouts``, each checkout that has
``seg_hist_layout`` also times the launch alone at the pair shape with
G = 2, 4, 8 features per CTA and 256-, 512- and 1,024-row tiles.

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
SEG_LANES, SEG_F = 25, 228
# (name, rows, nodes, share of rows inactive, share of bins moved to the
# missing bin), chip_smoke.py's SEG_SHAPES with its seeds 4000 + i
SEG_SHAPES = (("root", 2444, 1, 0.0, 0.0), ("pair", 2444, 2, 0.0, 0.0),
              ("ragged", 2443, 2, 0.7, 0.0), ("crowded", 2444, 2, 0.0, 0.5))
LAYOUTS = ((2, 512), (4, 512), (8, 512), (4, 256), (4, 1024))


def seg_inputs(torch, N: int, n_nodes: int, seed: int, inactive: float, missing: float,
               root: bool):
    """chip_smoke.py's ``seg_inputs`` at K = SEG_LANES, F = SEG_F."""
    K, F = SEG_LANES, SEG_F
    g = torch.Generator(device="cuda").manual_seed(seed)
    binned = torch.randint(0, N_BINS_TOT, (K, F, N), generator=g, device="cuda").to(torch.int16)
    node_q = torch.randint(0, n_nodes + 1, (K, N), generator=g, device="cuda")
    node_q[torch.rand(K, N, generator=g, device="cuda") < inactive] = n_nodes
    p = torch.rand(K, N, generator=g, device="cuda")
    y = (torch.rand(K, N, generator=g, device="cuda") < 0.1).float()
    w = 0.5 + 1.5 * torch.rand(K, N, generator=g, device="cuda")
    gh = torch.stack([w * (p - y), w * p * (1 - p)], dim=-1).contiguous()
    if root:
        node_q = torch.zeros_like(node_q)
    if missing:
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        binned[torch.rand(K, F, N, generator=g, device="cuda") < missing] = N_BINS_TOT - 1
    seg_base = (node_q.to(torch.int32) * N_BINS_TOT).contiguous()
    return binned.contiguous(), seg_base, gh


def time_checkout(layouts: bool) -> dict:
    """Times the K3 of the checkout first on ``sys.path``."""
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
    for i, (name, N, nodes, inactive, missing) in enumerate(SEG_SHAPES):
        binned, seg_base, gh = seg_inputs(torch, N, nodes, 4000 + i, inactive, missing,
                                          root=name == "root")
        n_seg = nodes * N_BINS_TOT
        K, F, _ = binned.shape
        out = torch.empty(K, F, n_seg, 2, device="cuda")
        if hasattr(hist_cuda, "launch_seg_kernel"):
            def launch():
                hist_cuda.launch_seg_kernel(binned, seg_base, gh, out, n_seg)
        else:  # one CTA per (lane, feature), the lane's scale from the caller
            maxabs = gh.abs().amax(dim=1).contiguous()

            def launch():
                cuda_build.check(lib.mallorn_seg_hist(
                    binned.data_ptr(), seg_base.data_ptr(), gh.data_ptr(), maxabs.data_ptr(),
                    out.data_ptr(), K, F, N, n_seg, stream), "mallorn_seg_hist")
        want = hist_cuda.build_seg_histograms(binned, seg_base, gh, n_seg)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name}: the launch alone disagrees with the wrapper")
        res[name] = {
            "wrapper_ms": ms(lambda: hist_cuda.build_seg_histograms(binned, seg_base, gh, n_seg)),
            "launch_ms": ms(launch),
            "sha256": hashlib.sha256(want.cpu().numpy().tobytes()).hexdigest()}
        if layouts and name == "pair" and hasattr(hist_cuda, "seg_hist_layout"):
            def launch_at(group, rows):
                cuda_build.check(lib.mallorn_seg_hist(
                    binned.data_ptr(), seg_base.data_ptr(), gh.data_ptr(), out.data_ptr(),
                    K, F, N, n_seg, group, rows, stream), "mallorn_seg_hist")
            res[name]["launch_ms_by_layout"] = {
                f"G{g}_R{r}": ms(lambda: launch_at(g, r)) for g, r in LAYOUTS}
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise AssertionError("pair: a layout's output disagrees with the wrapper's")
    return res


def main(argv) -> int:
    layouts = "--layouts" in argv
    dirs = [a for a in argv if a != "--layouts"]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("time_seg_hist: no CUDA device", file=sys.stderr)
        return 1
    runs = []
    for d in dirs:
        root = Path(d).resolve()
        got = subprocess.run([sys.executable, __file__, "--child", str(root)]
                             + (["--layouts"] if layouts else []),
                             capture_output=True, text=True, timeout=900, cwd=root)
        if got.returncode != 0:
            print(f"time_seg_hist: {d} failed:\n{got.stderr[-4000:]}", file=sys.stderr)
            return 1
        res = json.loads(got.stdout.strip().splitlines()[-1])
        runs.append({"dir": d, "shapes": res})
        for name, r in res.items():
            extra = "".join(f" {k}={v:.4f}" for k, v in r.get("launch_ms_by_layout", {}).items())
            print(f"{d} {name}: launch_ms={r['launch_ms']:.4f} "
                  f"wrapper_ms={r['wrapper_ms']:.4f}{extra}", flush=True)
    for name, *_ in SEG_SHAPES:
        if len({r["shapes"][name]["sha256"] for r in runs}) != 1:
            print(f"time_seg_hist: the checkouts' outputs differ at {name}", file=sys.stderr)
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
