"""Times the port's mesh at world size 1 over NCCL on one CUDA card: each
collective a sharded fit calls, and a batched fit with and without the
mesh.

    python3 tools/time_mesh.py

One rank runs in this process (``parallel.mesh.launch(..., spawn=False)``).
Per collective, by host clocks around 300 calls after 10 warm-up calls,
with the card synchronised before and after: the max-reduce of a tree's
per-lane maxima (float32 [5, 2]), the sum-reduce of K1's int64 sums at the
v92d CV's deepest level ([5, 222, 8, 257, 2]), the leaf-sum row gather
(``sharded_train.gather_fn``: 5 x 2,444 leaf ids beside their (g, h), one
all-gather), ``torch.distributed.all_reduce`` of the [5, 2] tensor called
directly, and one plain torch op for scale. Then a 100-round, 5-fold,
depth-5 fit on 10,000 x 222 seeded rows, early-stopped at 50, without the
mesh (``train_gbdt_folds``) and on it (``train_gbdt_folds_sharded``), in
turns, twice each (the first call of each warms up); the forests are held
bit for bit equal. Last, the collectives of a 10-round fit on the mesh
(``Mesh.record``), per round.

Prints one line per measurement and the card's name and power limit.
Exits non-zero with no CUDA device or when the two fits' forests differ.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mallorn_tpu_torch.parallel import sharded_train  # noqa: E402
from mallorn_tpu_torch.parallel.mesh import launch  # noqa: E402
from mallorn_tpu_torch.trees.gbdt import GBDTParams, train_gbdt_folds  # noqa: E402


def per_call_ms(fn, n: int = 300) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def measure(mesh) -> list:
    import torch.distributed as dist

    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(0)
    maxima = torch.rand(5, 2, generator=g, device=dev)
    sums = torch.randint(0, 9, (5, 222, 8, 257, 2), generator=g, device=dev)
    leaf = torch.randint(0, 32, (5, 2444), generator=g, device=dev, dtype=torch.int32)
    gh = torch.rand(5, 2444, 2, generator=g, device=dev)
    gather = sharded_train.gather_fn(mesh, 2444)
    out = [("torch add_ of float32[5,2] (ms)", per_call_ms(lambda: maxima.add_(0))),
           ("mesh all_reduce max float32[5,2] (ms)",
            per_call_ms(lambda: mesh.all_reduce(maxima, "max"))),
           ("mesh all_reduce sum int64[5,222,8,257,2] (ms)",
            per_call_ms(lambda: mesh.all_reduce(sums))),
           ("leaf-sum gather of int32[5,2444] beside float32[5,2444,2] (ms)",
            per_call_ms(lambda: gather(leaf, gh))),
           ("dist.all_reduce float32[5,2] (ms)", per_call_ms(lambda: dist.all_reduce(maxima)))]

    rng = np.random.default_rng(0)
    n = 10000
    X = rng.normal(size=(n, 222)).astype(np.float32)
    y = (X[:, 0] + rng.normal(0, 1, n) > 1).astype(np.float32)
    folds = []
    for k in range(5):
        va = np.arange(n) % 5 == k
        folds.append({"X": X[~va], "y": y[~va], "X_val": X[va], "y_val": y[va], "spw": 1.0})
    params = GBDTParams(n_rounds=100, max_depth=5)
    fits = {"without the mesh": lambda: train_gbdt_folds(folds, params, early_stopping_rounds=50,
                                                         device=dev),
            "on the mesh": lambda: sharded_train.train_gbdt_folds_sharded(
                mesh, folds, params, early_stopping_rounds=50)}
    models = {}
    for turn in (1, 2):
        for name, fit in fits.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            models[name] = fit()
            torch.cuda.synchronize()
            out.append((f"100-round fit {name}, call {turn} (s)", time.perf_counter() - t))
    same = all(all(torch.equal(a, b) for a, b in zip(m.forest, w.forest))
               for m, w in zip(models["on the mesh"], models["without the mesh"]))
    out.append(("forests bit for bit equal", float(same)))
    with mesh.record() as calls:
        sharded_train.train_gbdt_folds_sharded(mesh, folds, params._replace(n_rounds=10))
    out.append(("collectives per round of the fit on the mesh", len(calls) / 10))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_mesh: no CUDA device is available", file=sys.stderr)
        return 2
    for name, value in launch(measure, 1, device="cuda", spawn=False):
        print(f"{name}: {value:.4f}", flush=True)
        if name == "forests bit for bit equal" and value != 1.0:
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
