"""Times K2 and K6, the port's batched Cholesky-inverse and Cholesky
(``mallorn_tpu_torch.ops.chol_cuda.chol_inv`` / ``cholesky``), of one or
more checkouts on one CUDA card, in turns.

    python3 tools/time_chol.py DIR [DIR ...]

Each DIR is the root of a checkout of this repository: ``.`` for this one,
or an unpacked ``git archive`` of another commit in a gitignored folder
(``.scratch_parent``). Each DIR runs in a process of its own, in the order
given, so ``.scratch_parent . . .scratch_parent`` times two commits in
turns. Every process builds its checkout's CUDA sources and takes the same
seeded inputs (``chip_smoke.py``'s ``spd_batch``: A A^T / T + I with the
last 0..T/4 rows and columns identity-padded). By CUDA events over 20
calls (2 for a column loop, in a checkout that still has one), each
process times the wrapper and, for the one-launch kernels (blocked and
cluster), the launch alone (its entry point on prepared outputs,
``launch_ms``, held bit for bit to the wrapper's output):

- the wrapper at the shapes of ``NARROW`` (T <= 320, where the blocked
  kernel serves K2 and K6), with a digest of each output;
- the wrapper at the shapes of ``WIDE`` (T > 320), whichever kernel the
  checkout dispatches there (the cluster kernel up to T = 784; beyond, the
  tiled kernel, or the column loop before it), the kernel named by the
  checkout's launch counters, the largest difference from the float64
  plain version, and a digest of each output;
- the library yardstick at every wide shape: ``cholesky_ex`` +
  ``solve_triangular`` against I (K2) or ``cholesky_ex`` (K6), and the
  bound (max of bytes / 3.35 TB/s and flops / 67 TFLOP/s).

Two checkouts must agree bit for bit at every shape of ``NARROW`` and at
every shape of ``WIDE`` up to T = 784 (``SAME_UP_TO``); beyond, their
kernels may sum in different orders, and whether they agree is reported.
Prints one line per run and shape, the card's name and power limit, and
last one JSON object of every run. Exits non-zero with no CUDA device or
when two checkouts' outputs differ where they must agree.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# (kernel, B, T): K2 is chol_inv, K6 cholesky
NARROW = (("K2", 2048, 64), ("K2", 2048, 160), ("K2", 2048, 256), ("K2", 2048, 320),
          ("K6", 2048, 160), ("K6", 64, 320))
WIDE = (("K2", 64, 336), ("K2", 63, 344), ("K2", 64, 400), ("K2", 2048, 400),
        ("K2", 64, 432), ("K2", 64, 512), ("K2", 64, 576), ("K2", 64, 784),
        ("K6", 64, 400), ("K6", 64, 512),
        ("K2", 8, 800), ("K2", 64, 1024), ("K2", 512, 1024), ("K2", 63, 1000),
        ("K6", 8, 800), ("K6", 64, 1024), ("K6", 512, 1024))
SAME_UP_TO = 784  # the blocked and cluster kernels' widest


def spd_batch(torch, B: int, T: int, seed: int):
    """chip_smoke.py's ``spd_batch``, float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(B, T, T, generator=g, device="cuda", dtype=torch.float64)
    K = A @ A.transpose(1, 2) / T + torch.eye(T, device="cuda", dtype=torch.float64)
    n_pad = torch.randint(0, T // 4 + 1, (B,), generator=g, device="cuda")
    keep = torch.arange(T, device="cuda")[None, :] < (T - n_pad)[:, None]
    mm = keep[:, :, None] & keep[:, None, :]
    eye = torch.eye(T, device="cuda", dtype=torch.float64).expand(B, T, T)
    return torch.where(mm, K, eye).float().contiguous()


def bound_ms(kernel: str, B: int, T: int) -> float:
    n_bytes = B * (T * (T + 1) // 2 + T * T) * 4 + (B * 4 if kernel == "K2" else 0)
    n_flop = B * (2.0 if kernel == "K2" else 1.0) * T ** 3 / 3.0
    return max(n_bytes / HBM_BYTES_PER_S, n_flop / F32_FLOP_PER_S) * 1e3


def time_checkout() -> dict:
    """Times the K2 and K6 of the checkout first on ``sys.path``."""
    import torch
    from mallorn_tpu_torch.ops import chol_cuda
    from mallorn_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False

    def ms(fn, reps=20, warmup=2):
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

    def launch_alone(kernel, K, out, counts):
        """The entry point of the kernel the wrapper's call counted, on
        prepared outputs, checked against the wrapper's output ``out``; None
        beyond T = 784 (a call of several launches, timed by the wrapper)."""
        B, T, _ = K.shape
        L = torch.empty_like(K)
        ld = torch.empty(B, device="cuda")
        if counts.get("launches") or counts.get("chol_launches"):
            name, args = (("mallorn_chol_inv", (ld.data_ptr(),)) if kernel == "K2"
                          else ("mallorn_chol", ()))
            tail = (B, T)
        elif counts.get("cluster_launches") or counts.get("chol_cluster_launches"):
            name, args = (("mallorn_chol_inv_cluster", (ld.data_ptr(),)) if kernel == "K2"
                          else ("mallorn_chol_cluster", ()))
            tail = (B, T, chol_cuda.cluster_size(T))
        else:
            return None

        def launch():
            cuda_build.check(getattr(lib, name)(K.data_ptr(), L.data_ptr(), *args, *tail,
                                                stream), name)
        launch()
        torch.cuda.synchronize()
        got = torch.cat([L.flatten(), ld]) if kernel == "K2" else L
        if not torch.equal(got.view(torch.int32), out.view(torch.int32)):
            raise AssertionError(f"{name} T={T}: the launch alone disagrees with the wrapper")
        return launch

    res = {}
    for kernel, B, T in NARROW:
        K = spd_batch(torch, B, T, 1000 + T)
        fn = chol_cuda.chol_inv if kernel == "K2" else chol_cuda.cholesky
        chol_cuda.reset_launches()
        out = fn(K)
        counts = {k: v for k, v in vars(chol_cuda).items()
                  if k.endswith("launches") and isinstance(v, int) and v}
        out = torch.cat([o.flatten() for o in out]) if kernel == "K2" else out
        res[f"{kernel} B={B} T={T}"] = {
            "ms": ms(lambda: fn(K)), "launch_ms": ms(launch_alone(kernel, K, out, counts)),
            "bound_ms": bound_ms(kernel, B, T),
            "sha256": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()}
    for kernel, B, T in WIDE:
        K = spd_batch(torch, B, T, 3000 + T)
        fn = chol_cuda.chol_inv if kernel == "K2" else chol_cuda.cholesky
        chol_cuda.reset_launches()
        out = fn(K)
        counts = {k: v for k, v in vars(chol_cuda).items()
                  if k.endswith("launches") and isinstance(v, int) and v}
        launch = launch_alone(kernel, K, torch.cat([o.flatten() for o in out])
                              if kernel == "K2" else out, counts)
        if kernel == "K2":
            want, _ = chol_cuda.chol_inv_plain(K.double())
            got = out[0]
        else:
            want, got = chol_cuda.cholesky_plain(K.double()), out
        err = (got.double() - want).abs().max().item()
        eye = torch.eye(T, device="cuda").expand(B, T, T)

        def library():
            L, _ = torch.linalg.cholesky_ex(K)
            if kernel == "K2":
                torch.linalg.solve_triangular(L, eye, upper=False)

        # a column loop (a checkout before the tiled kernel) takes seconds a
        # call at the widest shapes
        loop = (counts.get("large_launches") or counts.get("chol_large_launches")) and \
            not hasattr(chol_cuda, "tiled_plan")
        res[f"{kernel} B={B} T={T}"] = {
            "ms": ms(lambda: fn(K), reps=2 if loop else 20, warmup=1 if loop else 2),
            "launch_ms": ms(launch) if launch else None,
            "counters": counts, "max_abs_err_f64": err,
            "sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest(),
            "library_ms": ms(library, reps=5), "bound_ms": bound_ms(kernel, B, T)}
    return res


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("time_chol: no CUDA device", file=sys.stderr)
        return 1
    runs = []
    for d in argv:
        root = Path(d).resolve()
        got = subprocess.run([sys.executable, __file__, "--child", str(root)],
                             capture_output=True, text=True, timeout=900, cwd=root)
        if got.returncode != 0:
            print(f"time_chol: {d} failed:\n{got.stderr[-4000:]}", file=sys.stderr)
            return 1
        res = json.loads(got.stdout.strip().splitlines()[-1])
        runs.append({"dir": d, "shapes": res})
        for name, r in res.items():
            extra = "".join(f" {k}={r[k]:.4f}" for k in ("launch_ms", "library_ms", "bound_ms")
                            if r.get(k) is not None)
            if "counters" in r:
                extra += f" max_abs_err_f64={r['max_abs_err_f64']:.3e} counters={r['counters']}"
            print(f"{d} {name}: ms={r['ms']:.4f}{extra}", flush=True)
    for kernel, B, T in NARROW + tuple(w for w in WIDE if w[2] <= SAME_UP_TO):
        name = f"{kernel} B={B} T={T}"
        if len({r["shapes"][name]["sha256"] for r in runs}) != 1:
            print(f"time_chol: the checkouts' outputs differ at {name}", file=sys.stderr)
            return 1
    if len(runs) > 1:
        print(f"outputs bit for bit equal across the checkouts at every T <= {SAME_UP_TO} "
              f"shape")
        same = [f"{k} B={B} T={T}" for k, B, T in WIDE if T > SAME_UP_TO
                and len({r["shapes"][f"{k} B={B} T={T}"]["sha256"] for r in runs}) == 1]
        print(f"T > {SAME_UP_TO} shapes whose outputs are bit for bit equal across the "
              f"checkouts: {same}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(time_checkout()))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
