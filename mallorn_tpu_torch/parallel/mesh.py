"""Ranks, the mesh and its collectives on ``torch.distributed`` (port of
``mallorn_tpu.parallel.mesh``).

The JAX package is single-controller SPMD: one program places arrays on a
device mesh and XLA partitions the work. The port is multi-process SPMD:
``launch`` starts one process (a rank) per device, every rank runs the
same host code on the whole (small) dataset, keeps only its contiguous
block of rows for the fits (``Mesh.block``) and of objects for
extraction, and ranks meet only in the mesh's collectives
(``Mesh.all_reduce``, ``all_gather``, ``broadcast``), which record each
call's kind, dtype, shape and bytes while ``Mesh.record`` is on.

Backends: on CUDA, NCCL with one device per rank (``cuda:r``); on the
CPU, gloo. Several gloo ranks may share one CUDA device only when the
caller asks for it (``launch(..., shared_device=True)``), which is how
one card runs a two-rank mesh; gloo then carries every collective through
pinned host memory (``Mesh._host``), its transport for device tensors.

Rendezvous is a ``FileStore`` in a fresh directory (no TCP port, so that
concurrent launches never collide), the process group has a timeout (ranks
that diverge raise instead of hanging), and the parent joins its children
with a timeout, kills them on a failure and raises with the failing
rank's traceback.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before it raises
GROUP_TIMEOUT_S = 600.0
# seconds ``launch`` waits for its ranks
LAUNCH_TIMEOUT_S = 3600.0

# the launched rank's device and backend (``_init_rank`` sets them)
_RANK_CONTEXT: dict = {}


@dataclass
class Mesh:
    """One rank's view of the mesh: its process group, rank, size, device
    and shape ((size,), or (n_slices, per_slice) from ``make_mesh_2d``;
    rows shard over the joint axes in rank order). ``calls`` is the call
    log while ``record`` is on."""

    group: object
    rank: int
    size: int
    device: torch.device
    shape: Tuple[int, ...]
    backend: str
    calls: Optional[List[tuple]] = field(default=None, repr=False)

    def block(self, n: int) -> Tuple[int, int, int]:
        """(lo, hi, n_pad) of this rank's contiguous block of ``n`` rows
        padded to a multiple of the mesh size (the row quantum)."""
        n_pad = -(-int(n) // self.size) * self.size
        b = n_pad // self.size
        return self.rank * b, (self.rank + 1) * b, n_pad

    @contextlib.contextmanager
    def record(self):
        """Log every collective inside the block as (kind, "dtype[shape]",
        bytes); yields the list."""
        prev, self.calls = self.calls, []
        try:
            yield self.calls
        finally:
            self.calls = prev

    def _log(self, kind: str, t: torch.Tensor) -> None:
        if self.calls is not None:
            dt = str(t.dtype).replace("torch.", "")
            self.calls.append((kind, f"{dt}[{','.join(map(str, t.shape))}]",
                               t.numel() * t.element_size()))

    def _host(self, t: torch.Tensor) -> bool:
        """Whether ``t`` rides through pinned host memory: gloo moves no
        device memory itself."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the mesh ("sum" or "max"), in place; returns
        it."""
        self._log(f"all_reduce_{op}", t)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._host(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            dist.all_reduce(h, rop, group=self.group)
            t.copy_(h)
        else:
            dist.all_reduce(t, rop, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape on each) concatenated in rank
        order along dim 0."""
        self._log("all_gather", t)
        src = t.contiguous()
        if self._host(src):
            h = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            h.copy_(src)
            parts = [torch.empty_like(h) for _ in range(self.size)]
            dist.all_gather(parts, h, group=self.group)
            return torch.cat(parts).to(t.device)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns it."""
        self._log("broadcast", t)
        if self._host(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            dist.broadcast(h, src, group=self.group)
            t.copy_(h)
        else:
            dist.broadcast(t, src, group=self.group)
        return t


def _world():
    if not dist.is_initialized():
        raise RuntimeError("the mesh needs a process group: build it inside a rank that "
                           "launch() started")
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def _rank_device(rank: int, backend: str) -> torch.device:
    if "device" in _RANK_CONTEXT:
        return _RANK_CONTEXT["device"]
    return torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The 1-D mesh over every rank of the process group (``n_devices``,
    when given, must be the world size)."""
    rank, world, backend = _world()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: need {n_devices} devices, the process group has "
                         f"{world} ranks")
    return Mesh(dist.group.WORLD, rank, world, _rank_device(rank, backend), (world,), backend)


def make_mesh_2d(n_slices: int, per_slice: Optional[int] = None) -> Mesh:
    """The (slice, device-within-slice) mesh over every rank: rows shard
    over both axes in rank order, and the one all-reduce of a histogram
    spans the world group. Refuses a world that does not split into
    ``n_slices`` equal slices, or a shape that is not the world's."""
    rank, world, backend = _world()
    if per_slice is None:
        if n_slices <= 0 or world % n_slices != 0:
            raise ValueError(f"make_mesh_2d: {world} devices do not split into {n_slices} "
                             f"equal slices (pass per_slice explicitly to use a subset)")
        per_slice = world // n_slices
    if n_slices * per_slice > world or n_slices < 1 or per_slice < 1:
        raise ValueError(f"make_mesh_2d: need {n_slices}x{per_slice} devices, have {world}")
    if n_slices * per_slice != world:
        raise ValueError(f"make_mesh_2d: {n_slices}x{per_slice} devices is a subset of the "
                         f"{world} ranks; launch that many ranks instead")
    return Mesh(dist.group.WORLD, rank, world, _rank_device(rank, backend), (n_slices, per_slice),
                backend)


_DEFAULT_MESH: Optional[Mesh] = None


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    """Process-wide default mesh. ``train_cv`` / ``train_cv_multiclass``
    resolve ``mesh=None`` to it, so one switch (the command line's
    ``--mesh N``) turns every config's GBDT CV distributed."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def default_mesh() -> Optional[Mesh]:
    return _DEFAULT_MESH


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def run_each(mesh: Mesh, calls: Sequence[tuple]) -> list:
    """``[fn(mesh, *args, **kwargs) for fn, args, kwargs in calls]``: several
    calls in one launch (each launch pays for starting its ranks)."""
    return [fn(mesh, *args, **kwargs) for fn, args, kwargs in calls]


def _plan(n: int, device, shared_device: bool) -> Tuple[str, List[str]]:
    """(backend, each rank's device) of ``n`` ranks on ``device``."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"launch: {n} ranks")
    if dev.type == "cpu":
        return "gloo", ["cpu"] * n
    if dev.type != "cuda":
        raise ValueError(f"launch: unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("launch: a CUDA mesh needs a GPU and none is available")
    if shared_device:
        idx = dev.index or 0
        return "gloo", [f"cuda:{idx}"] * n
    n_dev = torch.cuda.device_count()
    if n > n_dev:
        raise ValueError(f"launch: {n} NCCL ranks need {n} devices; only {n_dev} devices "
                         f"available")
    return "nccl", [f"cuda:{r}" for r in range(n)]


def _init_rank(rank: int, world: int, store_path: str, backend: str, device: str,
               mesh_shape: Optional[Sequence[int]]) -> Mesh:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    _RANK_CONTEXT.update(device=dev, backend=backend)
    if mesh_shape is not None and len(mesh_shape) == 2:
        return make_mesh_2d(*mesh_shape)
    return make_mesh()


def _close_rank() -> None:
    _RANK_CONTEXT.clear()
    set_default_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, world: int, store_path: str, backend: str, device: str,
               mesh_shape, fn: Callable, args: tuple, kwargs: dict, out_dir: str,
               threads: Optional[int]) -> None:
    """A spawned rank: join the group, call ``fn(mesh, *args, **kwargs)``,
    rank 0 saves the result; an exception is written out with its
    traceback for the parent, then ends the rank (exit code 1)."""
    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = _init_rank(rank, world, store_path, backend, device, mesh_shape)
        out = fn(mesh, *args, **kwargs)
        if rank == 0:
            tmp = os.path.join(out_dir, "result.tmp")
            torch.save(out, tmp)
            os.replace(tmp, os.path.join(out_dir, "result.pt"))
        _close_rank()
    except Exception:
        Path(out_dir, f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def launch(fn: Callable, n: int, args: tuple = (), kwargs: Optional[dict] = None, *,
           device="cpu", shared_device: bool = False,
           mesh_shape: Optional[Sequence[int]] = None, spawn: bool = True,
           workdir=None, threads: Optional[int] = None, timeout: float = LAUNCH_TIMEOUT_S):
    """Run ``fn(mesh, *args, **kwargs)`` on ``n`` ranks and return rank 0's
    result (its tensors on the CPU).

    ``device``: "cpu" (gloo) or "cuda" (NCCL, one card per rank; more
    ranks than cards raises). ``shared_device``: every rank on one CUDA
    device over gloo. ``mesh_shape``: (n_slices, per_slice) for a 2-D
    mesh. ``spawn=False`` with ``n == 1`` runs the one rank in this
    process. ``workdir``: where the rendezvous file and the results live
    (a temporary directory by default). ``threads``: torch threads per
    rank (default: this process's share). The CUDA kernels are built here,
    once, before any rank starts; the ranks load that library.

    A rank that raises fails the call with its traceback; ranks still
    running after ``timeout`` seconds are killed and the call raises."""
    kwargs = kwargs or {}
    backend, devices = _plan(n, device, shared_device)
    if devices[0].startswith("cuda"):
        from mallorn_tpu_torch.utils import cuda_build

        cuda_build.build()
    base = Path(tempfile.mkdtemp(prefix="mesh_", dir=workdir))
    try:
        store = str(base / "store")
        if not spawn:
            if n != 1:
                raise ValueError("launch: spawn=False runs one rank only")
            mesh = _init_rank(0, 1, store, backend, devices[0], mesh_shape)
            try:
                return fn(mesh, *args, **kwargs)
            finally:
                _close_rank()
        if threads is None and devices[0] == "cpu":
            threads = max(1, torch.get_num_threads() // n)
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, store, backend, devices[r], mesh_shape, fn, args,
                                   kwargs, str(base), threads))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    r = failed[0]
                    err = base / f"error_{r}.txt"
                    tb = err.read_text() if err.exists() else f"exit code {procs[r].exitcode}"
                    raise RuntimeError(f"mesh rank {r} of {n} failed:\n{tb}")
                if all(p.exitcode == 0 for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"mesh ranks still running after {timeout} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        return torch.load(base / "result.pt", map_location="cpu", weights_only=False)
    finally:
        shutil.rmtree(base, ignore_errors=True)
