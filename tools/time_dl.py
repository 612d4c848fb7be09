#!/usr/bin/env python3
"""Where a DL model's training epoch goes, on the card.

    python3 tools/time_dl.py [v10 v13 v22 v27] [--epochs 5]

For each sequence model at its default width, on the bench split's
train half (``.bench_data_v2.npz``) and its stratified 80/20 holdout, as
``train.pipelines.run_dl_model`` trains it (v22's tabular tower on a
random standardised 224-column matrix): three warm-up epochs, then
``--epochs`` full-batch Adam epochs timed with CUDA events (ms per
epoch), then the same epochs under ``torch.profiler`` with the ten CUDA
kernels of most device time and the device's busy share of the window.
TF32 stays off, as in ``chip_smoke.py``. Prints the card's name and
power limit first. Needs a card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mallorn_tpu_torch.data.packing import Metadata, pack_lightcurves  # noqa: E402
from mallorn_tpu_torch.models import (ATAT, GRUClassifier, LSTMClassifier,  # noqa: E402
                                      TransformerClassifier, make_band_batch,
                                      make_sequence_batch)
from mallorn_tpu_torch.models.data import take  # noqa: E402
from mallorn_tpu_torch.models.train_dl import focal_loss  # noqa: E402
from mallorn_tpu_torch.train.pipelines import dl_holdout, standardise_tabular  # noqa: E402

MODELS = {"v10": LSTMClassifier, "v13": TransformerClassifier, "v22": ATAT,
          "v27": GRUClassifier}


def load_train(dev):
    with np.load(ROOT / ".bench_data_v2.npz", allow_pickle=False) as z:
        cols = [z[f"tr_{k}"] for k in ("object_index", "time", "flux", "flux_err", "band")]
        meta = Metadata(object_ids=z["tr_object_ids"], z=z["tr_z"], ebv=z["tr_ebv"],
                        target=z["tr_target"])
    return pack_lightcurves(*cols, len(meta.z), device=dev), meta


def one_model(config: str, packed, meta, epochs: int, dev) -> None:
    batch = (make_band_batch if config == "v27" else make_sequence_batch)(packed, meta)
    tr_ix, _ = dl_holdout(meta.target)
    batch = take(batch, tr_ix)
    kw, args = {}, ()
    if config == "v22":
        X = np.random.default_rng(0).normal(size=(packed.n_objects, 224))
        args = (torch.as_tensor(standardise_tabular(X)[0][tr_ix], device=dev),)
        kw["n_tabular"] = 224
    model = MODELS[config](device=dev, **kw)
    model.train()
    gen = torch.Generator(device=dev).manual_seed(0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    y = batch.label.float()

    def epoch():
        opt.zero_grad(set_to_none=True)
        focal_loss(model(batch, *args, generator=gen), y).backward()
        opt.step()

    for _ in range(3):
        epoch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(epochs):
        epoch()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / epochs

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(epochs):
            epoch()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    print(f"{config} ({type(model).__name__}, {len(tr_ix)} objects): {ms:.2f} ms per epoch "
          f"(CUDA events); device kernels {total_us / 1e3 / epochs:.2f} ms per epoch "
          f"under the profiler ({100 * total_us / 1e3 / epochs / ms:.1f}% of the epoch)",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3 / epochs:8.3f} ms  "
              f"{100 * e.self_device_time_total / max(total_us, 1):5.1f}%  "
              f"x{e.count // epochs:<5d} {e.key[:110]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("configs", nargs="*", default=list(MODELS))
    ap.add_argument("--epochs", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_dl: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    packed, meta = load_train(dev)
    for config in args.configs:
        one_model(config, packed, meta, args.epochs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
