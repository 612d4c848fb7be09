"""The port stands alone: its import closure holds no JAX, flax, optax,
orbax, pandas, scikit-learn, matplotlib (the figures import it when they
draw) or JAX package, and its entry points default to the card.

The machine with the card has torch, numpy and scipy but no JAX, pandas
or scikit-learn, so a stray import would stop the port there. The check
runs in a fresh interpreter: this test process has JAX loaded already.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import mallorn_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mallorn_tpu_torch.__path__, "mallorn_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # its imports, without running it
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "pandas",
                                       "sklearn", "matplotlib", "mallorn_tpu"))
print("MODULES", len(mods))
print("NAMES", ",".join(mods))
print("BANNED", ",".join(banned))
"""


def test_import_closure_has_no_jax_pandas_sklearn_or_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("MODULES ", "BANNED ", "NAMES ")))
    assert int(lines["MODULES"]) >= 30
    walked = set(lines["NAMES"].split(","))
    for m in ("utils.prng", "trees.objectives", "trees.xla_cpu", "ops.hist_cuda",
              "train.cv", "train.adversarial", "train.feature_selection",
              "train.pipelines", "io.submission", "io.model_store", "features.research",
              "train.calibration", "train.oversample", "train.hpo", "train.analysis",
              "train.visualize", "features.extinction", "features.categorical",
              "features.interactions", "features.powerlaw", "features.tde_models",
              "features.blackbody", "features.advanced_physics", "features.gp1d",
              "features.dtw", "features.advanced", "features.cesium", "features.high_snr",
              "features.fourier", "features.fwhm", "features.temp_fwhm",
              "features.peak_ordering", "features.powerlaw_ratio",
              "features.enhanced_colors", "features.time_to_decline",
              "data.augmentation", "models.layers", "models.data", "models.train_dl",
              "models.transformer", "models.lstm", "models.gru", "models.atat",
              "models.mlp", "models.astromer", "features.astromer", "cli.main",
              "data.loader", "io.native", "io.cache", "utils.profiling",
              "parallel.mesh", "parallel.sharded_train", "parallel.pipeline"):
        assert f"mallorn_tpu_torch.{m}" in walked, m
    assert lines["BANNED"].strip() == "", f"the port pulled in: {lines['BANNED']}"


def test_smoke_script_fails_without_a_card_or_the_package(tmp_path):
    if torch.cuda.is_available():
        return  # on a machine with a card the script runs for real
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_entry_points_default_to_the_card(tmp_path):
    from mallorn_tpu_torch.cli.main import main as cli_main
    from mallorn_tpu_torch.data.loader import load_all_data
    from mallorn_tpu_torch.data.packing import pack_lightcurves
    from mallorn_tpu_torch.io.model_store import forest_from_numpy
    from mallorn_tpu_torch.trees.binning import fit_bins
    from mallorn_tpu_torch.utils.device import resolve_device

    cols = (np.zeros(3, np.int64), np.arange(3.0), np.ones(3), np.ones(3),
            np.zeros(3, np.int64), 1)
    X = np.random.default_rng(0).normal(size=(16, 3))
    trees = (np.zeros((2, 3)), np.zeros((2, 3)), np.zeros((2, 3), bool),
             np.zeros((2, 3), bool), np.zeros((2, 7)))
    from mallorn_tpu_torch.train.cv import train_cv
    from mallorn_tpu_torch.trees.gbdt import GBDTParams, train_gbdt

    y = np.arange(16) % 2
    small = GBDTParams(n_rounds=2, max_depth=2)
    from mallorn_tpu_torch.models import (ATAT, GRUClassifier, LSTMClassifier,
                                          TransformerClassifier)
    from mallorn_tpu_torch.models.astromer import SingleBandEncoder, load_pretrained
    from mallorn_tpu_torch.models.mlp import ResidualMLP, train_mlp_cv

    calls = [lambda **kw: pack_lightcurves(*cols, **kw),
             lambda **kw: LSTMClassifier(**kw), lambda **kw: TransformerClassifier(**kw),
             lambda **kw: GRUClassifier(**kw), lambda **kw: ATAT(**kw),
             lambda **kw: ResidualMLP(3, **kw), lambda **kw: SingleBandEncoder(**kw),
             lambda **kw: load_pretrained(**kw),
             lambda **kw: train_mlp_cv(X, y, n_folds=2, n_epochs=1, **kw),
             lambda **kw: fit_bins(X, n_bins=8, **kw),
             lambda **kw: forest_from_numpy(*trees, **kw),
             lambda **kw: train_gbdt(X, y, small, **kw),
             lambda **kw: train_cv(X, y, None, small, n_folds=2, **kw),
             lambda **kw: load_all_data(tmp_path, **kw),
             lambda **kw: cli_main(["synth", "--out", str(tmp_path / "synth")], **kw)]
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert resolve_device("cpu").type == "cpu"
    assert pack_lightcurves(*cols, device="cpu").band_time.device.type == "cpu"
    assert fit_bins(X, n_bins=8, device="cpu").edges.device.type == "cpu"
    assert forest_from_numpy(*trees, device="cpu").feature.device.type == "cpu"
    assert train_gbdt(X, y, small, device="cpu").forest.feature.device.type == "cpu"
    assert LSTMClassifier(device="cpu").Dense_0.kernel.device.type == "cpu"
    assert load_pretrained(device="cpu")[1].Dense_0.kernel.device.type == "cpu"
    from mallorn_tpu_torch.data.synthetic import generate_dataset, write_reference_layout

    _, meta, flat = generate_dataset(4, seed=1, device="cpu")
    write_reference_layout(tmp_path / "data", flat, meta)
    data = load_all_data(tmp_path / "data", device="cpu")
    assert data["train_packed"].band_time.device.type == "cpu"
