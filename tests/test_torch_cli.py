"""The port's command line (``mallorn_tpu_torch.cli.main``) against the JAX
package's (``mallorn_tpu.cli.main``) on one small workspace.

The port writes the workspace: ``synth`` at 120 objects (train) and 279
(test), then ``extract`` of the four v92d families and ``research`` at
8 GP steps, all on the CPU. The JAX command line trains on a copy of
that cache, so the two packages' selection artifacts never mix. Both
train with ``--set hist_subtract=false`` and the port's adversarial CV
without subtraction (the JAX package's CPU fits never subtract; with
subtraction, empty-bin residuals decide some exact ties otherwise, see
tests/test_torch_gbdt_train.py), so their forests are the same.

A ``slow`` sweep runs every ``--config`` on the port alone, as
tests/test_cli.py does for the JAX package.
"""

import filecmp
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mallorn_tpu.cli.main import main as jax_main
from mallorn_tpu_torch.cli import main as cli
from mallorn_tpu_torch.train import pipelines as TP

N_TRAIN = 120
N_TEST = int(N_TRAIN * 2.33)
FAMILIES = "features_v4,tde_physics,multiband_gp,bazin,research"
EXTRA_FAMILIES = ("powerlaw,powerlaw_ratio,peak_ordering,fwhm,temp_fwhm,dtw,advanced,"
                  "advanced_physics,cesium,fourier,enhanced_colors,time_to_decline,"
                  "blackbody,high_snr,astromer")
PARITY = ["--rounds", "12", "--set", "hist_subtract=false"]


def port_main(argv):
    cli.main(argv, device="cpu")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_cli_ws")
    port_main(["synth", "--out", str(ws / "data"), "--n-objects", str(N_TRAIN),
               "--seed", "5"])
    port_main(["extract", "--data", str(ws / "data"), "--cache", str(ws / "cache"),
               "--families", FAMILIES, "--gp-steps", "8"])
    shutil.copytree(ws / "cache", ws / "cache_jax")
    return ws


@pytest.fixture
def direct_adversarial(monkeypatch):
    monkeypatch.setattr(TP, "ADV_PARAMS", TP.ADV_PARAMS._replace(hist_subtract=False))


@pytest.fixture(scope="module")
def trained(workspace):
    """``trained(package, config)``: the output folder of that package's
    ``train --config``, trained the first time a test asks for it."""
    done = {}
    runs = {"port": (port_main, "cache"), "jax": (jax_main, "cache_jax")}

    def train(package, config):
        out = workspace / f"{package}_{config}"
        if (package, config) not in done:
            run, cache = runs[package]
            run(["train", "--data", str(workspace / "data"), "--cache", str(workspace / cache),
                 "--config", config, "--out", str(out), *PARITY])
            done[package, config] = out
        return out

    return train


def test_workspace_files(workspace):
    log = (workspace / "data" / "train_log.csv").read_text().splitlines()
    assert log[0] == "object_id,Z,EBV,SpecType,target" and len(log) == 1 + N_TRAIN
    assert len((workspace / "data" / "test_log.csv").read_text().splitlines()) == 1 + N_TEST
    for fam in FAMILIES.split(","):
        for split in ("train", "test"):
            assert (workspace / "cache" / f"{fam}_{split}.npz").exists()


@pytest.mark.parametrize("config", ["v92d", "v34a"])
def test_train_matches_the_jax_command_line(trained, direct_adversarial, config):
    t_out, j_out = trained("port", config), trained("jax", config)
    got = json.loads((t_out / f"result_{config}.json").read_text())
    want = json.loads((j_out / f"result_{config}.json").read_text())
    assert sorted(got) == sorted(want)
    for k in ("oof_f1", "threshold", "n_features"):
        assert got[k] == want[k], k
    if "adv_auc" in want:
        assert got.pop("adv_auc") == pytest.approx(want.pop("adv_auc"), rel=1e-12)
    assert got == want
    assert filecmp.cmp(t_out / f"submission_{config}.csv", j_out / f"submission_{config}.csv",
                       shallow=False)
    lines = (t_out / f"submission_{config}.csv").read_text().splitlines()
    assert lines[0] == "object_id,target" and len(lines) == 1 + N_TEST
    assert (t_out / f"models_{config}" / "manifest.json").exists()


@pytest.mark.parametrize("config", ["v92d", "v34a"])
def test_predict_from_the_ports_models(workspace, trained, direct_adversarial, config):
    """The port's ``predict`` equals the JAX package's fold models and
    ``predict_proba_folds`` on the model's columns, and train's submission.
    (The JAX command line's own ``predict`` feeds both of a model's
    ``temp_stability`` columns tde_physics' copy, ``mallorn_tpu/cli/main.py:
    777-781``, which this workspace's models keep.)"""
    from mallorn_tpu.io.model_store import load_cv_models
    from mallorn_tpu.trees.gbdt import predict_proba_folds

    model = trained("port", config) / f"models_{config}"
    out = workspace / f"port_pred_{config}"
    port_main(["predict", "--data", str(workspace / "data"), "--cache",
               str(workspace / "cache"), "--model", str(model), "--out", str(out)])
    got = np.load(out / "probs_test.npy")
    models, man = load_cv_models(model)
    X_all, names = cli.load_matrices(workspace / "cache_jax", "test", FAMILIES.split(",")[:4])
    cols = cli.model_columns(names, man["feature_names"])
    assert [names[i] for i in cols] == man["feature_names"]
    assert len(set(cols)) == len(cols)  # every copy of a shared name its own column
    X = np.nan_to_num(X_all[:, cols], nan=np.nan, posinf=1e10, neginf=-1e10)
    want = np.asarray(predict_proba_folds(models, X)).mean(axis=0)
    assert got.shape == (N_TEST,) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    def labels(path):
        return np.array([int(line.rsplit(",", 1)[1])
                         for line in path.read_text().splitlines()[1:]])

    far = np.abs(got - man["threshold"]) > 1e-4
    from_train = labels(model.parent / f"submission_{config}.csv")
    np.testing.assert_array_equal(labels(out / "submission_test.csv")[far], from_train[far])


def test_model_columns_takes_each_copy_once():
    names = ["a", "t", "b", "t", "c", "r", "r"]
    assert cli.model_columns(names, ["t", "b", "t", "r"]) == [1, 2, 3, 6]
    assert cli.model_columns(names, ["b", "t", "c"]) == [2, 3, 4]
    with pytest.raises(SystemExit, match="missing columns"):
        cli.model_columns(names, ["a", "zz"])
    with pytest.raises(SystemExit, match="3 columns named 'a'"):
        cli.model_columns(names, ["a", "a", "a"])


def _argparse_error(fn, argv, capsys):
    with pytest.raises(SystemExit):
        fn(argv)
    return capsys.readouterr().err.strip().splitlines()[-1].split(": ", 1)[1]


def test_config_choices_and_options_equal_the_jax_parser(capsys):
    argv = ["train", "--data", "d", "--cache", "c", "--config", "no_such_config"]
    want = _argparse_error(jax_main, argv, capsys)
    got = _argparse_error(port_main, argv, capsys)
    assert got == want and "v92d" in got and "kaggle" in got
    train = cli.build_parser()._subparsers._group_actions[0].choices["train"]
    assert train.get_default("config") == "v92d"
    for cmd in ("synth", "extract", "train", "predict"):
        with pytest.raises(SystemExit):
            port_main([cmd, "--no-such-option"])


BAD_SETS = ("max_depth=2.5", "reg_lambda=abc", "max_depth=nan", "learning_rate=inf",
            "hist_subtract=ture", "not_a_field=1")


def test_set_errors_give_the_jax_messages(workspace):
    for bad in BAD_SETS:
        argv = ["train", "--data", str(workspace / "data"), "--cache",
                str(workspace / "cache"), "--config", "v34a", "--out",
                str(workspace / "bad"), "--rounds", "2", "--set", bad]
        with pytest.raises(SystemExit) as got:
            port_main(argv)
        with pytest.raises(SystemExit) as want:
            jax_main(argv[:4] + [str(workspace / "cache_jax")] + argv[5:])
        g, w = str(got.value), str(want.value)
        assert g.startswith("--set") and g.split(" (valid:")[0] == w.split(" (valid:")[0], bad
    # a TPU-only field of the JAX package's GBDTParams is unknown here
    with pytest.raises(SystemExit, match="unknown GBDTParams field 'use_pallas_hist'"):
        port_main(argv[:-1] + ["use_pallas_hist=true"])
    assert cli.apply_overrides(TP.V34A_PARAMS, 7, "hist_dtype=int8,reg_lambda=5").n_rounds == 7


def test_module_entry_point_refuses_without_a_card(workspace):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run on it")
    r = subprocess.run([sys.executable, "-m", "mallorn_tpu_torch.cli.main", "synth", "--out",
                        str(workspace / "refused")], capture_output=True, text=True,
                       timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert r.returncode != 0 and "device='cpu'" in r.stderr
    assert not (workspace / "refused").exists()


def test_train_mesh_flag_identical_result(workspace, trained, monkeypatch):
    """``train --mesh 2`` on the host: two gloo ranks, every CV's rows split
    over them (the default mesh of each rank, never of this process), rank
    0 the only writer: the single-device result JSON and submission. More
    ranks than cards is refused with the JAX package's message
    (``mallorn_tpu/cli/main.py:153-155``)."""
    import torch

    from mallorn_tpu_torch.parallel.mesh import default_mesh

    single = trained("port", "v34a")
    out = workspace / "port_v34a_mesh"
    argv = ["train", "--data", str(workspace / "data"), "--cache", str(workspace / "cache"),
            "--config", "v34a", "--out", str(out), *PARITY]
    port_main(argv + ["--mesh", "2"])
    assert (json.loads((out / "result_v34a.json").read_text())
            == json.loads((single / "result_v34a.json").read_text()))
    assert filecmp.cmp(out / "submission_v34a.csv", single / "submission_v34a.csv",
                       shallow=False)
    assert default_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--mesh 2: only 1 devices available"):
        cli.main(argv + ["--mesh", "2"])


# ---------------------------------------------------------------------------
# slow: every config on the port alone
# ---------------------------------------------------------------------------

ALL_CONFIGS = [c for c in cli.CONFIGS if c != "v16"]  # v16 needs external data: below


@pytest.fixture(scope="module")
def full_workspace(workspace):
    port_main(["extract", "--data", str(workspace / "data"), "--cache",
               str(workspace / "cache"), "--families", EXTRA_FAMILIES, "--gp-steps", "8"])
    return workspace


@pytest.mark.slow
@pytest.mark.parametrize("config", ALL_CONFIGS)
def test_every_config_end_to_end(full_workspace, config):
    out = full_workspace / f"sweep_{config}"
    port_main(["train", "--data", str(full_workspace / "data"), "--cache",
               str(full_workspace / "cache"), "--config", config, "--out", str(out),
               "--rounds", "12"])
    result = json.loads((out / f"result_{config}.json").read_text())
    key = "val_f1" if config in TP.DL_CONFIGS else "oof_f1"
    assert 0.0 <= result[key] <= 1.0 and np.isfinite(result["threshold"])
    lines = (out / f"submission_{config}.csv").read_text().strip().splitlines()
    assert len(lines) == 1 + N_TEST
    assert {int(line.rsplit(",", 1)[1]) for line in lines[1:]} <= {0, 1}


@pytest.mark.slow
def test_v16_external_rows(full_workspace, tmp_path_factory):
    ext = tmp_path_factory.mktemp("torch_cli_ext")
    port_main(["synth", "--out", str(ext / "data"), "--n-objects", "80", "--seed", "77"])
    port_main(["extract", "--data", str(ext / "data"), "--cache", str(ext / "cache"),
               "--families", "features_v4,tde_physics,multiband_gp,bazin", "--gp-steps", "8"])
    out = full_workspace / "sweep_v16"
    port_main(["train", "--data", str(full_workspace / "data"), "--cache",
               str(full_workspace / "cache"), "--config", "v16", "--out", str(out),
               "--rounds", "12", "--data-external", str(ext / "data"),
               "--cache-external", str(ext / "cache")])
    result = json.loads((out / "result_v16.json").read_text())
    assert result["n_external"] == 80 and np.isfinite(result["oof_f1"])
