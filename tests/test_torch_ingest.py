"""The port's data ingest against the JAX package's: the reference layout's
writer, the loader (the native parser and its numpy twin), the feature
cache, the profiling tools and ``predict_proba_folds``.

Both packages get the same numpy inputs. The native parser and its twin
are held to each other and to the JAX package's native path bit for bit;
the JAX package's pandas path, whose float parser is not correctly
rounded, at ``tests/test_native_csv.py``'s tolerances.
"""

import filecmp
import json
import zipfile

import numpy as np
import pytest
import torch

from mallorn_tpu.data import loader as JL
from mallorn_tpu.data import synthetic as JS
from mallorn_tpu.io import cache as JC
from mallorn_tpu.io import native as JN
from mallorn_tpu.utils import profiling as JP
from mallorn_tpu_torch.data import loader as TL
from mallorn_tpu_torch.data import synthetic as TS
from mallorn_tpu_torch.io import cache as TC
from mallorn_tpu_torch.io import native as TN
from mallorn_tpu_torch.utils import profiling as TPF

HEADER = "object_id,Time (MJD),Flux,Flux_err,Filter\n"


def bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8) if a.dtype.kind in "fc" else a


def packed_bits_equal(port, jax_packed):
    for x, y in zip(port.tensors(), jax_packed[:-1]):
        x, y = x.numpy(), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(bits(x), bits(y))
    assert port.time_offset == jax_packed.time_offset


def meta_equal(port, jax_meta):
    np.testing.assert_array_equal(port.object_ids, np.asarray(jax_meta.object_ids).astype(str))
    np.testing.assert_array_equal(bits(port.z), bits(jax_meta.z))
    np.testing.assert_array_equal(bits(port.ebv), bits(jax_meta.ebv))
    for a, b in ((port.target, jax_meta.target), (port.spec_type, jax_meta.spec_type)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """Both packages' layouts of a 12-object train split and a 64-object
    test split (20 shards, no targets, as the JAX package's synth writes)."""
    out = {}
    _, meta_tr, cols_tr = JS.generate_dataset(12, seed=7)
    _, meta_te, cols_te = JS.generate_dataset(64, seed=8, **JS.TEST_SHIFT)
    for tag, writer in (("jax", JS.write_reference_layout), ("port", TS.write_reference_layout)):
        d = tmp_path_factory.mktemp(f"layout_{tag}")
        writer(d, cols_tr, meta_tr, split="train")
        writer(d, cols_te, meta_te, n_splits=20, split="test")
        out[tag] = d
    return out


def test_reference_layout_bytes_equal(layout):
    files = sorted(p.relative_to(layout["jax"]) for p in layout["jax"].rglob("*.csv"))
    assert len(files) == 2 + 4 + 20
    assert files == sorted(p.relative_to(layout["port"]) for p in layout["port"].rglob("*.csv"))
    for f in files:
        assert filecmp.cmp(layout["jax"] / f, layout["port"] / f, shallow=False), f
    head = (layout["port"] / "test_log.csv").read_text().splitlines()[0]
    assert head == "object_id,Z,EBV,SpecType"  # no target in the test split


def test_csv_text_is_pandas_text():
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    a = rng.standard_normal(5000) * 10.0 ** rng.integers(-30, 30, 5000)
    a[::97] = np.nan
    a[1], a[2], a[3] = -0.0, np.inf, 5e-324
    b = a.astype(np.float32)
    frame = pd.DataFrame({"a": a, "b": b}).to_csv(index=False).splitlines()[1:]
    want = [line.split(",") for line in frame]
    assert [w[0] for w in want] == TS.csv_text(a)
    assert [w[1] for w in want] == TS.csv_text(b)


@pytest.mark.parametrize("use_native", [True, False])
def test_load_all_data_bit_for_bit(layout, use_native):
    port = TL.load_all_data(layout["port"], use_native=use_native, device="cpu")
    jax_native = JL.load_all_data(layout["port"], use_native=True)
    jax_pandas = JL.load_all_data(layout["port"], use_native=False)
    assert sorted(port) == sorted(jax_native) == ["test_meta", "test_packed", "train_meta",
                                                  "train_packed"]
    for split in ("train", "test"):
        packed_bits_equal(port[f"{split}_packed"], jax_native[f"{split}_packed"])
        meta_equal(port[f"{split}_meta"], jax_native[f"{split}_meta"])
        pn, pp = port[f"{split}_packed"], jax_pandas[f"{split}_packed"]
        np.testing.assert_array_equal(pn.band_mask.numpy(), np.asarray(pp.band_mask))
        np.testing.assert_allclose(pn.band_flux.numpy(), np.asarray(pp.band_flux),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pn.all_time.numpy(), np.asarray(pp.all_time),
                                   rtol=1e-6, atol=1e-4)


def test_native_parser_and_twin_on_every_shard(layout):
    for p in sorted(layout["port"].rglob("*_full_lightcurves.csv")):
        a, b, j = TN.parse_lightcurves(p), TN.parse_lightcurves_np(p), JN.parse_lightcurves(p)
        for k in ("time", "flux", "flux_err", "band", "object_index"):
            np.testing.assert_array_equal(bits(a[k]), bits(b[k]))
            np.testing.assert_array_equal(bits(a[k]), bits(j[k]))
        assert list(a["object_ids"]) == list(b["object_ids"]) == list(j["object_ids"])


@pytest.mark.parametrize("parse", [TN.parse_lightcurves, TN.parse_lightcurves_np])
def test_parse_direct(tmp_path, parse):
    p = tmp_path / "lc.csv"
    p.write_text(HEADER + "OBJ1,60001.5,10.25,0.5,g\nOBJ1,60002.5,11.0,0.5,r\n"
                 "OBJ2,60003.0,-3.5,1.25,u\nOBJ1,60004.0,9.0,0.4,g\n")
    d = parse(p)
    assert list(d["object_ids"]) == ["OBJ1", "OBJ2"]
    np.testing.assert_array_equal(d["object_index"], [0, 0, 1, 0])
    np.testing.assert_array_equal(d["time"], [60001.5, 60002.5, 60003.0, 60004.0])
    np.testing.assert_array_equal(d["flux"], [10.25, 11.0, -3.5, 9.0])
    np.testing.assert_array_equal(d["band"], [1, 2, 0, 1])


@pytest.mark.parametrize("parse", [TN.parse_lightcurves, TN.parse_lightcurves_np])
def test_parse_empty_and_junk_fields_are_nan(tmp_path, parse):
    p = tmp_path / "lc.csv"
    p.write_text(HEADER + "OBJ1,60001.5,,0.5,g\nOBJ1,60002.5,11.0,junk,r\n"
                 "OBJ1,60003.5,1e30,0.5,i\n")
    d = parse(p)
    assert np.isnan(d["flux"][0]) and d["flux"][2] == 1e30
    assert np.isnan(d["flux_err"][1])
    np.testing.assert_array_equal(d["time"], [60001.5, 60002.5, 60003.5])


def test_twin_follows_strtod_and_the_row_rules(tmp_path):
    """Prefixes, hex, inf / nan, white space, long fields, CRLF, columns in
    another order, short rows and unknown filters: the twin's arrays are
    the parser's, bit for bit."""
    fields = ["1.5x", "0x1.8p3", "-0X.8", "inf", "-Infinity", "nan", "  2.5", "1e", "1e+",
              "-", ".", ".5", "5.", "+.5e-3", "1_000", "0x", "1e400", "1e-400", "-0",
              "4.9e-324", "1" * 70 + ".5", "0." + "0" * 70 + "1", "\t7", "", "abc", "1.5.5",
              "12345678901234567890123", "2.2250738585072011e-308"]
    rows = ["Filter,junk,Flux_err,Flux,object_id,Time (MJD)\r\n"]
    for i, v in enumerate(fields):
        rows.append(f"{'ugrizy'[i % 6]}suffix,x,{v},{fields[-1 - i]},ID{i % 4},{v}\r\n")
    rows += ["q,x,1,1,IDQ,1\r\n", "g,x,1\r\n", "\r\n", "\n", "Y,x,1,1,ID9,1\n",
             "z,x,3,4,ID5,6"]
    p = tmp_path / "odd.csv"
    p.write_bytes("".join(rows).encode())
    a, b = TN.parse_lightcurves(p), TN.parse_lightcurves_np(p)
    assert a["time"].shape == (len(fields) + 1,)
    for k in ("time", "flux", "flux_err", "band", "object_index"):
        np.testing.assert_array_equal(bits(a[k]), bits(b[k]))
    assert list(a["object_ids"]) == list(b["object_ids"]) == ["ID0", "ID1", "ID2", "ID3", "ID5"]
    for bad in ("object_id,Flux\n1,2\n", "no header line"):
        q = tmp_path / "bad.csv"
        q.write_text(bad)
        for parse in (TN.parse_lightcurves, TN.parse_lightcurves_np):
            with pytest.raises(ValueError, match="fast_csv"):
                parse(q)


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "fast_csv.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "SRC", src)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "_lib", None)
    with pytest.raises(RuntimeError, match="native CSV parser build failed"):
        TN.parse_lightcurves(tmp_path / "any.csv")


def test_unknown_objects_missing_columns_and_splits(tmp_path):
    _, meta, cols = JS.generate_dataset(10, seed=3)
    TS.write_reference_layout(tmp_path, cols, meta, split="train")
    # rows of an object the log does not list are dropped
    shard = tmp_path / "split_01" / "train_full_lightcurves.csv"
    with open(shard, "a") as f:
        f.write("GHOST,60010.0,1.0,0.5,g\nGHOST,60011.0,2.0,0.5,r\n")
    # a log without Z / EBV: zeros
    log = (tmp_path / "train_log.csv").read_text().splitlines()
    (tmp_path / "train_log.csv").write_text(
        "\n".join(",".join(c for i, c in enumerate(line.split(",")) if i not in (1, 2))
                  for line in log) + "\n")
    port = TL.load_all_data(tmp_path, device="cpu")
    jax_native = JL.load_all_data(tmp_path, use_native=True)
    assert sorted(port) == ["train_meta", "train_packed"]  # no test split
    packed_bits_equal(port["train_packed"], jax_native["train_packed"])
    meta_equal(port["train_meta"], jax_native["train_meta"])
    assert not port["train_meta"].z.any() and port["train_meta"].z.dtype == np.float32
    assert int(port["train_packed"].band_mask.sum()) == len(cols["time"])
    twin = TL.load_all_data(tmp_path, use_native=False, device="cpu")
    packed_bits_equal(twin["train_packed"], jax_native["train_packed"])
    # a log with no lightcurve files, and nothing at all
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "train_log.csv").write_text("object_id,Z,EBV\nA,0.1,0.01\n")
    with pytest.raises(FileNotFoundError):
        TL.load_all_data(empty, device="cpu")
    with pytest.raises(FileNotFoundError):
        TL.load_metadata(empty, "test")


def test_cache_round_trips_between_packages(tmp_path):
    rng = np.random.default_rng(1)
    feats = {"b": torch.tensor(rng.normal(size=7)), "a": torch.tensor(rng.normal(size=7))}
    feats["a"][2] = float("nan")
    ids = np.array([f"SYN{i:06d}" for i in range(7)])
    TC.save_features(tmp_path / "port.npz", feats, ids)
    mat, names, oids = JC.load_features(tmp_path / "port.npz")
    assert names == ["b", "a"] and mat.dtype == np.float32
    np.testing.assert_array_equal(bits(mat), bits(np.stack([feats["b"].numpy(), feats["a"].numpy()],
                                                           axis=1).astype(np.float32)))
    np.testing.assert_array_equal(oids, ids)
    assert json.loads((tmp_path / "port.manifest.json").read_text()) == {"names": names}

    JC.save_features(tmp_path / "jax.npz", {k: v.numpy() for k, v in feats.items()}, ids)
    m2, n2, o2 = TC.load_features(tmp_path / "jax.npz")
    np.testing.assert_array_equal(bits(m2), bits(mat))
    assert n2 == names and list(o2) == list(ids)


def test_cached_heals_a_broken_entry(tmp_path):
    calls = []

    def compute():
        calls.append(1)
        return {"x": np.arange(3.0)}

    entry = tmp_path / "fam_train.npz"
    entry.write_bytes(b"truncated")
    mat, names, _ = TC.cached(entry, compute, object_ids=np.array(["a", "b", "c"]))
    assert calls == [1] and names == ["x"] and zipfile.is_zipfile(entry)
    TC.cached(entry, compute, object_ids=np.array(["a", "b", "c"]))
    assert calls == [1]  # a good entry loads
    # names and columns of different generations
    TC.atomic_savez(entry, matrix=np.zeros((3, 2), np.float32),
                    object_ids=np.array(["a", "b", "c"]), names=np.array(["x"]))
    mat, names, _ = TC.cached(entry, compute, object_ids=np.array(["a", "b", "c"]))
    assert calls == [1, 1] and mat.shape == (3, 1)


def test_timings_report_matches():
    records = [("load", 1.25), ("extract/gp", 12.5), ("extract", 14.0), ("train/cv/fold", 0.004)]
    tj, tp = JP.Timings(), TPF.Timings()
    tj.records, tp.records = list(records), list(records)
    assert tp.report() == tj.report() and tp.totals() == tj.totals()
    with tp.section("a"):
        with tp.section("b"):
            pass
    assert [r[0] for r in tp.records[-2:]] == ["a/b", "a"]


def test_device_trace_and_block_and_time(tmp_path):
    with TPF.device_trace(None) as prof:
        assert prof is None
    with TPF.device_trace(str(tmp_path / "trace")):
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    out, secs = TPF.block_and_time(torch.mm, x, x)
    assert out.shape == (64, 64) and secs >= 0.0


def test_predict_proba_folds_matches(tmp_path):
    from mallorn_tpu.io.model_store import load_cv_models as j_load
    from mallorn_tpu.trees.gbdt import predict_proba_folds as j_ppf
    from mallorn_tpu_torch.io.model_store import load_cv_models as t_load
    from mallorn_tpu_torch.io.model_store import save_cv_models
    from mallorn_tpu_torch.train.cv import train_cv
    from mallorn_tpu_torch.trees.gbdt import V34A_PARAMS, predict_proba_folds

    rng = np.random.default_rng(4)
    X = rng.normal(size=(160, 9)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    y = (X[:, 0] + 0.5 * rng.normal(size=160) > 0.8).astype(np.int64)
    cv = train_cv(X, y, None, V34A_PARAMS._replace(n_rounds=20), device="cpu")
    save_cv_models(tmp_path / "models_v34a", cv.models, cv.best_threshold,
                   [f"f{i}" for i in range(9)])
    Xq = rng.normal(size=(50, 9)).astype(np.float32)
    tm, _ = t_load(tmp_path / "models_v34a", device="cpu")
    jm, _ = j_load(tmp_path / "models_v34a")
    got, want = predict_proba_folds(tm, Xq), j_ppf(jm, Xq)
    assert got.shape == (5, 50) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=0)
