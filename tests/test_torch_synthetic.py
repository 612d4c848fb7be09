"""Port vs JAX package: the synthetic lightcurve generator
(``data/synthetic.py``), numpy only, array for array.

The same seed must give the JAX package's arrays bit for bit: the raw
observation columns, the metadata (spectral types included) and the
packed tensors, for a train split, a TEST_SHIFT test split and a
STRONG_TEST_SHIFT one, at a few dozen objects.
"""

import numpy as np
import pytest

from mallorn_tpu.data import synthetic as JS
from mallorn_tpu_torch.data import synthetic as TS


def _assert_same_split(want, got):
    (jp, jm, jc), (tp, tm, tc) = want, got
    assert sorted(jc) == sorted(tc)
    for k in jc:
        assert tc[k].dtype == jc[k].dtype, k
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    for k in ("object_ids", "z", "ebv", "target", "spec_type"):
        a, b = getattr(tm, k), getattr(jm, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for name, a, b in zip(tp._fields, tp.tensors(), jp[:-1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert tp.time_offset == pytest.approx(float(jp.time_offset), abs=0)


@pytest.mark.parametrize("n,seed,tde_frac", [(40, 0, 0.05), (33, 20260816, 0.2)])
def test_generate_dataset_matches_jax(n, seed, tde_frac):
    want = JS.generate_dataset(n, seed=seed, tde_frac=tde_frac)
    got = TS.generate_dataset(n, seed=seed, tde_frac=tde_frac, device="cpu")
    _assert_same_split(want, got)
    assert set(got[1].spec_type) <= set(TS.SPEC_TYPES)
    assert int(got[1].target.sum()) == max(1, int(round(tde_frac * n)))


@pytest.mark.parametrize("shift", [None, "strong"])
def test_competition_splits_match_jax(shift):
    kw = {} if shift is None else {"shift": JS.STRONG_TEST_SHIFT}
    tkw = {} if shift is None else {"shift": TS.STRONG_TEST_SHIFT}
    want = JS.generate_competition_splits(24, 30, seed=7, tde_frac=0.1, **kw)
    got = TS.generate_competition_splits(24, 30, seed=7, tde_frac=0.1, device="cpu", **tkw)
    for w, g in zip(want, got):
        _assert_same_split(w, g)


def test_shift_constants_match_jax():
    for name in ("SPEC_TYPES", "NON_TDE_KINDS", "TRAIN_CLASS_MIX", "TEST_CLASS_MIX",
                 "TEST_SHIFT", "STRONG_TEST_SHIFT"):
        assert getattr(TS, name) == getattr(JS, name), name
    t = np.array([[5000.0, 20000.0], [9000.0, 40000.0]])
    np.testing.assert_array_equal(TS._band_weights(t), JS._band_weights(t))
