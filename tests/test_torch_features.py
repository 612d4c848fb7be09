"""Port vs JAX package: the feature families of the v92d serving path.

The same packed synthetic objects go through each JAX family and its
port. Names and column order must be identical (the JAX package's column
order is that of its jitted dict outputs), NaN positions identical, and
values within rtol 1e-4. The absolute floor is 1e-4 of the column's
largest magnitude: columns that difference large nearly equal values
(e.g. ``temp_evolution``, a difference of two ~1e4 K temperatures) carry
the operands' float32 rounding, not a relative error of the result.

Bazin fits are iterative (Levenberg-Marquardt); as in
``tests/test_bazin.py`` they are held by fit quality: the port's chi^2
against the JAX package's on the same lanes.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.features import bazin as jbazin
from mallorn_tpu.features import colors as jcolors
from mallorn_tpu.features import physics as jphysics
from mallorn_tpu.features import shape as jshape
from mallorn_tpu.features import statistical as jstat
from mallorn_tpu.features import tde as jtde
from mallorn_tpu_torch.data.packing import from_numpy
from mallorn_tpu_torch.features import bazin as tbazin
from mallorn_tpu_torch.features import colors as tcolors
from mallorn_tpu_torch.features import physics as tphysics
from mallorn_tpu_torch.features import shape as tshape
from mallorn_tpu_torch.features import statistical as tstat
from mallorn_tpu_torch.features import tde as ttde
from mallorn_tpu_torch.utils.constants import LSST_BANDS

torch.set_num_threads(2)

FAMILIES = {
    "statistical": (lambda p, m: jstat.extract(p, m), lambda p, m: tstat.extract(p, m)),
    "colors": (lambda p, m: jcolors.extract(p, m), lambda p, m: tcolors.extract(p, m)),
    "shape": (lambda p, m: jshape.extract(p), lambda p, m: tshape.extract(p)),
    "physics": (lambda p, m: jphysics.extract(p, m), lambda p, m: tphysics.extract(p, m)),
    "tde": (lambda p, m: jtde.extract(p), lambda p, m: ttde.extract(p)),
}


def _torch_packed(packed):
    return from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset,
                      device="cpu")


def _assert_columns_close(want: dict, got: dict, rtol: float):
    assert list(got) == list(want)
    for k in want:
        a = np.asarray(want[k], np.float64)
        b = got[k].double().numpy()
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a), err_msg=k)
        scale = np.nanmax(np.abs(a), initial=0.0)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_matches_jax(small_dataset, family):
    packed, meta, _ = small_dataset
    jfn, tfn = FAMILIES[family]
    _assert_columns_close(jfn(packed, meta), tfn(_torch_packed(packed), meta), 1e-4)


def test_bazin_matches_jax_fit_quality(small_dataset):
    packed, _, _ = small_dataset
    want = {k: np.asarray(v) for k, v in jbazin.extract(packed).items()}
    got = {k: v.numpy() for k, v in tbazin.extract(_torch_packed(packed)).items()}
    assert list(got) == list(want)
    for k in want:  # same guard / failed-fit lanes
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]), err_msg=k)
    ratios = []
    for band in LSST_BANDS:
        a, b = want[f"{band}_bazin_fit_chi2"], got[f"{band}_bazin_fit_chi2"]
        ok = np.isfinite(a)
        ratios.append(b[ok] / np.maximum(a[ok], 1e-9))
        # the port's fit is as good as the JAX package's: the test_bazin bar
        assert np.mean(b[ok] <= a[ok] * 1.05 + 0.5) >= 0.98, band
    ratios = np.concatenate(ratios)
    assert len(ratios) > 100
    assert 0.99 <= np.median(ratios) <= 1.01
