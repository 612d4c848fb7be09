"""Port vs JAX package: every masked reduction of ``ops/masked.py``.

Rows cover a full mask, a random mask, a single point, an empty mask and
a valid NaN value; empty masks and NaN lanes must give the same NaN (or
the same default) in both, never an exception.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mallorn_tpu.ops import masked as JM
from mallorn_tpu_torch.ops import masked as TM

torch.set_num_threads(2)


def _inputs():
    rng = np.random.default_rng(0)
    n, T = 9, 20
    x = rng.normal(size=(n, T)).astype(np.float32)
    t = np.sort(rng.uniform(0, 100, size=(n, T)), axis=1).astype(np.float32)
    mask = rng.random((n, T)) < 0.6
    mask[0] = True  # full
    mask[1] = False  # empty
    mask[2] = False
    mask[2, 5] = True  # one point
    mask[3, :] = np.arange(T) < 7  # prefix
    x[4, 3] = np.nan  # NaN in a valid lane
    mask[4, 3] = True
    x[5, 1] = 3.0
    x[5, 2] = 3.0  # tie for argmax
    mask[5, 1:3] = True
    x[8, 4] = x[8, 6] = -5.0  # tie for argmin
    mask[8, 4:7] = True
    target = rng.uniform(-10, 110, size=n).astype(np.float32)
    target[6] = np.nan
    target[7] = t[7][np.argmax(mask[7])]  # exactly the first valid time
    return x, t, mask, target


X, TT, MASK, TARGET = _inputs()

CASES = {
    "count": lambda M, x, t, m, tg: M.count(m),
    "msum": lambda M, x, t, m, tg: M.msum(x, m),
    "mean": lambda M, x, t, m, tg: M.mean(x, m),
    "var": lambda M, x, t, m, tg: M.var(x, m),
    "var_ddof1": lambda M, x, t, m, tg: M.var(x, m, ddof=1),
    "std": lambda M, x, t, m, tg: M.std(x, m),
    "mmin": lambda M, x, t, m, tg: M.mmin(x, m),
    "mmax": lambda M, x, t, m, tg: M.mmax(x, m),
    "argmax": lambda M, x, t, m, tg: M.argmax(x, m),
    "argmin": lambda M, x, t, m, tg: M.argmin(x, m),
    "quantile_10": lambda M, x, t, m, tg: M.quantile(x, m, 0.1),
    "quantile_90": lambda M, x, t, m, tg: M.quantile(x, m, 0.9),
    "median": lambda M, x, t, m, tg: M.median(x, m),
    "mad": lambda M, x, t, m, tg: M.mad(x, m),
    "iqr": lambda M, x, t, m, tg: M.iqr(x, m),
    "skewness": lambda M, x, t, m, tg: M.skewness(x, m),
    "kurtosis": lambda M, x, t, m, tg: M.kurtosis(x, m),
    "beyond_1std": lambda M, x, t, m, tg: M.beyond_nstd(x, m, 1.0),
    "linfit_slope": lambda M, x, t, m, tg: M.linfit(t, x, m)[0],
    "linfit_intercept": lambda M, x, t, m, tg: M.linfit(t, x, m)[1],
    "interp_at": lambda M, x, t, m, tg: M.interp_at(t, x, m, tg, max_gap=50.0),
    "interp_at_gap5": lambda M, x, t, m, tg: M.interp_at(t, x, m, tg, max_gap=5.0),
    "value_at_nearest": lambda M, x, t, m, tg: M.value_at_nearest(t, x, m, tg, 20.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_masked_matches_jax(name):
    fn = CASES[name]
    # the JAX package calls these per object (under vmap)
    per_object = jax.vmap(lambda *a: fn(JM, *a))
    want = np.asarray(per_object(*(jnp.asarray(a) for a in (X, TT, MASK, TARGET))))
    got = fn(TM, *(torch.from_numpy(a) for a in (X, TT, MASK, TARGET))).numpy()
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)
    # the empty row never raises and gives NaN or the reference default
    assert got.shape[0] == X.shape[0]
