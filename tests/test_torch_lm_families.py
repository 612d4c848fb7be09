"""Port vs JAX package: the four feature families fitted by batched
Levenberg-Marquardt (``ops.lm.lm_fit_batched``): powerlaw (v55),
tde_models (v37a, the hybrid model), blackbody (v64) and advanced_physics
(v30).

- Each model's value and its analytic Jacobian against the JAX model and
  ``jax.jacfwd`` at random parameters inside the families' bounds: rtol
  1e-5, with an absolute floor of 1e-5 of the column's largest magnitude
  over the lane's points (a value or derivative that is a sum of terms of
  opposite sign, such as A g(t) + B or d/dt0 of the TDE models, carries
  its terms' float32 rounding, not a relative error of the result).
- Each family on the packed synthetic objects of ``small_dataset``: names
  and order identical, NaN positions identical (the guards and the failed
  fits), the columns that do not come out of a fit at
  tests/test_torch_features.py's rule (rtol 1e-4, floor 1e-4 of the
  column's largest magnitude), and the fits by their quality, Bazin's
  gate (tests/test_torch_features.py): over the lanes the JAX package
  fitted, the port's cost <= 1.05 x the JAX package's + 0.5 on >= 98%,
  and the median cost ratio within [0.99, 1.01] over the fits that leave
  a residual (JAX cost >= 1e-6). The cost is the family's
  reduced chi^2, or for powerlaw's R^2 the residual sum of squares
  (1 - R^2) ss_tot, with ss_tot from the same data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mallorn_tpu.features import advanced_physics as japh
from mallorn_tpu.features import blackbody as jbb
from mallorn_tpu.features import powerlaw as jpl
from mallorn_tpu.features import tde_models as jtde
from mallorn_tpu_torch.data.packing import from_numpy
from mallorn_tpu_torch.features import advanced_physics as taph
from mallorn_tpu_torch.features import blackbody as tbb
from mallorn_tpu_torch.features import powerlaw as tpl
from mallorn_tpu_torch.features import tde_models as ttde
from mallorn_tpu_torch.utils.constants import LSST_BANDS

torch.set_num_threads(2)

# (JAX model, port model, parameter box, range of t): t in days, or the
# wavelength in Angstrom for the Planck models
_TDE_T = (-200.0, 400.0)
MODELS = {
    **{f"powerlaw_{k}": (jpl._make_power_model(p), tpl.make_power_model(p),
                         ([0.0, -10.0], [1e6, 10.0]), (-5.0, 100.0))
       for k, p in tpl.POWERS.items()},
    "exponential": (jpl._exp_model, tpl.exp_model,
                    ([0.0, 1.0, -10.0], [1e6, 500.0, 10.0]), (-5.0, 100.0)),
    "linear": (jpl._linear_model, tpl.linear_model,
               ([0.0, 0.0, -10.0], [1e6, 100.0, 10.0]), (-5.0, 100.0)),
    "hybrid": (jtde.hybrid_model, ttde.hybrid_model,
               ([0.0, -50.0, 1.0, 10.0, 0.5, -1e3], [1e4, 50.0, 200.0, 1000.0, 3.0, 1e3]),
               _TDE_T),
    "guillochon": (jtde.guillochon_model, ttde.guillochon_model,
                   ([0.0, -50.0, 1.0, 10.0, -1e3], [1e4, 50.0, 200.0, 1000.0, 1e3]), _TDE_T),
    "piecewise": (jtde.piecewise_model, ttde.piecewise_model,
                  ([0.0, -50.0, 5.0, 10.0, 0.5, -1e3], [1e4, 50.0, 200.0, 1000.0, 3.0, 1e3]),
                  _TDE_T),
    "blackbody": (jbb._bb_model, tbb._bb_model, ([3000.0, -20.0], [1e5, 0.0]),
                  (4825.0, 7545.0)),
    "sed": (japh._sed_model, taph._sed_model, ([3000.0, -20.0], [1e5, 10.0]),
            (4825.0, 8691.0)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_and_jacobian_match_jax(name):
    jmodel, tmodel, (lo, hi), (t_lo, t_hi) = MODELS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    L, T = 48, 30
    theta = rng.uniform(lo, hi, size=(L, len(lo))).astype(np.float32)
    t = rng.uniform(t_lo, t_hi, size=(L, T)).astype(np.float32)
    if name == "hybrid":
        # t = t0: the edge of the [dt > 0] guard (for the Guillochon and
        # piecewise models t0 is also where the rise reaches its clip at
        # 1, a kink that rounding puts on either side)
        t[:, :3] = theta[:, 1:2]

    def lane(tt, th):
        return jmodel(tt, tuple(th))

    want_f = np.asarray(jax.vmap(lane)(jnp.asarray(t), jnp.asarray(theta)))
    want_J = np.asarray(jax.vmap(jax.jacfwd(lane, argnums=1))(jnp.asarray(t),
                                                               jnp.asarray(theta)))
    f, J = tmodel(torch.from_numpy(t), torch.from_numpy(theta), True)
    assert J.shape == (L, T, len(lo))
    f_floor = 1e-5 * np.abs(want_f).max(axis=1, keepdims=True)
    assert (np.abs(f.numpy() - want_f) <= 1e-5 * np.abs(want_f) + f_floor).all()
    np.testing.assert_allclose(tmodel(torch.from_numpy(t), torch.from_numpy(theta)).numpy(),
                               f.numpy(), rtol=0, atol=0)
    assert np.isfinite(J.numpy()).all() and np.isfinite(want_J).all()
    floor = 1e-5 * np.abs(want_J).max(axis=1, keepdims=True)
    assert (np.abs(J.numpy() - want_J) <= 1e-5 * np.abs(want_J) + floor).all()


def _torch_packed(packed):
    return from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset, device="cpu")


def _powerlaw_ss_tot(packed):
    """[N, 3] ss_tot of the post-peak g/r/i fluxes, as the family takes it."""
    t = np.asarray(packed.band_time)[:, 1:4].astype(np.float64)
    f = np.asarray(packed.band_flux)[:, 1:4].astype(np.float64)
    m = np.asarray(packed.band_mask)[:, 1:4]
    pk = np.argmax(np.where(m, f, -1e30), axis=-1)
    pt = np.take_along_axis(t, pk[..., None], -1)
    post = m & (t > pt)
    mu = np.where(post, f, 0).sum(-1) / np.maximum(post.sum(-1), 1)
    return np.where(post, (f - mu[..., None]) ** 2, 0).sum(-1)


def _fit_costs(family, want, got, packed):
    """{gate name: (JAX cost, port cost)} over the lanes the JAX package
    fitted."""
    out = {}
    if family == "powerlaw":
        ss = _powerlaw_ss_tot(packed)
        for bi, band in enumerate("gri"):
            for m in tpl.MODEL_NAMES:
                k = f"{band}_{m}_r2"
                ok = np.isfinite(want[k]) & (ss[:, bi] > 0)
                out[k] = ((1 - want[k][ok]) * ss[ok, bi], (1 - got[k][ok]) * ss[ok, bi])
        return out
    keys = {"tde_models": [f"{b}_tde_fit_chi2" for b in LSST_BANDS],
            "blackbody": [f"T_chi2_{e}" for e in tbb.EPOCH_NAMES],
            "advanced_physics": [f"temp_chi2_epoch_{int(e)}d" for e in taph.TEMP_EPOCHS]}
    for k in keys[family]:
        ok = np.isfinite(want[k])
        out[k] = (want[k][ok].astype(np.float64), got[k][ok].astype(np.float64))
    return out


# the columns that do not come out of a fit (the rest are fitted
# parameters, their chi^2 and what is derived from them)
def _not_fitted(family, name):
    if family == "blackbody":
        return name.startswith("L_proxy_")
    if family == "advanced_physics":
        return not name.startswith(("temp_", "cooling_rate_", "sed_quality_"))
    return False


FAMILIES = {
    "powerlaw": (jpl.extract, tpl.extract, 27),
    "tde_models": (jtde.extract, ttde.extract, 61),
    "blackbody": (jbb.extract, tbb.extract, 49),
    "advanced_physics": (japh.extract, taph.extract, 41),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_matches_jax(small_dataset, family):
    packed, _, _ = small_dataset
    jfn, tfn, n_cols = FAMILIES[family]
    want = {k: np.asarray(v) for k, v in jfn(packed).items()}
    got = {k: v.numpy() for k, v in tfn(_torch_packed(packed)).items()}
    assert list(got) == list(want) and len(got) == n_cols
    for k in want:
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]), err_msg=k)
        if _not_fitted(family, k):
            a, b = want[k].astype(np.float64), got[k].astype(np.float64)
            scale = np.nanmax(np.abs(a), initial=0.0)
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * scale, equal_nan=True,
                                       err_msg=k)
    costs = _fit_costs(family, want, got, packed)
    a = np.concatenate([c[0] for c in costs.values()])
    b = np.concatenate([c[1] for c in costs.values()])
    assert len(a) > 100
    assert np.mean(b <= a * 1.05 + 0.5) >= 0.98
    # the ratio over the fits that leave a residual (a fit with as many
    # points as parameters ends at rounding noise, ~1e-14)
    res = a >= 1e-6
    assert res.sum() > 50
    assert 0.99 <= np.median(b[res] / a[res]) <= 1.01
