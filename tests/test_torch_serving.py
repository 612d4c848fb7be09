"""Port vs JAX package: the v92d serving forward, end to end.

The JAX package's flagship (``__graft_entry__._build_flagship``, trained
at example scale) is saved with its own ``save_cv_models`` and carried
into the port by the port's ``load_cv_models``. Then, on the flagship's
own 64 objects:

- forest: the port's routing on JAX's binned matrix reproduces JAX's
  margins to 1e-6;
- binning: the port's binned matrix equals JAX's except at knife edges.
  The flagship fits its quantile edges on the same 64 objects it serves,
  so nearly every served value sits on an edge, and a last-digit
  difference moves it one bin. Allowed, and why:
  * closed-form columns: a cell may differ by exactly one bin, only where
    the two feature values agree within the family tolerance (rtol 1e-4
    of the column scale, as test_torch_features) — a knife edge by
    definition — and on at most 1% of those cells;
  * the 2D-GP (8 Adam steps) and Bazin (40 LM iterations) columns are
    iterative fits that agree less tightly (test_torch_gp,
    test_torch_features): at most 10% of their cells;
- probabilities agree to 1e-3 on every object whose binned row matches;
  with edges at the served values only a minority of rows match in full
  (13 of 64 on this fixture), so at least 10 are required;
- the server holds the GP's width and two-phase decision: a request's GP
  features do not depend on what else it holds, and a request wider than
  that width is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from mallorn_tpu.features import bazin as jbazin
from mallorn_tpu.features import colors as jcolors
from mallorn_tpu.features import multiband_gp as jgp
from mallorn_tpu.features import physics as jphysics
from mallorn_tpu.features import shape as jshape
from mallorn_tpu.features import statistical as jstat
from mallorn_tpu.features import tde as jtde
from mallorn_tpu.data.packing import Metadata as JMetadata
from mallorn_tpu.features.base import feature_matrix_jnp, merge as jmerge
from mallorn_tpu.io.model_store import save_cv_models
from mallorn_tpu.trees.binning import apply_bins as japply_bins
from mallorn_tpu.trees.gbdt import GBDTModel as JGBDTModel
from mallorn_tpu.trees.gbdt import _predict_margin_jit
from mallorn_tpu_torch.data.packing import from_numpy
from mallorn_tpu_torch.features import bazin as bazin_fit
from mallorn_tpu_torch.features.multiband_gp import serving_config
from mallorn_tpu_torch.io.model_store import load_cv_models
from mallorn_tpu_torch.serving import SHIFT_FEATURES, V92dServer
from mallorn_tpu_torch.trees.gbdt import predict_margin_folds
from mallorn_tpu_torch.utils.constants import LSST_BANDS

torch.set_num_threads(2)

GP_STEPS = 8


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    fn, (packed, z, ebv) = graft._build_flagship(n_objects=64, gp_steps=GP_STEPS)
    state = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    forest, spec, params = state["forest"], state["bin_spec"], state["params"]
    model = JGBDTModel(forest=forest, bin_spec=spec, params=params,
                       importance_gain=jnp.zeros(spec.edges.shape[0]),
                       eval_history=jnp.zeros(forest.feature.shape[0]),
                       best_iteration=-1)
    d = tmp_path_factory.mktemp("v92d_model")
    save_cv_models(d, [model], threshold=0.5, feature_names=state["names"])

    # JAX's binned matrix: the flagship forward's steps up to apply_bins
    meta = JMetadata(object_ids=None, z=z, ebv=ebv)
    f4 = jmerge(jstat.extract(packed, meta), jcolors.extract(packed, meta),
                jshape.extract(packed), jphysics.extract(packed, meta),
                pandas_suffix=True)
    full = jmerge({k: f4[k] for k in state["selected"]}, jtde.extract(packed),
                  jgp._extract_chunk(packed, GP_STEPS, state["t_compact"],
                                     state["two_phase"]),
                  jbazin.extract(packed), pandas_suffix=True)
    mat = feature_matrix_jnp(full, state["names"])
    mat = jnp.where(jnp.isposinf(mat), 1e10, jnp.where(jnp.isneginf(mat), -1e10, mat))
    f_model = spec.edges.shape[0]
    if mat.shape[1] < f_model:
        mat = jnp.concatenate([mat, jnp.full((mat.shape[0], f_model - mat.shape[1]),
                                             jnp.nan, mat.dtype)], axis=1)
    binned = np.asarray(japply_bins(spec, mat))
    margin = np.asarray(_predict_margin_jit(
        forest, jnp.asarray(binned),
        (params.n_bins, params.max_depth, None, float(params.base_score))))
    probs = np.asarray(jax.jit(fn)(packed, z, ebv))
    return dict(state=state, dir=d, packed=packed, z=z, ebv=ebv, binned=binned,
                mat=np.asarray(mat),
                margin=margin, probs=probs, n_cols=len(state["names"]))


@pytest.fixture(scope="module")
def server(flagship):
    st = flagship["state"]
    return V92dServer.load(flagship["dir"], st["selected"], gp_steps=GP_STEPS,
                           gp_t_compact=st["t_compact"],
                           gp_two_phase=st["two_phase"], device="cpu")


def _torch_packed(p):
    return from_numpy([np.asarray(x) for x in p[:-1]], p.time_offset, device="cpu")


@pytest.fixture(scope="module")
def port_run(flagship, server):
    tp = _torch_packed(flagship["packed"])
    full = server.features(tp, flagship["z"], flagship["ebv"])
    mat = server.matrix(full)
    binned = server.binned(mat)
    return mat.numpy(), binned[0].numpy(), server.predict_binned(binned).numpy()


def test_model_store_carries_the_jax_model(flagship, server):
    models, man = load_cv_models(flagship["dir"], device="cpu")
    st = flagship["state"]
    assert man["feature_names"] == list(st["names"]) == server.names
    assert not set(SHIFT_FEATURES) & set(server.names)
    for name in ("feature", "split_bin", "default_left", "is_leaf", "leaf_value"):
        np.testing.assert_array_equal(getattr(models[0].forest, name).numpy(),
                                      np.asarray(getattr(st["forest"], name)))
    np.testing.assert_array_equal(models[0].bin_spec.edges.numpy(),
                                  np.asarray(st["bin_spec"].edges))
    assert (server.n_bins, server.max_depth) == (st["params"].n_bins, st["params"].max_depth)


def test_forest_on_jax_binned_matrix_matches_jax_margin(flagship, server):
    jax_binned = torch.from_numpy(flagship["binned"].copy())
    margin = predict_margin_folds(server.forest, jax_binned,
                                  server.n_trees, server.n_bins, server.max_depth,
                                  server.base_score)[0].numpy()
    np.testing.assert_allclose(margin, flagship["margin"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        server.predict_binned(jax_binned).numpy(),
        flagship["probs"], rtol=0, atol=1e-6)


_BAZIN_FIT = ({f"{b}_{n}" for b in LSST_BANDS for n in bazin_fit.FEATURE_NAMES}
              | {"bazin_rise_consistency", "bazin_fall_consistency",
                 "bazin_avg_fit_chi2", "bazin_fit_quality_dispersion"})


def _fit_columns(names, width):
    """Columns of the 2D-GP and Bazin-fit families (a pandas-suffixed
    collision keeps the fit family's ``_y`` copy)."""
    def is_fit(n):
        base = n[:-2] if n.endswith(("_x", "_y")) else n
        return (n.startswith(("gp2d_", "gp_"))
                or (base in _BAZIN_FIT and not n.endswith("_x")))

    fit = np.zeros(width, bool)
    fit[: len(names)] = [is_fit(n) for n in names]
    return fit


def test_binned_matrix_matches_jax_except_knife_edges(flagship, port_run):
    mat, binned, _ = port_run
    want, want_mat = flagship["binned"], flagship["mat"]
    assert binned.shape == want.shape
    diff = binned != want
    fit = _fit_columns(flagship["state"]["names"], want.shape[1])

    closed = diff[:, ~fit]
    step = np.abs(binned.astype(int) - want.astype(int))[:, ~fit]
    assert (step[closed] == 1).all()
    a, b = mat[:, ~fit].astype(np.float64), want_mat[:, ~fit].astype(np.float64)
    scale = np.nanmax(np.abs(b), axis=0, initial=0.0)[None, :].repeat(len(b), 0)
    assert (np.abs(a - b)[closed] <= 1e-4 * (np.abs(b) + scale)[closed]).all()
    assert closed.mean() <= 0.01, closed.mean()
    assert diff[:, fit].mean() <= 0.10, diff[:, fit].mean()


def test_gp_features_do_not_depend_on_request_membership(flagship):
    """The server fits every request at its own GP width and path, so an
    object's GP features are the same whatever shares its request. Half
    the objects keep every third point of their all-band view: served
    alone, that sparse half would compact to 64 points and take the
    single-phase path; the whole set compacts to 160 and, at 30 steps,
    takes the two-phase one."""
    p = flagship["packed"]
    tp = _torch_packed(p)
    n = tp.n_objects
    dropped = ((torch.arange(n) < n // 2)[:, None]
               & (torch.arange(tp.all_mask.shape[1]) % 3 != 0)[None, :])
    tp = tp._replace(all_mask=tp.all_mask & ~dropped)
    tc, two_phase = serving_config(tp, 30)
    assert two_phase and serving_config(tp.map(lambda x: x[: n // 2]), 30) == (64, False)
    models, man = load_cv_models(flagship["dir"], device="cpu")
    srv = V92dServer(models, man["feature_names"], flagship["state"]["selected"],
                     gp_t_compact=tc, gp_two_phase=two_phase, gp_steps=30,
                     device="cpu")
    z, ebv = np.asarray(flagship["z"]), np.asarray(flagship["ebv"])
    whole = srv.bundle(tp, z, ebv)["multiband_gp"]
    halves = [srv.bundle(tp.map(lambda x: x[s]), z[s], ebv[s])["multiband_gp"]
              for s in (slice(0, n // 2), slice(n // 2, n))]
    for k, v in whole.items():
        np.testing.assert_allclose(torch.cat([h[k] for h in halves]).numpy(),
                                   v.numpy(), rtol=1e-6, atol=0, err_msg=k)


def test_server_refuses_a_request_wider_than_its_gp_width(flagship):
    """Compacting to the server's width would drop valid points, so a
    request with more than that raises instead."""
    models, man = load_cv_models(flagship["dir"], device="cpu")
    srv = V92dServer(models, man["feature_names"], flagship["state"]["selected"],
                     gp_t_compact=64, gp_two_phase=False, gp_steps=GP_STEPS,
                     device="cpu")
    with pytest.raises(ValueError, match="GP width 64"):
        srv(_torch_packed(flagship["packed"]), np.asarray(flagship["z"]),
            np.asarray(flagship["ebv"]))


def test_probabilities_match_jax_on_matching_rows(flagship, port_run):
    _, binned, probs = port_run
    same = (binned == flagship["binned"]).all(axis=1)
    assert probs.shape == flagship["probs"].shape
    assert np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all()
    assert same.sum() >= 10, same.sum()
    np.testing.assert_allclose(probs[same], flagship["probs"][same], rtol=0, atol=1e-3)
