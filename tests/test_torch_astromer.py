"""Port vs JAX package: astromer's encoder, pretraining draws, artifact and
146 feature columns, and ``prng.randint``.

- ``prng.randint`` and ``make_probe_masks`` (the pretraining's minibatch
  and probe draws) equal ``jax.random``'s bit for bit;
- the port's artifact is byte for byte the JAX package's, and the encoder
  it loads gives the JAX package's embeddings of the same sequences within
  rtol 1e-4, atol 1e-5 (the JAX side under ``jax.jit``, as
  ``features.astromer`` runs it);
- ``normalize_band`` within rtol / atol 1e-6 (masks and counts equal),
  the magnitudes within atol 1e-5: standardising divides the log's last
  bit by the sequence's spread; both sides given the same input bits and
  each within those bars of a float64 standardisation of them; the
  pretraining loss of carried parameters within rtol 1e-5;
- ``extract`` on ``generate_dataset(24, seed=11)``, with one band emptied
  and two cut below 5 points: names in the same order, NaN lanes
  identical, the 144 embedding columns within rtol 1e-4, atol 1e-5. A ratio
  column divides by a band mean guarded to |m| >= 1e-6, so its error is
  the numerator's over |denominator| plus the ratio's times the
  denominator's relative error: each ratio is held to
  1e-5 (1 + |r|) (1 + 1 / |d|), d the JAX package's guarded denominator;
- without weights, ``extract`` warns and returns the 146 columns all NaN.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mallorn_tpu.data.synthetic import generate_dataset
from mallorn_tpu.features import astromer as jfeat
from mallorn_tpu.models import astromer as jast
from mallorn_tpu_torch.data.packing import from_numpy
from mallorn_tpu_torch.features import astromer as tfeat
from mallorn_tpu_torch.models import astromer as tast
from mallorn_tpu_torch.models.layers import state_from_flax, state_to_flax
from mallorn_tpu_torch.utils import prng

torch.set_num_threads(2)

FWD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,lo,hi", [((7,), 0, 10), ((64, 37), 0, 37),
                                         ((256,), 0, 18324), ((1000,), -5, 2**31 - 1),
                                         ((300,), -2**31, 2**31 - 1), ((9,), 5, 5),
                                         ((50, 3), 3, 12345678)])
def test_randint_is_jax_randint(shape, lo, hi):
    for seed in (0, 7, 2**31 + 3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(key, shape, lo, hi))
        got = prng.randint(np.asarray(key), shape, lo, hi)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _sparse(packed):
    """Object 0's g band emptied, object 1's r band and object 2's i band
    cut to 3 and 4 points (valid points stay a prefix)."""
    bm = np.array(packed.band_mask)
    bm[0, 1] = False
    bm[1, 2, 3:] = False
    bm[2, 3, 4:] = False
    return packed._replace(band_mask=jnp.asarray(bm))


@pytest.fixture(scope="module")
def data():
    packed, meta, _ = generate_dataset(n_objects=24, seed=11)
    packed = _sparse(packed)
    tp = from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset, device="cpu")
    return packed, tp


@pytest.fixture(scope="module")
def seqs(data):
    packed, tp = data
    nb = packed.band_time.shape[0] * 6
    j = jast.normalize_band(*(np.asarray(a).reshape(nb, -1) for a in
                              (packed.band_time, packed.band_flux, packed.band_err,
                               packed.band_mask)))
    t = tast.normalize_band(*(a.reshape(nb, -1) for a in
                              (tp.band_time, tp.band_flux, tp.band_err, tp.band_mask)))
    return j, t


def test_normalize_band_matches(seqs):
    j, t = seqs
    assert t._fields == j._fields
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.n_valid.numpy(), np.asarray(j.n_valid))
    assert ((t.n_valid > 0) & (t.n_valid < 5)).any() and (t.n_valid == 0).any()
    for name, atol in (("times", 1e-6), ("mags", 1e-5), ("errs", 1e-6)):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-6, atol=atol, err_msg=name)


def test_normalize_band_sides_match_float64(data, seqs):
    """Both sides were given the same input bits, and each side's
    magnitudes are within float32 rounding (the bars above) of a float64
    standardisation of them: should the two sides disagree, this names the
    side that moved (each measured within 4.1e-6 of float64 on a CPU)."""
    packed, tp = data
    j, t = seqs
    nb = packed.band_time.shape[0] * 6
    flux = np.asarray(packed.band_flux).reshape(nb, -1)
    for name in ("band_time", "band_flux", "band_err", "band_mask"):
        np.testing.assert_array_equal(getattr(tp, name).reshape(nb, -1).numpy(),
                                      np.asarray(getattr(packed, name)).reshape(nb, -1),
                                      err_msg=name, strict=True)
    mask = np.asarray(j.mask)
    mag = np.where(mask, -2.5 * np.log10(np.where(mask, flux, 1.0).astype(np.float64)), 0.0)
    n = np.maximum(mask.sum(axis=1), 1)
    mu = mag.sum(axis=1) / n
    sd = np.sqrt(np.where(mask, (mag - mu[:, None]) ** 2, 0.0).sum(axis=1) / n)
    want = np.where(mask, (mag - mu[:, None]) / np.where(sd > 1e-6, sd, 1.0)[:, None], 0.0)
    for side, got in (("JAX package", np.asarray(j.mags)), ("port", t.mags.numpy())):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, err_msg=side)


def test_probe_masks_are_jax_draws(seqs):
    j, t = seqs
    for seed in (0, 5):
        key = jax.random.PRNGKey(seed)
        want = jast.make_probe_masks(key, j.mask)
        got = tast.make_probe_masks(np.asarray(key), t.mask)
        for name, a, b in zip(("probe", "hidden", "swapped", "swap_idx"), want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        assert got[0].any() and got[1].any() and got[2].any()


def test_artifact_is_the_jax_packages():
    assert tast.DEFAULT_WEIGHTS.parent.parent.name == "mallorn_tpu_torch"
    assert tast.DEFAULT_WEIGHTS.read_bytes() == Path(jast.DEFAULT_WEIGHTS).read_bytes()
    assert tfeat.available() and "self-supervised" in tfeat.pretrained_origin()


def _jax_encode(params, model, s, n=None):
    fn = jax.jit(lambda p, *a: model.apply(p, *a))
    return fn(params, *(a[:n] for a in (s.times, s.mags, s.errs, s.mask)))


def test_pretrained_encoder_matches(seqs):
    """Both packages' encoders on the same (the JAX package's) normalised
    sequences."""
    j, _ = seqs
    jparams, jmodel, jcfg = jast.load_pretrained()
    _, tmodel, tcfg = tast.load_pretrained(device="cpu")
    assert tcfg == jcfg and not tmodel.training
    want_h, want_r = _jax_encode(jparams, jmodel, j)
    with torch.no_grad():
        # copies: a tensor over a JAX array's read-only buffer is undefined
        # behaviour in PyTorch
        got_h, got_r = tmodel(*(torch.from_numpy(np.array(a))
                                for a in (j.times, j.mags, j.errs, j.mask)))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **FWD)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **FWD)


def test_pretraining_loss_matches(seqs):
    """The masked-reconstruction loss of the artifact's parameters for the
    same key (so the same probes and swaps)."""
    j, t = seqs
    jparams, jmodel, _ = jast.load_pretrained()
    _, tmodel, _ = tast.load_pretrained(device="cpu")
    for seed in (1, 2):
        key = jax.random.PRNGKey(seed)
        want = float(jax.jit(lambda p, k: jast.pretrain_loss(p, jmodel, j, k))(jparams, key))
        with torch.no_grad():
            got = tast.pretrain_loss(tmodel, t, np.asarray(key)).item()
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pretraining_loss_falls(seqs):
    """The JAX package's pretraining gate on the port (its
    tests/test_astromer_pretrained.py): 150 steps of d 16, one layer, from
    the sequences with >= 5 points; the loss falls below the mean
    predictor's 1.0."""
    _, t = seqs
    keep = t.n_valid >= 5
    kept = tast.BandSequences(*(a[keep] for a in t))
    _, _, hist = tast.pretrain(kept, d_model=16, n_layers=1, n_steps=150, batch_size=64,
                               seed=0, eval_every=50, device="cpu")
    assert [s for s, _ in hist] == [0, 50, 100, 149]
    first, last = hist[0][1], hist[-1][1]
    assert last < first and last < 0.8, (first, last)


def test_artifact_round_trip_both_ways(seqs, tmp_path):
    """A port-written encoder file reads back in the port and in the JAX
    package, with the same parameters and embeddings."""
    j, t = seqs
    model = tast.SingleBandEncoder(d_model=16, n_layers=1, seed=4, device="cpu").eval()
    cfg = {"d_model": 16, "n_heads": 4, "n_layers": 1}
    path = tmp_path / "w.npz"
    tast.save_pretrained(path, model, cfg)
    _, back, cfg2 = tast.load_pretrained(path, device="cpu")
    assert cfg2 == cfg
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    jparams, jmodel, jcfg = jast.load_pretrained(path)
    assert jcfg == cfg
    want_h, _ = _jax_encode(jparams, jmodel, j, 12)
    with torch.no_grad():
        got_h, _ = model(t.times[:12], t.mags[:12], t.errs[:12], t.mask[:12])
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **FWD)
    with np.load(path) as z:
        assert json.loads(bytes(z["__config__"]).decode()) == cfg
        assert set(z.files) - {"__config__"} == set(state_to_flax(model))
    assert state_from_flax(jparams).keys() == model.state_dict().keys()


@pytest.fixture(scope="module")
def features(data):
    packed, tp = data
    return jfeat.extract(packed), tfeat.extract(tp)


def test_extract_matches_the_jax_columns(features):
    want, got = features
    names = tfeat.feature_names()
    assert list(got) == list(want) == names and len(names) == 146
    for name in names:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
    # the sparse bands are NaN lanes, the full ones finite
    assert torch.isnan(got["g_astromer_emb_0"][0]) and torch.isnan(got["r_astromer_emb_5"][1])
    assert torch.isnan(got["i_astromer_emb_std"][2])
    assert np.isfinite(got["g_astromer_emb_0"][1:].numpy()).all()
    emb = [n for n in names if "ratio" not in n]
    for name in emb:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **FWD,
                                   err_msg=name)


def test_extract_ratio_columns(features):
    want, got = features
    for b1, b2 in (("g", "r"), ("r", "i")):
        w = np.asarray(want[f"astromer_{b1}{b2}_mean_ratio"], np.float64)
        g = got[f"astromer_{b1}{b2}_mean_ratio"].numpy().astype(np.float64)
        m2 = np.asarray(want[f"{b2}_astromer_emb_mean"], np.float64)
        d = np.where(m2 >= 0, np.maximum(m2, 1e-6), np.minimum(m2, -1e-6))
        ok = np.isfinite(w)
        assert ok.sum() >= 20
        bar = 1e-5 * (1 + np.abs(w[ok])) * (1 + 1 / np.abs(d[ok]))
        assert (np.abs(g[ok] - w[ok]) <= bar).all(), np.abs(g[ok] - w[ok]) / bar


def test_extract_without_weights_is_all_nan(data, tmp_path):
    _, tp = data
    with pytest.warns(UserWarning, match="no pretrained astromer weights"):
        out = tfeat.extract(tp, weights_path=tmp_path / "missing.npz")
    assert list(out) == tfeat.feature_names()
    assert all(v.shape == (tp.n_objects,) and torch.isnan(v).all() for v in out.values())
    assert not tfeat.available(tmp_path / "missing.npz")


def test_learned_embeddings_fallback():
    """``extract_learned_embeddings``: a briefly trained transformer's CLS
    embeddings, one column per dimension, finite for every object."""
    from mallorn_tpu_torch.data.synthetic import generate_dataset as tgen

    packed, meta, _ = tgen(16, seed=2, tde_frac=0.4, device="cpu")
    out = tfeat.extract_learned_embeddings(packed, meta, d_model=8, n_epochs=2)
    assert list(out) == [f"emb_{i}" for i in range(8)]
    assert all(v.shape == (16,) and torch.isfinite(v).all() for v in out.values())
