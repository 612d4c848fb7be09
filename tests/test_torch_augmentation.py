"""Port vs JAX package: the augmentation transforms.

Each transform runs with the same ``jax.random`` key in both packages (the
port draws on the host through ``utils.prng``). Masks and ids must be
identical, times, fluxes and errors within rtol 1e-5: the uniform draws
are bit for bit JAX's, the normal and beta draws within a few float32
ulps (``tests/test_torch_prng.py``), and XLA fuses some products and sums
that PyTorch rounds twice. The invariants of ``tests/test_augmentation.py``
are then checked on the port's own results.
"""

import jax
import numpy as np
import pytest
import torch

from mallorn_tpu.data import augmentation as jaug
from mallorn_tpu.data.synthetic import generate_dataset
from mallorn_tpu_torch.data import augmentation as taug
from mallorn_tpu_torch.data.packing import Metadata, from_numpy

torch.set_num_threads(2)

RTOL = 1e-5
FLOATS = ("band_time", "band_flux", "band_err", "all_time", "all_flux", "all_err")
EXACT = ("band_mask", "all_mask", "all_band")


@pytest.fixture(scope="module")
def data():
    packed, meta, _ = generate_dataset(24, seed=3, tde_frac=0.25)
    tp = from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset, device="cpu")
    tmeta = Metadata(object_ids=meta.object_ids, z=np.asarray(meta.z, np.float32),
                     ebv=meta.ebv, target=meta.target, spec_type=meta.spec_type)
    return packed, meta, tp, tmeta


def _assert_packed_close(want, got):
    assert got.time_offset == want.time_offset
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=RTOL, err_msg=f)


def _key(i):
    key = jax.random.PRNGKey(100 + i)
    return key, np.asarray(key)


TRANSFORMS = {
    "flux_scale": lambda m, p, meta, k: m.flux_scale(p, k),
    "time_stretch": lambda m, p, meta, k: m.time_stretch(p, k),
    "time_shift": lambda m, p, meta, k: m.time_shift(p, k),
    "noise_injection": lambda m, p, meta, k: m.noise_injection(p, k),
    "observation_dropout": lambda m, p, meta, k: m.observation_dropout(p, k),
    "dropout_heavy": lambda m, p, meta, k: m.observation_dropout(p, k, frac=0.9, min_keep=5),
    "snr_degradation": lambda m, p, meta, k: m.snr_degradation(p, k),
    "tde_mixup": lambda m, p, meta, k: m.tde_mixup(p, meta, k),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(data, name):
    packed, meta, tp, tmeta = data
    jkey, tkey = _key(sorted(TRANSFORMS).index(name))
    fn = TRANSFORMS[name]
    _assert_packed_close(fn(jaug, packed, meta, jkey), fn(taug, tp, tmeta, tkey))


def test_redshift_augment_matches_jax(data):
    packed, meta, tp, tmeta = data
    jkey, tkey = _key(20)
    want, want_meta = jaug.redshift_augment(packed, meta, jkey)
    got, got_meta = taug.redshift_augment(tp, tmeta, tkey)
    _assert_packed_close(want, got)
    np.testing.assert_allclose(got_meta.z, np.asarray(want_meta.z), rtol=RTOL)
    assert not np.allclose(got_meta.z, meta.z)


@pytest.mark.parametrize("n_copies", [1, 2])
def test_augment_dataset_matches_jax(data, n_copies):
    packed, meta, tp, tmeta = data
    jkey, tkey = _key(30 + n_copies)
    want, want_meta = jaug.augment_dataset(packed, meta, jkey, n_copies=n_copies)
    got, got_meta = taug.augment_dataset(tp, tmeta, tkey, n_copies=n_copies)
    _assert_packed_close(want, got)
    assert got.n_objects == (n_copies + 1) * tp.n_objects
    np.testing.assert_array_equal(got_meta.object_ids, want_meta.object_ids)
    np.testing.assert_array_equal(got_meta.target, want_meta.target)
    np.testing.assert_array_equal(got_meta.z, want_meta.z)


# the invariants of tests/test_augmentation.py, on the port's results

def test_invariants(data):
    _, meta, tp, tmeta = data
    m = tp.band_mask.numpy()
    scaled = taug.flux_scale(tp, _key(40)[1])
    ratio = scaled.band_flux.numpy()[m] / tp.band_flux.numpy()[m]
    ratio = ratio[np.isfinite(ratio)]
    assert ratio.min() >= 0.8 - 1e-5 and ratio.max() <= 1.2 + 1e-5

    shifted = taug.time_shift(tp, _key(41)[1])
    for i in range(tp.n_objects):
        for b in range(6):
            mb = m[i, b]
            np.testing.assert_allclose(np.diff(shifted.band_time[i, b].numpy()[mb]),
                                       np.diff(tp.band_time[i, b].numpy()[mb]),
                                       rtol=1e-5, atol=1e-3)

    dropped = taug.observation_dropout(tp, _key(42)[1], frac=0.9, min_keep=5)
    nb_old, nb_new = m.sum(-1), dropped.band_mask.numpy().sum(-1)
    assert (nb_new[nb_old >= 5] >= 5).all() and nb_new.sum() < nb_old.sum()
    assert not (dropped.band_mask.numpy() & ~m).any()

    degraded = taug.snr_degradation(tp, _key(43)[1])
    assert (degraded.band_err.numpy()[m] >= tp.band_err.numpy()[m] - 1e-6).all()

    moved, meta2 = taug.redshift_augment(tp, tmeta, _key(44)[1])
    mr = m[0, 2]
    span_old = np.ptp(tp.band_time[0, 2].numpy()[mr])
    span_new = np.ptp(moved.band_time[0, 2].numpy()[mr])
    np.testing.assert_allclose(span_new / span_old, (1 + meta2.z[0]) / (1 + meta.z[0]),
                               rtol=1e-4)

    mixed = taug.tde_mixup(tp, tmeta, _key(45)[1])
    non = meta.target == 0
    np.testing.assert_array_equal(mixed.band_flux.numpy()[non], tp.band_flux.numpy()[non])
    assert not np.array_equal(mixed.band_flux.numpy()[~non], tp.band_flux.numpy()[~non])
