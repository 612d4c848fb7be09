"""Port vs JAX package: the ten closed-form feature families of the last
slice (advanced, cesium, high_snr, fourier, fwhm, temp_fwhm,
peak_ordering, powerlaw_ratio, enhanced_colors, time_to_decline).

The same packed objects go through each JAX family and its port. Names and
column order must be identical (a jitted family's keys come back sorted),
NaN positions identical, and values within rtol 1e-4 with a floor of 1e-4
of the column's largest magnitude (``tests/test_torch_features.py``'s
rule). Two fixtures: the synthetic ``small_dataset``, and a dense one
(64 points per band over 200 days, every 8th object with tied peak
fluxes) on which the windowed colors, the half-max crossings and the
declines are mostly defined. The first maximum wins a tie in fwhm,
temp_fwhm and time_to_decline; peak_ordering's tie-breaks are pinned
against ``tests/test_more_features.py``'s case.

The slice as a whole: all twelve families of the slice (these ten, dtw
and gp1d) through ``chunked_extract`` with a chunk smaller than the
fixture, merged, against the JAX package's ``chunked_extract``: the same
merged names and order, the closed-form columns and DTW's distances at
the rule above, DTW's warp fractions equal, and gp1d's 20-step fit at the
multiband_gp gate (``tests/test_torch_gp.py``: per column >= 90% of lanes
within rtol 2e-3, mean >= 97%; NaNs identical).
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.data.packing import pack_lightcurves as jax_pack
from mallorn_tpu.features import dtw as jdtw
from mallorn_tpu.features import gp1d as jgp1d
from mallorn_tpu.features.base import chunked_extract as jax_chunked
from mallorn_tpu.features.base import merge as jax_merge
from mallorn_tpu.features import (advanced as jadvanced, cesium as jcesium,
                                  enhanced_colors as jenhanced, fourier as jfourier,
                                  fwhm as jfwhm, high_snr as jhigh_snr,
                                  peak_ordering as jpeak, powerlaw_ratio as jplr,
                                  temp_fwhm as jtemp, time_to_decline as jttd)
from mallorn_tpu_torch.data.packing import Metadata, from_numpy, pack_lightcurves
from mallorn_tpu_torch.features import (advanced, cesium, dtw, enhanced_colors, fourier, fwhm,
                                         gp1d, high_snr, peak_ordering, powerlaw_ratio,
                                         temp_fwhm, time_to_decline)
from mallorn_tpu_torch.features.base import chunked_extract, merge
from tests.test_torch_gp import _assert_mostly_close

torch.set_num_threads(2)

FAMILIES = {
    "advanced": (lambda p, m: jadvanced.extract(p, m), lambda p, m: advanced.extract(p, m)),
    "cesium": (lambda p, m: jcesium.extract(p), lambda p, m: cesium.extract(p)),
    "high_snr": (lambda p, m: jhigh_snr.extract(p), lambda p, m: high_snr.extract(p)),
    "fourier": (lambda p, m: jfourier.extract(p), lambda p, m: fourier.extract(p)),
    "fwhm": (lambda p, m: jfwhm.extract(p), lambda p, m: fwhm.extract(p)),
    "temp_fwhm": (lambda p, m: jtemp.extract(p), lambda p, m: temp_fwhm.extract(p)),
    "peak_ordering": (lambda p, m: jpeak.extract(p), lambda p, m: peak_ordering.extract(p)),
    "powerlaw_ratio": (lambda p, m: jplr.extract(p), lambda p, m: powerlaw_ratio.extract(p)),
    "enhanced_colors": (lambda p, m: jenhanced.extract(p),
                        lambda p, m: enhanced_colors.extract(p)),
    "time_to_decline": (lambda p, m: jttd.extract(p), lambda p, m: time_to_decline.extract(p)),
}
# the families whose columns the synthetic fixture mostly leaves NaN or
# never ties: they also run on the dense fixture
DENSE = ("enhanced_colors", "fwhm", "peak_ordering", "temp_fwhm", "time_to_decline")


def torch_packed(packed):
    return from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset,
                      device="cpu")


def assert_columns_close(want: dict, got: dict, rtol: float = 1e-4, floor: float = 0.0):
    """``floor``: the least magnitude the absolute floor is taken of (a
    one-object column that differences two ~1e4 K temperatures is ~0)."""
    assert list(got) == list(want)
    for k in want:
        a = np.asarray(want[k], np.float64)
        b = got[k].double().numpy()
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a), err_msg=k)
        scale = max(np.nanmax(np.abs(a), initial=0.0), floor)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale, equal_nan=True,
                                   err_msg=k)


class _Meta:
    def __init__(self, z):
        self.z = z


@pytest.fixture(scope="module")
def dense_dataset():
    """24 objects x 6 bands x 64 points over 200 days: a fast rise and a
    power-law decline per band (blue bands first), noise, a few sparse
    bands, and on every 8th object the peak flux repeated at the next
    point (a tie)."""
    rng = np.random.default_rng(2024)
    rows = []
    for o in range(24):
        t_peak = rng.uniform(40, 90)
        for b in range(6):
            n = 64 if (o + b) % 11 else 4
            t = np.sort(rng.uniform(0, 200, n))
            dt = t - (t_peak + 3.0 * b)
            f = np.where(dt < 0, np.exp(np.minimum(dt, 0.0) / 8.0),
                         np.maximum(1 + dt / 20.0, 1.0) ** -1.6)
            f = (100.0 - 8 * b) * f + rng.normal(0, 1.5, n)
            if o % 8 == 0 and n > 5:
                k = int(np.argmax(f))
                f[min(k + 1, n - 1)] = f[k]
            rows.append((np.full(n, o), t, f, np.full(n, 1.5), np.full(n, b)))
    oi, t, f, e, b = (np.concatenate(c) for c in zip(*rows))
    packed = jax_pack(oi, t, f, e, b, 24)
    z = rng.uniform(0.05, 0.6, 24).astype(np.float32)
    return packed, _Meta(z)


CASES = [(f, "synthetic") for f in sorted(FAMILIES)] + [(f, "dense") for f in DENSE]


@pytest.mark.parametrize("family,fixture", CASES)
def test_family_matches_jax(small_dataset, dense_dataset, family, fixture):
    packed, meta = small_dataset[:2] if fixture == "synthetic" else dense_dataset
    jfn, tfn = FAMILIES[family]
    want = jfn(packed, meta)
    got = tfn(torch_packed(packed), meta)
    if fixture == "dense" and family != "peak_ordering":
        finite = np.mean([np.isfinite(np.asarray(v)).mean() for v in want.values()])
        assert finite > 0.3, finite
    assert_columns_close(want, got)


def test_peak_ordering_tie_breaks():
    """Equal peak times in u, g, r: first_peak goes to the lowest band
    index, g_peaks_last to the highest (tests/test_more_features.py:186)."""
    times, fluxes, bands = [], [], []
    for bi in (0, 1, 2):
        times += [0.0, 10.0, 20.0]
        fluxes += [1.0, 5.0, 2.0]
        bands += [bi] * 3
    n = len(times)
    args = (np.zeros(n, np.int64), np.asarray(times), np.asarray(fluxes), np.ones(n),
            np.asarray(bands, np.int64), 1)
    out = peak_ordering.extract(pack_lightcurves(*args, device="cpu"))
    assert float(out["first_peak_u"][0]) == 1.0
    assert float(out["first_peak_g"][0]) == 0.0
    assert float(out["g_peaks_last"][0]) == 0.0
    assert float(out["peak_time_spread"][0]) == 0.0
    assert float(out["g_to_r_peak_delay"][0]) == 0.0
    assert_columns_close(jpeak.extract(jax_pack(*args)), out)


def test_first_maximum_wins_a_tie():
    """One band whose two largest fluxes are equal: the peak is the first
    of them in fwhm, temp_fwhm and time_to_decline, as in the JAX package."""
    t = np.array([0.0, 5.0, 10.0, 15.0, 20.0, 30.0, 45.0, 60.0])
    f = np.array([1.0, 4.0, 9.0, 9.0, 7.0, 4.0, 2.0, 0.5])
    n = len(t)
    oi = np.zeros(2 * n, np.int64)
    args = (oi, np.concatenate([t, t]), np.concatenate([f, 0.8 * f]), np.ones(2 * n),
            np.repeat(np.array([2, 1], np.int64), n), 1)
    jp, tp = jax_pack(*args), pack_lightcurves(*args, device="cpu")
    for jmod, tmod in ((jfwhm, fwhm), (jtemp, temp_fwhm), (jttd, time_to_decline)):
        assert_columns_close(jmod.extract(jp), tmod.extract(tp),
                             floor=1e4 if tmod is temp_fwhm else 0.0)
    # r peaks at t = 10 (index 2), not 15: the fall side starts there
    assert float(fwhm.extract(tp)["r_fall_hwhm"][0]) == pytest.approx(
        (20 + (4.5 - 7.0) * (30 - 20) / (4.0 - 7.0)) - 10.0, rel=1e-6)
    assert float(time_to_decline.extract(tp)["r_decline_to_80pct"][0]) == pytest.approx(
        15 + (7.2 - 9.0) * (20 - 15) / (7.0 - 9.0) - 10.0, rel=1e-6)


def test_the_slice_through_chunked_extract(small_dataset):
    packed, meta, _ = small_dataset
    tp = torch_packed(packed)
    tmeta = Metadata(object_ids=meta.object_ids, z=meta.z, ebv=meta.ebv, target=meta.target)
    chunk, steps = 24, 20
    jt_tpl = jdtw.build_templates(packed, meta.target)
    tt_tpl = dtw.build_templates(tp, meta.target)
    want = {
        "gp1d": jax_chunked(jgp1d.extract, packed, chunk_size=chunk, n_steps=steps),
        "dtw": jax_chunked(jdtw.extract, packed, jt_tpl, chunk_size=chunk),
        "advanced": jax_chunked(jadvanced.extract, packed, meta, chunk_size=chunk),
    }
    got = {
        "gp1d": chunked_extract(gp1d.extract, tp, chunk_size=chunk, n_steps=steps),
        "dtw": chunked_extract(dtw.extract, tp, tt_tpl, chunk_size=chunk),
        "advanced": chunked_extract(advanced.extract, tp, tmeta, chunk_size=chunk),
    }
    for name in sorted(FAMILIES):
        if name != "advanced":
            jfn, tfn = FAMILIES[name]
            want[name] = jax_chunked(lambda p: jfn(p, None), packed, chunk_size=chunk)
            got[name] = chunked_extract(lambda p: tfn(p, None), tp, chunk_size=chunk)
    w_all = jax_merge(*want.values())
    g_all = merge(*got.values())
    assert list(g_all) == list(w_all)
    assert len(g_all) == sum(len(v) for v in want.values())
    assert all(len(v) == tp.n_objects for v in g_all.values())
    warp = [k for k in want["dtw"] if "warp" in k]
    for k in warp:
        np.testing.assert_array_equal(g_all[k].numpy(), np.asarray(w_all[k]), err_msg=k)
    _assert_mostly_close({k: w_all[k] for k in want["gp1d"]},
                         {k: g_all[k].numpy() for k in want["gp1d"]}, 2e-3)
    held = [k for k in w_all if k not in warp and k not in want["gp1d"]]
    assert_columns_close({k: w_all[k] for k in held}, {k: g_all[k] for k in held})
