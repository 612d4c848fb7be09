"""Port vs JAX package: packing raw observations into padded tensors.

Both packers get the same flat observation columns (from the JAX
package's synthetic generator); every packed array must be exactly equal.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.data import packing as jpack
from mallorn_tpu.data.synthetic import generate_dataset
from mallorn_tpu_torch.data import packing as tpack

torch.set_num_threads(2)


def _assert_same(j, t):
    assert j.time_offset == t.time_offset
    for name, a, b in zip(jpack.PackedLightcurves._fields, j[:-1], t[:-1]):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed,n,kw", [
    (3, 24, {}),
    (11, 40, {"pad_multiple": 16}),
    (5, 16, {"max_band_len": 12, "max_total_len": 40}),
])
def test_pack_lightcurves_matches_jax(seed, n, kw):
    _, _, cols = generate_dataset(n_objects=n, seed=seed)
    args = (cols["object_index"], cols["time"], cols["flux"], cols["flux_err"],
            cols["band"], n)
    _assert_same(jpack.pack_lightcurves(*args, **kw),
                 tpack.pack_lightcurves(*args, device="cpu", **kw))


def test_pad_objects_matches_jax():
    packed, _, cols = generate_dataset(n_objects=10, seed=2)
    t = tpack.from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset,
                         device="cpu")
    _assert_same(jpack.pad_objects(packed, 16), tpack.pad_objects(t, 16))
    assert tpack.pad_objects(t, 10) is t
    with pytest.raises(ValueError):
        tpack.pad_objects(t, 4)
