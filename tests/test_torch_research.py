"""Port vs JAX package: the research feature family (v115c), whose six
minimal columns feed the kaggle ensemble's v114d member.

The same packed synthetic objects go through ``mallorn_tpu.features.
research.extract`` and the port's ``features.research.extract``. Names and
column order must be identical, NaN positions identical, and values
within rtol 1e-4 with an absolute floor of 1e-4 of the column's largest
magnitude (the bar of tests/test_torch_features.py). The MHPS columns go
through an FFT in both packages (float32 ``rfft`` / ``irfft`` of length
2048).
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.features import research as jresearch
from mallorn_tpu_torch.data.packing import from_numpy
from mallorn_tpu_torch.features import research as tresearch
from mallorn_tpu_torch.train.pipelines import V115_MINIMAL_RESEARCH

torch.set_num_threads(2)


def _torch_packed(packed):
    return from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset,
                      device="cpu")


@pytest.mark.parametrize("dataset", ["tiny_dataset", "small_dataset"])
def test_research_family_matches_jax(dataset, request):
    packed, meta, _ = request.getfixturevalue(dataset)
    want = {k: np.asarray(v, np.float64) for k, v in jresearch.extract(packed, meta).items()}
    got = {k: v.double().numpy() for k, v in
           tresearch.extract(_torch_packed(packed), meta).items()}
    assert list(got) == list(want)
    for k in want:
        a, b = want[k], got[k]
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a), err_msg=k)
        scale = np.nanmax(np.abs(a), initial=0.0)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * scale, equal_nan=True,
                                   err_msg=k)
    # the ensemble's six columns are there and not all NaN
    for k in V115_MINIMAL_RESEARCH:
        assert np.isfinite(got[k]).any(), k


def test_no_redshift_gives_nan_luminosity(tiny_dataset):
    packed, _, _ = tiny_dataset
    got = tresearch.extract(_torch_packed(packed), None)
    for k in ("luminosity_distance_mpc", "peak_luminosity", "mean_luminosity"):
        assert bool(torch.isnan(got[k]).all()), k
    assert bool(torch.isfinite(got["nuclear_smoothness"]).any())
