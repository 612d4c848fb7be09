"""Port vs JAX package: the fused Cholesky-inverse (K2).

``chol_inv_plain`` (the CUDA kernel's plain PyTorch version, which is what
``chol_inv`` runs on a CPU tensor) against ``cholesky_inverse_lanes`` in
Pallas interpret mode and against float64 numpy, at the bars of
``tests/test_chol_pallas.py``: Linv 5e-5, logdet rtol 1e-5 / atol 1e-4,
Kinv rtol 1e-4. The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mallorn_tpu.ops.chol_pallas import cholesky_inverse_lanes
from mallorn_tpu_torch.ops import chol_cuda
from mallorn_tpu_torch.ops.chol_cuda import cho_solve, chol_inv, chol_inv_plain

torch.set_num_threads(2)


def _spd(b, t, seed=0, n_pad=0):
    """SPD batch; the last ``n_pad`` rows/columns identity-padded."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(b, t, t))
    K = A @ A.transpose(0, 2, 1) + t * np.eye(t)
    if n_pad:
        K[:, t - n_pad:, :] = 0.0
        K[:, :, t - n_pad:] = 0.0
        K[:, np.arange(t - n_pad, t), np.arange(t - n_pad, t)] = 1.0
    return K.astype(np.float32)


def _f64_reference(K):
    L = np.linalg.cholesky(K.astype(np.float64))
    Linv = np.stack([np.linalg.inv(l) for l in L])
    return Linv, 2 * np.log(np.diagonal(L, axis1=1, axis2=2)).sum(1)


@pytest.mark.parametrize("b,t,n_pad", [(3, 32, 0), (5, 24, 6), (130, 16, 3)])
def test_chol_inv_plain_matches_pallas_and_f64(b, t, n_pad):
    K = _spd(b, t, seed=b + t, n_pad=n_pad)
    Linv, ld = chol_inv(torch.from_numpy(K))  # CPU tensor -> plain version
    Linv, ld = Linv.numpy(), ld.numpy()

    j_Linv, j_ld = cholesky_inverse_lanes(jnp.asarray(K), interpret=True)
    np.testing.assert_allclose(Linv, np.asarray(j_Linv), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(ld, np.asarray(j_ld), rtol=1e-5, atol=1e-4)

    ref_Linv, ref_ld = _f64_reference(K)
    np.testing.assert_allclose(Linv, ref_Linv, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(ld, ref_ld, rtol=1e-5, atol=1e-4)
    assert np.max(np.abs(np.triu(Linv, 1))) == 0.0
    Kinv = Linv.transpose(0, 2, 1) @ Linv
    np.testing.assert_allclose(Kinv, np.linalg.inv(K.astype(np.float64)),
                               rtol=1e-4, atol=1e-5)


def test_chol_inv_plain_float64_oracle():
    K = _spd(4, 20, seed=3).astype(np.float64)
    Linv, ld = chol_inv_plain(torch.from_numpy(K))
    ref_Linv, ref_ld = _f64_reference(K)
    np.testing.assert_allclose(Linv.numpy(), ref_Linv, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ld.numpy(), ref_ld, rtol=1e-12)


def test_non_spd_gives_nan_not_an_exception():
    K = _spd(3, 16, seed=4)
    K[1, 5, 5] = -1.0
    Linv, ld = chol_inv(torch.from_numpy(K))
    assert torch.isnan(ld).tolist() == [False, True, False]
    assert bool(torch.isnan(Linv[1]).any())
    assert bool(torch.isfinite(Linv[0]).all()) and bool(torch.isfinite(Linv[2]).all())
    j_Linv, j_ld = cholesky_inverse_lanes(jnp.asarray(K), interpret=True)
    assert np.isnan(np.asarray(j_ld)).tolist() == [False, True, False]


def test_cho_solve_matches_numpy():
    K = _spd(4, 12, seed=5)
    r = np.random.default_rng(6).normal(size=(4, 12)).astype(np.float32)
    Linv, _ = chol_inv_plain(torch.from_numpy(K))
    got = cho_solve(Linv, torch.from_numpy(r)).numpy()
    want = np.linalg.solve(K.astype(np.float64), r.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_plain_calls_are_not_counted_and_other_devices_raise():
    chol_cuda.reset_launches()
    chol_inv(torch.from_numpy(_spd(2, 8)))
    assert chol_cuda.launches == 0
    with pytest.raises(ValueError):
        chol_inv(torch.empty(2, 8, 8, device="meta"))
