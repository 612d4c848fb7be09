"""Port vs JAX package: the fused Cholesky-inverse (K2) and the
factorisation alone (K6, at the end).

``chol_inv_plain`` (the CUDA kernel's plain PyTorch version, which is what
``chol_inv`` runs on a CPU tensor) against ``cholesky_inverse_lanes`` in
Pallas interpret mode and against float64 numpy, at the bars of
``tests/test_chol_pallas.py``: Linv 5e-5, logdet rtol 1e-5 / atol 1e-4,
Kinv rtol 1e-4. The CUDA kernels themselves are held against the same
plain version on the card by ``chip_smoke.py`` and by the ``cuda`` case
below. The machine with the card has no JAX, so the JAX package is
imported inside the tests that use it, and the file runs there as
``pytest --noconftest -m cuda tests/test_torch_chol.py``.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu_torch.ops import chol_cuda
from mallorn_tpu_torch.ops.chol_cuda import (cho_solve, chol_inv, chol_inv_blocked_plain,
                                             chol_inv_plain, cholesky, cholesky_blocked_plain,
                                             cholesky_plain)

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


def cholesky_inverse_lanes(K, interpret):
    from mallorn_tpu.ops.chol_pallas import cholesky_inverse_lanes as lanes

    return lanes(K, interpret=interpret)


def _f64_reference(K):
    L = np.linalg.cholesky(K.astype(np.float64))
    Linv = np.stack([np.linalg.inv(l) for l in L])
    return Linv, 2 * np.log(np.diagonal(L, axis1=1, axis2=2)).sum(1)


@pytest.mark.parametrize("b,t,n_pad", [(3, 32, 0), (5, 24, 6), (130, 16, 3)])
def test_chol_inv_plain_matches_pallas_and_f64(b, t, n_pad):
    K = _spd(b, t, seed=b + t, n_pad=n_pad)
    Linv, ld = chol_inv(torch.from_numpy(K))  # CPU tensor -> plain version
    Linv, ld = Linv.numpy(), ld.numpy()

    j_Linv, j_ld = cholesky_inverse_lanes(np.asarray(K), interpret=True)
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
    j_Linv, j_ld = cholesky_inverse_lanes(np.asarray(K), interpret=True)
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


def test_gp_features_of_objects_wider_than_the_shared_memory_kernel():
    """Objects with 274-314 usable points, at a compacted width of 320
    (272 < width <= MAX_T: the blocked kernel's widest instantiation, 320
    threads and a 215,040-byte triangle): the GP family through
    ``chol_inv`` (its plain version here; the blocked kernel on the card)
    against the JAX package's, at the gate of tests/test_torch_gp.py (per
    column >= 90% of lanes within rtol 2e-3, mean >= 97%)."""
    from mallorn_tpu.data.synthetic import generate_dataset
    from mallorn_tpu.features import multiband_gp as jgp
    from mallorn_tpu_torch.data.packing import from_numpy
    from mallorn_tpu_torch.features import multiband_gp as tgp

    packed, _, _ = generate_dataset(n_objects=4, seed=5, mean_obs_per_band=48.0)
    tp = from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset, device="cpu")
    counts = tgp._use_mask(tp).sum(1).numpy()
    _, widths = tgp.gp_schedule(counts, tp.all_time.shape[1], 8)
    assert counts.min() > 272 and 272 < widths[0] <= chol_cuda.MAX_T
    want = {k: np.asarray(v, np.float64) for k, v in jgp.extract(packed, n_steps=8).items()}
    got = {k: v.double().numpy() for k, v in tgp.extract(tp, n_steps=8).items()}
    assert list(got) == list(want)
    fracs = []
    for k in want:
        a, b = want[k], got[k]
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a), err_msg=k)
        close = np.isclose(b, a, rtol=2e-3, atol=2e-3 * np.nanmax(np.abs(a), initial=0.0))
        close |= np.isnan(a) & np.isnan(b)
        assert close.mean() >= 0.90, (k, close.mean())
        fracs.append(close.mean())
    assert np.mean(fracs) >= 0.97


@pytest.mark.cuda
def test_wide_kernel_matches_plain_on_the_card():
    """MAX_T < T <= MAX_T_CLUSTER takes the cluster kernel (one launch, 2 or
    4 CTAs per matrix), T > MAX_T_CLUSTER the tiled kernel (64 x 64 tiles
    in a global scratch, one call counted per call), each alone, at the
    bars above, T = 1000 not a multiple of the tile; two launches bit for
    bit equal; a non-positive pivot gives NaN in that matrix only."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    for t in (336, 344, 400, 512, 800, 1000, 1024):
        K = torch.from_numpy(_spd(6, t, seed=t, n_pad=t // 8)).cuda()
        K[2, 7, 7] = -1.0
        chol_cuda.reset_launches()
        Linv, ld = chol_inv(K)
        Linv2, ld2 = chol_inv(K)
        torch.cuda.synchronize()
        cluster = t <= chol_cuda.MAX_T_CLUSTER
        assert chol_cuda.cluster_launches_by_t == ({t: 2} if cluster else {})
        assert chol_cuda.large_launches_by_t == ({} if cluster else {t: 2})
        assert chol_cuda.large_launches == (0 if cluster else 2) and chol_cuda.launches == 0
        assert torch.equal(torch.nan_to_num(Linv), torch.nan_to_num(Linv2))
        assert torch.equal(torch.nan_to_num(ld), torch.nan_to_num(ld2))
        Lp, ldp = chol_inv_plain(K.double())
        ok = [0, 1, 3, 4, 5]
        assert torch.isnan(ld).tolist() == [i == 2 for i in range(6)]
        assert torch.isnan(Linv).flatten(1).any(1).tolist() == [i == 2 for i in range(6)]
        np.testing.assert_allclose(Linv[ok].cpu().numpy(), Lp[ok].cpu().numpy(),
                                   rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(ld[ok].cpu().numpy(), ldp[ok].cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)
        assert float(torch.triu(Linv[ok], 1).abs().max()) == 0.0


# The T <= MAX_T kernel's blocked algorithm (``chol_inv_blocked_plain``:
# panels of nb columns, the inverse formed in place) against the JAX
# package and float64 at the bars above, at widths that are not multiples
# of nb (the kernel pads with identity) and with identity-padded rows.

@pytest.mark.parametrize("b,t,nb,n_pad", [(3, 24, 16, 6), (4, 40, 16, 5), (2, 72, 32, 9)])
def test_chol_inv_blocked_plain_matches_pallas_and_f64(b, t, nb, n_pad):
    K = _spd(b, t, seed=10 * t + nb, n_pad=n_pad)
    Linv, ld = chol_inv_blocked_plain(torch.from_numpy(K), nb)
    Linv, ld = Linv.numpy(), ld.numpy()

    j_Linv, j_ld = cholesky_inverse_lanes(np.asarray(K), interpret=True)
    np.testing.assert_allclose(Linv, np.asarray(j_Linv), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(ld, np.asarray(j_ld), rtol=1e-5, atol=1e-4)

    ref_Linv, ref_ld = _f64_reference(K)
    np.testing.assert_allclose(Linv, ref_Linv, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(ld, ref_ld, rtol=1e-5, atol=1e-4)
    assert np.max(np.abs(np.triu(Linv, 1))) == 0.0
    Kinv = Linv.transpose(0, 2, 1) @ Linv
    np.testing.assert_allclose(Kinv, np.linalg.inv(K.astype(np.float64)),
                               rtol=1e-4, atol=1e-5)
    # float64 in, the oracle out
    L64, ld64 = chol_inv_blocked_plain(torch.from_numpy(K.astype(np.float64)), nb)
    np.testing.assert_allclose(L64.numpy(), ref_Linv, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ld64.numpy(), ref_ld, rtol=1e-12)


def test_chol_inv_blocked_plain_at_nineteen_panels_matches_f64():
    """nt = 19 panels (T = 300), a width of the 320-thread instantiation,
    against float64 numpy only: Pallas interpret mode at T = 300 would
    cost tens of seconds of the CPU test budget."""
    K = _spd(2, 300, seed=300, n_pad=12)
    Linv, ld = chol_inv_blocked_plain(torch.from_numpy(K))
    ref_Linv, ref_ld = _f64_reference(K)
    np.testing.assert_allclose(Linv.numpy(), ref_Linv, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(ld.numpy(), ref_ld, rtol=1e-5, atol=1e-4)
    assert float(torch.triu(Linv, 1).abs().max()) == 0.0
    L64, ld64 = chol_inv_blocked_plain(torch.from_numpy(K.astype(np.float64)))
    np.testing.assert_allclose(L64.numpy(), ref_Linv, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ld64.numpy(), ref_ld, rtol=1e-12)


def test_chol_inv_blocked_plain_nan_stays_in_its_matrix():
    """A non-positive pivot in the second panel gives NaN in that matrix
    only, as in the JAX package; K's upper triangle is never read."""
    K = _spd(3, 40, seed=12, n_pad=4)
    K[1, 20, 20] = -1.0
    K[2][np.triu_indices(40, 1)] = np.nan
    Linv, ld = chol_inv_blocked_plain(torch.from_numpy(K))
    assert torch.isnan(ld).tolist() == [False, True, False]
    assert torch.isnan(Linv).flatten(1).any(1).tolist() == [False, True, False]
    j_Linv, j_ld = cholesky_inverse_lanes(np.tril(K), interpret=True)
    assert np.isnan(np.asarray(j_ld)).tolist() == [False, True, False]
    np.testing.assert_allclose(Linv[2].numpy(), np.asarray(j_Linv)[2], rtol=5e-5, atol=5e-5)


@pytest.mark.cuda
def test_blocked_kernel_matches_plain_on_the_card():
    """T <= MAX_T takes the blocked kernel at every width, multiples of 16
    or not: within the bars above of the plain version (float64), two
    launches bit for bit equal, a non-positive pivot giving NaN in that
    matrix only, and one launch counted per call at its width."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    for t in (64, 72, 184, 240, 256, 288, 320):
        K = torch.from_numpy(_spd(6, t, seed=t, n_pad=t // 8)).cuda()
        K[3, 17, 17] = -1.0
        chol_cuda.reset_launches()
        Linv, ld = chol_inv(K)
        Linv2, ld2 = chol_inv(K)
        torch.cuda.synchronize()
        assert chol_cuda.launches == 2 and chol_cuda.launches_by_t == {t: 2}
        assert chol_cuda.large_launches == 0 and chol_cuda.cluster_launches == 0
        assert torch.equal(torch.nan_to_num(Linv), torch.nan_to_num(Linv2))
        assert torch.equal(torch.isnan(ld), torch.isnan(ld2))
        assert torch.equal(torch.nan_to_num(ld), torch.nan_to_num(ld2))
        assert torch.isnan(ld).tolist() == [i == 3 for i in range(6)]
        assert torch.isnan(Linv).flatten(1).any(1).tolist() == [i == 3 for i in range(6)]
        ok = [0, 1, 2, 4, 5]
        Lp, ldp = chol_inv_plain(K.double())
        np.testing.assert_allclose(Linv[ok].cpu().numpy(), Lp[ok].cpu().numpy(),
                                   rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(ld[ok].cpu().numpy(), ldp[ok].cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)
        assert float(torch.triu(Linv[ok], 1).abs().max()) == 0.0


@pytest.mark.cuda
def test_blocked_kernel_at_the_gp1d_shapes_on_the_card():
    """gp1d's chunks: 12,288 lanes (and a ragged 12,287) at the band view's
    width T = 40, the blocked kernel within the bars above of the plain
    version (float64), two launches bit for bit equal, one launch counted
    per call at T = 40."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    for b in (12288, 12287):
        K = torch.from_numpy(_spd(b, 40, seed=b, n_pad=5)).cuda()
        chol_cuda.reset_launches()
        Linv, ld = chol_inv(K)
        Linv2, ld2 = chol_inv(K)
        torch.cuda.synchronize()
        assert chol_cuda.launches_by_t == {40: 2} and chol_cuda.cluster_launches == 0
        assert torch.equal(Linv, Linv2) and torch.equal(ld, ld2)
        Lp, ldp = chol_inv_plain(K.double())
        np.testing.assert_allclose(Linv.cpu().numpy(), Lp.cpu().numpy(), rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(ld.cpu().numpy(), ldp.cpu().numpy(), rtol=1e-5, atol=1e-4)
        assert float(torch.triu(Linv, 1).abs().max()) == 0.0


@pytest.mark.cuda
def test_gp1d_on_the_card_counts_its_launches():
    """gp1d's fit: n_steps + 1 K2 launches at the band view's width, and
    the CPU's features at the multiband_gp gate (tests/test_torch_gp.py:
    per column >= 90% of lanes within rtol 2e-3, mean >= 97%; NaNs
    identical)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    from mallorn_tpu_torch.data.synthetic import generate_dataset
    from mallorn_tpu_torch.features import gp1d

    packed = generate_dataset(40, seed=5, device="cpu")[0]
    chol_cuda.reset_launches()
    got = gp1d.extract(packed.to("cuda"), n_steps=20)
    torch.cuda.synchronize()
    assert chol_cuda.launches_by_t == {packed.band_time.shape[-1]: 21}
    assert chol_cuda.cluster_launches == 0 and chol_cuda.large_launches == 0
    want = gp1d.extract(packed, n_steps=20)
    fracs = []
    for k in want:
        a, b = want[k].double().numpy(), got[k].cpu().double().numpy()
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a), err_msg=k)
        close = np.isclose(b, a, rtol=2e-3, atol=2e-3 * np.nanmax(np.abs(a), initial=0.0))
        fracs.append((close | np.isnan(a)).mean())
        assert fracs[-1] >= 0.90, (k, fracs[-1])
    assert np.mean(fracs) >= 0.97


# K6: ``cholesky_plain`` (what ``cholesky`` runs on a CPU tensor) against
# ``cholesky_lanes`` in Pallas interpret mode at the bars of
# tests/test_chol_pallas.py:19 (rtol / atol 2e-5, upper triangle exactly 0).

def test_cholesky_plain_matches_cholesky_lanes_and_f64():
    from mallorn_tpu.ops.chol_pallas import cholesky_lanes

    K = _spd(5, 24)
    L = cholesky(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(L, np.asarray(cholesky_lanes(np.asarray(K), interpret=True)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(L, np.linalg.cholesky(K.astype(np.float64)), rtol=2e-5, atol=2e-5)
    assert np.max(np.abs(np.triu(L, 1))) == 0.0


def test_cholesky_plain_float64_is_the_oracle_and_nan_stays_in_its_matrix():
    K = _spd(3, 18, seed=8, n_pad=4).astype(np.float64)
    L = cholesky_plain(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=1e-12, atol=1e-12)
    K = K.astype(np.float32)
    K[2, 6, 6] = -1.0
    L = cholesky(torch.from_numpy(K))
    assert torch.isnan(L).flatten(1).any(1).tolist() == [False, False, True]
    assert float(torch.triu(L[:2], 1).abs().max()) == 0.0
    chol_cuda.reset_launches()
    cholesky(torch.from_numpy(K))
    assert chol_cuda.chol_launches == 0
    with pytest.raises(ValueError):
        cholesky(torch.empty(2, 8, 8, device="meta"))


# The T <= MAX_T kernel's K6 algorithm (``cholesky_blocked_plain``: the
# panels of ``chol_inv_blocked_plain`` with L_kk left in the diagonal tiles
# and no inverse) against the JAX package and float64 at the bars above.

@pytest.mark.parametrize("b,t,nb,n_pad", [(3, 24, 16, 6), (4, 40, 16, 5), (2, 72, 32, 9)])
def test_cholesky_blocked_plain_matches_cholesky_lanes_and_f64(b, t, nb, n_pad):
    from mallorn_tpu.ops.chol_pallas import cholesky_lanes

    K = _spd(b, t, seed=20 * t + nb, n_pad=n_pad)
    L = cholesky_blocked_plain(torch.from_numpy(K), nb).numpy()
    np.testing.assert_allclose(L, np.asarray(cholesky_lanes(np.asarray(K), interpret=True)),
                               rtol=2e-5, atol=2e-5)
    ref = np.linalg.cholesky(K.astype(np.float64))
    np.testing.assert_allclose(L, ref, rtol=2e-5, atol=2e-5)
    assert np.max(np.abs(np.triu(L, 1))) == 0.0
    # float64 in, the oracle out
    L64 = cholesky_blocked_plain(torch.from_numpy(K.astype(np.float64)), nb).numpy()
    np.testing.assert_allclose(L64, ref, rtol=1e-10, atol=1e-12)


def test_cholesky_blocked_plain_nan_stays_in_its_matrix():
    """A non-positive pivot in the second panel gives NaN in that matrix
    only, as in the JAX package; K's upper triangle is never read."""
    from mallorn_tpu.ops.chol_pallas import cholesky_lanes

    K = _spd(3, 40, seed=13, n_pad=4)
    K[1, 20, 20] = -1.0
    K[2][np.triu_indices(40, 1)] = np.nan
    L = cholesky_blocked_plain(torch.from_numpy(K))
    assert torch.isnan(L).flatten(1).any(1).tolist() == [False, True, False]
    j_L = np.asarray(cholesky_lanes(np.tril(K), interpret=True))
    assert np.isnan(j_L).reshape(3, -1).any(1).tolist() == [False, True, False]
    np.testing.assert_allclose(L[2].numpy(), j_L[2], rtol=2e-5, atol=2e-5)
    assert float(torch.triu(L[[0, 2]], 1).abs().max()) == 0.0


@pytest.mark.cuda
def test_cholesky_kernel_matches_plain_on_the_card():
    """T <= MAX_T (the blocked kernel, counted in ``chol_launches``),
    MAX_T < T <= MAX_T_CLUSTER (the cluster kernel, ``chol_cluster_launches``)
    and beyond (the tiled kernel in a global scratch, one call counted in
    ``chol_large_launches`` per call), each alone, at the bars above; two
    launches bit for bit equal; a non-positive pivot gives NaN in that
    matrix only."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    for t in (24, 160, 256, 320, 400, 512, 800, 1000, 1024):
        K = torch.from_numpy(_spd(6, t, seed=t, n_pad=t // 8)).cuda()
        K[4, 3, 3] = -1.0
        chol_cuda.reset_launches()
        L = cholesky(K)
        L2 = cholesky(K)
        torch.cuda.synchronize()
        blocked = t <= chol_cuda.MAX_T
        cluster = chol_cuda.MAX_T < t <= chol_cuda.MAX_T_CLUSTER
        assert chol_cuda.chol_launches == (2 if blocked else 0)
        assert chol_cuda.chol_cluster_launches == (2 if cluster else 0)
        assert chol_cuda.chol_large_launches == (0 if blocked or cluster else 2)
        assert chol_cuda.launches == 0 and chol_cuda.large_launches == 0
        assert chol_cuda.cluster_launches == 0
        assert torch.equal(torch.isnan(L), torch.isnan(L2))
        assert torch.equal(torch.nan_to_num(L), torch.nan_to_num(L2))
        ok = [0, 1, 2, 3, 5]
        assert torch.isnan(L).flatten(1).any(1).tolist() == [i == 4 for i in range(6)]
        want = cholesky_plain(K.double())[ok].cpu().numpy()
        np.testing.assert_allclose(L[ok].cpu().numpy(), want, rtol=2e-5, atol=2e-5)
        assert float(torch.triu(L[ok], 1).abs().max()) == 0.0
