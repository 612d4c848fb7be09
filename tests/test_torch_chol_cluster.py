"""The cluster Cholesky (K2 and K6 for MAX_T < T <= MAX_T_CLUSTER) on the
CPU: its layout arithmetic, its algorithm's plain twins at its widths, and
the GP family at a width only it serves.

- ``chol_cuda.cluster_size`` / ``cluster_smem_bytes`` against a count of
  each rank's tile rows and against the constants of
  ``csrc/chol_inv_cluster.cu``.
- ``chol_inv_blocked_plain`` and ``cholesky_blocked_plain`` (the blocked
  and the cluster kernel's order) at T = 400 (25 panels) and a ragged 344
  with identity-padded rows, against float64 numpy at the bars of
  ``tests/test_chol_pallas.py`` (Pallas interpret mode at these widths
  would cost minutes of the CPU budget).
- The 2D-GP family on objects of more than 320 usable points (compacted
  width 400) against the JAX package, at the gate of
  ``tests/test_torch_gp.py``.

The card runs the kernel itself against the plain versions
(``tests/test_torch_chol.py``'s ``cuda`` cases, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mallorn_tpu_torch.ops import chol_cuda
from mallorn_tpu_torch.ops.chol_cuda import (MAX_T, MAX_T_CLUSTER, SMEM_BYTES,
                                             chol_inv_blocked_plain, cholesky_blocked_plain,
                                             cluster_size, cluster_smem_bytes)

torch.set_num_threads(2)

CU = Path(chol_cuda.__file__).resolve().parents[1] / "csrc" / "chol_inv_cluster.cu"


def _rank_bytes(T: int, C: int):
    """(bytes of each CTA, tiles of each rank's rows) counted tile by tile:
    rank r holds tile rows r, r + C, ... (row I holds I + 1 tiles); every
    CTA holds a staging area of nt tiles after the largest rank's rows, and
    the 16-byte logdet slot."""
    nt = -(-T // 16)
    rows = [sum(I + 1 for I in range(r, nt, C)) for r in range(C)]
    return 16 + (max(rows) + nt) * 1024, rows


def test_no_cluster_at_the_blocked_widths_nor_beyond_the_limit():
    assert all(cluster_size(T) == 0 for T in range(1, MAX_T + 1))
    assert all(cluster_size(T) in (2, 4, 8) for T in range(MAX_T + 1, MAX_T_CLUSTER + 1))
    assert all(cluster_size(T) == 0 for T in range(MAX_T_CLUSTER + 1, 1200))


@pytest.mark.parametrize("C,widths", [(2, (321, 432)), (4, (433, 576)), (8, (577, 784))])
def test_each_cluster_size_takes_its_range_and_every_share_fits(C, widths):
    lo, hi = widths
    for T in range(MAX_T + 1, MAX_T_CLUSTER + 1):
        assert (cluster_size(T) == C) == (lo <= T <= hi), T
    for T in range(lo, hi + 1):
        assert _rank_bytes(T, C)[0] == cluster_smem_bytes(T, C) <= SMEM_BYTES, T
        if C > 2:  # the smallest size that fits
            assert cluster_smem_bytes(T, C // 2) > SMEM_BYTES, T
    # one width more does not fit at this size
    assert cluster_smem_bytes(hi + 16, C) > SMEM_BYTES


def test_tile_index_packs_each_ranks_rows():
    for C in (2, 4, 8):
        for nt in (21, 25, 36, 49):
            for r in range(C):
                want = 0
                for I in range(r, nt, C):
                    assert [chol_cuda._tile_index(I, J, C) for J in range(I + 1)] == \
                        list(range(want, want + I + 1))
                    want += I + 1
                assert _rank_bytes(16 * nt, C)[1][r] == want


def test_limits_repeat_the_kernel_source():
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxT") == MAX_T_CLUSTER
    assert const("kMaxBlockSmem") == SMEM_BYTES
    assert const("kSlotFloats") * 4 == 16
    assert "(I / C) * (I % C + 1) + C * ((I / C) * (I / C - 1) / 2) + J" in src


def _spd(b, t, seed, n_pad):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(b, t, t))
    K = A @ A.transpose(0, 2, 1) + t * np.eye(t)
    if n_pad:
        K[:, t - n_pad:, :] = 0.0
        K[:, :, t - n_pad:] = 0.0
        K[:, np.arange(t - n_pad, t), np.arange(t - n_pad, t)] = 1.0
    return K.astype(np.float32)


@pytest.mark.parametrize("t,n_pad", [(400, 0), (344, 21)])
def test_chol_inv_blocked_plain_at_cluster_widths_matches_f64(t, n_pad):
    K = _spd(2, t, seed=t, n_pad=n_pad)
    K64 = K.astype(np.float64)
    L = np.linalg.cholesky(K64)
    ref_Linv = np.stack([np.linalg.inv(x) for x in L])
    ref_ld = 2 * np.log(np.diagonal(L, axis1=1, axis2=2)).sum(1)
    Linv, ld = chol_inv_blocked_plain(torch.from_numpy(K))
    np.testing.assert_allclose(Linv.numpy(), ref_Linv, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(ld.numpy(), ref_ld, rtol=1e-5, atol=1e-4)
    assert float(torch.triu(Linv, 1).abs().max()) == 0.0
    Kinv = Linv.double().transpose(1, 2) @ Linv.double()
    np.testing.assert_allclose(Kinv.numpy(), np.linalg.inv(K64), rtol=1e-4, atol=1e-5)
    L64, ld64 = chol_inv_blocked_plain(torch.from_numpy(K64))
    np.testing.assert_allclose(L64.numpy(), ref_Linv, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ld64.numpy(), ref_ld, rtol=1e-12)


@pytest.mark.parametrize("t,n_pad", [(400, 0), (344, 21)])
def test_cholesky_blocked_plain_at_cluster_widths_matches_f64(t, n_pad):
    K = _spd(2, t, seed=t + 1, n_pad=n_pad)
    ref = np.linalg.cholesky(K.astype(np.float64))
    L = cholesky_blocked_plain(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(L, ref, rtol=2e-5, atol=2e-5)
    assert np.max(np.abs(np.triu(L, 1))) == 0.0
    L64 = cholesky_blocked_plain(torch.from_numpy(K.astype(np.float64))).numpy()
    np.testing.assert_allclose(L64, ref, rtol=1e-10, atol=1e-12)


def test_gp_features_of_objects_wider_than_one_block():
    """Objects with 355-395 usable points, at a compacted width of 400 (the
    XL server's, 2 CTAs per matrix on the card): the GP family through
    ``chol_inv`` (its plain version here; the cluster kernel on the card)
    against the JAX package's, at the gate of tests/test_torch_gp.py (per
    column >= 90% of lanes within rtol 2e-3, mean >= 97%)."""
    from mallorn_tpu.data.synthetic import generate_dataset
    from mallorn_tpu.features import multiband_gp as jgp
    from mallorn_tpu_torch.data.packing import from_numpy
    from mallorn_tpu_torch.features import multiband_gp as tgp

    packed, _, _ = generate_dataset(n_objects=3, seed=6, mean_obs_per_band=64.0)
    tp = from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset, device="cpu")
    counts = tgp._use_mask(tp).sum(1).numpy()
    _, widths = tgp.gp_schedule(counts, tp.all_time.shape[1], 8)
    assert counts.min() > MAX_T and widths == [400] and cluster_size(400) == 2
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
