"""The tiled Cholesky (K2 and K6 for T > MAX_T_CLUSTER) on the CPU: its
plan against the kernel source, its algorithm's plain twins at nb = 64,
and the GP family at a width only it serves.

- ``chol_cuda.tiled_plan`` / ``tiled_scratch_floats`` against the
  constants and the launch loop of ``csrc/chol_tiled.cu``.
- ``chol_inv_blocked_plain`` and ``cholesky_blocked_plain`` at nb = 64
  (the tiled kernel's panels; it factors each diagonal tile at nb = 16,
  which changes only the order inside that tile) at T = 832 (13 panels)
  with identity-padded rows, against the float64 plain versions at the
  bars of ``tests/test_torch_chol.py``; a NaN from a non-SPD matrix stays
  in that matrix.
- The 2D-GP family on objects of 785-832 usable points (compacted width
  832) against the JAX package, at the gate of ``tests/test_torch_gp.py``.

The card runs the kernel itself against the plain versions
(``tests/test_torch_chol.py``'s ``cuda`` cases, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mallorn_tpu_torch.ops import chol_cuda
from mallorn_tpu_torch.ops.chol_cuda import (MAX_T_CLUSTER, SMEM_BYTES, TILED_NB,
                                             chol_inv_blocked_plain, chol_inv_plain,
                                             cholesky_blocked_plain, cholesky_plain, tiled_plan,
                                             tiled_scratch_floats)

torch.set_num_threads(2)

CU = Path(chol_cuda.__file__).resolve().parents[1] / "csrc" / "chol_tiled.cu"


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _launch_count(T: int, inverse: bool) -> int:
    """``launch_tiled``'s loops of the .cu, counted: pack, per panel the
    diagonal and (but for the last) the panel and the update, per block
    column but the last W and the sum (K2), unpack."""
    nt = -(-T // TILED_NB)
    n = 1
    for k in range(nt):
        n += 1
        if nt - 1 - k == 0:
            break
        n += 2
    if inverse:
        n += sum(2 for _ in range(nt - 2, -1, -1))
    return n + 1


def test_plan_repeats_the_kernel_source():
    src = CU.read_text()
    assert _const(src, "kPanel") == TILED_NB == 64
    # seven kernels, each launched at one site of launch_tiled
    assert src.count("<<<") == 7
    assert len(re.findall(r"if \(!launched\(\)\) return", src)) == 7
    # rows of a staged tile stay 16-byte aligned; the inverse's two stages fit
    assert "constexpr int kLd = kPanel + 4;" in src
    ld = TILED_NB + 4
    assert ld % 4 == 0 and (ld * 4) % 128 != 0
    assert 4 * TILED_NB * ld * 4 <= SMEM_BYTES
    assert "scratch + static_cast<size_t>(B) * Tp * Tp" in src


@pytest.mark.parametrize("T,nt,k2,k6", [(785, 13, 63, 39), (800, 13, 63, 39), (832, 13, 63, 39),
                                        (1000, 16, 78, 48), (1024, 16, 78, 48),
                                        (1025, 17, 83, 51)])
def test_plan_counts_panels_and_launches(T, nt, k2, k6):
    assert tiled_plan(T) == (TILED_NB, nt, k2) and tiled_plan(T, inverse=False)[2] == k6
    assert _launch_count(T, True) == k2 and _launch_count(T, False) == k6
    Tp = nt * TILED_NB
    assert tiled_scratch_floats(3, T) == 3 * Tp * (Tp + TILED_NB)


def test_every_width_past_the_cluster_kernel_has_a_plan():
    for T in range(MAX_T_CLUSTER + 1, 2049):
        nb, nt, n = tiled_plan(T)
        assert nb * (nt - 1) < T <= nb * nt
        assert n == _launch_count(T, True) and tiled_plan(T, False)[2] == _launch_count(T, False)


def _spd(b, t, seed, n_pad):
    """SPD batch (A A^T / t + I); matrix j's last n_pad[j] rows and columns
    identity-padded."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(b, t, t))
    K = A @ A.transpose(0, 2, 1) / t + np.eye(t)
    for j, n in enumerate(n_pad):
        if n:
            K[j, t - n:, :] = 0.0
            K[j, :, t - n:] = 0.0
            K[j, np.arange(t - n, t), np.arange(t - n, t)] = 1.0
    return torch.from_numpy(K.astype(np.float32))


def test_chol_inv_blocked_plain_at_nb64_matches_f64():
    K = _spd(3, 832, seed=832, n_pad=(0, 37, 100))
    Linv, ld = chol_inv_blocked_plain(K, 64)
    ref_Linv, ref_ld = chol_inv_plain(K.double())
    np.testing.assert_allclose(Linv.numpy(), ref_Linv.numpy(), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(ld.numpy(), ref_ld.numpy(), rtol=1e-5, atol=1e-4)
    assert float(torch.triu(Linv, 1).abs().max()) == 0.0
    Kinv = Linv.double().transpose(1, 2) @ Linv.double()
    np.testing.assert_allclose(Kinv.numpy(), np.linalg.inv(K.double().numpy()),
                               rtol=1e-4, atol=1e-5)
    L64, ld64 = chol_inv_blocked_plain(K.double(), 64)
    np.testing.assert_allclose(L64.numpy(), ref_Linv.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ld64.numpy(), ref_ld.numpy(), rtol=1e-12)


def test_cholesky_blocked_plain_at_nb64_matches_f64():
    K = _spd(3, 832, seed=833, n_pad=(5, 0, 64))
    ref = cholesky_plain(K.double())
    L = cholesky_blocked_plain(K, 64)
    np.testing.assert_allclose(L.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    np.testing.assert_allclose(cholesky_blocked_plain(K.double(), 64).numpy(), ref.numpy(),
                               rtol=1e-10, atol=1e-12)


def test_nan_stays_in_its_matrix_at_nb64():
    """A non-positive pivot in the eighth panel of matrix 1 gives NaN there
    only; matrix 2's upper triangle (NaN) is never read."""
    K = _spd(3, 832, seed=834, n_pad=(0, 0, 20))
    K[1, 470, 470] = -1.0
    K[2][tuple(torch.triu_indices(832, 832, 1))] = float("nan")
    Linv, ld = chol_inv_blocked_plain(K, 64)
    assert torch.isnan(ld).tolist() == [False, True, False]
    assert torch.isnan(Linv).flatten(1).any(1).tolist() == [False, True, False]
    L = cholesky_blocked_plain(K, 64)
    assert torch.isnan(L).flatten(1).any(1).tolist() == [False, True, False]
    ref_Linv, _ = chol_inv_plain(torch.tril(K[[0, 2]]).double())
    np.testing.assert_allclose(Linv[[0, 2]].numpy(), ref_Linv.numpy(), rtol=5e-5, atol=5e-5)


def test_gp_features_of_objects_wider_than_the_cluster_kernel():
    """Objects with 818 and 828 usable points, at a compacted width of 832
    (the tiled kernel on the card; 13 panels): the GP family through
    ``chol_inv`` (its plain version here) against the JAX package's, at the
    gate of tests/test_torch_gp.py (per column >= 90% of lanes within rtol
    2e-3, mean >= 97%)."""
    from mallorn_tpu.data.synthetic import generate_dataset
    from mallorn_tpu.features import multiband_gp as jgp
    from mallorn_tpu_torch.data.packing import from_numpy
    from mallorn_tpu_torch.features import multiband_gp as tgp

    packed, _, _ = generate_dataset(n_objects=2, seed=3, mean_obs_per_band=138.0)
    tp = from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset, device="cpu")
    counts = tgp._use_mask(tp).sum(1).numpy()
    _, widths = tgp.gp_schedule(counts, tp.all_time.shape[1], 8)
    assert counts.min() > MAX_T_CLUSTER and widths == [832] and tiled_plan(832)[1] == 13
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
