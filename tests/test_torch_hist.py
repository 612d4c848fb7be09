"""Port vs JAX package: the depthwise level histogram (K1).

``build_histograms_plain`` (the CUDA kernel's plain PyTorch version, which
is what ``build_histograms`` runs on a CPU tensor) against
``hist_pallas.build_histograms_fullhot`` in Pallas interpret mode, fold by
fold, and against a float64 numpy oracle, at the JAX package's bar for
its histogram kernels (tests/test_hist_pallas.py): rtol 1e-5, atol 1e-4.
The fixture is that of ``test_fullhot_matches_binlane_interpret`` (F=37,
N=500, 257 bins, 1/2/8 nodes, inactive rows), with a fold axis of 3. The
CUDA kernel itself is held against the plain version on the card (the
``cuda`` case below, and ``chip_smoke.py``). The machine with the card has
no JAX, so this file imports the JAX package inside the test that uses it
and runs there as ``pytest --noconftest -m cuda tests/test_torch_hist.py``.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.ops.hist_cuda import (build_histograms, build_histograms_fixed,
                                             build_histograms_plain)

torch.set_num_threads(2)

K, F, N, NBT = 3, 37, 500, 257
RTOL, ATOL = 1e-5, 1e-4


def _fixture(n_nodes, seed=5):
    """binned [K, F, N], node ids [K, N] (n_nodes = inactive), gh [K, N, 2]."""
    rng = np.random.default_rng(seed + n_nodes)
    binned = rng.integers(0, NBT, size=(K, F, N)).astype(np.int16)
    node_q = rng.integers(0, n_nodes + 1, size=(K, N)).astype(np.int32)
    g = rng.normal(size=(K, N)).astype(np.float32)
    h = np.abs(g) * 0.25 + 0.01
    return binned, node_q, np.stack([g, h], -1).astype(np.float32)


def _oracle(binned, node_q, gh, n_nodes):
    out = np.zeros((K, F, n_nodes, NBT, 2), np.float64)
    for k in range(K):
        act = node_q[k] < n_nodes
        for f in range(F):
            np.add.at(out[k, f], (node_q[k, act], binned[k, f, act]),
                      gh[k, act].astype(np.float64))
    return out


@pytest.mark.parametrize("n_nodes", [1, 2, 8])
def test_plain_matches_fullhot_interpret_and_f64(n_nodes):
    import jax.numpy as jnp

    from mallorn_tpu.ops import hist_pallas as hp

    binned, node_q, gh = _fixture(n_nodes)
    got = build_histograms(torch.from_numpy(binned), torch.from_numpy(node_q),
                           torch.from_numpy(gh), n_nodes, NBT).numpy()
    assert got.shape == (K, F, n_nodes, NBT, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, _oracle(binned, node_q, gh, n_nodes),
                               rtol=RTOL, atol=ATOL)
    for k in range(K):
        b = jnp.asarray(binned[k].astype(np.int32))
        want = hp.build_histograms_fullhot(
            hp.precompute_fullhot_i8(b, NBT), jnp.asarray(node_q[k]),
            hp.split_gh_digits(jnp.asarray(gh[k, :, 0]), jnp.asarray(gh[k, :, 1])),
            n_nodes, NBT, row_chunk=256, interpret=True)
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=RTOL, atol=ATOL)


def test_plain_float64_is_the_oracle():
    binned, node_q, gh = _fixture(2)
    got = build_histograms_plain(torch.from_numpy(binned), torch.from_numpy(node_q),
                                 torch.from_numpy(gh.astype(np.float64)), 2, NBT)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _oracle(binned, node_q, gh, 2),
                               rtol=1e-12, atol=1e-12)


def test_fixed_point_version_is_the_exact_sum_rounded_once():
    """The kernel's int64 fixed-point arithmetic, in plain PyTorch: within
    one float32 rounding of the float64 oracle, and NaN in every cell of a
    fold whose (g, h) is not finite."""
    binned, node_q, gh = _fixture(8)
    got = build_histograms_fixed(torch.from_numpy(binned), torch.from_numpy(node_q),
                                 torch.from_numpy(gh), 8, NBT).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _oracle(binned, node_q, gh, 8), rtol=1.2e-7, atol=1e-12)
    gh[1, 7, 0] = np.inf
    got = build_histograms_fixed(torch.from_numpy(binned), torch.from_numpy(node_q),
                                 torch.from_numpy(gh), 8, NBT).numpy()
    assert np.isnan(got[1]).all() and np.isfinite(got[[0, 2]]).all()


def test_inactive_rows_and_out_of_range_bins_count_nowhere():
    binned, node_q, gh = _fixture(4)
    node_q[:, ::3] = 4  # inactive
    node_q[:, 1::7] = -1  # outside [0, k_nodes): inactive too
    binned[0, :, 5] = NBT  # a bin outside [0, n_bins_tot): skipped
    got = build_histograms(torch.from_numpy(binned), torch.from_numpy(node_q),
                           torch.from_numpy(gh), 4, NBT).numpy()
    act = (node_q >= 0) & (node_q < 4)
    act0 = act[0].copy()
    act0[5] = False
    for k, a in enumerate((act0, act[1], act[2])):
        np.testing.assert_allclose(got[k].sum(axis=(1, 2)),
                                   np.broadcast_to(gh[k, a].sum(0), (F, 2)),
                                   rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    binned, node_q, gh = _fixture(1)
    hist_cuda.reset_launches()
    build_histograms(torch.from_numpy(binned), torch.from_numpy(node_q),
                     torch.from_numpy(gh), 1, NBT)
    assert hist_cuda.launches == 0


@pytest.mark.cuda
def test_kernel_matches_plain_and_repeats_bit_for_bit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    for n_nodes in (1, 2, 8):
        binned, node_q, gh = (torch.from_numpy(a).cuda() for a in _fixture(n_nodes))
        hist_cuda.reset_launches()
        a = build_histograms(binned, node_q, gh, n_nodes, NBT)
        b = build_histograms(binned, node_q, gh, n_nodes, NBT)
        assert hist_cuda.launches == 2
        assert torch.equal(a, b)
        assert torch.equal(a, build_histograms_fixed(binned, node_q, gh, n_nodes, NBT))
        want = build_histograms_plain(binned, node_q, gh.double(), n_nodes, NBT)
        np.testing.assert_allclose(a.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)
