"""Port vs JAX package: the leaf-wise segment histogram (K3).

``build_seg_histograms_plain`` (the CUDA kernel's plain PyTorch version,
which is what ``build_seg_histograms`` runs on a CPU tensor) against
``hist_pallas.build_histograms_pallas`` in Pallas interpret mode, lane by
lane, on the fixture of tests/test_hist_pallas.py::test_matches_segment_sum
(n 700, f 5, 4 nodes x 65 bins, some rows inactive) with 2 lanes, at that
test's bar: rtol 1e-5, atol 1e-4. The kernel's fixed-point arithmetic in
plain PyTorch (``build_seg_histograms_fixed``, bit for bit the kernel) is
within one float32 rounding of the float64 plain version. The kernel
itself is held against both on the card (the ``cuda`` case below, and
``chip_smoke.py``); run it there as
``pytest --noconftest -m cuda tests/test_torch_seg_hist.py``.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.ops.hist_cuda import (build_seg_histograms, build_seg_histograms_fixed,
                                             build_seg_histograms_plain)

torch.set_num_threads(2)

K, N, F, NBT, NODES = 2, 700, 5, 65, 4
N_SEG = NODES * NBT
RTOL, ATOL = 1e-5, 1e-4


def _fixture(seed=0):
    """bins [K, F, N] int16, segment bases [K, N] int32 (node * NBT, an
    inactive share at N_SEG and beyond), gh [K, N, 2] float32."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, NBT, size=(K, F, N)).astype(np.int16)
    node = rng.integers(0, NODES + 1, size=(K, N))
    seg_base = np.where(node < NODES, node * NBT, N_SEG + rng.integers(0, 10, size=(K, N)))
    gh = rng.normal(size=(K, N, 2)).astype(np.float32)
    return binned, seg_base.astype(np.int32), gh


def _oracle(binned, seg_base, gh):
    out = np.zeros((K, F, N_SEG, 2), np.float64)
    for k in range(K):
        for f in range(F):
            s = seg_base[k] + binned[k, f]
            act = seg_base[k] < N_SEG
            np.add.at(out[k, f], s[act], gh[k, act].astype(np.float64))
    return out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_plain_matches_pallas_interpret_and_f64():
    import jax.numpy as jnp

    from mallorn_tpu.ops.hist_pallas import build_histograms_pallas

    binned, seg_base, gh = _fixture()
    got = build_seg_histograms(*_t(binned, seg_base, gh), N_SEG).numpy()
    assert got.shape == (K, F, N_SEG, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, _oracle(binned, seg_base, gh), rtol=RTOL, atol=ATOL)
    for k in range(K):
        # the JAX package's own composition of the ids (gbdt.py:254-258)
        seg = np.where(seg_base[k] < N_SEG, seg_base[k] + binned[k].astype(np.int32), N_SEG)
        want = build_histograms_pallas(jnp.asarray(seg.astype(np.int32)), jnp.asarray(gh[k]),
                                       N_SEG, row_chunk=256, interpret=True)
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=RTOL, atol=ATOL)


def test_fixed_point_version_is_the_exact_sum_rounded_once():
    binned, seg_base, gh = _fixture(1)
    got = build_seg_histograms_fixed(*_t(binned, seg_base, gh), N_SEG)
    f64 = build_seg_histograms_plain(*_t(binned, seg_base, gh.astype(np.float64)), N_SEG)
    assert got.dtype == torch.float32 and f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), _oracle(binned, seg_base, gh), rtol=1e-12,
                               atol=1e-12)
    # within one float32 ulp of the exact (float64) sum
    want = f64.numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(got.numpy().astype(np.float64) - want) <= ulp).all()
    gh[1, 3, 1] = np.nan
    got = build_seg_histograms_fixed(*_t(binned, seg_base, gh), N_SEG).numpy()
    assert np.isnan(got[1]).all() and np.isfinite(got[0]).all()


def test_root_and_pair_shapes_and_cpu_counts_no_launch():
    """The leaf-wise fit's two calls: the root (one node, every row active)
    and a pair of children (2 nodes, most rows inactive)."""
    binned, _, gh = _fixture(2)
    hist_cuda.reset_launches()
    root = build_seg_histograms(*_t(binned, np.zeros((K, N), np.int32), gh), NBT).numpy()
    np.testing.assert_allclose(root.sum(axis=2), np.broadcast_to(gh.sum(1)[:, None], (K, F, 2)),
                               rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(3)
    pair = np.where(rng.random((K, N)) < 0.7, 2 * NBT, rng.integers(0, 2, (K, N)) * NBT)
    got = build_seg_histograms(*_t(binned, pair.astype(np.int32), gh), 2 * NBT).numpy()
    act = pair < 2 * NBT
    for k in range(K):
        np.testing.assert_allclose(got[k].sum(axis=1), np.broadcast_to(
            gh[k, act[k]].sum(0), (F, 2)), rtol=1e-4, atol=1e-4)
    assert hist_cuda.seg_launches == 0
    with pytest.raises(ValueError):
        build_seg_histograms(*(torch.empty(s, device="meta") for s in ((K, F, N), (K, N), (K, N, 2))),
                             NBT)


@pytest.mark.cuda
def test_kernel_matches_plain_and_repeats_bit_for_bit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    binned, seg_base, gh = (t.cuda() for t in _t(*_fixture(4)))
    hist_cuda.reset_launches()
    a = build_seg_histograms(binned, seg_base, gh, N_SEG)
    b = build_seg_histograms(binned, seg_base, gh, N_SEG)
    assert hist_cuda.seg_launches == 2
    assert torch.equal(a, b)
    assert torch.equal(a, build_seg_histograms_fixed(binned, seg_base, gh, N_SEG))
    want = build_seg_histograms_plain(binned, seg_base, gh.double(), N_SEG)
    np.testing.assert_allclose(a.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)
