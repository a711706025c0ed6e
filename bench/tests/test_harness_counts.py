"""The work counts of ``bench.work`` against hand counts: every product
of a 64-node graph's GCN and of a tiny band LM counted one multiply-add
at a time, and every operand's bytes counted from its arrays."""
import itertools

import numpy as np
import pytest

from bench import frozen, work

N = 64


def hand_gemm_spmm(indptr, indices, b, c, backward=False, need_db=True):
    """Operations and compulsory bytes of ``D = A·(B·C)`` (or its
    backward) by counting each multiply-add of each product."""
    n = len(indptr) - 1
    dense = sum(1 for _ in itertools.product(range(n), range(b), range(c)))
    sparse = lambda width: sum(  # noqa: E731
        (indptr[i + 1] - indptr[i]) * width for i in range(n))
    csr = indptr.size * 4 + indices.size * 4 + indices.size * 4
    if not backward:
        return 2 * (dense + sparse(c)), csr + 4 * (n * b + b * c + n * c)
    flops = 2 * (sparse(c) + dense)                  # dC = Bᵀ·(Aᵀ·Ḋ)
    nbytes = csr + 4 * (n * c + n * b + b * c)      # A, Ḋ, B; dC
    if need_db:
        flops += 2 * (dense + sparse(b))            # dB = Aᵀ·(Ḋ·Cᵀ)
        nbytes += 4 * (b * c + n * b)               # C; dB
    return flops, nbytes


@pytest.mark.parametrize("pattern", ["banded", "powerlaw"])
def test_gcn_calls_match_hand_counts(pattern):
    indptr, indices = (frozen.banded_pattern(N, 4, seed=3)
                       if pattern == "banded"
                       else frozen.powerlaw_pattern(N, 5, seed=3))
    cfg = {"n_nodes": N, "in_dim": 8, "hidden_dim": 16, "out_dim": 4,
           "n_layers": 3}
    dims = [8, 16, 16, 4]
    calls = work.gcn_calls(cfg, int(indices.size))
    assert len(calls) == 6
    for i, (b, c) in enumerate(zip(dims[:-1], dims[1:])):
        f, nb = hand_gemm_spmm(indptr, indices, b, c)
        assert (calls[i].flops, calls[i].bytes) == (f, nb)
        f, nb = hand_gemm_spmm(indptr, indices, b, c, backward=True,
                               need_db=i > 0)
        assert (calls[3 + i].flops, calls[3 + i].bytes) == (f, nb)
    assert work.gcn_step_flops(cfg, int(indices.size)) == \
        sum(w.flops for w in calls)


def test_band_nnz_counts_the_band():
    for seq, window in [(64, 8), (10, 32), (64, 1), (33, 33)]:
        want = sum(1 for i in range(seq) for j in range(seq)
                   if 0 <= i - j < window)
        assert work.band_nnz(seq, window) == want


def test_lm_step_flops_by_hand():
    cfg = {"n_layers": 2, "d_model": 8, "n_heads": 2, "d_ff": 12,
           "vocab_size": 20, "band_window": 4}
    batch, seq, d, inner, f, v = 3, 16, 8, 8, 12, 20
    tokens = batch * seq
    mm = lambda m, k, n: 2 * m * k * n  # noqa: E731
    layer = (mm(tokens, d, inner) * 2 + mm(tokens, inner, d)
             + mm(tokens, d, f) * 2 + mm(tokens, f, d)
             + batch * 2 * work.band_nnz(seq, 4) * inner)
    forward = 2 * layer + mm(tokens, d, v)
    assert work.lm_step_flops(cfg, batch, seq) == 3 * forward
    calls = work.lm_band_calls(cfg, batch, seq)
    assert len(calls) == 2 * 2 * batch
    nnz = work.band_nnz(seq, 4)
    ptr = np.zeros(seq + 1, np.int32)
    ptr[1:] = np.cumsum([min(i + 1, 4) for i in range(seq)])
    f_fwd, b_fwd = hand_gemm_spmm(ptr, np.zeros(nnz, np.int32), d, inner)
    assert (calls[0].flops, calls[0].bytes) == (f_fwd, b_fwd)


def test_least_time_is_the_larger_bound():
    w = work.Work(flops=495e12, bytes=0.0)
    assert w.least_s(work.PEAKS["tf32_flops"]) == pytest.approx(1.0)
    w = work.Work(flops=0.0, bytes=3.35e12)
    assert w.least_s(work.PEAKS["tf32_flops"]) == pytest.approx(1.0)
    assert work.PEAKS["bf16_flops"] == 989e12
    assert work.PEAKS["hbm_bytes_per_s"] == 3.35e12
