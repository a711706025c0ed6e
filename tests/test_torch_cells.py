"""Cells shared by the port's parity tests (``test_torch_*.py``).

The six sparsity patterns and the small Algorithm-1 knobs of
``tests/test_parity_matrix.py``, built once with the JAX package's
generators and carried into the port's ``CSR`` (same arrays), so both
packages see the same input.
"""
import numpy as np
import pytest

from repro.core.sparse.formats import CSR as RefCSR
from repro.core.sparse.random import (banded_spd, block_diag_noise,
                                      hub_powerlaw, powerlaw_graph)
from repro_torch.core.sparse.formats import CSR as PortCSR

KNOBS = dict(p=2, cache_size=30_000.0, ct_size=32)
N = 64


def _empty_rows(n: int, seed: int) -> RefCSR:
    dense = banded_spd(n, 3, seed=seed).to_dense()
    dense[::2, :] = 0.0
    return RefCSR.from_dense(dense)


PATTERNS = {
    "banded": lambda n, seed: banded_spd(n, 4, seed=seed),
    "blockdiag": lambda n, seed: block_diag_noise(n, block=32, seed=seed),
    "powerlaw": lambda n, seed: powerlaw_graph(n, 5, seed=seed),
    "empty-rows": _empty_rows,
    "single-hub-row": lambda n, seed: hub_powerlaw(n, 4, seed=seed),
    "1x1": lambda n, seed: RefCSR.from_dense(np.ones((1, 1))),
}


def as_port(a: RefCSR) -> PortCSR:
    return PortCSR(a.n_rows, a.n_cols, a.indptr, a.indices, a.data)


def pattern_pair(name: str, seed: int = 1):
    """(reference CSR, port CSR) of one pattern."""
    a = PATTERNS[name](N, seed)
    return a, as_port(a)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_cells_are_the_parity_matrix_patterns(name):
    """The shared cells are ``tests/test_parity_matrix.py``'s patterns, and
    the port's CSR carries them with the same content digest."""
    from test_parity_matrix import PATTERNS as MATRIX
    from repro.core.sparse.formats import csr_content_digest as ref_digest
    from repro_torch.core.sparse.formats import csr_content_digest
    ref, port = pattern_pair(name)
    want = MATRIX[name](N, 1)
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(ref, field),
                                      getattr(want, field))
    assert csr_content_digest(port) == ref_digest(want)
