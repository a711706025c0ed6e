"""The ``sparse-band`` token mixer: the banded-decay recurrence unrolled on
the time axis and run as the paper's GeMM-SpMM.

Twin of the band parts of ``repro.models.ssm`` (``decay_band_csr``,
``_BAND_SPEC``, ``band_mix_init``, ``band_mix_apply``).  The mix is
``A · (X · Wv)`` with the band ``A`` as the sparse operand, one
``tile_fused_matmul`` call a batch row, so the schedule comes from the
content-keyed cache and the backward runs the transposed fused products
(``api``'s autograd Functions).  The recurrences of that module
(``chunked_linear_recurrence``, mamba, mLSTM, sLSTM) are not ported yet
(ROADMAP Queue 1).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.sparse.formats import CSR
from ..core.tilefusion import api
from ..core.tilefusion.spec import FusionSpec
from .layers import init_weight


@functools.lru_cache(maxsize=8)
def decay_band_csr(seq: int, window: int, decay: float = 0.9) -> CSR:
    """The fixed-decay linear recurrence unrolled on the time axis:
    ``A[i, j] = (1 - decay) * decay**(i - j)`` for
    ``max(0, i - window + 1) <= j <= i``, a lower-triangular band whose SpMM
    against values is the windowed recurrence ``o_i = (1-a) Σ_j a^{i-j}
    v_j``.  The ``(1 - decay)`` scale keeps every row sum below 1.

    Memoized, as the reference's: the same object comes back for the same
    arguments, so the content-keyed schedule cache hits on every layer and
    step without hashing the matrix again."""
    if not (0.0 < decay < 1.0):
        raise ValueError(f"decay must be in (0, 1), got {decay}")
    w = max(1, min(int(window), seq))
    counts = np.minimum(np.arange(seq) + 1, w)
    indptr = np.zeros(seq + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    indices = np.concatenate(
        [np.arange(i - c + 1, i + 1) for i, c in enumerate(counts)]
    ).astype(np.int32)
    rows = np.repeat(np.arange(seq), counts)
    data = ((1.0 - decay) * decay ** (rows - indices)).astype(np.float32)
    return CSR(seq, seq, indptr, indices, data)


#: one spec drives every band-mixer dispatch; small ``p`` because the band
#: is narrow and perfectly local
_BAND_SPEC = FusionSpec(p=4, cache_size=600_000.0, ct_size=256)


def band_mix_init(gen, cfg, dtype, device=None) -> dict:
    """Value and gate projections ``(d, inner)`` and the down projection
    ``(inner, d)``, ``inner = n_heads · ssm_head_dim``."""
    d = cfg.d_model
    inner = cfg.n_heads * cfg.ssm_head_dim
    return {
        "wv": init_weight(gen, (d, inner), dtype=dtype, device=device),
        "wz": init_weight(gen, (d, inner), dtype=dtype, device=device),
        "w_down": init_weight(gen, (inner, d), dtype=dtype, device=device),
    }


def band_mix_apply(p, cfg, x, a: CSR, *, backend: str = "cuda",
                   spec: FusionSpec | None = None) -> torch.Tensor:
    """x ``(B, S, d)`` → ``(B, S, d)``; ``a = decay_band_csr(S, ...)``.

    ``(A · (x_i · Wv) ⊙ silu(x_i · Wz)) · W_down`` for each batch row
    ``x_i``, the band product in f32 (``x`` and ``Wv`` cast up, the mix cast
    back to ``x``'s dtype), as the reference computes it.

    ``backend="cuda"`` is the twin of the reference's ``"xla"``, which
    forces its fused executor: Eq 3 would pick the unfused arm at the
    band's shapes (fused ratio 0.27, traffic saving 0.02 at stablelm's
    widths), and the mixer runs the fused GeMM-SpMM kernel all the same.
    On CPU tensors it runs the kernel arm's glue with the kernels' plain
    versions; ``"torch"`` is the plain fused executor on any device, and
    ``"auto"`` / ``"unfused"`` take those arms of ``tile_fused_matmul``."""
    spec = _BAND_SPEC if spec is None else spec
    wv = p["wv"].float()
    mixed = torch.stack([
        api.tile_fused_matmul(a, x[i].float(), wv, backend=backend,
                              spec=spec)
        for i in range(x.shape[0])])
    z = x @ p["wz"]
    return (mixed.to(x.dtype) * F.silu(z)) @ p["w_down"]
