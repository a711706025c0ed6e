"""PyTorch and CUDA port of the tile-fusion system, beside the JAX package
``repro`` (the reference it is tested against).

It imports ``torch`` and ``numpy``, never ``jax`` or ``repro``.  The public
seam is ``repro_torch.core.tilefusion.api.tile_fused_matmul``; the GCN
model sits on it (``repro_torch.models.gcn``).
"""
