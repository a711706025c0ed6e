"""minicpm3-4b — dense decoder with MLA [hf:openbmb/MiniCPM3-4B; hf].

62L, d_model=2560, 40H, d_ff=6400, vocab=73448.  Multi-head latent attention:
the KV cache stores a rank-256 latent; K/V are re-expanded per use
(``models.layers.mla_attention``).
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    mla=True, mla_kv_rank=256,
    act="silu", skip_shapes=("long_500k",),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, mla_kv_rank=32, remat="none")
