"""minitron-8b — pruned nemotron dense decoder [arXiv:2407.14679; hf].

32L, d_model=4096, 32H (GQA kv=8), d_ff=16384, vocab=256000.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab_size=256000, head_dim=128,
    act="gelu", skip_shapes=("long_500k",),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, remat="none")
