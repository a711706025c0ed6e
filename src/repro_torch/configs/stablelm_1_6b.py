"""stablelm-1.6b — dense decoder [hf:stabilityai/stablelm-2-1_6b; unverified].

24L, d_model=2048, 32H (kv=32), d_ff=5632, vocab=100352.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab_size=100352,
    act="silu", skip_shapes=("long_500k",),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, remat="none")
