"""qwen2.5-3b — dense decoder, GQA + QKV bias [hf:Qwen/Qwen2.5; hf].

36L, d_model=2048, 16H (GQA kv=2), d_ff=11008, vocab=151936.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab_size=151936, head_dim=128,
    attn_bias=True, act="silu", skip_shapes=("long_500k",),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, remat="none")
