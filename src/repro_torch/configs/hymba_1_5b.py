"""hymba-1.5b — hybrid parallel attention+mamba heads [arXiv:2411.13676; hf].

32L, d_model=1600, 25H (GQA kv=5), d_ff=5504, ssm_state=16.  Each block runs
sliding-window attention (window=1024) and mamba heads in parallel on the
same input, averaged (``models.transformer.HybridBlock``); the window gives
a ring-buffer KV cache of 1024 slots beside the mamba state.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    block_pattern="attn+mamba", ssm_state=16, window=1024,
    act="silu",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, window=32, remat="none")
