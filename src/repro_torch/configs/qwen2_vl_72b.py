"""qwen2-vl-72b — VLM text backbone [arXiv:2409.12191; hf].

80L, d_model=8192, 64H (GQA kv=8), d_ff=29568, vocab=152064.
The vision frontend (dynamic resolution, patch merger) is a STUB: callers
give precomputed patch embeddings ``embeds (B, S, d_model)``, projected by
``frontend_proj``, or tokens.  M-RoPE degenerates to 1-D RoPE for the
text-only backbone, as in the reference's ``apply_rope``.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    rope="mrope", frontend="vision",
    act="silu", skip_shapes=("long_500k",),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, remat="none")
