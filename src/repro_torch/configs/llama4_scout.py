"""llama4-scout-17b-a16e — MoE decoder [hf:meta-llama/Llama-4-Scout; unverified].

48L, d_model=5120, 40H (GQA kv=8), expert d_ff=8192, vocab=202048,
MoE 16 experts top-1 + shared expert; chunked-local attention (window=8192)
following Llama-4's iRoPE local layers (a ring-buffer KV cache of 8192
slots).  The early-fusion frontend is out of scope for the text backbone.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    n_experts=16, moe_top_k=1, moe_shared_expert=True,
    window=8192,
    act="silu",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab_size=256, head_dim=16, n_experts=4, moe_top_k=1, window=32,
    remat="none")
