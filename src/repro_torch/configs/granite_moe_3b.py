"""granite-moe-3b-a800m — MoE decoder [hf:ibm-granite; hf].

32L, d_model=1536, 24H (GQA kv=8), expert d_ff=512, vocab=49155,
MoE 40 experts top-8 (the assignment header also says "32 experts top-8";
the explicit shape spec is followed: 40e top-8).

Tile-fusion flagship arch: expert dispatch is the sparse A whose tokens
form fused tiles (``models.layers.moe_apply``).
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    n_experts=40, moe_top_k=8,
    act="silu", skip_shapes=("long_500k",),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, n_experts=4, moe_top_k=2, remat="none")
