"""whisper-medium — enc-dec audio LM backbone [arXiv:2212.04356; unverified].

24L encoder + 24L decoder, d_model=1024, 16H (kv=16), d_ff=4096, vocab=51865.
The conv audio frontend is a STUB: callers give precomputed frame
embeddings ``enc_embeds (B, 1500, d_model)``, projected by
``frontend_proj``.  As in the reference, positions are RoPE in both
stacks; the decoder's blocks add cross-attention over the encoder's
output (no RoPE, no mask).
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="enc-dec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    encoder_layers=24, encoder_seq=1500, frontend="audio",
    act="gelu", skip_shapes=("long_500k",),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, encoder_seq=16, remat="none")
