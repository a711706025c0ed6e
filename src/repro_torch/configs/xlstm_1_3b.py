"""xlstm-1.3b — recurrent xLSTM stack [arXiv:2405.04517; unverified].

48L, d_model=2048, 4 heads, vocab=50304, d_ff=0 (blocks carry their own 2×
up-projection).  Pattern: groups of 7 mLSTM + 1 sLSTM
(``models.transformer.XLSTMGroup``); attention-free, so it runs none of
the flash kernel.  The mLSTM state is ``(H, dh, dh + 1)`` f32 a row, dh
512 here (``ssm_head_dim`` defaults to ``head_dim``).
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern="mlstm7+slstm",
    act="gelu",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=2, n_kv_heads=2,
    vocab_size=256, remat="none")
