"""Model/config schema shared by all architectures.

Copies of ``repro.configs.base``: ``ModelConfig`` with the same fields,
defaults and ``param_count``, so a configuration means the same model in
both packages, and the input shapes of the (arch × shape) cells
(``ShapeConfig``, ``SHAPES``) that ``launch.partitioning.plan`` lays out
on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | enc-dec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention flavour
    attn_bias: bool = False        # qwen2.5 QKV bias
    mla: bool = False              # minicpm3 multi-head latent attention
    mla_kv_rank: int = 256
    rope: str = "rope"             # rope | mrope(→rope for stub) | none
    window: int = 0                # sliding-window size (0 = full attention)
    is_encoder: bool = False
    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    moe_shared_expert: bool = False
    # ssm / hybrid / sparse
    # attn | mlstm | mlstm7+slstm | attn+mamba | sparse-band
    block_pattern: str = "attn"
    ssm_state: int = 16
    ssm_head_dim: Optional[int] = None
    band_window: int = 32          # sparse-band mixer: band width ...
    band_decay: float = 0.9        # ... and per-step decay
    # enc-dec / frontends
    encoder_layers: int = 0
    encoder_seq: int = 1500        # whisper audio frames after conv stub
    frontend: str = "none"         # none | audio | vision
    # numerics
    act: str = "silu"
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # §Perf iteration 4: "dots" (save matmul outputs) beat "full" remat on
    # every roofline term at equal peak memory — framework default.
    remat: str = "dots"            # none | full | dots
    # Fully unroll layer scans.  Compile-time O(L) instead of O(1); used by
    # the dry-run because XLA cost_analysis counts a while body ONCE — the
    # roofline needs the true per-step FLOPs/bytes/collectives.
    scan_unroll: bool = False
    # which input shapes apply (dry-run applicability, DESIGN.md §4)
    skip_shapes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_head_dim is None:
            object.__setattr__(self, "ssm_head_dim", self.head_dim)

    # ---- parameter counts (roofline MODEL_FLOPS = 6·N·D) ----
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
        if self.mla:
            r = self.mla_kv_rank
            attn = d * h * dh + d * r + 2 * r * h * dh + h * dh * d
        if self.n_experts:
            e_used = self.moe_top_k if active_only else self.n_experts
            ffn = e_used * 3 * d * f + d * self.n_experts  # router
            if self.moe_shared_expert:
                ffn += 3 * d * f
        else:
            ffn = 3 * d * f
        inner = h * (self.ssm_head_dim or dh)
        mlstm = 2 * d * inner + 3 * inner * inner + inner * d
        mamba = 2 * d * inner + 2 * inner * h * self.ssm_state + inner * d
        if self.block_pattern == "attn":
            per_layer = attn + ffn
        elif self.block_pattern == "mlstm7+slstm":
            per_layer = mlstm  # sLSTM blocks are similar order; counted same
        elif self.block_pattern == "attn+mamba":
            per_layer = attn + mamba + ffn
        elif self.block_pattern == "sparse-band":
            per_layer = 3 * d * inner + ffn   # wv, wz, w_down
        else:
            per_layer = attn + ffn
        total = self.n_layers * per_layer + 2 * v * d
        if self.encoder_layers:
            total += self.encoder_layers * (attn + 3 * d * f)
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
