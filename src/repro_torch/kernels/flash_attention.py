"""Flash attention with causal and sliding-window masks and grouped K/V
heads.

The hand-written CUDA kernel (``csrc/flash_attention.cu``) that replaces
the TPU kernel ``repro.kernels.flash_attention._flash_attention``.  One
block per (batch, head, q block) walks the kv blocks that the masks leave
open, with the online-softmax state in registers.  bf16 with a head dim of
64 or 128 (every model the repo configures) runs on Hopper's ``wgmma``
with K/V tiles arriving by TMA through a ring in shared memory
(``flash_attention_wgmma_kernel``); other bf16 head dims up to 128 run on
``mma.sync``, f32 and wider heads on the CUDA cores.  Query head ``h``
reads K/V head ``h // (H // Hkv)`` in place, so grouped-query attention
needs no repeated copy of K and V.  The kernel masks the ragged
``Sq``/``Sk`` edges itself, so any length runs (Whisper's 1500 frames fit
no block), and any head dim up to 256.

On ``meta`` tensors (``launch.dryrun``) the wrapper launches nothing: it
returns ``torch.empty_like(q)`` and charges the dry run's counter with the
kernel's own work (``work``), as it does beside a launch and beside the
plain version that stands for the kernel on the CPU.
"""
from __future__ import annotations

import functools

import torch

from . import config, ref

#: widest head dim the kernel takes (its shared-memory tiles)
MAX_HEAD_DIM = 256
#: the device function of each path the launcher reports
PATHS = {0: "flash_attention_wgmma_kernel", 1: "flash_attention_mma_kernel",
         2: "flash_attention_kernel", -1: "none"}


def last_path() -> str:
    """The device function that the last launch on the card ran (the
    launcher records its dispatch): ``"flash_attention_wgmma_kernel"`` for
    bf16 at head dim 64 or 128 with 16-byte aligned rows,
    ``"flash_attention_mma_kernel"`` for other bf16 head dims up to 128,
    ``"flash_attention_kernel"`` (CUDA cores) for f32 and wider heads,
    ``"none"`` before any launch or for an empty one."""
    return PATHS[config.kernel_library("cuda").flash_attention_last_path()]


@functools.lru_cache(maxsize=64)
def kept_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs of one (batch, head) that the masks keep:
    query ``i`` sees key ``j`` where ``j <= i`` (``causal``) and ``i - j <
    window`` (``window > 0``), as ``ref.attention_mask`` has it."""
    if not causal and window <= 0:
        return sq * sk
    total = 0
    for i in range(sq):
        hi = min(sk - 1, i) if causal else sk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def work(q, k, v, *, causal: bool, window: int) -> tuple:
    """``(flops, bytes)`` of one call: ``4 · D`` FLOPs a kept pair (the
    score and the output product, 2 · D each) over every (batch, head), and
    the compulsory bytes, q, k and v read once and the output written
    once.  Pairs, not the kernel's tiles, so a tile size does not change
    the count."""
    b, h, sq, d = q.shape
    flops = 4 * d * b * h * kept_pairs(sq, k.shape[2], causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return flops, nbytes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: float | None = None,
                    impl: str = "cuda") -> torch.Tensor:
    """q ``(B, H, Sq, D)``; k, v ``(B, Hkv, Sk, D)`` with ``H % Hkv == 0``
    → ``(B, H, Sq, D)`` in q's dtype (f32 or bf16), f32 softmax state.
    Query head ``h`` attends with K/V head ``h // (H // Hkv)``.

    CPU tensors, or ``impl="torch"``, take the plain PyTorch version; CUDA
    tensors launch the kernel or raise; ``meta`` tensors give
    ``torch.empty_like(q)`` and launch nothing.  The kernel has no
    backward: under grad mode, for an input that requires grad, the kernel
    arm raises ``NotImplementedError`` (``config.refuse_grad``).  In a dry
    run the kernel arm (``impl="cuda"``) charges ``work`` to the counter;
    ``impl="torch"`` is counted op by op."""
    plain = config.plain_arm(q, impl)
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         f"(B, H, Sq, D) and (B, Hkv, Sk, D) with H % Hkv "
                         f"== 0")
    if config.counter is not None and impl == "cuda":
        with config.kernel_work(*work(q, k, v, causal=causal,
                                      window=window)):
            return _run(q, k, v, plain, causal, window, sm_scale)
    return _run(q, k, v, plain, causal, window, sm_scale)


def _run(q, k, v, plain, causal, window, sm_scale):
    if plain:
        return ref.attention(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale)
    config.refuse_grad("flash_attention", q, k, v)
    if q.is_meta:
        return torch.empty_like(q)
    lib = config.kernel_library(q.device)
    device = config.check_launch({}, dict(q=q, k=k, v=v))
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
        hkv, sq, sk, d, float(sm_scale), int(causal), int(window),
        config.DTYPE_CODES[q.dtype], config.stream_of(device))
    config.raise_on_error(err, "flash_attention")
    flash_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
