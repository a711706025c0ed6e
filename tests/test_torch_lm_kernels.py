"""The LM kernels' plain PyTorch versions against the TPU kernels they
replace: flash attention, the fused FFN and the fused MoE FFN.

``repro_torch.kernels.ops.*`` on CPU tensors run the plain versions; the
JAX side runs the Pallas kernels in interpret mode at the shapes and masks
of ``tests/test_kernels.py``, and ``repro.kernels.ref`` at ragged shapes
the Pallas kernels refuse.  Tolerances: attention f32 2e-4 (the
reference's own bar for its flash kernel); FFNs f32 2e-3; bf16 2e-2 — the
Pallas flash kernel rounds P to V's dtype before the PV product and the
Pallas FFNs round H and the running output to the operand dtype, while the
port's versions keep f32 and round once.  The CUDA kernels are held to
these plain versions on the card (``test_torch_gpu.py``,
``chip_smoke.py``); the FFN kernels' own arithmetic (bf16: H rounded to
bf16; f32: both products as 3xTF32) is emulated here, against an f64 FFN
at published widths and against the Pallas kernels, to ground the
tolerances the card holds them to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tf32 import tf32
from repro.kernels import flash_attention as pallas_flash
from repro.kernels import fused_ffn as pallas_ffn
from repro.kernels import moe as pallas_moe
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import ops, ref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"f32": 2e-4, "bf16": 2e-2}
FFN_TOL = {"f32": 2e-3, "bf16": 2e-2}


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(x, jnp.float32).astype(jdt),
            torch.as_tensor(np.asarray(x, np.float32)).to(tdt))


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) * sc for s, sc in
            zip(shapes, scale if isinstance(scale, tuple)
                else (scale,) * len(shapes))]


# ---------------------------------------------------------- attention ----
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32)])
@pytest.mark.parametrize("s,dh", [(128, 32), (256, 64)])
def test_flash_attention_matches_pallas(causal, window, s, dh, dtype):
    arrs = _arrays(s + dh, *[(2, 2, s, dh)] * 3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrs)
    want = pallas_flash.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                        causal=causal, window=window,
                                        interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_long_kv_matches_pallas(dtype):
    """Decode-like: few queries against a long kv, non-causal."""
    arrs = _arrays(7, (1, 2, 128, 32), (1, 2, 1024, 32), (1, 2, 1024, 32))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrs)
    want = pallas_flash.flash_attention(jq, jk, jv, block_q=128,
                                        block_k=256, causal=False,
                                        interpret=True)
    _close(ops.flash_attention(tq, tk, tv, causal=False), want,
           ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fully_masked_rows_get_the_mean_of_v(dtype):
    """Causal, window 32, Sq 256 > Sk 128: rows q >= 159 see no key.  The
    masks use the finite -1e30, so the reference and the Pallas kernel give
    such a row the mean of V; the port (and its CUDA kernel, which skips
    masked kv blocks elsewhere) must too."""
    arrs = _arrays(11, (1, 2, 256, 32), (1, 2, 128, 32), (1, 2, 128, 32))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrs)
    want = pallas_flash.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                        causal=True, window=32,
                                        interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=32)
    _close(got, want, ATTN_TOL[dtype])
    mean_v = tv.float().mean(dim=2, keepdim=True).expand(-1, -1, 256 - 159,
                                                         -1)
    _close(got[:, :, 159:], mean_v.numpy(), ATTN_TOL[dtype])
    assert not torch.allclose(got[:, :, 158].float(),
                              mean_v[:, :, 0], atol=1e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,sq,sk,dh,causal,window", [
    (1, 3, 100, 100, 48, True, 0),      # ragged everything
    (2, 2, 75, 150, 16, False, 0),      # Sk > Sq, no block divides
    (1, 2, 150, 150, 64, False, 0),     # whisper-like encoder, non-causal
    (1, 2, 130, 130, 32, True, 20),     # ragged with a window
    (1, 1, 90, 40, 8, True, 7),         # Sq > Sk with a window: empty rows
])
def test_flash_attention_ragged_matches_ref(b, h, sq, sk, dh, causal,
                                            window, dtype):
    arrs = _arrays(sq * sk + dh, (b, h, sq, dh), (b, h, sk, dh),
                   (b, h, sk, dh))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrs)
    want = jref.attention(jq, jk, jv, causal=causal, window=window)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    _close(got, want, ATTN_TOL[dtype])


def test_flash_attention_sm_scale():
    arrs = _arrays(3, *[(1, 2, 64, 16)] * 3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "f32") for a in arrs)
    want = jref.attention(jq, jk, jv, causal=True, sm_scale=0.3)
    _close(ops.flash_attention(tq, tk, tv, sm_scale=0.3), want,
           ATTN_TOL["f32"])


# ------------------------------------------------ grouped K/V heads ----
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,hkv,causal,window", [
    (16, 2, True, 0),       # rep 8: qwen2.5-3b's 16 heads over 2 K/V heads
    (25, 5, True, 32),      # rep 5: hymba-1.5b's 25 heads over 5, windowed
    (10, 2, False, 0)])
def test_flash_attention_gqa_matches_jax(h, hkv, causal, window, dtype):
    """K/V with fewer heads than q, read in place by the port (query head
    i attends with K/V head i // (H // Hkv)), against the reference's
    ``chunked_attention`` (which repeats K/V itself) and against the Pallas
    kernel on K/V repeated to H heads by numpy."""
    arrs = _arrays(h * 7 + hkv, (1, h, 128, 32), (1, hkv, 128, 32),
                   (1, hkv, 128, 32))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrs)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jlayers.chunked_attention(jq, jk, jv, causal=causal,
                                     window=window, chunk=64)
    _close(got, want, ATTN_TOL[dtype])
    rep_k, rep_v = (np.repeat(a, h // hkv, axis=1) for a in arrs[1:])
    want = pallas_flash.flash_attention(
        jq, _pair(rep_k, dtype)[0], _pair(rep_v, dtype)[0], block_q=64,
        block_k=64, causal=causal, window=window, interpret=True)
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("kv_shape", [(1, 4, 8, 16), (1, 0, 8, 16),
                                      (2, 2, 8, 16), (1, 2, 8, 8)])
def test_flash_attention_rejects_kv_that_does_not_group(kv_shape, impl):
    """H % Hkv != 0 (6 heads over 4), no K/V head, another batch or another
    head dim: a ValueError on any device and either impl."""
    q = torch.zeros(1, 6, 8, 16)
    k = torch.zeros(kv_shape)
    with pytest.raises(ValueError, match="H % Hkv"):
        ops.flash_attention(q, k, k, impl=impl)


# --------------------------------------------------------------- FFNs ----
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,d,f,bm,bf,act", [
    (256, 64, 512, 128, 256, "gelu"), (128, 32, 256, 128, 128, "silu"),
    (128, 32, 256, 64, 128, "none")])
def test_fused_ffn_matches_pallas(m, d, f, bm, bf, act, dtype):
    arrs = _arrays(m + d + f, (m, d), (d, f), (f, d), scale=(1.0, 0.05, 0.05))
    (jx, tx), (j1, t1), (j2, t2) = (_pair(a, dtype) for a in arrs)
    want = pallas_ffn.fused_ffn(jx, j1, j2, block_m=bm, block_f=bf, act=act,
                                interpret=True)
    got = ops.fused_ffn(tx, t1, t2, act=act)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, FFN_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,d,f,act", [(100, 48, 200, "gelu"),
                                       (7, 33, 70, "silu"),
                                       (65, 16, 40, "none")])
def test_fused_ffn_ragged_matches_ref(m, d, f, act, dtype):
    arrs = _arrays(m * f, (m, d), (d, f), (f, d), scale=(1.0, 0.1, 0.1))
    (jx, tx), (j1, t1), (j2, t2) = (_pair(a, dtype) for a in arrs)
    _close(ops.fused_ffn(tx, t1, t2, act=act), jref.ffn(jx, j1, j2, act=act),
           FFN_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("e,cap,d,f,act", [(4, 128, 64, 512, "silu"),
                                           (2, 256, 32, 128, "gelu"),
                                           (2, 128, 32, 128, "none")])
def test_fused_moe_ffn_matches_pallas(e, cap, d, f, act, dtype):
    arrs = _arrays(e * cap + f, (e, cap, d), (e, d, f), (e, f, d),
                   scale=(1.0, 0.05, 0.05))
    (jx, tx), (j1, t1), (j2, t2) = (_pair(a, dtype) for a in arrs)
    want = pallas_moe.fused_moe_ffn(jx, j1, j2, block_c=64, block_f=128,
                                    act=act, interpret=True)
    got = ops.fused_moe_ffn(tx, t1, t2, act=act)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, FFN_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("e,cap,d,f,act", [(3, 40, 24, 56, "silu"),
                                           (5, 9, 16, 33, "gelu")])
def test_fused_moe_ffn_ragged_matches_ref(e, cap, d, f, act, dtype):
    arrs = _arrays(e + cap * d, (e, cap, d), (e, d, f), (e, f, d),
                   scale=(1.0, 0.1, 0.1))
    (jx, tx), (j1, t1), (j2, t2) = (_pair(a, dtype) for a in arrs)
    _close(ops.fused_moe_ffn(tx, t1, t2, act=act),
           jref.moe_ffn(jx, j1, j2, act=act), FFN_TOL[dtype])


def test_moe_act_none_follows_the_pallas_kernel():
    """The reference disagrees with itself: ``ref.moe_ffn`` maps
    ``act="none"`` to gelu, the Pallas kernel applies no activation
    (ROADMAP Queue 3).  The port follows the kernel."""
    arrs = _arrays(5, (2, 64, 32), (2, 32, 128), (2, 128, 32),
                   scale=(1.0, 0.2, 0.2))
    (jx, tx), (j1, t1), (j2, t2) = (_pair(a, "f32") for a in arrs)
    got = ops.fused_moe_ffn(tx, t1, t2, act="none")
    linear = torch.bmm(torch.bmm(tx, t1), t2)
    _close(got, linear.numpy(), FFN_TOL["f32"])
    oracle = np.asarray(jref.moe_ffn(jx, j1, j2, act="none"))
    assert np.abs(got.numpy() - oracle).max() > 1e-2


# ------------------------------------- the bf16 CUDA kernel's numerics ----
#: row-wise limit of the bf16 FFN / MoE kernels on the card against the plain
#: versions (``test_torch_gpu.py``, ``chip_smoke.py``): one bf16 rounding of
#: the output plus the bf16 rounding of H summed over f
FFN_BF16_ROW_TOL = 2.0 ** -6


def _emulate_bf16_kernel(x, w1, w2, act):
    """The arithmetic of ``csrc/fused_ffn.cu``'s bf16 path in plain torch:
    X·W1 summed in f32, the activation, H rounded to bf16 (as the Pallas
    kernels round it), H·W2 summed in f32 over all of f, one rounding."""
    h = ref.activation(x.float() @ w1.float(), act).to(torch.bfloat16)
    return (h.float() @ w2.float()).to(x.dtype)


def _row_rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("lead,m,d,f,act", [
    ((), 64, 2048, 5632, "gelu"),        # one stablelm-1.6b row block
    ((2,), 64, 1536, 512, "silu")])      # granite-moe-3b experts
def test_bf16_kernel_arithmetic_within_the_row_limit(lead, m, d, f, act):
    """Rounding H to bf16 keeps every output row within 2^-6 of the plain
    version (H in f32) at published widths: the limit the card holds the
    kernel to is not looser than its arithmetic needs."""
    rng = np.random.default_rng(d + f)
    x, w1, w2 = (torch.from_numpy(
        (rng.standard_normal(lead + s) * sc).astype(np.float32)).to(
            torch.bfloat16) for s, sc in (((m, d), 1.0), ((d, f), d ** -0.5),
                                          ((f, d), f ** -0.5)))
    got = _emulate_bf16_kernel(x, w1, w2, act)
    want = (ref.moe_ffn if lead else ref.ffn)(x, w1, w2, act=act)
    err = _row_rel_err(got, want)
    assert 0 < err <= FFN_BF16_ROW_TOL


@pytest.mark.parametrize("moe,shape,block,act", [
    (False, (256, 64, 512), (128, 256), "gelu"),
    (False, (128, 32, 256), (128, 128), "silu"),
    (False, (128, 32, 256), (64, 128), "none"),
    (True, (4, 128, 64, 512), (64, 128), "silu"),
    (True, (2, 256, 32, 128), (64, 128), "gelu"),
    (True, (2, 128, 32, 128), (64, 128), "none")])
def test_bf16_kernel_arithmetic_matches_pallas(moe, shape, block, act):
    """The same emulation against the TPU kernels in interpret mode, at the
    shapes and tolerance of the FFN / MoE tests above."""
    if moe:
        e, c, d, f = shape
        arrs = _arrays(e * c + f, (e, c, d), (e, d, f), (e, f, d),
                       scale=(1.0, 0.05, 0.05))
    else:
        m, d, f = shape
        arrs = _arrays(m + d + f, (m, d), (d, f), (f, d),
                       scale=(1.0, 0.05, 0.05))
    (jx, tx), (j1, t1), (j2, t2) = (_pair(a, "bf16") for a in arrs)
    if moe:
        want = pallas_moe.fused_moe_ffn(jx, j1, j2, block_c=block[0],
                                        block_f=block[1], act=act,
                                        interpret=True)
    else:
        want = pallas_ffn.fused_ffn(jx, j1, j2, block_m=block[0],
                                    block_f=block[1], act=act,
                                    interpret=True)
    _close(_emulate_bf16_kernel(tx, t1, t2, act), want, FFN_TOL["bf16"])


# -------------------------------------- the f32 CUDA kernel's numerics ----
#: row-wise limit of the f32 FFN / MoE kernels on the card against the plain
#: versions (``test_torch_gpu.py``, ``chip_smoke.py``)
FFN_F32_ROW_TOL = 1e-4


@pytest.fixture()
def _one_thread():
    """One intra-op thread: several test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _three_tf32(a: torch.Tensor, b: torch.Tensor, *, parts: int = 1,
                fresh: int = 32) -> torch.Tensor:
    """``a @ b`` (f32, any leading batch axes) as 3xTF32: each 32-deep block
    of k as lo·hi + hi·lo + hi·hi of the tf32 splits (lo·lo dropped).
    Block i goes to partial sum i % ``parts``; a partial sum's
    accumulator is added to it in f32 every ``fresh`` of its k (one block:
    fresh accumulators a block), and the partial sums are added last."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    shape = (*a.shape[:-1], b.shape[-1])
    totals = [torch.zeros(shape) for _ in range(parts)]
    accs = [torch.zeros(shape) for _ in range(parts)]
    depth = [0] * parts
    for i, k0 in enumerate(range(0, a.shape[-1], 32)):
        ks, q = slice(k0, k0 + 32), i % parts
        accs[q] = accs[q] + a_lo[..., ks] @ b_hi[..., ks, :]
        accs[q] = accs[q] + a_hi[..., ks] @ b_lo[..., ks, :]
        accs[q] = accs[q] + a_hi[..., ks] @ b_hi[..., ks, :]
        depth[q] += 32
        if depth[q] % fresh == 0 or k0 + 32 >= a.shape[-1]:
            totals[q] = totals[q] + accs[q]
            accs[q] = torch.zeros(shape)
    return sum(totals[1:], totals[0])


def _emulate_f32_kernel(x, w1, w2, act):
    """The arithmetic of ``csrc/fused_ffn.cu``'s f32 path in plain torch:
    X·W1 as 3xTF32, its two warpgroups summing alternate 32-deep blocks of
    d into fresh accumulators a block; the activation in f32 on their sum,
    H kept in f32 (the Pallas kernels round H to x's dtype, here f32); H·W2
    as 3xTF32, each chunk of 64 C columns of H (C = min(8, ceil(d / 256))
    CTAs a cluster) summed in one accumulator and added to the f32
    output.  The tensor cores' own rounding inside an accumulation is not
    emulated."""
    c = min(8, -(-x.shape[-1] // 256))
    h = ref.activation(_three_tf32(x, w1, parts=2), act)
    return _three_tf32(h, w2, fresh=64 * c)


def _published(lead, m, d, f, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(lead + s) * sc).astype(
        np.float32)) for s, sc in (((m, d), 1.0), ((d, f), d ** -0.5),
                                   ((f, d), f ** -0.5))]


@pytest.mark.usefixtures("_one_thread")
@pytest.mark.parametrize("lead,m,d,f,act", [
    ((), 64, 2048, 5632, "gelu"),        # one stablelm-1.6b row block
    ((2,), 64, 1536, 512, "silu")])      # granite-moe-3b experts
def test_f32_kernel_arithmetic_grounds_the_tolerance(lead, m, d, f, act):
    """3xTF32 on both products (depth d, then f) stays within 1e-5 of an
    f64 FFN row by row at published widths, while one TF32 product each
    misses the 1e-4 the card holds the kernel to: the tolerance needs the
    three products and is met with a margin."""
    x, w1, w2 = _published(lead, m, d, f, d + f)
    exact = ref.activation(x.double() @ w1.double(), act) @ w2.double()
    got = _emulate_f32_kernel(x, w1, w2, act)
    one = tf32(ref.activation(tf32(x) @ tf32(w1), act)) @ tf32(w2)
    assert _row_rel_err(got, exact) <= 1e-5
    assert _row_rel_err(one, exact) > FFN_F32_ROW_TOL


@pytest.mark.usefixtures("_one_thread")
@pytest.mark.parametrize("moe,shape,block,act", [
    (False, (256, 64, 512), (128, 256), "gelu"),
    (False, (128, 32, 256), (128, 128), "silu"),
    (False, (128, 32, 256), (64, 128), "none"),
    (True, (4, 128, 64, 512), (64, 128), "silu"),
    (True, (2, 256, 32, 128), (64, 128), "gelu"),
    (True, (2, 128, 32, 128), (64, 128), "none")])
def test_f32_kernel_arithmetic_matches_pallas(moe, shape, block, act):
    """The f32 emulation against the TPU kernels in interpret mode at f32,
    at the shapes and tolerance of the FFN / MoE tests above."""
    if moe:
        e, c, d, f = shape
        arrs = _arrays(e * c + f, (e, c, d), (e, d, f), (e, f, d),
                       scale=(1.0, 0.05, 0.05))
    else:
        m, d, f = shape
        arrs = _arrays(m + d + f, (m, d), (d, f), (f, d),
                       scale=(1.0, 0.05, 0.05))
    (jx, tx), (j1, t1), (j2, t2) = (_pair(a, "f32") for a in arrs)
    if moe:
        want = pallas_moe.fused_moe_ffn(jx, j1, j2, block_c=block[0],
                                        block_f=block[1], act=act,
                                        interpret=True)
    else:
        want = pallas_ffn.fused_ffn(jx, j1, j2, block_m=block[0],
                                    block_f=block[1], act=act,
                                    interpret=True)
    _close(_emulate_f32_kernel(tx, t1, t2, act), want, FFN_TOL["f32"])


# ----------------------------------------------------------- wrappers ----
def test_lm_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises — here
    (no card) the wrappers raise instead of running their plain versions;
    ``impl="torch"`` is the explicit way to the plain version.  Flash
    attention on ``meta`` tensors (the dry run) returns an empty output
    and launches nothing, neither kernel nor plain version."""
    meta = dict(device="meta")
    q = torch.empty(1, 2, 8, 4, **meta)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, q, q)
    assert out.is_meta and out.shape == q.shape
    assert ops.launch_counts()["flash_attention"] == 0
    x, w1, w2 = (torch.empty(8, 4, **meta), torch.empty(4, 6, **meta),
                 torch.empty(6, 4, **meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fused_ffn(x, w1, w2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fused_moe_ffn(x[None], w1[None], w2[None])
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, q, q, impl="xla")
    assert ops.flash_attention(q, q, q, impl="torch").shape == q.shape


def test_ffn_rejects_an_unknown_activation():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="act"):
        ops.fused_ffn(x, torch.randn(8, 16), torch.randn(16, 8), act="relu")
