"""The port's gated MoE layer and the two MoE decoders against the JAX
package: the capacity dispatch array for array (drops and tied experts
included), the combine, the expert chain, ``moe_apply`` and its gradients,
and ``granite-moe-3b-a800m`` / ``llama4-scout-17b-a16e`` at their
``REDUCED`` sizes: forward, prefill plus decode with the caches, decode
against forward, 6 train steps, checkpoints both ways and the parameter
counts.

Inputs are made with numpy from a seed, and the reference's weights are
loaded with ``Transformer.params_from_jax``.  Tolerances: f32
``rtol=atol=2e-3``, the reference's parity bar (the sides sum in other
orders; the routing is the same, held array for array); bf16 3e-2
relative to the largest value, as ``test_torch_lm.py`` grounds it.  The
dispatch's integer arrays are held exactly, and the train steps' losses
to 1e-5 relative (each step starts from the reference's state).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import checkpoint as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jax_adamw
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig, adamw

TOL = 2e-3
BF16_TOL = 3e-2
ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e"]


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _cfg(arch, dtype="float32", **kw):
    return dataclasses.replace(get_config(arch, reduced=True), dtype=dtype,
                               **kw)


def _models(cfg, seed=0):
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    model = T.Transformer(cfg, device="cpu", seed=seed)
    model.params_from_jax(jax.tree.map(np.asarray, params))
    return params, model


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, tol=TOL, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=err_msg)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


def _moe_params(cfg, seed, skew=0.0):
    """The reference's ``moe_init`` weights as numpy (f32); ``skew`` adds
    to the router's column of expert 1, so most tokens pick it."""
    p = jax.tree.map(np.asarray, JL.moe_init(jax.random.PRNGKey(seed), cfg,
                                             jnp.float32))
    p["router"] = p["router"].copy()
    p["router"][:, 1] += skew
    return p


def _torch_params(p, dtype=torch.float32):
    """numpy weights as tensors of ``dtype``; the router stays f32."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = _torch_params(v, dtype)
        else:
            t = torch.from_numpy(np.array(v))
            out[k] = t if k == "router" else t.to(dtype)
    return out


def _jax_params(p, dtype):
    return {k: _jax_params(v, dtype) if isinstance(v, dict)
            else jnp.asarray(v, jnp.float32 if k == "router" else dtype)
            for k, v in p.items()}


# ----------------------------------------------------------- dispatch ----
def test_moe_capacity_is_the_references():
    """``cap = int(1.25·s·k/e)``, rounded up to a multiple of 8, at least
    8: granite's S 2048 gives 512, a decode step 8."""
    granite = get_config("granite-moe-3b-a800m")
    llama = get_config("llama4-scout-17b-a16e")
    assert L.moe_capacity(granite, 2048) == 512
    assert L.moe_capacity(granite, 1) == 8
    assert L.moe_capacity(llama, 2048) == 160
    assert L.moe_capacity(granite, 2048, 0.5) == 208


def _reference_arrays(route, cap):
    """Each row's ``keep``, ``slot``, token and gate arrays in the
    reference's layout (assignments sorted by expert, then token; slot
    ``expert·cap + position``, ``e·cap`` where dropped), read off the
    port's tables.  Also checks that every kept pick's slot lies in its
    own row's block."""
    b, s, k = route.experts.shape
    n_slots = route.slot_pick.numel()
    e = n_slots // (b * cap)
    order = np.argsort(route.experts.reshape(b, s * k).numpy(), axis=-1,
                       kind="stable")
    gslot = np.take_along_axis(route.tok_slot.view(b, s * k).numpy(), order,
                               -1)
    keep = gslot < n_slots
    rows = np.arange(b)[:, None]
    assert ((gslot // cap % b == rows) | ~keep).all()
    slot = np.where(keep, gslot // (b * cap) * cap + gslot % cap, e * cap)
    gate = np.take_along_axis(route.gates.reshape(b, s * k).numpy(), order,
                              -1)
    return keep, slot, order // k, gate


def _dispatch_case(arch, b, s, seed, skew=0.0, capacity_factor=1.25,
                   x=None):
    cfg = _cfg(arch)
    p = _moe_params(cfg, seed, skew)
    if x is None:
        x = np.random.default_rng(seed).standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    cap = L.moe_capacity(cfg, s, capacity_factor)
    xe, route = L._row_dispatch(cfg, torch.from_numpy(x),
                                torch.from_numpy(p["router"]), cap)
    assert xe.shape == (cfg.n_experts, b * cap, cfg.d_model)
    xe = xe.view(cfg.n_experts, b, cap, cfg.d_model)
    dropped = 0
    dispatch = jax.jit(JL._row_dispatch, static_argnums=(0, 3))
    arrays = _reference_arrays(route, cap)
    for i in range(b):
        jxe, (keep, slot, tok, gate) = dispatch(
            cfg, jnp.asarray(x[i]), jnp.asarray(p["router"]), cap)
        np.testing.assert_array_equal(xe[:, i].numpy(), np.asarray(jxe))
        np.testing.assert_array_equal(arrays[0][i], np.asarray(keep))
        np.testing.assert_array_equal(arrays[1][i], np.asarray(slot))
        np.testing.assert_array_equal(arrays[2][i], np.asarray(tok))
        np.testing.assert_allclose(arrays[3][i], np.asarray(gate),
                                   rtol=1e-6, atol=1e-7)
        dropped += int((~np.asarray(keep)).sum())
    return route, dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_row_dispatch_matches_jax(arch):
    """Each batch row of the port's batched dispatch equals the
    reference's ``_row_dispatch`` of that row: ``xe``, ``keep``, ``slot``,
    the token and the gate order."""
    _dispatch_case(arch, 3, 24, seed=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_row_dispatch_drops_like_jax(arch):
    """``capacity_factor`` 0.5 and a router skewed toward expert 1: the
    capacity drops assignments, the same ones on both sides."""
    route, dropped = _dispatch_case(arch, 2, 32, seed=2, skew=0.5,
                                    capacity_factor=0.5)
    assert dropped > 8, dropped
    assert int((route.tok_slot >= route.slot_pick.numel()).sum()) == dropped


def test_row_dispatch_sorts_tied_experts_stably():
    """Every token of a row the same vector, so every token picks the same
    expert (top-1): the stable sort keeps them in token order and the
    capacity of 8 keeps the first 8 tokens, as the reference's does."""
    cfg = _cfg("llama4-scout-17b-a16e")
    row = np.random.default_rng(3).standard_normal(cfg.d_model)
    x = np.broadcast_to(row, (2, 24, cfg.d_model)).astype(np.float32)
    route, dropped = _dispatch_case("llama4-scout-17b-a16e", 2, 24, seed=3,
                                    capacity_factor=0.1, x=x)
    assert dropped == 2 * 16
    keep, _, tok, _ = _reference_arrays(route, L.moe_capacity(cfg, 24, 0.1))
    np.testing.assert_array_equal(tok[0], np.arange(24))
    np.testing.assert_array_equal(keep[0], np.arange(24) < 8)


def test_dispatch_tables_invert_each_other():
    """``tok_slot`` and ``slot_pick`` are inverse maps between the kept
    (token, pick) pairs and the filled slots."""
    cfg = _cfg("granite-moe-3b-a800m")
    route, _ = _dispatch_case("granite-moe-3b-a800m", 2, 32, seed=4,
                              skew=0.5, capacity_factor=0.5)
    ts, sp = route.tok_slot.numpy(), route.slot_pick.numpy()
    kept = ts < sp.size
    assert (sp[ts[kept]] == np.flatnonzero(kept)).all()
    filled = sp < ts.size
    assert (ts[sp[filled]] == np.flatnonzero(filled)).all()
    assert kept.sum() == filled.sum() < ts.size
    assert (np.diff(route.experts.numpy(), axis=-1) > 0).all()
    assert route.gates.shape == (2, 32, cfg.moe_top_k)


# ------------------------------------------------ combine, experts ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_row_combine_matches_jax(arch, dtype):
    """The same ``ye`` through both combines, with drops (``capacity_factor``
    0.5): the gate rounded to the dtype, each kept slot's output summed
    into its token's row."""
    cfg = _cfg(arch)
    b, s = 2, 32
    p = _moe_params(cfg, 5, skew=0.5)
    x = np.random.default_rng(5).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    cap = L.moe_capacity(cfg, s, 0.5)
    _, route = L._row_dispatch(cfg, torch.from_numpy(x),
                               torch.from_numpy(p["router"]), cap)
    ye = np.random.default_rng(6).standard_normal(
        (cfg.n_experts, b * cap, cfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    got = L._row_combine(torch.from_numpy(ye).to(tdt), route, b, s, tdt)
    assert got.dtype == tdt and got.shape == (b, s, cfg.d_model)
    ye4 = ye.reshape(cfg.n_experts, b, cap, cfg.d_model)
    for i in range(b):
        _, aux = JL._row_dispatch(cfg, jnp.asarray(x[i]),
                                  jnp.asarray(p["router"]), cap)
        want = JL._row_combine(jnp.asarray(ye4[:, i], jdt), aux, s,
                               cfg.d_model, jdt)
        if dtype == "float32":
            _close(got[i], want, 1e-5)
        else:
            assert _rel(got[i], want) <= 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_ffn_matches_jax(arch, dtype):
    cfg = _cfg(arch)
    p = _moe_params(cfg, 7)
    xe = np.random.default_rng(7).standard_normal(
        (cfg.n_experts, 24, cfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JL._expert_ffn(cfg, jnp.asarray(xe, jdt),
                          *(jnp.asarray(p[k], jdt) for k in ("w1", "w3",
                                                             "w2")))
    got = L._expert_ffn(cfg, torch.from_numpy(xe).to(tdt),
                        *(torch.from_numpy(np.array(p[k])).to(tdt)
                          for k in ("w1", "w3", "w2")))
    assert got.dtype == tdt
    if dtype == "float32":
        _close(got, want)
    else:
        assert _rel(got, want) <= BF16_TOL


# -------------------------------------------------------- moe_apply ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, dtype):
    """granite (top-2 of 4, no shared expert) and llama4 (top-1 of 4 plus
    the shared expert), B 2 × S 32."""
    cfg = _cfg(arch, dtype=dtype)
    p = _moe_params(cfg, 8)
    assert ("shared" in p) == cfg.moe_shared_expert
    x = np.random.default_rng(8).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(lambda p_, x_: JL.moe_apply(p_, cfg, x_, None))(
        _jax_params(p, jdt), jnp.asarray(x, jdt))
    got = L.moe_apply(_torch_params(p, tdt), cfg, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        _close(got, want)
    else:
        assert _rel(got, np.asarray(want, np.float32)) <= BF16_TOL


@pytest.mark.parametrize("skew", [0.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_gradients_match_jax(arch, skew):
    """Gradients of ``(moe_apply(x) · w).sum()`` in x, the router, w1, w3,
    w2 and the shared expert against ``jax.grad`` (f32); ``skew`` 0.5
    with ``capacity_factor`` 0.5 drops assignments."""
    cfg = _cfg(arch)
    p = _moe_params(cfg, 9, skew)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    cf = 0.5 if skew else 1.25

    def jloss(p_, x_):
        return (JL.moe_apply(p_, cfg, x_, None, capacity_factor=cf)
                * w).sum()
    wg_p, wg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        _jax_params(p, jnp.float32), jnp.asarray(x))
    tp = _torch_params(p)
    leaves = {k: v.requires_grad_() for k, v in tp.items()
              if k != "shared"}
    if "shared" in tp:
        for k, v in tp["shared"].items():
            v.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    (L.moe_apply(tp, cfg, tx, capacity_factor=cf)
     * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, wg_x, err_msg="x")
    for k, v in leaves.items():
        _close(v.grad, wg_p[k], err_msg=k)
    for k, v in tp.get("shared", {}).items():
        _close(v.grad, wg_p["shared"][k], err_msg=f"shared.{k}")


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.dim():
            self.ops.append((func.__name__, out.dtype, out.shape[-1]))
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_moves_float_rows_without_a_scatter(dtype):
    """Forward and backward of the layer (with drops) move no row of width
    d by a float scatter or an accumulating index op, whose atomics would
    make it non-deterministic on the card (the top-k's and the pick
    order's backward scatter a token's k gates to distinct places), and
    two runs give the same bits."""
    cfg = _cfg("granite-moe-3b-a800m")
    p = _torch_params(_moe_params(cfg, 10, 0.5), dtype)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)).to(dtype)

    def run():
        ps = {k: v.detach().requires_grad_() for k, v in p.items()}
        xs = x.detach().requires_grad_()
        y = L.moe_apply(ps, cfg, xs, capacity_factor=0.5)
        y.float().square().sum().backward()
        return [y, xs.grad] + [v.grad for v in ps.values()]
    with _OpLog() as log:
        first = run()
    row_writes = [name for name, dt, width in log.ops
                  if dt.is_floating_point and width == cfg.d_model
                  and ("scatter" in name or "index_add" in name
                       or "index_put" in name)]
    assert not row_writes, row_writes
    assert any("index_select" in name for name, _, _ in log.ops)
    for a, b in zip(first, run(), strict=True):
        assert torch.equal(a, b)


# ------------------------------------------------------------ models ----
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cfg = _cfg(arch)
    params, model = _models(cfg)
    toks = _tokens(cfg, (2, 40))
    want = jax.jit(lambda p, t: JT.forward(cfg, p, {"tokens": t}))(
        params, jnp.asarray(toks))
    got = model(torch.from_numpy(toks))
    assert got.shape == (2, 40, cfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_jax(arch):
    cfg = get_config(arch, reduced=True)
    assert cfg.dtype == "bfloat16"
    params, model = _models(cfg, seed=3)
    toks = _tokens(cfg, (2, 12), seed=3)
    want = jax.jit(lambda p, t: JT.forward(cfg, p, {"tokens": t}))(
        params, jnp.asarray(toks))
    got = model(torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert model.blocks[0].moe["router"].dtype == torch.float32
    assert _rel(got, np.asarray(want, np.float32)) <= BF16_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """One batched prefill of 36 tokens plus 4 decode steps: logits and
    both caches after every step.  granite's prefill drops assignments
    (cap 24 of 36 tokens a row); llama4's 32-slot ring buffer is overfilled
    by the prefill and wraps in the decode steps."""
    cfg = _cfg(arch)
    params, model = _models(cfg, seed=1)
    b, s, gen = 2, 36, 4
    toks = _tokens(cfg, (b, s + gen), seed=1)
    jcache = JT.init_cache(cfg, b, s + gen)
    jdecode = jax.jit(lambda p, t, c, n: JT.decode_step(
        cfg, p, {"tokens": t}, c, n))
    cache = model.init_cache(b, s + gen)
    assert cache[0].shape == jcache[0].shape
    if cfg.window:
        assert cache[0].shape[3] == cfg.window < s
    for step in range(gen + 1):
        lo, hi = (0, s) if step == 0 else (s + step - 1, s + step)
        want, jcache = jdecode(params, jnp.asarray(toks[:, lo:hi]), jcache,
                               jnp.int32(lo))
        got, cache = model.decode_step(torch.from_numpy(toks[:, lo:hi]),
                                       cache, lo)
        _close(got, want)
        for mine, theirs in zip(cache, jcache):
            _close(mine, theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The twin of ``tests/test_models.py::test_decode_matches_forward``
    on the port alone: 8 tokens decoded one at a time against the
    teacher-forced forward, ``REDUCED`` in bf16, at the reference test's
    tolerance (0.15 for ``attn`` blocks).  At 8 tokens no capacity drops
    (cap 8), so the two paths route alike."""
    cfg = get_config(arch, reduced=True)
    model = T.Transformer(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(_tokens(cfg, (2, 8)))
    with torch.inference_mode():
        full = model(toks)
        cache = model.init_cache(2, 8)
        outs = []
        for i in range(8):
            lg, cache = model.decode_step(toks[:, i:i + 1], cache, i)
            outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)
    _close(got, full.float().numpy(), 0.15)


def _as_tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """6 AdamW steps against the reference's jitted ``make_train_step``
    (f32, B 2 × S 32): the step-1 gradients tensor for tensor, the losses
    step for step.

    Each step starts from the reference's parameters and AdamW state,
    loaded into the port.  Run free, the two sides part: Adam moves a
    weight with a near-zero gradient by about ±lr whatever the gradient's
    size, so rounding-level gradient differences give weights that differ
    by 3e-4 after one step, and the routing is discontinuous: llama4's
    top-1 pick of a token whose two best gates lay 3e-5 apart flipped at
    step 4 (loss 4.3135 against the reference's 4.3186)."""
    cfg = _cfg(arch)
    params, model = _models(cfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 32))
             for k in ("tokens", "labels")}
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jax_steps.make_loss_fn(cfg, rules=None)
    want_grads = jax.jit(jax.grad(lambda p: loss_fn(p, jb)[0]))(params)
    jstep = jax_steps.make_train_step(
        cfg, JOptConfig(**dataclasses.asdict(ocfg)), rules=None, jit=True)
    jstate = jax_adamw.init(params)
    step = steps.make_train_step(model, ocfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, want = [], []
    for i in range(6):
        model.params_from_jax(params)
        state = adamw.state_from_tree(_as_tensors(tuple(jstate)), model)
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
        if i == 0:
            for (name, p), w in zip(model.named_parameters(),
                                    model.from_tree(want_grads)):
                _close(p.grad, np.asarray(w), err_msg=name)
        params, jstate, jm = jstep(params, jstate, jb)
        want.append(float(jm["loss"]))
        assert state.step == int(jstate.step)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert min(losses[2:]) < losses[0], losses


def test_decay_mask_decays_every_moe_weight():
    """The reference's rank rule on the stacked tree: the router, the
    experts and the shared expert are decayed, ``ln_f`` is not."""
    model = T.Transformer(get_config("llama4-scout-17b-a16e", reduced=True),
                          device="cpu")
    named = dict(zip((n for n, _ in model.named_parameters()),
                     model.decay_mask()))
    assert {n for n, dk in named.items() if not dk} == {"ln_f"}
    assert {"blocks.0.moe.router", "blocks.0.moe.w1",
            "blocks.1.moe.shared.w_down"} <= set(named)


# ------------------------------------------------------ checkpoints ----
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_move_both_ways(arch, tmp_path):
    """The reference writes its ``(params, opt_state)`` tree (bf16 weights,
    the f32 router, nested ``shared``); the port's ``restore`` reads it
    leaf for leaf into the model and its AdamW state, writes it again, and
    the reference's ``restore`` reads the port's step back: the same
    leaves and the same manifest text both ways."""
    cfg = get_config(arch, reduced=True)
    params = JT.init_params(cfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    jstate = jax_adamw.OptState(
        jnp.int32(3),
        *(jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)), params) for _ in range(2)))
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_ckpt.save(d_ref, 3, (params, jstate), extra={"step": 3})

    model = T.Transformer(cfg, device="cpu", seed=1)
    state = adamw.init(model.parameters())
    (ptree, otree), extra = ckpt.restore(d_ref, 3, train._tree(model, state))
    assert extra == {"step": 3}
    model.params_from_jax(ptree)
    state = adamw.state_from_tree(otree, model)
    assert state.step == 3
    for a, b in zip(jax.tree.leaves(model.params_to_jax()),
                    jax.tree.leaves(params), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    for a, b in zip(state.mu, model.from_tree(jstate.mu), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    ckpt.save(d_port, 3, train._tree(model, state), extra={"step": 3})
    manifests = [open(os.path.join(d, "step_00000003", "manifest.json")).read()
                 for d in (d_ref, d_port)]
    assert manifests[0] == manifests[1]
    got, extra = jax_ckpt.restore(d_port, 3, (params, jstate))
    assert extra == {"step": 3}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves((params, jstate)),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# ------------------------------------------------- counts, the CLIs ----
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_the_model(arch):
    """``param_count()`` counts the model's parameters less the norm
    gains, and ``param_count(active_only=True)`` those less the experts a
    token does not use; the twin of
    ``tests/test_models.py::test_moe_active_params_smaller``."""
    cfg = get_config(arch, reduced=True)
    assert cfg.param_count() == jax_get_config(arch, reduced=True) \
        .param_count()
    model = T.Transformer(cfg, device="cpu")
    n = sum(p.numel() for name, p in model.named_parameters()
            if "ln" not in name)
    assert n == cfg.param_count()
    per_expert = 3 * cfg.d_model * cfg.d_ff
    idle = cfg.n_layers * (cfg.n_experts - cfg.moe_top_k) * per_expert
    assert cfg.param_count(active_only=True) == n - idle
    full = get_config(arch)
    assert full.param_count(active_only=True) < full.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_clis_serve_and_train_on_the_cpu(arch, capsys):
    """``launch.serve`` and ``launch.train`` at ``--reduced --device
    cpu``: tokens in range, finite losses, no kernel launched."""
    ops.reset_launch_counts()
    tokens = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "40", "--gen",
                         "3"])
    assert tokens.shape == (2, 3)
    assert ((tokens >= 0) & (tokens < 256)).all()
    run = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--log-every", "100"])
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert "sample:" in capsys.readouterr().out
    assert sum(ops.launch_counts().values()) == 0
