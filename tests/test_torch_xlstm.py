"""The port's xLSTM blocks and the ``mlstm7+slstm`` decoder
(``xlstm-1.3b``) against the JAX package: ``mlstm_init`` / ``slstm_init``'s
trees, ``mlstm_apply`` and ``slstm_apply`` with and without a carried
state (a multi-chunk forward, a prefill, a decode step) and their
gradients, and the model at its ``REDUCED`` size (one group of 8 layers):
forward, prefill plus decode with the ``(g, 7)`` mLSTM and the sLSTM
caches, decode against forward, one train step's loss and gradients
(remat ``"dots"`` against ``"none"`` too), the decay set and the parameter
round trip, checkpoints both ways and the CLIs.

Inputs are made with numpy from a seed, and the reference's weights are
loaded with ``Transformer.params_from_jax``.  Tolerances: f32
``rtol=atol=2e-3``, the reference's parity bar; bf16 3e-2 relative to the
largest value, as ``test_torch_lm.py`` grounds it.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.launch import steps as jax_steps
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.optim import adamw as jax_adamw
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

TOL = 2e-3
BF16_TOL = 3e-2
ARCH = "xlstm-1.3b"
F32_LEAVES = ("w_f", "w_i")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _cfg(dtype="float32"):
    return dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype)


#: the reference's ``init_params``, compiled: drawn eagerly, the
#: ``REDUCED`` tree (27 M parameters, mLSTM heads of 512) takes seconds
_jax_init = jax.jit(JT.init_params, static_argnums=0)


def _models(cfg, seed=0):
    """The reference's parameters and a port model loaded with them; the
    port's own draws are skipped (``params_from_jax`` overwrites every
    parameter)."""
    params = _jax_init(cfg, jax.random.PRNGKey(seed))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (L, S):
            mp.setattr(mod, "init_weight",
                       lambda gen, shape, scale=None, dtype=torch.float32,
                       device=None: torch.empty(shape, dtype=dtype,
                                                device=device))
        model = T.Transformer(cfg, device="cpu", seed=seed)
    model.params_from_jax(jax.tree.map(np.asarray, params))
    return params, model


@pytest.fixture(scope="module")
def f32():
    """The f32 ``REDUCED`` pair ``(params, model)``, shared; a test that
    changes the model's parameters loads ``params`` back."""
    return _models(_cfg(), seed=4)


@pytest.fixture(scope="module")
def bf16():
    """The ``REDUCED`` pair in its own dtype, bf16 (the gates in f32)."""
    return _models(_cfg("bfloat16"), seed=5)


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


# ------------------------------------------------------------ the blocks ----
BLOCKS = {"mlstm": (S.mlstm_init, S.mlstm_apply, JS.mlstm_init,
                    JS.mlstm_apply),
          "slstm": (S.slstm_init, S.slstm_apply, JS.slstm_init,
                    JS.slstm_apply)}


def _block_params(block, cfg, seed):
    return jax.tree.map(np.array, BLOCKS[block][2](jax.random.PRNGKey(seed),
                                                   cfg, jnp.float32))


def _state(block, cfg, b, rng):
    """A carried-in state of the block's layout, drawn."""
    h, dh = cfg.n_heads, cfg.ssm_head_dim
    if block == "mlstm":
        st = rng.standard_normal((b, h, dh, dh + 1)).astype(np.float32)
        st[..., -1] = np.abs(st[..., -1])      # the normalizer's column
        return st
    return tuple(rng.standard_normal((b, h * dh)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_init_keeps_the_references_tree(block):
    """The keys and shapes of the reference's tree in a bf16 model; the
    mLSTM's gate weights ``w_f`` / ``w_i`` in f32 at scale 0.02."""
    cfg = get_config(ARCH, reduced=True)
    p = BLOCKS[block][0](torch.Generator().manual_seed(0), cfg,
                         torch.bfloat16)
    want = jax.eval_shape(lambda k: BLOCKS[block][2](k, cfg, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    assert set(p) == set(want)
    for name, t in p.items():
        assert tuple(t.shape) == want[name].shape, name
        assert t.dtype == (torch.float32 if name in F32_LEAVES
                           else torch.bfloat16), name
    for name in set(F32_LEAVES) & set(p):
        assert float(p[name].abs().max()) <= 2 * 0.02


@pytest.mark.parametrize("path", ["forward", "prefill", "decode",
                                  "decode from zeros"])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_apply_matches_jax(block, path):
    """The block on the reference's weights: no state (S 136 for the
    mLSTM: two chunks of 128 and the padding; 40 for the sLSTM), a prefill
    from a carried-in state (S 24), a decode step (S 1) from one and from
    none; the output and the returned state."""
    cfg = _cfg()
    p = _block_params(block, cfg, 1)
    rng = np.random.default_rng(1)
    s = {"forward": 136 if block == "mlstm" else 40,
         "prefill": 24}.get(path, 1)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    state = _state(block, cfg, 2, rng) if path in ("prefill", "decode") \
        else None
    jfn = jax.jit(lambda p_, x_, c_: BLOCKS[block][3](p_, cfg, x_, cache=c_))
    want, want_state = jfn(p, x, state)
    tstate = None if state is None else jax.tree.map(torch.from_numpy, state)
    got, got_state = BLOCKS[block][1](
        {k: torch.from_numpy(v) for k, v in p.items()}, cfg,
        torch.from_numpy(x), cache=tstate)
    assert got.shape == (2, s, cfg.d_model)
    _close(got, want)
    for mine, theirs in zip(jax.tree.leaves(got_state),
                            jax.tree.leaves(want_state), strict=True):
        assert mine.dtype == torch.float32
        _close(mine, theirs)


def test_block_apply_bf16_matches_jax():
    """Both blocks in bf16 (the mLSTM's gates in f32) from no state, S 40,
    within 3e-2 of the largest value."""
    cfg = _cfg("bfloat16")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    for block in BLOCKS:
        p = _block_params(block, cfg, 2)
        jp = {k: jnp.asarray(v, jnp.float32 if k in F32_LEAVES
                             else jnp.bfloat16) for k, v in p.items()}
        tp = {k: torch.from_numpy(v).to(torch.float32 if k in F32_LEAVES
                                        else torch.bfloat16)
              for k, v in p.items()}
        want = jax.jit(lambda p_, x_: BLOCKS[block][3](p_, cfg, x_)[0])(
            jp, jnp.asarray(x, jnp.bfloat16))
        got = BLOCKS[block][1](tp, cfg,
                               torch.from_numpy(x).to(torch.bfloat16))[0]
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= BF16_TOL, block


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_gradients_match_jax(block):
    """Gradients of ``(apply(x, state)·w).sum()`` in x, the carried-in
    state and every weight (f32, S 40) against ``jax.grad``."""
    cfg = _cfg()
    p = _block_params(block, cfg, 3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    state = _state(block, cfg, 2, rng)
    w = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)

    def jloss(p_, x_, c_):
        return (BLOCKS[block][3](p_, cfg, x_, cache=c_)[0] * w).sum()
    wg_p, wg_x, wg_c = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        p, x, state)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tc = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), state)
    (BLOCKS[block][1](tp, cfg, tx, cache=tc)[0]
     * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, wg_x, err_msg="x")
    for mine, theirs in zip(jax.tree.leaves(tc), jax.tree.leaves(wg_c),
                            strict=True):
        _close(mine.grad, theirs, err_msg="state")
    for k, v in tp.items():
        _close(v.grad, wg_p[k], err_msg=k)


# ------------------------------------------------------------ the model ----
def test_model_holds_the_references_grouped_tree(f32):
    """One group of 8 layers: ``mlstm`` stacked ``(1, 7, ...)``, ``slstm``
    ``(1, ...)``, ``ln_m (1, 7, d)``, ``ln_s (1, d)``; ``to_tree`` and
    ``params_to_jax`` give the reference's tree back leaf for leaf, and
    every leaf but ``ln_f`` is decayed (the rank rule on the stacked
    tree: the f32 gates and the norm gains too).  Two groups' stacks are
    refused, and so is a depth that is not whole groups."""
    params, model = f32
    cfg = model.cfg
    got = model.params_to_jax()
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params),
                    strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    inner = cfg.n_heads * cfg.ssm_head_dim
    assert got["mlstm"]["w_f"].shape == (1, 7, inner, cfg.n_heads)
    assert got["ln_m"].shape == (1, 7, cfg.d_model)
    assert got["ln_s"].shape == (1, cfg.d_model)
    ps = [p.detach() for p in model.parameters()]
    for a, b in zip(model.from_tree(model.to_tree(ps)), ps, strict=True):
        assert torch.equal(a, b)
    named = dict(zip((n for n, _ in model.named_parameters()),
                     model.decay_mask()))
    assert {n for n, dk in named.items() if not dk} == {"ln_f"}
    assert named["groups.0.ln_m.3"] and named["groups.0.mlstm.6.w_i"]
    two = dict(got, **{k: jax.tree.map(lambda a: np.concatenate([a, a]),
                                       got[k])
                       for k in ("mlstm", "slstm", "ln_m", "ln_s")})
    with pytest.raises(ValueError, match="layers"):
        model.params_from_jax(two)
    with pytest.raises(ValueError, match="n_layers % 8"):
        T.Transformer(dataclasses.replace(cfg, n_layers=12), device="cpu")


def test_forward_matches_jax(f32):
    params, model = f32
    cfg = model.cfg
    toks = _tokens(cfg, (2, 40), seed=5)
    want = jax.jit(lambda p, t: JT.forward(cfg, p, {"tokens": t}))(
        params, jnp.asarray(toks))
    got = model(torch.from_numpy(toks))
    assert got.shape == (2, 40, cfg.vocab_size)
    _close(got, want)


def test_forward_bf16_is_as_close_to_f32_as_the_reference(bf16):
    """In bf16 the model drifts from its own f32 values through the 8
    layers (the mLSTM heads of 512 sum in bf16 products): the reference's
    bf16 forward lies 0.2 of the largest logit from its f32 forward at
    this seed.  The port's bf16 forward must be no farther from that f32
    truth than the reference's own (within a quarter more); the f32
    forward is held at the parity bar above."""
    params, model = bf16
    cfg = model.cfg
    assert model.groups[0].mlstm[0]["w_f"].dtype == torch.float32
    toks = jnp.asarray(_tokens(cfg, (2, 40), seed=5))
    fwd = jax.jit(JT.forward, static_argnums=0)
    truth = np.asarray(fwd(_cfg(), jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32), params), {"tokens": toks}))
    theirs = np.asarray(fwd(cfg, params, {"tokens": toks}), np.float32)
    got = model(torch.from_numpy(np.asarray(toks)))
    assert got.dtype == torch.bfloat16
    assert _rel(got, truth) <= 1.25 * _rel(torch.from_numpy(theirs), truth)


def test_prefill_and_decode_match_jax(f32):
    """One batched prefill of 24 tokens plus 4 decode steps: the logits
    and the caches (the ``(g, 7)`` mLSTM states and the sLSTM's ``(c,
    hid)``) array for array after every step, against the reference's
    ``decode_step``."""
    params, model = f32
    cfg = model.cfg
    b, s, gen = 2, 24, 4
    toks = _tokens(cfg, (b, s + gen), seed=6)
    jcache = JT.init_cache(cfg, b, s + gen)
    jdecode = jax.jit(lambda p, t, c, n: JT.decode_step(
        cfg, p, {"tokens": t}, c, n))
    cache = model.init_cache(b, s + gen)
    assert cache["mlstm"].shape == jcache["mlstm"].shape
    for step in range(gen + 1):
        lo, hi = (0, s) if step == 0 else (s + step - 1, s + step)
        want, jcache = jdecode(params, jnp.asarray(toks[:, lo:hi]), jcache,
                               jnp.int32(lo))
        got, cache = model.decode_step(torch.from_numpy(toks[:, lo:hi]),
                                       cache, lo)
        _close(got, want)
        for mine, theirs in zip(jax.tree.leaves(cache),
                                jax.tree.leaves(jcache), strict=True):
            assert mine.dtype == torch.float32
            _close(mine, theirs)


def test_decode_matches_forward(f32):
    """8 tokens decoded one at a time against the teacher-forced forward
    (f32, on the port alone): the recurrences carry the same state."""
    model = f32[1]
    cfg = model.cfg
    toks = torch.from_numpy(_tokens(cfg, (2, 8)))
    with torch.inference_mode():
        full = model(toks)
        cache = model.init_cache(2, 8)
        outs = []
        for i in range(8):
            lg, cache = model.decode_step(toks[:, i:i + 1], cache, i)
            outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy())


def _grads(model, batch, remat="none"):
    model.cfg = dataclasses.replace(model.cfg, remat=remat)
    model.zero_grad()
    loss, _ = steps.make_loss_fn(model)(batch)
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


def test_train_step_matches_jax(f32):
    """One train step (f32, B 2 × S 40): the loss and every gradient
    against ``jax.grad`` of the reference's loss; the step updates every
    parameter."""
    params, model = f32
    cfg = model.cfg
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 40))
             for k in ("tokens", "labels")}
    loss_fn = jax_steps.make_loss_fn(cfg, rules=None)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {k: jnp.asarray(v)
                              for k, v in batch.items()})[0]))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _grads(model, tb)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    for (name, _), g, w in zip(model.named_parameters(), grads,
                               model.from_tree(want_grads), strict=True):
        _close(g, np.asarray(w), err_msg=name)
    before = [p.detach().clone() for p in model.parameters()]
    step = steps.make_train_step(model, adamw.OptConfig(lr=1e-2,
                                                        warmup_steps=1))
    state, m = step(adamw.init(model.parameters()), tb)
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    assert all(not torch.equal(a, b) for a, b in
               zip(before, model.parameters()))
    model.params_from_jax(params)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_the_gradients(remat):
    """Under remat (the mLSTM blocks recomputed in the backward, the sLSTM
    not) the loss and gradients are those of ``"none"``, on the port
    alone, at a narrow cut (heads of 16) of the config."""
    cfg = dataclasses.replace(_cfg(), head_dim=16, ssm_head_dim=16)
    model = T.Transformer(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(8)
    tb = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
          for k in ("tokens", "labels")}
    want_loss, want = _grads(model, tb)
    loss, got = _grads(model, tb, remat)
    assert float(loss) == float(want_loss)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_checkpoints_move_both_ways(bf16, tmp_path):
    """The reference writes its ``(params, opt_state)`` tree (bf16
    weights, the f32 gates, the ``(g, 7)`` stacks); the port's ``restore``
    reads it leaf for leaf, writes it again, and the reference's
    ``restore`` reads the port's step back: the same leaves and manifest
    text both ways."""
    params, model = bf16
    cfg = model.cfg
    rng = np.random.default_rng(8)
    jstate = jax_adamw.OptState(
        jnp.int32(3),
        *(jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)), params) for _ in range(2)))
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_ckpt.save(d_ref, 3, (params, jstate), extra={"step": 3})

    state = adamw.init(model.parameters())
    (ptree, otree), extra = ckpt.restore(d_ref, 3, train._tree(model, state))
    assert extra == {"step": 3}
    model.params_from_jax(ptree)
    state = adamw.state_from_tree(otree, model)
    assert state.step == 3
    for a, b in zip(jax.tree.leaves(model.params_to_jax()),
                    jax.tree.leaves(params), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    for a, b in zip(state.nu, model.from_tree(jstate.nu), strict=True):
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


def test_xlstm_clis_serve_and_train_on_the_cpu(capsys):
    """``launch.serve`` and ``launch.train`` at ``--reduced --device cpu``:
    tokens in range, finite losses, no kernel launched (the stack is
    attention-free)."""
    ops.reset_launch_counts()
    tokens = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--batch", "1", "--prompt-len", "12", "--gen",
                         "3"])
    assert tokens.shape == (1, 3)
    assert ((tokens >= 0) & (tokens < 256)).all()
    run = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "1", "--seq", "8",
                      "--log-every", "100"])
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert "sample:" in capsys.readouterr().out
    assert sum(ops.launch_counts().values()) == 0
