"""The port's cross-attention, encoder and stubbed frontends against the
JAX package: ``cross_attention`` (serving and training paths, S ≠ Se, a
decode step's S = 1) and its gradients, ``_encoder``, and two models at
their ``REDUCED`` sizes: ``whisper-medium`` (encoder-decoder over stubbed
audio frames) and ``qwen2-vl-72b`` (a decoder over stubbed vision
embeddings, or tokens): forward, prefill plus decode against the
reference's ``decode_step`` (whisper's encoder runs in every step;
qwen2-vl's prefill takes embeddings and its decode steps tokens), one
train step's loss and gradients, the decay set and the parameter tree,
checkpoints both ways and the CLIs.

The encoder's inputs are never zeros: with no biases an encoder on zeros
gives exact zeros, and the cross-attention then adds nothing, so a wrong
encoder or cross-attention would pass.  Every ``enc_embeds`` here is
seeded unit-normal (as ``tests/test_models.py`` draws them), and the
cross-attention's output is checked to be non-zero.

Inputs are made with numpy from a seed, and the reference's weights are
loaded with ``Transformer.params_from_jax``.  Tolerance: f32
``rtol=atol=2e-3``, the reference's parity bar.
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
from repro_torch.optim import adamw

TOL = 2e-3
WHISPER, QWEN_VL = "whisper-medium", "qwen2-vl-72b"


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)


def _models(cfg, seed=0):
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    model = T.Transformer(cfg, device="cpu", seed=seed)
    model.params_from_jax(jax.tree.map(np.asarray, params))
    return params, model


def _close(got, want, tol=TOL, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=err_msg)


def _batch(cfg, b, s, seed, embeds=False):
    """A seeded batch of the model's inputs as numpy: tokens (or unit-normal
    ``embeds``), labels, and unit-normal ``enc_embeds`` for an
    encoder-decoder."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s))}
    if embeds:
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)) \
            .astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s))
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------- cross-attention ----
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("train", [False, True])
def test_cross_attention_matches_jax(train, s):
    """``cross_attention`` on the reference's weights, S 5 or a decode
    step's 1 over 16 encoder frames, on the serving path (the flash
    kernel's plain version here) and the training path
    (``scan_attention``); non-zero."""
    cfg = _cfg(WHISPER)
    p = jax.tree.map(np.array, JL.gqa_init(jax.random.PRNGKey(1), cfg,
                                           jnp.float32))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)) \
        .astype(np.float32)
    want, _ = jax.jit(lambda p_, x_, e_: JL.cross_attention(
        p_, cfg, x_, e_, rules=None))(p, x, enc)
    got = L.cross_attention({k: torch.from_numpy(v) for k, v in p.items()},
                            cfg, torch.from_numpy(x), torch.from_numpy(enc),
                            train=train)
    assert got.shape == (2, s, cfg.d_model)
    assert float(got.norm()) > 0.1
    _close(got, want)


def test_cross_attention_gradients_match_jax():
    """Gradients of ``(cross_attention(x, enc)·w).sum()`` in x, the
    encoder output and every weight, on the training path, against
    ``jax.grad``."""
    cfg = _cfg(WHISPER)
    p = jax.tree.map(np.array, JL.gqa_init(jax.random.PRNGKey(2), cfg,
                                           jnp.float32))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)) \
        .astype(np.float32)
    w = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)

    def jloss(p_, x_, e_):
        return (JL.cross_attention(p_, cfg, x_, e_, rules=None)[0] * w).sum()
    wg_p, wg_x, wg_e = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        p, x, enc)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx, te = (torch.from_numpy(a).requires_grad_() for a in (x, enc))
    (L.cross_attention(tp, cfg, tx, te, train=True)
     * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, wg_x, err_msg="x")
    _close(te.grad, wg_e, err_msg="enc_out")
    for k, v in tp.items():
        _close(v.grad, wg_p[k], err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_encoder_matches_jax(train):
    """The encoder over seeded frames (the projection, the non-causal
    blocks with RoPE, ``ln_enc``) against the reference's ``_encoder``."""
    cfg = _cfg(WHISPER)
    params, model = _models(cfg, seed=3)
    enc = _batch(cfg, 2, 4, seed=3)["enc_embeds"]
    want = jax.jit(lambda p, e: JT._encoder(cfg, p, e, None))(params, enc)
    got = model._encoder(torch.from_numpy(enc), "cuda", train)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    _close(got, want)


# ------------------------------------------------------------ the models ----
@pytest.mark.parametrize("arch", [WHISPER, QWEN_VL])
def test_forward_matches_jax(arch):
    """whisper on tokens and seeded frames; qwen2-vl on seeded
    embeddings and on tokens."""
    cfg = _cfg(arch)
    params, model = _models(cfg, seed=4)
    fwd = jax.jit(lambda p, b: JT.forward(cfg, p, b))
    for embeds in ([False] if arch == WHISPER else [True, False]):
        batch = _batch(cfg, 2, 12, seed=4, embeds=embeds)
        del batch["labels"]
        got = model(_t(batch))
        assert got.shape == (2, 12, cfg.vocab_size)
        _close(got, fwd(params, _j(batch)))


@pytest.mark.parametrize("arch", [WHISPER, QWEN_VL])
def test_prefill_and_decode_match_jax(arch):
    """A batched prefill of 10 positions plus 4 decode steps, against the
    reference's ``decode_step``: the logits and the KV caches after every
    step.  whisper's steps all take the same seeded frames (the encoder
    runs in each); qwen2-vl's prefill takes embeddings, its decode steps
    tokens."""
    cfg = _cfg(arch)
    params, model = _models(cfg, seed=5)
    b, s, gen = 2, 10, 4
    first = _batch(cfg, b, s, seed=5, embeds=arch == QWEN_VL)
    toks = _batch(cfg, b, gen, seed=6)["tokens"]
    jdecode = jax.jit(lambda p, bt, c, n: JT.decode_step(cfg, p, bt, c, n))
    jcache = JT.init_cache(cfg, b, s + gen)
    cache = model.init_cache(b, s + gen)
    for step in range(gen + 1):
        if step == 0:
            batch, lo = {k: v for k, v in first.items() if k != "labels"}, 0
        else:
            batch, lo = {"tokens": toks[:, step - 1:step]}, s + step - 1
            if cfg.encoder_layers:
                batch["enc_embeds"] = first["enc_embeds"]
        want, jcache = jdecode(params, _j(batch), jcache, jnp.int32(lo))
        got, cache = model.decode_step(_t(batch), cache, lo)
        _close(got, want)
        for mine, theirs in zip(cache, jcache, strict=True):
            _close(mine, theirs)


def test_whisper_decode_matches_forward():
    """8 tokens decoded one at a time over the same seeded frames against
    the teacher-forced forward (f32, on the port alone)."""
    cfg = _cfg(WHISPER)
    model = T.Transformer(cfg, device="cpu", seed=0)
    batch = _t(_batch(cfg, 2, 8, seed=7))
    with torch.inference_mode():
        full = model(batch)
        cache = model.init_cache(2, 8)
        outs = []
        for i in range(8):
            lg, cache = model.decode_step(
                {"tokens": batch["tokens"][:, i:i + 1],
                 "enc_embeds": batch["enc_embeds"]}, cache, i)
            outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy())


@pytest.mark.parametrize("arch", [WHISPER, QWEN_VL])
def test_train_step_matches_jax(arch):
    """One train step (f32): the loss and every gradient against
    ``jax.grad`` of the reference's loss, and the updated parameters
    against the reference's train step; whisper on tokens and seeded
    frames, qwen2-vl on the ``"embeds"`` data kind's batch (labels zeros),
    whose token embedding gets no gradient here and zeros there (AdamW
    still decays it)."""
    cfg = _cfg(arch)
    params, model = _models(cfg, seed=8)
    batch = _batch(cfg, 2, 12, seed=8, embeds=arch == QWEN_VL)
    if arch == QWEN_VL:
        batch["labels"] = np.zeros_like(batch["labels"])
    loss_fn = jax_steps.make_loss_fn(cfg, rules=None)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, b)[0]))(params, _j(batch))
    ocfg = adamw.OptConfig(lr=1e-2, warmup_steps=1)
    step = steps.make_train_step(model, ocfg)
    before = [p.detach().clone() for p in model.parameters()]
    state, m = step(adamw.init(model.parameters()), _t(batch))
    assert float(m["loss"]) == pytest.approx(float(want_loss), rel=1e-5)
    for (name, p), w in zip(model.named_parameters(),
                            model.from_tree(want_grads), strict=True):
        _close(torch.zeros_like(p) if p.grad is None else p.grad,
               np.asarray(w), err_msg=name)
    assert (model.tok["embed"].grad is None) == (arch == QWEN_VL)
    jstep = jax_steps.make_train_step(
        cfg, JOptConfig(**dataclasses.asdict(ocfg)), rules=None, jit=True)
    new_params, _, _ = jstep(params, jax_adamw.init(params), _j(batch))
    for (name, p), w, b in zip(model.named_parameters(),
                               model.from_tree(new_params), before,
                               strict=True):
        assert not torch.equal(p, b), name
        _close(p, np.asarray(w), err_msg=name)


def test_decay_set_and_tree_of_the_encoder_decoder():
    """The reference's tree: ``frontend_proj``, the decoder's ``layers``
    with ``ln_x`` / ``xattn``, the encoder's ``enc_layers`` (no
    cross-attention) and ``ln_enc``; ``to_tree`` inverts ``from_tree``.
    The rank rule on the stacked tree decays every leaf but ``ln_f`` and
    ``ln_enc`` (1-D); ``frontend_proj`` is decayed."""
    cfg = _cfg(WHISPER)
    params, model = _models(cfg, seed=9)
    got = model.params_to_jax()
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params),
                    strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert "xattn" in got["layers"] and "xattn" not in got["enc_layers"]
    named = dict(zip((n for n, _ in model.named_parameters()),
                     model.decay_mask()))
    assert {n for n, dk in named.items() if not dk} == {"ln_f", "ln_enc"}
    assert named["frontend_proj"] and named["blocks.1.ln_x"]
    ps = [p.detach() for p in model.parameters()]
    for a, b in zip(model.from_tree(model.to_tree(ps)), ps, strict=True):
        assert torch.equal(a, b)
    qwen = T.Transformer(_cfg(QWEN_VL), device="cpu")
    assert dict(zip((n for n, _ in qwen.named_parameters()),
                    qwen.decay_mask()))["frontend_proj"]
    del params["enc_layers"]
    with pytest.raises(ValueError, match="keys"):
        model.params_from_jax(params)


@pytest.mark.parametrize("arch", [WHISPER, QWEN_VL])
def test_checkpoints_move_both_ways(arch, tmp_path):
    """The reference writes its ``(params, opt_state)`` tree (bf16
    weights, the encoder's and the frontend's leaves); the port's
    ``restore`` reads it leaf for leaf, writes it again, and the
    reference's ``restore`` reads the port's step back: the same leaves
    and manifest text both ways."""
    cfg = get_config(arch, reduced=True)
    params = JT.init_params(cfg, jax.random.PRNGKey(10))
    rng = np.random.default_rng(10)
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


@pytest.mark.parametrize("arch", [WHISPER, QWEN_VL])
def test_clis_serve_and_train_on_the_cpu(arch, capsys):
    """``launch.serve`` (whisper's frames are zeros, as the reference's
    CLI feeds them) and ``launch.train`` (whisper on tokens and zero
    frames; qwen2-vl on the ``"embeds"`` data kind) at ``--reduced
    --device cpu``: tokens in range, finite losses; whisper's serve run
    launches nothing (the flash kernel's plain version runs on the
    CPU)."""
    ops.reset_launch_counts()
    tokens = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert tokens.shape == (2, 3)
    assert ((tokens >= 0) & (tokens < 256)).all()
    run = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--log-every", "100"])
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert "sample:" in capsys.readouterr().out
    assert sum(ops.launch_counts().values()) == 0
