"""The port's LM training driver against the JAX package: the data stream,
checkpoints in the reference's layout (both ways), ``scan_attention`` and
its gradients, the dense train step, ``cfg.remat`` and the trainer's
preemption and resume.

Inputs are made with numpy from a seed, and the reference's
``init_params`` tree is loaded into the port with
``Transformer.params_from_jax``.  Tolerances: f32 ``rtol=atol=2e-3``, the
reference's parity bar (the sides sum in other orders); the largest
``scan_attention`` error seen over the cases here was 6.0e-7 forward and
9.5e-7 in the gradients (absolute).  The losses of later train steps are held to
1e-4 relative, as in ``test_torch_lm_train.py`` (Adam moves a weight with
a tiny gradient by about ±lr, so rounding-level differences could grow).
Remat and resume are held bit for bit: they recompute or replay the same
ops on the same inputs.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticStream as JSyntheticStream
from repro.launch import steps as jax_steps
from repro.launch import train as jax_train
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jax_adamw
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch import steps, train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig, adamw

TOL = 2e-3
LATER_STEP_TOL = 1e-4
B, SEQ = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _f32(arch="qwen2.5-3b", **kw):
    return dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32", **kw)


def _models(cfg, seed=0):
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    model = T.Transformer(cfg, device="cpu", seed=seed)
    model.params_from_jax(jax.tree.map(np.asarray, params))
    return params, model


def _leaves_equal(a, b) -> bool:
    """Two trees' leaves, dtype and bits (bf16 compared as its bits)."""
    la, lb = ckpt.ckpt._flatten(a)[0], ckpt.ckpt._flatten(b)[0]
    bits = ckpt.ckpt._to_numpy
    return len(la) == len(lb) and all(
        bits(x)[1] == bits(y)[1] and np.array_equal(bits(x)[0], bits(y)[0])
        for x, y in zip(la, lb))


# ------------------------------------------------------------ data stream --
@pytest.mark.parametrize("kind", ["lm", "embeds"])
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_stream_matches_jax(seed, shards, kind):
    """``batch_at`` against the reference's, array for array, for every
    shard of the layout and several steps; the shards stacked give the
    one-shard batch."""
    kw = dict(vocab_size=1000, seq_len=12, global_batch=8, seed=seed,
              kind=kind, d_model=6)
    whole = SyntheticStream(DataConfig(**kw))
    for step in (0, 1, 5, 1234):
        parts = []
        for i in range(shards):
            got = SyntheticStream(DataConfig(**kw), i, shards).batch_at(step)
            want = JSyntheticStream(JDataConfig(**kw), i,
                                    shards).batch_at(step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            parts.append(got)
        for k, v in whole.batch_at(step).items():
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), v)
    assert np.array_equal(next(iter(whole))["labels"],
                          whole.batch_at(0)["labels"])


def test_synthetic_stream_checks_the_shard_layout():
    with pytest.raises(ValueError, match="shards"):
        SyntheticStream(DataConfig(10, 4, global_batch=6), 0, 4)


# ------------------------------------------------------------ checkpoints --
def _tree():
    """f32, bf16, an int32 0-d and a NamedTuple, as a train state holds."""
    g = torch.Generator().manual_seed(3)
    return ({"w": torch.randn(3, 4, generator=g),
             "b": torch.randn(5, generator=g).to(torch.bfloat16)},
            adamw.OptState(step=torch.tensor(7, dtype=torch.int32),
                           mu={"b": torch.randn(5, generator=g)},
                           nu={"b": torch.rand(5, generator=g)}))


def test_checkpoint_round_trip(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    ckpt.save(d, 5, tree, extra={"step": 5, "arch": "x"})
    assert ckpt.latest_step(d) == 5
    got, extra = ckpt.restore(d, 5, tree)
    assert extra == {"step": 5, "arch": "x"}
    assert isinstance(got[1], adamw.OptState) and list(got[0]) == ["w", "b"]
    assert got[0]["b"].dtype == torch.bfloat16
    assert got[1].step.dtype == torch.int32 and got[1].step.dim() == 0
    assert _leaves_equal(got, tree)
    with open(os.path.join(d, "step_00000005", "manifest.json")) as f:
        manifest = f.read()
    for key in ('"n_leaves": 5', '"complete": true',
                '"dtypes": ["bfloat16", "float32", "int32", "float32", '
                '"float32"]'):
        assert key in manifest
    assert np.load(os.path.join(d, "step_00000005",
                                "leaf_00000.npy")).dtype == np.uint16
    # a half-written step is skipped, and a wrong template refused
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) == 5
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 5, ({"w": torch.zeros(4, 3), "b": tree[0]["b"]},
                            tree[1]))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(d, 5, tree[0])
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_prune(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, {"a": torch.zeros(2)})
    ckpt.prune(d, keep=2)
    assert ckpt.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]


def _jax_tree(tree):
    """The same tree as the reference holds it: jnp arrays, its OptState."""
    w = {k: jnp.asarray(ckpt.ckpt._to_numpy(v)[0].view(jnp.bfloat16)
                        if v.dtype == torch.bfloat16 else v.numpy())
         for k, v in tree[0].items()}
    st = tree[1]
    return (w, jax_adamw.OptState(
        jnp.asarray(st.step.numpy()),
        {"b": jnp.asarray(st.mu["b"].numpy())},
        {"b": jnp.asarray(st.nu["b"].numpy())}))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_layout_is_the_references(tmp_path, writer):
    """A step written by one package is read by the other's ``restore``,
    leaf for leaf; the two manifests are the same text."""
    tree = _tree()
    jtree = _jax_tree(tree)
    d_port, d_ref = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(d_port, 2, tree, extra={"step": 2})
    jax_ckpt.save(d_ref, 2, jtree, extra={"step": 2})
    with open(os.path.join(d_port, "step_00000002", "manifest.json")) as f:
        m_port = f.read()
    with open(os.path.join(d_ref, "step_00000002", "manifest.json")) as f:
        m_ref = f.read()
    assert m_port == m_ref
    if writer == "reference":
        got, extra = ckpt.restore(d_ref, 2, tree)
        assert extra == {"step": 2} and _leaves_equal(got, tree)
    else:
        got, extra = jax_ckpt.restore(d_port, 2, jtree)
        assert extra == {"step": 2}
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------- scan_attention --
#: (b, h, hkv, sq, sk, causal, window, chunk, q_offset)
ATTN_CASES = [
    (2, 4, 4, 48, 48, True, 0, 16, 0),       # sk % chunk == 0
    (2, 4, 2, 40, 40, True, 0, 16, 0),       # GQA, sk % chunk != 0
    (1, 4, 1, 37, 37, True, 8, 16, 0),       # window, one KV head
    (2, 2, 2, 20, 20, False, 0, 8, 0),       # encoder (no mask)
    (1, 4, 2, 8, 40, True, 0, 16, 32),       # q_offset (a continuation)
    (1, 2, 2, 24, 24, True, 0, 1024, 0),     # the default chunk, padded
]


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal,window,chunk,q_offset",
                         ATTN_CASES)
def test_scan_attention_matches_jax(b, h, hkv, sq, sk, causal, window, chunk,
                                    q_offset):
    """Output and the gradients of ``(out · w).sum()`` in q, k, v against
    the reference's ``chunked_attention`` and ``jax.grad`` (f32)."""
    rng = np.random.default_rng(sq * 7 + sk)
    q = rng.standard_normal((b, h, sq, 16)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, 16)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, 16)).astype(np.float32)
    w = rng.standard_normal((b, h, sq, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_offset)

    def jloss(q, k, v):
        return (JL.chunked_attention(q, k, v, **kw) * w).sum()
    want = JL.chunked_attention(q, k, v, **kw)
    wgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = L.scan_attention(tq, tk, tv, **kw)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    for name, t, g in zip("qkv", (tq, tk, tv), wgrads):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_scan_attention_keeps_the_dtype():
    x = torch.randn(1, 2, 8, 16, dtype=torch.bfloat16)
    assert L.scan_attention(x, x, x).dtype == torch.bfloat16


# ------------------------------------------------------- dense train step --
def _jax_losses_and_grads(cfg, params, batch, ocfg, n_steps):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jax_steps.make_loss_fn(cfg, rules=None)
    grads = jax.grad(lambda p: loss_fn(p, jb)[0])(params)
    step = jax_steps.make_train_step(
        cfg, JOptConfig(**dataclasses.asdict(ocfg)), rules=None, jit=True)
    state, losses = jax_adamw.init(params), []
    for _ in range(n_steps):
        params, state, m = step(params, state, jb)
        losses.append(float(m["loss"]))
    return losses, grads


def test_dense_train_step_matches_jax():
    """6 AdamW steps of qwen2.5-3b ``REDUCED`` (attention through
    ``scan_attention``) against the reference's jitted ``make_train_step``
    (f32): the step-1 gradients tensor for tensor, the losses step for
    step.  The twin of ``test_torch_lm_train.py::test_train_step_matches_
    jax`` for ``block_pattern="attn"``."""
    cfg = _f32()
    params, model = _models(cfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, SEQ))
             for k in ("tokens", "labels")}
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    want_losses, want_grads = _jax_losses_and_grads(cfg, params, batch,
                                                    ocfg, 6)
    step = steps.make_train_step(model, ocfg)
    state = adamw.init(model.parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for i in range(6):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
        if i == 0:
            for (name, p), w in zip(model.named_parameters(),
                                    model.from_tree(want_grads)):
                np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                           rtol=TOL, atol=TOL, err_msg=name)
    assert losses[0] == pytest.approx(want_losses[0], rel=1e-5)
    np.testing.assert_allclose(losses, want_losses, rtol=LATER_STEP_TOL)
    assert min(losses[2:]) < losses[0], losses


def test_param_tree_is_the_references_layout():
    """``params_to_jax`` is the inverse of ``params_from_jax``: the
    reference's tree comes back array for array; ``to_tree`` and
    ``from_tree`` invert each other in ``parameters()`` order."""
    cfg = _f32()
    params, model = _models(cfg, seed=4)
    got = model.params_to_jax()
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    ps = list(model.parameters())
    for a, b in zip(model.from_tree(model.to_tree(ps)), ps, strict=True):
        assert torch.equal(a, b)
    # bf16 comes back widened to f32, and loads back bit for bit
    bf = T.Transformer(get_config("qwen2.5-3b", reduced=True), device="cpu",
                       seed=1)
    tree = bf.params_to_jax()
    assert tree["tok"]["embed"].dtype == np.float32
    again = T.Transformer(get_config("qwen2.5-3b", reduced=True),
                          device="cpu", seed=2)
    again.params_from_jax(tree)
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(),
                                                 bf.parameters()))


def test_opt_state_tree_round_trip():
    """``state_to_tree`` gives the reference's ``OptState`` layout (int32
    0-d step, f32 moments stacked as the parameters) and
    ``state_from_tree`` takes it back."""
    cfg = get_config("qwen2.5-3b", reduced=True)
    model = T.Transformer(cfg, device="cpu", seed=0)
    state = adamw.init(model.parameters())
    g = torch.Generator().manual_seed(1)
    for m in state.mu + state.nu:
        m.copy_(torch.randn(m.shape, generator=g))
    state = state._replace(step=11)
    tree = adamw.state_to_tree(state, model)
    jstate = jax_adamw.init(JT.init_params(cfg, jax.random.PRNGKey(0)))
    assert jax.tree.structure(jax.tree.map(np.asarray, tuple(tree))) == \
        jax.tree.structure(tuple(jstate))
    assert tree.step.dtype == torch.int32 and tree.step.dim() == 0
    back = adamw.state_from_tree(tree, model)
    assert back.step == 11
    for a, b in zip(back.mu + back.nu, state.mu + state.nu, strict=True):
        assert a.dtype == torch.float32 and torch.equal(a, b)


# ------------------------------------------------------------------ remat --
def _step1_grads(cfg, remat, toks):
    model = T.Transformer(dataclasses.replace(cfg, remat=remat),
                          device="cpu", seed=0)
    steps.cross_entropy(model(toks, train=True), toks).backward()
    return [p.grad for p in model.parameters()]


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("pattern", ["attn", "sparse-band"])
def test_remat_gives_the_same_gradients(pattern, remat):
    """Step-1 gradients of every parameter under ``remat`` against
    ``"none"``, bit for bit: the backward recomputes the same ops on the
    same inputs.  The sparse-band mixer recomputes through
    ``tile_fused_matmul``'s autograd Functions (the kernel arm's glue, its
    plain kernels here)."""
    cfg = _f32("stablelm-1.6b", **(
        {} if pattern == "attn" else dict(
            block_pattern="sparse-band", band_window=8, ssm_head_dim=16)))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, SEQ)))
    want = _step1_grads(cfg, "none", toks)
    got = _step1_grads(cfg, remat, toks)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def test_remat_dots_keeps_less_than_none_and_more_than_full(monkeypatch):
    """Bytes kept for the backward by the training forward, per policy:
    what autograd saves outside the checkpointed blocks (a
    ``saved_tensors_hooks`` count, which inside a checkpointed block sees
    nothing) plus, under ``"dots"``, the outputs its policy keeps (counted
    from the policy's calls in the forward, ``mm`` / ``addmm`` alone).
    ``"full"`` < ``"dots"`` < ``"none"``."""
    cfg = _f32()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, SEQ)))
    policy, kept = T._dots_policy, []

    def counting(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and op in T.SAVED_DOTS:
            a, b = args[-2], args[-1]
            kept.append(a.shape[0] * b.shape[1] * a.element_size())
        return decision
    monkeypatch.setattr(T, "_dots_policy", counting)
    saved = {}
    for remat in ("none", "full", "dots"):
        model = T.Transformer(dataclasses.replace(cfg, remat=remat),
                              device="cpu", seed=0)
        n = [0]

        def pack(t):
            n[0] += t.numel() * t.element_size()
            return t
        kept.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = steps.cross_entropy(model(toks, train=True), toks)
        saved[remat] = n[0] + sum(kept)
        if remat == "dots":
            # 7 products a layer: q, k, v (addmm: the bias), o, gate, up,
            # down
            assert len(kept) == 7 * cfg.n_layers
        loss.backward()
    assert saved["full"] < saved["dots"] < saved["none"], saved


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat"):
        T.remat("some", lambda x: x)


# ---------------------------------------------------------------- trainer --
TRAIN = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu", "--steps",
         "8", "--batch", "2", "--seq", "16", "--ckpt-every", "3",
         "--log-every", "100"]


def _leaf_files(d, step):
    path = os.path.join(d, f"step_{step:08d}")
    return [np.load(os.path.join(path, f)) for f in sorted(os.listdir(path))
            if f.endswith(".npy")]


def test_trainer_preemption_and_exact_resume(tmp_path, capsys):
    """The twin of ``test_substrate.py::test_preemption_restart_exact_
    resume``, in-process: ``--simulate-preemption 6`` exits 17, the rerun
    resumes from step 6, and the step-8 leaves equal an uninterrupted
    run's bit for bit."""
    d1, d2 = str(tmp_path / "interrupted"), str(tmp_path / "clean")
    with pytest.raises(SystemExit) as e:
        train.main(TRAIN + ["--ckpt-dir", d1, "--simulate-preemption", "6"])
    assert e.value.code == 17
    assert ckpt.latest_step(d1) == 6
    run = train.main(TRAIN + ["--ckpt-dir", d1])
    assert "[restore] resumed from step 6" in capsys.readouterr().out
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    train.main(TRAIN + ["--ckpt-dir", d2])
    f1, f2 = _leaf_files(d1, 8), _leaf_files(d2, 8)
    assert f1 and len(f1) == len(f2)
    for a, b in zip(f1, f2):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(d1)) == [f"step_{s:08d}" for s in (3, 6, 8)]


def test_trainer_resumes_a_reference_checkpoint(tmp_path, capsys):
    """The reference's trainer writes step 3; the port's restores it and,
    with nothing left to run, saves step 3 again: the leaves (bf16 bits,
    the f32 moments, the int32 step) and the manifest's dtypes are the
    reference's.  Two more steps then train from there."""
    d = str(tmp_path / "ref")
    args = ["--arch", "qwen2.5-3b", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "16", "--log-every", "100", "--ckpt-dir", d]
    jax_train.main(args)
    shutil.copytree(d, str(tmp_path / "copy"))
    want = _leaf_files(str(tmp_path / "copy"), 3)
    run = train.main(args + ["--device", "cpu"])
    assert "[restore] resumed from step 3" in capsys.readouterr().out
    assert run.losses == []
    got = _leaf_files(d, 3)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("manifest.json",):
        with open(os.path.join(d, "step_00000003", name)) as f:
            m_port = f.read()
        with open(os.path.join(str(tmp_path / "copy"), "step_00000003",
                               name)) as f:
            m_ref = f.read()
        assert m_port == m_ref
    run = train.main(args[:4] + ["5"] + args[5:] + ["--device", "cpu"])
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()


def test_trainer_runs_on_the_card_by_default(monkeypatch):
    """``--device`` defaults to ``cuda``: with no card the trainer raises,
    it never drops to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        train.main(["--reduced", "--steps", "1"])
