"""The block patterns other than the plain ``attn`` decoder, split over a
``MeshExecutor``'s members, on CPU meshes.

MLA (minicpm3-4b), ``attn+mamba`` (hymba-1.5b), ``sparse-band``
(stablelm-1.6b's band variant), ``mlstm7+slstm`` (xlstm-1.3b) and the
encoder-decoder (whisper-medium), ``REDUCED`` in f32, on CPU meshes (2, 2)
and (1, 2) (``"cpu"`` repeated; every pattern's heads divide the model
axis there) and hymba on (1, 8), where its 4 heads do not:

- the forward, prefill + 4 decode steps with a ``MeshCache``, the cache
  gathered whole, against the port unsharded (``SELF_TOL``);
- one ZeRO-1 step against the unsharded trainer: the loss and grad norm,
  each leaf's gradient summed over the members against the unsharded
  gradient (normwise, ``SELF_TOL``), and each leaf's update against
  AdamW applied unsharded to those gradients (``UPDATE_TOL``); for every
  pattern but xLSTM also each leaf's update against the unsharded step's
  in f64 (``UPDATE_TOL``).  xLSTM's is not held that way: its ``REDUCED``
  heads are 512 wide, its recurrences run in f32 whatever the model's
  dtype, and the model grows f32 rounding several hundredfold, so one
  near-zero gradient element flips the sign of AdamW's first update
  (±lr), which alone exceeds the bar as a normwise gap.  Its split
  gradients are held instead to lie within twice the unsharded f32
  model's distance from an f64 model's;
- ``sharding.comm_bytes`` against formulas written here from the
  configs: no weight gathered (``MeshExecutor.full``) where the heads and
  slices divide, no cache region rebuilt or written back for a cache
  split by heads (its blocks are read in place), and the activation
  gathers the mamba and xLSTM blocks make;
- the per-call rule (``split_form``, ``block_bytes``) on shapes, and a
  call where it keeps the gathered form (a long prefill);
- against the reference, from one subprocess on forced host devices: each
  pattern's forward on a (1, 2) mesh under the reference's rules
  (``TOL``), and one ZeRO-1 step on (2, 2) in f64 (the loss and grad norm;
  every leaf's update at ``UPDATE_TOL`` but xLSTM's).
"""
import contextlib
import copy
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.launch import partitioning, steps
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.models.sharding import Mesh
from repro_torch.optim import OptConfig, adamw

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-3
SELF_TOL = 1e-4
UPDATE_TOL = 1e-3
MODELS = ["minicpm3-4b", "hymba-1.5b", "sparse-band", "xlstm-1.3b",
          "whisper-medium"]
MESHES = [(2, 2), (1, 2)]
CELLS = [(a, m) for a in MODELS for m in MESHES]
IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in CELLS]
BATCH, SEQ, PROMPT = 4, 12, 8
OPT = OptConfig(lr=3e-4, warmup_steps=1, total_steps=10)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the models are small, and several test workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_cfg(arch, dtype="float32"):
    if arch == "sparse-band":
        return dataclasses.replace(ref_get_config("stablelm-1.6b", True),
                                   block_pattern="sparse-band", dtype=dtype)
    return dataclasses.replace(ref_get_config(arch, True), dtype=dtype)


def _cfg(arch, dtype="float32"):
    if arch == "sparse-band":
        return dataclasses.replace(get_config("stablelm-1.6b", True),
                                   block_pattern="sparse-band", dtype=dtype)
    return dataclasses.replace(get_config(arch, True), dtype=dtype)


def _batch(cfg, b, s, seed=1):
    """The inputs both sides build from ``seed`` (numpy)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _train_batch(cfg, dtype=np.float32):
    """Tokens of ``SEQ`` positions and their next tokens as labels."""
    b = _batch(cfg, BATCH, SEQ + 1)
    out = {"tokens": b["tokens"][:, :-1], "labels": b["tokens"][:, 1:]}
    if "enc_embeds" in b:
        out["enc_embeds"] = b["enc_embeds"].astype(dtype)
    return out


# --------------------------------------------------------------------------
# The reference on forced host devices (one subprocess, started early)
# --------------------------------------------------------------------------
_REF_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
assert len(jax.devices()) == 4, jax.devices()
from repro.launch import partitioning as RP
from repro.launch import steps as RS
from repro.models import transformer as RT
from repro.optim import adamw as RA
from test_torch_tp_blocks import (MODELS, BATCH, SEQ, _batch, _ref_cfg,
                                  _train_batch)
out = {}
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
for arch in MODELS:
    cfg = _ref_cfg(arch)
    rules = RP.make_rules(cfg, mesh)
    p = RT.init_params(cfg, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, BATCH, SEQ).items()}
    with mesh:
        out[f"fwd/{arch}"] = np.asarray(jax.jit(
            lambda p, b: RT.forward(cfg, p, b, rules=rules))(p, batch))
jax.config.update("jax_enable_x64", True)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
opt = RA.OptConfig(lr=3e-4, warmup_steps=1, total_steps=10)
for arch in MODELS:
    cfg = _ref_cfg(arch, "float64")
    rules = RP.make_rules(cfg, mesh)
    p = RT.init_params(cfg, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v)
             for k, v in _train_batch(cfg, np.float64).items()}
    with mesh:
        p2, _, m = RS.make_train_step(cfg, opt, rules, jit=True)(
            p, RA.init(p), batch)
    out[f"train/{arch}/loss"] = np.asarray(m["loss"])
    out[f"train/{arch}/grad_norm"] = np.asarray(m["grad_norm"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(p2)[0]:
        key = "/".join(str(getattr(q, "key", q)) for q in path)
        out[f"train/{arch}/p1/{key}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
print("REF OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _ref_proc(tmp_path_factory):
    """The reference's side on 4 forced host devices, running beside the
    in-process cells from the first test of this file on."""
    path = tmp_path_factory.mktemp("ref_tp") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(REPO_ROOT, "src"),
                    os.path.join(REPO_ROOT, "tests"),
                    os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    proc = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, str(path)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(_ref_proc):
    proc, path = _ref_proc
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    assert "REF OK" in out
    return dict(np.load(path))


# --------------------------------------------------------------------------
# Models and meshes
# --------------------------------------------------------------------------
_MODELS = {}


def _model(arch, dtype="float32"):
    """The port's ``REDUCED`` model with the reference's weights
    (``PRNGKey(0)``), built on the meta device and filled (exactly, as
    tensors), so the port's own draws are skipped."""
    if (arch, dtype) not in _MODELS:
        model = T.Transformer(_cfg(arch, dtype), device="meta").to_empty(
            device="cpu")
        model.params_from_jax(_ref_params(arch, dtype))
        _MODELS[(arch, dtype)] = model
    return _MODELS[(arch, dtype)]


def _ref_params(arch, dtype="float32"):
    """The reference's initial tree as tensors (f64 needs x64 on)."""
    with jax.enable_x64(dtype == "float64"):
        p = RT.init_params(_ref_cfg(arch, dtype), jax.random.PRNGKey(0))
        return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


def _rules(cfg, shape):
    return partitioning.make_rules(
        cfg, Mesh(np.full(shape, "cpu", dtype=object), ("data", "model")))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=SELF_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@contextlib.contextmanager
def _tagged_comm():
    """While active, ``sharding.count`` files each collective's bytes
    under the executor method that moved them (``full``, ``take``,
    ``put``, ``_whole_mm``, ``_gather_cols``, ``_psum_model``; else its
    kind): yields that dict."""
    plain, by = sharding.count, {}
    tags = ("full", "take", "put", "_whole_mm", "_gather_cols",
            "_psum_model")

    def count(kind, nbytes, members=2):
        f = sys._getframe(1)
        while f is not None and f.f_code.co_name not in tags:
            f = f.f_back
        tag = kind if f is None else f.f_code.co_name
        by[tag] = by.get(tag, 0) + nbytes
        plain(kind, nbytes, members)
    sharding.count = count
    try:
        yield by
    finally:
        sharding.count = plain


# --------------------------------------------------------------------------
# Against the port unsharded
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_forward_splits_and_matches_the_unsharded_run(arch, shape):
    model = _model(arch)
    rules = _rules(model.cfg, shape)
    ex = T.MeshExecutor(model, rules)
    batch = _torch(_batch(model.cfg, BATCH, SEQ))
    rows = BATCH // shape[0]
    prefix = "groups.0" if model.xlstm else "blocks.0"
    assert ex.split_form(prefix, rows, SEQ)
    if model.cfg.encoder_layers:
        assert ex.split_form("enc_blocks.0", rows, model.cfg.encoder_seq)
    with _tagged_comm() as by, torch.inference_mode():
        got = ex.forward(batch, impl="torch")
    assert "full" not in by, by
    with torch.inference_mode():
        want = model(batch, impl="torch")
    _close(got, want)


@pytest.mark.parametrize("arch,shape",
                         [c for c in CELLS if c[0] != "sparse-band"],
                         ids=[i for c, i in zip(CELLS, IDS)
                              if c[0] != "sparse-band"])
def test_prefill_decode_and_cache_match_the_unsharded_run(arch, shape):
    """Prefill + 4 decode steps on a ``MeshCache`` (a sparse-band block
    has no cache): logits, and the cache gathered whole."""
    model = _model(arch)
    rules = _rules(model.cfg, shape)
    ex = T.MeshExecutor(model, rules)
    batch = _torch(_batch(model.cfg, BATCH, SEQ))

    def run(mesh):
        cache = model.init_cache(BATCH, SEQ, rules=rules if mesh else None)
        decode = ex.decode_step if mesh else model.decode_step
        outs = []
        for t0, t1 in [(0, PROMPT)] + [(t, t + 1) for t in range(PROMPT,
                                                               SEQ)]:
            step = {k: v[:, t0:t1] if k != "enc_embeds" else v
                    for k, v in batch.items()}
            logits, cache = decode(step, cache, t0, impl="torch")
            outs.append(logits)
        return torch.cat(outs, 1), cache
    with torch.inference_mode():
        want, want_cache = run(False)
        got, got_cache = run(True)
    _close(got, want)
    for a, b in zip(T._flatten(got_cache.gather()), T._flatten(want_cache),
                    strict=True):
        _close(a, b)


def _assembled_grads(ex) -> list:
    """Each parameter's gradient whole: each distinct block's gradient
    summed over the members holding it, as ``Zero1`` sums it."""
    out = []
    for k, p in enumerate(ex.model.parameters()):
        g = torch.zeros(p.shape, dtype=torch.float64)
        groups = {}
        for who in ex.mem.all():
            groups.setdefault(ex.regions[who][k], []).append(who)
        for reg, whos in groups.items():
            grads = [ex.pieces[w][k].grad for w in whos]
            if all(t is None for t in grads):
                continue
            g[tuple(slice(a, b) for a, b in reg)] = sum(
                t.double() for t in grads if t is not None)
        out.append(g)
    return out


def _gap(after, before, want_after) -> float:
    d = after.double() - before.double()
    dw = want_after.double() - before.double()
    return float((d - dw).norm() / max(float(dw.norm()), 1e-30))


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_zero1_step_matches_the_unsharded_trainer(arch, shape):
    """The loss, the grad norm, each leaf's summed gradient (normwise,
    ``SELF_TOL``), and the update the step wrote back against AdamW
    applied unsharded to those gradients (``UPDATE_TOL``)."""
    base = _model(arch)
    plain_m, mesh_m = copy.deepcopy(base), copy.deepcopy(base)
    before = [p.detach().clone() for p in base.parameters()]
    batch = _torch(_train_batch(base.cfg))
    plain = steps.make_train_step(plain_m, OPT, impl="torch")
    _, m0 = plain(adamw.init(plain_m.parameters()), batch)
    step = steps.make_train_step(mesh_m, OPT, impl="torch",
                                 rules=_rules(base.cfg, shape))
    _, m1 = step(adamw.init(mesh_m.parameters()), batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m1[key]), float(m0[key]),
                                   rtol=1e-5)
    grads = _assembled_grads(step.executor)
    names = [n for n, _ in base.named_parameters()]
    for name, g, p in zip(names, grads, plain_m.parameters()):
        want = torch.zeros_like(g) if p.grad is None else p.grad.double()
        assert float((g - want).norm()) <= \
            SELF_TOL * float(want.norm()) + 1e-12, name
    # AdamW fed the members' gradients, unsharded
    ref_m = copy.deepcopy(base)
    params = list(ref_m.parameters())
    with torch.no_grad():
        adamw.update(OPT, [g.float() for g in grads],
                     adamw.init(params), params, ref_m.decay_mask())
    for name, got, want, b in zip(names, mesh_m.parameters(), params,
                                  before):
        assert _gap(got.detach(), b, want.detach()) < UPDATE_TOL, name


@pytest.mark.parametrize("arch", [a for a in MODELS if a != "xlstm-1.3b"])
def test_zero1_update_matches_the_unsharded_step_in_f64(arch):
    """Each leaf's update of the ZeRO-1 step on (2, 2) against the
    unsharded step's, the models in f64 (the loss's softmax stays f32)."""
    base = _model(arch, "float64")
    plain_m, mesh_m = copy.deepcopy(base), copy.deepcopy(base)
    batch = _torch(_train_batch(base.cfg, np.float64))
    steps.make_train_step(plain_m, OPT, impl="torch")(
        adamw.init(plain_m.parameters()), batch)
    steps.make_train_step(mesh_m, OPT, impl="torch",
                          rules=_rules(base.cfg, (2, 2)))(
        adamw.init(mesh_m.parameters()), batch)
    for (name, b), got, want in zip(base.named_parameters(),
                                    mesh_m.parameters(),
                                    plain_m.parameters()):
        assert _gap(got.detach(), b.detach(), want.detach()) < UPDATE_TOL, \
            name


def test_xlstm_split_gradients_are_as_close_to_f64_as_unsharded_ones():
    """xLSTM on (1, 2): the f32 split model's gradients lie within twice
    the unsharded f32 model's distance from an f64 model's (same weights;
    its recurrences are f32 inside), normwise at the worst leaf: the
    split's reordered sums add rounding of the size the model's own f32
    rounding has, and the model grows both alike."""
    model = _model("xlstm-1.3b")
    m64 = T.Transformer(_cfg("xlstm-1.3b", "float64"),
                        device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for a, b in zip(m64.parameters(), model.parameters()):
            a.copy_(b)
    batch = _torch(_train_batch(model.cfg))

    def grads(fwd, m):
        m.zero_grad(set_to_none=True)
        steps.cross_entropy(fwd(batch, impl="torch", train=True),
                            batch["labels"]).backward()
        out = [p.grad.double().clone() for p in m.parameters()]
        m.zero_grad(set_to_none=True)
        return out

    def worst(gs, want):
        return max(float((g - w).norm() / w.norm().clamp_min(1e-30))
                   for g, w in zip(gs, want))
    want = grads(m64, m64)
    unsharded = worst(grads(model, model), want)
    split = worst(grads(T.MeshExecutor(model, _rules(model.cfg, (1, 2)))
                        .forward, model), want)
    assert split <= 2 * unsharded, (split, unsharded)


def test_heads_not_dividing_the_model_axis():
    """hymba ``REDUCED`` on (1, 8): 4 heads and 2 kv heads on 8 members,
    the weights still sliced; every member computes all heads (``wq`` /
    ``wk`` / ``wv`` gathered, all mamba heads) and its rows of ``wo``."""
    model = _model("hymba-1.5b")
    rules = _rules(model.cfg, (1, 8))
    ex = T.MeshExecutor(model, rules)
    assert not rules.shard_heads and ex.gather_q and ex.gather_kv
    assert not ex.split_heads and ex.sliced("blocks.0.attn.wo")
    assert ex.split_form("blocks.0", BATCH, 1)
    batch = _torch(_batch(model.cfg, BATCH, PROMPT + 1))
    with torch.inference_mode():
        got = ex.forward(batch, impl="torch")
        want = model(batch, impl="torch")
        cache = model.init_cache(BATCH, PROMPT + 1, rules=rules)
        want_cache = model.init_cache(BATCH, PROMPT + 1)
        for t0, t1 in ((0, PROMPT), (PROMPT, PROMPT + 1)):
            step = {"tokens": batch["tokens"][:, t0:t1]}
            g, _ = ex.decode_step(step, cache, t0, impl="torch")
            w, _ = model.decode_step(step, want_cache, t0, impl="torch")
            _close(g, w)
    _close(got, want)
    for a, b in zip(T._flatten(cache.gather()), T._flatten(want_cache)):
        _close(a, b)


# --------------------------------------------------------------------------
# The collectives
# --------------------------------------------------------------------------
def _forward_bytes(cfg, rows, s):
    """The collective bytes of a split forward on (1, 2), f32: member
    activations of ``rows`` × ``s`` positions; a psum of ``n = 2`` hands
    ``2 (n - 1)`` partials, an all-gather ``n - 1`` of its ``n`` parts."""
    act = rows * s * cfg.d_model * 4
    inner = cfg.n_heads * cfg.ssm_head_dim
    psum = 2 * act
    layers = cfg.n_layers
    gathers = 0
    if cfg.block_pattern == "mlstm7+slstm":
        # per group: 7 mLSTM (x·W_up as an activation, 2·inner wide; heads
        # split: q / k / v local) and the sLSTM (x·W_up, 4·inner wide)
        groups = layers // 8
        n_psum = 1 + 8 * groups
        gathers = groups * (7 * rows * s * 2 * inner + rows * s * 4 * inner) \
            * 4
    elif cfg.block_pattern == "attn+mamba":
        # x·W_in (2·inner) and the heads' output (inner) as activations;
        # one psum for attention + mamba, one for the FFN
        n_psum = 1 + 2 * layers
        gathers = layers * rows * s * 3 * inner * 4
    elif cfg.encoder_layers:
        se = cfg.encoder_seq
        n_psum = 1 + 3 * layers
        psum_enc = 2 * cfg.encoder_layers * 2 * (rows * se * cfg.d_model * 4)
        return n_psum * psum + psum_enc, gathers
    else:
        n_psum = 1 + 2 * layers
    return n_psum * psum, gathers


@pytest.mark.parametrize("arch", MODELS)
def test_collectives_of_a_split_forward(arch):
    """(1, 2): the psums and activation gathers of ``_forward_bytes``, no
    weight gathered, the logits gathered once over the model axis."""
    model = _model(arch)
    cfg = model.cfg
    ex = T.MeshExecutor(model, _rules(cfg, (1, 2)))
    sharding.reset_comm_bytes()
    with _tagged_comm() as by, torch.inference_mode():
        ex.forward(_torch(_batch(cfg, BATCH, PROMPT)), impl="torch")
    psum, gathers = _forward_bytes(cfg, BATCH, PROMPT)
    assert sharding.comm_bytes["psum"] == psum
    assert sharding.comm_bytes["all_gather"] == gathers
    assert "full" not in by
    assert sharding.comm_bytes["gather"] == \
        BATCH * PROMPT * cfg.vocab_size // 2 * 4


@pytest.mark.parametrize("arch", ["whisper-medium", "hymba-1.5b",
                                  "minicpm3-4b"])
def test_split_caches_are_read_in_place(arch):
    """A decode step on (1, 2) after the prefill: the kv heads (whisper,
    hymba), hymba's mamba state split by heads, and MLA's replicated
    latent are each member's own block, so ``take`` / ``put`` move
    nothing; what the step gathers are hymba's activations alone."""
    model = _model(arch)
    cfg = model.cfg
    rules = _rules(cfg, (1, 2))
    ex = T.MeshExecutor(model, rules)
    batch = _torch(_batch(cfg, BATCH, PROMPT + 1))
    cache = model.init_cache(BATCH, PROMPT + 1, rules=rules)
    with torch.inference_mode():
        ex.decode_step({k: v[:, :PROMPT] if k == "tokens" else v
                        for k, v in batch.items()}, cache, 0, impl="torch")
        sharding.reset_comm_bytes()
        with _tagged_comm() as by:
            ex.decode_step({k: v[:, PROMPT:] if k == "tokens" else v
                            for k, v in batch.items()}, cache, PROMPT,
                           impl="torch")
    assert "take" not in by and "put" not in by, by
    inner = cfg.n_heads * cfg.ssm_head_dim
    want = cfg.n_layers * BATCH * 3 * inner * 4 \
        if cfg.block_pattern == "attn+mamba" else 0
    assert sharding.comm_bytes["all_gather"] == want
    for k in range(len(cache.leaves)):
        needs = ex._needs(cache, k, 0, True)
        assert cache.moved(k, needs) == 0


def test_xlstm_state_written_to_every_replica():
    """xLSTM's mLSTM state is replicated (``cache_shardings``): a decode
    step on (1, 2) writes each member's heads into the other member's
    copy (``put``), 7 blocks of ``(rows, 1 head, dh, dh + 1)`` f32 each
    way a group, and both copies stay equal to the unsharded state."""
    model = _model("xlstm-1.3b")
    cfg = model.cfg
    rules = _rules(cfg, (1, 2))
    ex = T.MeshExecutor(model, rules)
    batch = _torch(_batch(cfg, BATCH, 1))
    cache = model.init_cache(BATCH, 4, rules=rules)
    want_cache = model.init_cache(BATCH, 4)
    with _tagged_comm() as by, torch.inference_mode():
        ex.decode_step(batch, cache, 0, impl="torch")
    with torch.inference_mode():
        model.decode_step(batch, want_cache, 0, impl="torch")
    dh = cfg.ssm_head_dim
    groups = cfg.n_layers // 8
    assert by["put"] == groups * 2 * 7 * BATCH * dh * (dh + 1) * 4
    assert "take" not in by and "full" not in by
    parts = list(cache.parts[0].values())
    assert torch.equal(parts[0], parts[1])
    _close(parts[0], want_cache["mlstm"])


# --------------------------------------------------------------------------
# The rule
# --------------------------------------------------------------------------
def test_rule_on_shapes():
    """``block_bytes`` on (1, 2), f32, against the formulas: the split
    form's psums and activation gathers grow with the positions, the
    gathered form's weights do not; a decode step splits, a long prefill
    keeps the gathered form."""
    model = _model("hymba-1.5b")
    cfg = model.cfg
    ex = T.MeshExecutor(model, _rules(cfg, (1, 2)))
    inner = cfg.n_heads * cfg.ssm_head_dim
    d, f = cfg.d_model, cfg.d_ff
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # every sliced weight of a block, gathered: (n - 1) of its bytes
    weights = 4 * (d * h * dh + 2 * d * hkv * dh + h * dh * d    # attn
                   + d * 2 * inner + inner * d                   # mamba
                   + 3 * d * f)                                  # ffn
    for rows, s in ((4, 1), (2, 64), (1, 4096)):
        split, gathered = ex.block_bytes("blocks.0", rows, s)
        xz = min(d * 2 * inner, rows * s * 2 * inner) * 4
        want = 2 * 2 * rows * s * d * 4 + xz + rows * s * inner * 4
        assert (split, gathered) == (want, weights), (rows, s)
        assert ex.split_form("blocks.0", rows, s) == (want < weights)
    assert ex.split_form("blocks.0", 4, 1)
    assert not ex.split_form("blocks.0", 1, 4096)
    # sparse-band: two psums against its weights
    band = _model("sparse-band")
    bx = T.MeshExecutor(band, _rules(band.cfg, (1, 2)))
    bi = band.cfg.n_heads * band.cfg.ssm_head_dim
    bw = 4 * (band.cfg.d_model * bi * 2 + 3 * band.cfg.d_model *
              band.cfg.d_ff)
    assert bx.block_bytes("blocks.0", 4, 16) == \
        (2 * 2 * 4 * 16 * band.cfg.d_model * 4, bw)


def test_rule_keeps_the_gathered_form_for_a_long_prefill():
    """sparse-band on (1, 2) at 4 × 256 positions: the psums would move
    more than the block's weights, so each block runs gathered (its
    weights through ``full``) and the result is the unsharded model's."""
    model = _model("sparse-band")
    cfg = model.cfg
    ex = T.MeshExecutor(model, _rules(cfg, (1, 2)))
    s = 256
    split, gathered = ex.block_bytes("blocks.0", BATCH, s)
    assert gathered < split
    assert not ex.split_form("blocks.0", BATCH, s)
    batch = _torch(_batch(cfg, BATCH, s))
    sharding.reset_comm_bytes()
    with _tagged_comm() as by, torch.inference_mode():
        got = ex.forward(batch, impl="torch")
    assert by["full"] == cfg.n_layers * gathered
    # the embedding's psum only
    assert sharding.comm_bytes["psum"] == 2 * BATCH * s * cfg.d_model * 4
    with torch.inference_mode():
        want = model(batch, impl="torch")
    _close(got, want)


# --------------------------------------------------------------------------
# Against the reference's runs on forced host devices
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MODELS)
def test_forward_on_a_head_splitting_mesh_matches_the_reference(ref, arch):
    model = _model(arch)
    rules = _rules(model.cfg, (1, 2))
    assert rules.shard_heads
    with torch.inference_mode():
        got = T.MeshExecutor(model, rules).forward(
            _torch(_batch(model.cfg, BATCH, SEQ)), impl="torch")
    _close(got, ref[f"fwd/{arch}"], TOL)


@pytest.mark.parametrize("arch", MODELS)
def test_zero1_step_matches_the_reference_in_f64(ref, arch):
    """The ZeRO-1 step on (2, 2) in f64 against the reference's
    ``make_train_step`` under its rules, from the same f64 weights: the
    loss and grad norm, and every leaf's update but xLSTM's (see the
    module's docstring)."""
    model = copy.deepcopy(_model(arch, "float64"))
    before = copy.deepcopy(model.param_tree())
    step = steps.make_train_step(model, OPT, impl="torch",
                                 rules=_rules(model.cfg, (2, 2)))
    _, m = step(adamw.init(model.parameters()),
                _torch(_train_batch(model.cfg, np.float64)))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]),
                                   float(ref[f"train/{arch}/{key}"]),
                                   rtol=1e-4)
    if arch == "xlstm-1.3b":
        return
    after = model.param_tree()
    gaps = {}

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], path + (k,))
            return
        key = "/".join(path)
        want = torch.from_numpy(ref[f"train/{arch}/p1/{key}"])
        gaps[key] = _gap(a, b, want)
    walk(after, before, ())
    worst = max(gaps.items(), key=lambda kv: kv[1])
    assert worst[1] < UPDATE_TOL, worst
