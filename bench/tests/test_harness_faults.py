"""Whole runs on the CPU with the timed path broken underneath: each
fault a training cell can have makes ``correct`` false under the cell's
own limits, a sound run keeps it true, and the control (the reference a
precision below the configuration's, put in the program's place) fails
them too.  The look for a card is skipped; the cells run at sizes a test
run can hold."""
import time

import pytest
import torch
import torch.nn.functional as F

from bench import compare, control, generate, harness
from bench.families import gcn as gcn_family
from bench.families import lm as lm_family
from repro_torch.core.tilefusion import api
from repro_torch.launch import steps
from repro_torch.models.gcn import GCN
from repro_torch.optim import adamw

GCN_CELLS = ["gcn-arxiv.train.band"]
LM_CELL = "stablelm-band.train"


def small_gcn(n=600, dims=(16, 32, 8)):
    return dict(generate.load("configs", "gcn-ogbn-arxiv"), n_nodes=n,
                in_dim=dims[0], hidden_dim=dims[1], out_dim=dims[2])


def small_lm():
    return dict(generate.load("configs", "stablelm-1.6b-sparse-band"),
                n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                vocab_size=512)


def small_stream():
    return dict(generate.load("traffic", "stream.4x2048"), seq_len=128)


def run(cell, seed=5):
    lm = cell == LM_CELL
    return harness.run(cell, seed, 0.2, False, device="cpu",
                       t_start=time.perf_counter(),
                       config=small_lm() if lm else small_gcn(),
                       traffic=small_stream() if lm else None,
                       log=lambda s: None)


# ------------------------------------------------------------ faults ----
def gcn_state_unchanged(monkeypatch):
    def make(model, **kwargs):
        def step(x, y):
            for w in model.weights:
                w.grad = None
            loss = model.loss(x, y)
            loss.backward()
            return loss.detach()
        return step
    monkeypatch.setattr(steps, "make_gcn_train_step", make)


def gcn_half_batch(monkeypatch):
    def loss(self, x, labels, *, backend="auto", mesh=None):
        logp = F.log_softmax(self(x, backend=backend, mesh=mesh), dim=-1)
        half = x.shape[0] // 2
        return -torch.take_along_dim(logp[:half], labels[:half, None],
                                     dim=1).mean()
    monkeypatch.setattr(GCN, "loss", loss)


def product_altered(scale):
    def plant(monkeypatch):
        orig = api.tile_fused_matmul

        def altered(*args, **kwargs):
            return orig(*args, **kwargs) * scale
        monkeypatch.setattr(api, "tile_fused_matmul", altered)
    return plant


def lm_state_unchanged(monkeypatch):
    monkeypatch.setattr(adamw, "update",
                        lambda cfg, grads, state, params, decay:
                        (state, {"grad_norm": torch.zeros(()), "lr": 0.0}))


def lm_half_batch(monkeypatch):
    orig = steps.cross_entropy
    monkeypatch.setattr(steps, "cross_entropy", lambda logits, labels: orig(
        logits[: logits.shape[0] // 2], labels[: labels.shape[0] // 2]))


GCN_FAULTS = {"state_unchanged": gcn_state_unchanged,
              "half_batch": gcn_half_batch,
              "product_altered": product_altered(1.001)}
LM_FAULTS = {"state_unchanged": lm_state_unchanged,
             "half_batch": lm_half_batch,
             "product_altered": product_altered(1.05)}


@pytest.mark.parametrize("cell", GCN_CELLS + [LM_CELL])
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("fault", sorted(GCN_FAULTS))
@pytest.mark.parametrize("cell", GCN_CELLS)
def test_gcn_faults_are_not_correct(cell, fault, monkeypatch):
    GCN_FAULTS[fault](monkeypatch)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("fault", sorted(LM_FAULTS))
def test_lm_faults_are_not_correct(fault, monkeypatch):
    LM_FAULTS[fault](monkeypatch)
    assert not run(LM_CELL)["correct"]


# ----------------------------------------------------------- control ----
@pytest.mark.parametrize("cell", GCN_CELLS + [LM_CELL])
def test_the_control_is_not_correct(cell):
    w = harness.find_cell(harness.manifest(), cell)
    limits = generate.load("limits", cell)
    if cell == LM_CELL:
        sess = lm_family.Session(small_lm(), small_stream(), 2, "cpu")
    else:
        sess = gcn_family.Session(small_gcn(2000, (32, 64, 16)),
                                  generate.load("traffic", w["traffic"]),
                                  2, "cpu")
    sess.setup()
    sess.close()
    ref = sess.reference()
    low = sess.reference(control.LOWER[sess.cfg["dtype"]])
    assert compare.judge(compare.gaps(sess.readings, ref), limits)
    assert not compare.judge(compare.gaps(low, ref), limits)
