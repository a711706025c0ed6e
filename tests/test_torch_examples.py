"""CPU smoke cells of the port's examples (``examples/torch_*.py``): each
runs in process with ``--device cpu`` at a few steps.  The quickstart's
fused product is held to the float64 oracle at 1e-5 (the reference
example's bar), the LM trainer is preempted and resumes from its
checkpoint, and the MoE serving example decodes and serves the subgraph
stream.  ``torch_gcn_train.py``'s cell lives in
``test_torch_gcn_train.py``."""
import importlib.util
import os

import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the models here are small, and several test
    workers share the host's cores (more threads a worker slowed these
    cells 10-60x under a parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_the_cpu(capsys):
    err = _example("torch_quickstart").main(["--device", "cpu", "--nodes",
                                             "512", "--steps", "4"])
    assert err <= 1e-5
    out = capsys.readouterr().out
    assert "fused_ratio=" in out and "4 GCN steps" in out


def test_lm_train_checkpoint_and_restart_on_the_cpu(tmp_path, capsys):
    mod = _example("torch_lm_train")
    args = ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as stop:
        mod.main(args + ["--simulate-preemption", "2"])
    assert stop.value.code == 17
    run = mod.main(args)
    assert "[restore] resumed from step 2" in capsys.readouterr().out
    assert len(run.losses) == 2
    assert run.model.cfg.name == "small-lm-25m"


def test_moe_serve_on_the_cpu(capsys):
    front = _example("torch_moe_serve").main(["--device", "cpu", "--gen",
                                              "4", "--subgraphs", "8"])
    assert front is not None
    out = capsys.readouterr().out
    assert "generated (4, 4)" in out and "served 8 subgraph requests" in out
