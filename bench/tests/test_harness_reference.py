"""The plain references against the port's plain CPU path at the
configurations' ``REDUCED`` sizes, and the frozen input generators
against the program's."""
import dataclasses

import numpy as np
import pytest

from bench import compare, frozen, generate
from bench.families import gcn, lm
from repro_torch.configs import gcn as gcn_configs
from repro_torch.configs import stablelm_1_6b
from repro_torch.core.sparse import random as program_random
from repro_torch.data.pipeline import DataConfig, SyntheticStream


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_frozen_graphs_match_the_program(seed):
    a = program_random.banded_spd(300, 8, seed=seed)
    ptr, idx = frozen.banded_pattern(300, 8, seed=seed)
    np.testing.assert_array_equal(ptr, a.indptr)
    np.testing.assert_array_equal(idx, a.indices)
    a = program_random.powerlaw_graph(300, 14, 2.1, seed=seed)
    ptr, idx = frozen.powerlaw_pattern(300, 14, 2.1, seed=seed)
    np.testing.assert_array_equal(ptr, a.indptr)
    np.testing.assert_array_equal(idx, a.indices)


@pytest.mark.parametrize("params", [
    {"generator": "banded", "bandwidth": 8},
    {"generator": "powerlaw", "avg_deg": 14, "alpha": 2.1}])
def test_graph_files_and_the_permutation(params):
    """A traffic's generator is found by its file name; ``permute`` gives
    the same graph with its nodes relabelled, from the seed."""
    seed = 2**31 + 11
    ptr, idx = generate.graph({"graph": params}, 300, seed)
    want = (frozen.banded_pattern(300, 8, seed) if "bandwidth" in params
            else frozen.powerlaw_pattern(300, 14, 2.1, seed))
    np.testing.assert_array_equal(ptr, want[0])
    np.testing.assert_array_equal(idx, want[1])
    shuffled = dict(params, permute=True)
    pptr, pidx = generate.graph({"graph": shuffled}, 300, seed)
    again = generate.graph({"graph": shuffled}, 300, seed)
    np.testing.assert_array_equal(pidx, again[1])
    assert not np.array_equal(pptr, ptr) or not np.array_equal(pidx, idx)
    dense = np.zeros((300, 300), bool)
    dense[np.repeat(np.arange(300), np.diff(ptr)), idx] = True
    pdense = np.zeros((300, 300), bool)
    pdense[np.repeat(np.arange(300), np.diff(pptr)), pidx] = True
    perm = np.random.default_rng([seed, 1]).permutation(300)
    np.testing.assert_array_equal(pdense[np.ix_(perm, perm)], dense)
    with pytest.raises(FileNotFoundError):
        generate.graph({"graph": {"generator": "nonesuch"}}, 300, seed)


def test_frozen_stream_matches_the_program():
    stream = SyntheticStream(DataConfig(vocab_size=1000, seq_len=32,
                                        global_batch=3, seed=5))
    for step in (0, 4):
        want = stream.batch_at(step)
        got = frozen.lm_batch_at(5, step, 3, 32, 1000)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def gcn_reduced():
    r = gcn_configs.REDUCED
    return dict(generate.load("configs", "gcn-ogbn-arxiv"),
                n_nodes=r.n_nodes, in_dim=r.in_dim, hidden_dim=r.hidden_dim,
                out_dim=r.out_dim, n_layers=r.n_layers)


def lm_reduced(dtype):
    fields = dataclasses.asdict(stablelm_1_6b.REDUCED)
    cfg = generate.load("configs", "stablelm-1.6b-sparse-band")
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab_size")
    return dict(cfg, **{k: fields[k] for k in keys}, dtype=dtype)


@pytest.mark.parametrize("traffic", ["fullbatch.band",
                                     "fullbatch.powerlaw"])
def test_gcn_reference_matches_the_port(traffic):
    sess = gcn.Session(gcn_reduced(), generate.load("traffic", traffic), 3,
                       "cpu")
    sess.setup()
    gaps = compare.gaps(sess.readings, sess.reference())
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-5 and gaps["change_gap"] < 1e-5


def test_lm_reference_matches_the_port_in_f32():
    traffic = dict(generate.load("traffic", "stream.4x2048"), seq_len=64)
    sess = lm.Session(lm_reduced("float32"), traffic, 3, "cpu")
    sess.setup()
    gaps = compare.gaps(sess.readings, sess.reference())
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4
