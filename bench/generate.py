"""The one generator of inputs: it reads a traffic mix (a data file under
``traffic/``) and a configuration (``configs/``) and makes a cell's inputs
and weights from the run's seed.

Every stream of random numbers comes from its own child of
``numpy.random.SeedSequence(seed)``, so any whole number up to 2**63 is a
seed, and the same seed gives the same graph, features, labels, weights
and batches.  Tensors are drawn on the run's device with a
``torch.Generator`` there, in a few large calls.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import torch

from . import frozen

HERE = Path(__file__).resolve().parent
STREAMS = ("graph", "features", "labels", "weights", "batches")


def load(kind: str, name: str) -> dict:
    """``configs/<name>.json``, ``traffic/<name>.json`` or
    ``limits/<name>.json``."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return json.loads(path.read_text())


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of this folder (a graph generator
    under ``graphs/``, a metric's reader under ``metrics/``)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"bench.{kind}.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seeds(seed: int) -> dict:
    """One 32-bit seed a stream, from the run's seed."""
    words = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS))
    return {k: int(w) for k, w in zip(STREAMS, words)}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------- graphs ----
def graph(traffic: dict, n_nodes: int, seed: int) -> tuple:
    """``(indptr, indices)`` of the traffic's graph at ``n_nodes``, unit
    weights implied.  ``graph.generator`` names a file under ``graphs/``
    whose ``pattern(n_nodes, params, seed)`` makes the pattern; with
    ``graph.permute`` true, the nodes are then relabelled by a permutation
    drawn from the same seed (the same graph, its locality hidden)."""
    g = traffic["graph"]
    indptr, indices = module("graphs", g["generator"]).pattern(n_nodes, g,
                                                              seed)
    return permuted(indptr, indices, seed) if g.get("permute") else \
        (indptr, indices)


def permuted(indptr: np.ndarray, indices: np.ndarray, seed: int) -> tuple:
    """The pattern with node ``i`` renamed ``perm[i]``, rows and columns
    alike."""
    n = indptr.shape[0] - 1
    perm = np.random.default_rng([seed, 1]).permutation(n)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    return frozen._pattern(n, perm[rows], perm[indices])


def gcn_inputs(cfg: dict, seeds: dict, device) -> tuple:
    """Node features ``N(0, 1)`` ``(n, in_dim)``, labels uniform over
    ``out_dim`` classes, and each layer's weight ``randn / sqrt(fan_in)``
    (the model's own distribution), all f32 on ``device``."""
    n = cfg["n_nodes"]
    x = torch.randn(n, cfg["in_dim"], device=device,
                    generator=generator(seeds["features"], device))
    y = torch.randint(0, cfg["out_dim"], (n,), device=device,
                      generator=generator(seeds["labels"], device))
    dims = ([cfg["in_dim"]] + [cfg["hidden_dim"]] * (cfg["n_layers"] - 1)
            + [cfg["out_dim"]])
    gen = generator(seeds["weights"], device)
    weights = [torch.randn(a, b, device=device, generator=gen) / a ** 0.5
               for a, b in zip(dims[:-1], dims[1:])]
    return x, y, weights


# --------------------------------------------------------------- the LM ----
def lm_layout(cfg: dict) -> list:
    """``(name, shape, scale)`` of every weight of the sparse-band LM, in
    the program's parameter names: a gain of ones has scale ``None``; the
    token embedding is drawn at 0.02, every other matrix at
    ``1/sqrt(rows)``."""
    d, f, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    inner = cfg["n_heads"] * cfg.get("ssm_head_dim", d // cfg["n_heads"])
    out = [("tok.embed", (v, d), 0.02), ("tok.lm_head", (d, v), d ** -0.5),
           ("ln_f", (d,), None)]
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1", (d,), None), (p + "ln2", (d,), None),
                (p + "mix.wv", (d, inner), d ** -0.5),
                (p + "mix.wz", (d, inner), d ** -0.5),
                (p + "mix.w_down", (inner, d), inner ** -0.5),
                (p + "ffn.w_gate", (d, f), d ** -0.5),
                (p + "ffn.w_up", (d, f), d ** -0.5),
                (p + "ffn.w_down", (f, d), f ** -0.5)]
    return out


def lm_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight of ``lm_layout`` as a view of one flat tensor of the
    configuration's dtype: one normal draw, clipped to [-2, 2], then each
    matrix scaled and each gain set to ones."""
    layout = lm_layout(cfg)
    sizes = [int(np.prod(shape)) for _, shape, _ in layout]
    flat = torch.empty(sum(sizes), dtype=getattr(torch, cfg["dtype"]),
                       device=device)
    flat.normal_(generator=generator(seed, device)).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for (name, shape, scale), size in zip(layout, sizes):
        t = flat[at:at + size].view(shape)
        if scale is None:
            t.fill_(1.0)
        else:
            t.mul_(scale)
        out[name] = t
        at += size
    return out


def lm_batch(traffic: dict, cfg: dict, seed: int, step: int) -> dict:
    """Batch ``step`` of the traffic's token stream, numpy int32."""
    if traffic["stream"] != "zipf_cube":
        raise ValueError(f"unknown token stream {traffic['stream']!r}")
    return frozen.lm_batch_at(seed, step, traffic["batch"],
                              traffic["seq_len"], cfg["vocab_size"])
