"""Batched serving: an LM's prefill and greedy decoding, or a stream of
sampled subgraphs through the tile-fusion serving tier.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --subgraphs 24 \\
        --subgraph-nodes 256 --feat-dim 32 --out-dim 16 --device cpu

The twin of ``repro.launch.serve``, with the same flags and ``--device``
(default ``cuda``: the run needs the card unless the CPU is asked for).
LM weights and prompts come from ``--seed`` through ``torch.Generator``s,
so they are not the reference's numbers; the subgraph stream is the
reference's own (numpy, from ``--seed``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.sparse.formats import csr_content_digest
from ..core.sparse.random import (induced_subgraph, perturb_rows,
                                  powerlaw_graph)
from ..core.tilefusion.serving import ServingTier
from ..models import transformer as T
from . import steps


@dataclasses.dataclass
class Timing:
    prefill_s: float      # host clock around the prefill step
    decode_s: list        # host clock around each later decode step


def build(cfg, *, batch: int, prompt_len: int, seed: int, device):
    """The model and ``(batch, prompt_len)`` int64 prompts, from ``seed``."""
    model = T.Transformer(cfg, device=device, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen)
    return model, prompts.to(model.device)


@torch.inference_mode()
def generate(model, prompts: torch.Tensor, gen: int, *, enc_embeds=None):
    """Greedy decoding: one batched prefill of ``prompts`` fills the cache
    and yields the first token; ``gen - 1`` decode steps follow.  An
    encoder-decoder takes ``enc_embeds (B, Se, d)`` in every step (the
    encoder runs again in each, as in the reference).  Returns ``(tokens
    (B, gen) int32, Timing)``; on the card each step ends in a
    synchronize, so the times are the steps' own.  Runs under
    ``torch.inference_mode()``."""
    b, prompt_len = prompts.shape
    extra = {} if enc_embeds is None else {"enc_embeds": enc_embeds}
    serve_step = steps.make_serve_step(model)
    on_card = model.device.type == "cuda"

    def clock():
        if on_card:
            torch.cuda.synchronize(model.device)
        return time.perf_counter()

    cache = model.init_cache(b, prompt_len + gen)
    t0 = clock()
    next_tok, cache = serve_step({"tokens": prompts, **extra}, cache, 0)
    prefill_s = clock() - t0
    out, decode_s = [next_tok], []
    for i in range(gen - 1):
        t0 = clock()
        next_tok, cache = serve_step({"tokens": next_tok[:, None], **extra},
                                     cache, prompt_len + i)
        decode_s.append(clock() - t0)
        out.append(next_tok)
    return torch.stack(out, dim=1), Timing(prefill_s, decode_s)


class SubgraphFrontEnd:
    """Request-batching front of a ``ServingTier`` for GNN-style loads.

    Each request is ``(a, feats, w)``: a sampled subgraph, its node
    features ``(a.n_cols, feat_dim)`` and a per-request weight ``(feat_dim,
    out_dim)``, computing ``a @ (feats @ w)``.  ``submit`` queues; ``flush``
    groups queued requests by pattern and stacks up to ``max_batch`` of
    them into one tier dispatch: features side by side in B's columns and
    the weights block-diagonally in C, so one schedule lookup and one
    executor call serve the whole stack (unused column blocks stay zero,
    so the shapes never change).  Results come back in submit order.

    B and C are assembled in f32 on ``device``.  Features and weights given
    as numpy arrays are uploaded once, at ``submit``; tensors already on
    the device are not copied.  The outputs are views of the stacked
    result and stay on the device."""

    def __init__(self, feat_dim: int, out_dim: int, max_batch: int = 4, *,
                 device="cuda", **tier_kw):
        self.feat_dim = feat_dim
        self.out_dim = out_dim
        self.max_batch = max(int(max_batch), 1)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SubgraphFrontEnd runs on the card by default "
                               "and found no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        self.tier = ServingTier(b_col=feat_dim * self.max_batch,
                                c_col=out_dim * self.max_batch, **tier_kw)
        self._queue: list = []
        self.batches = 0

    def _on_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    def submit(self, a, feats, w) -> int:
        """Queue a request; returns its index into ``flush()``'s result."""
        self._queue.append((a, self._on_device(feats), self._on_device(w)))
        return len(self._queue) - 1

    def flush(self) -> list:
        """Serve every queued request; a list of ``(n_rows, out_dim)``
        outputs on the device, in submit order."""
        queue, self._queue = self._queue, []
        results: list = [None] * len(queue)
        groups: dict = {}
        for i, (a, _, _) in enumerate(queue):
            groups.setdefault(csr_content_digest(a), []).append(i)
        fd, od, mb = self.feat_dim, self.out_dim, self.max_batch
        for idxs in groups.values():
            for lo in range(0, len(idxs), mb):
                chunk = idxs[lo: lo + mb]
                a = queue[chunk[0]][0]
                b = torch.zeros((a.n_cols, fd * mb), dtype=torch.float32,
                                device=self.device)
                c = torch.zeros((fd * mb, od * mb), dtype=torch.float32,
                                device=self.device)
                for s, i in enumerate(chunk):
                    b[:, s * fd:(s + 1) * fd] = queue[i][1]
                    c[s * fd:(s + 1) * fd, s * od:(s + 1) * od] = queue[i][2]
                d = self.tier.matmul(a, b, c)
                # the stacked call resolved the schedule once; count the
                # piggy-backed requests so tier stats stay per-request
                for _ in chunk[1:]:
                    self.tier.schedule_for(a)
                for s, i in enumerate(chunk):
                    results[i] = d[:, s * od:(s + 1) * od]
                self.batches += 1
        return results


def _run_subgraph_stream(args, on_flush=None) -> SubgraphFrontEnd:
    """Drive the reference's sampled-subgraph request stream through the
    front end on ``args.device``; ``on_flush(requests, outputs)``, when
    given, sees each flushed batch.  Returns the front end."""
    rng = np.random.default_rng(args.seed)
    base = powerlaw_graph(8 * args.subgraph_nodes, avg_deg=6, seed=args.seed)
    fe = SubgraphFrontEnd(args.feat_dim, args.out_dim, args.max_batch,
                          device=args.device, p=8, cache_size=600_000.0,
                          ct_size=256)
    windows = [induced_subgraph(base, s, args.subgraph_nodes)
               for s in (0, args.subgraph_nodes, 3 * args.subgraph_nodes)]
    on_card = fe.device.type == "cuda"

    def clock():
        if on_card:
            torch.cuda.synchronize(fe.device)
        return time.perf_counter()

    # sampler streams drift: mostly the current minibatch pattern, some
    # re-sampled neighbour sets, the odd jump to a fresh sample window
    current = windows[0]
    t0 = clock()
    served = 0
    while served < args.subgraphs:
        n_batch = min(args.max_batch, args.subgraphs - served)
        requests = []
        for _ in range(n_batch):
            r = rng.random()
            if r < 0.1 and served:
                current = windows[int(rng.integers(len(windows)))]
            elif r < 0.4:
                k = max(1, current.n_rows // 50)
                current = perturb_rows(
                    current, rng.choice(current.n_rows, k, replace=False),
                    seed=int(rng.integers(1 << 31)))
            a = current
            feats = rng.standard_normal((a.n_cols, args.feat_dim))
            w = rng.standard_normal((args.feat_dim, args.out_dim))
            fe.submit(a, feats, w)
            requests.append((a, feats, w))
            served += 1
        outs = fe.flush()
        assert all(o is not None for o in outs)
        if on_flush is not None:
            on_flush(requests, outs)
    dt = clock() - t0
    st = fe.tier.stats
    print(f"served {served} subgraph requests on {fe.device} in {dt:.2f}s "
          f"({served / max(dt, 1e-9):.1f} req/s) over {fe.batches} batched "
          f"dispatches")
    print(f"tier: hit_rate={fe.tier.hit_rate():.2f} exact={st['exact_hits']} "
          f"incremental={st['incremental']} rebuilds={st['rebuilds']}")
    return fe


def main(argv=None, *, on_flush=None):
    """The CLI.  With ``--subgraphs N`` it serves the subgraph stream and
    returns the ``SubgraphFrontEnd`` (``on_flush`` sees each batch), else
    it serves the LM and returns the tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: the card)")
    ap.add_argument("--subgraphs", type=int, default=0,
                    help="serve N sampled-subgraph requests through the "
                         "tile-fusion serving tier instead of the LM loop")
    ap.add_argument("--subgraph-nodes", type=int, default=256)
    ap.add_argument("--feat-dim", type=int, default=32)
    ap.add_argument("--out-dim", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    args = ap.parse_args(argv)

    if args.subgraphs:
        return _run_subgraph_stream(args, on_flush=on_flush)
    cfg = get_config(args.arch, reduced=args.reduced)
    model, prompts = build(cfg, batch=args.batch, prompt_len=args.prompt_len,
                           seed=args.seed, device=args.device)
    enc_embeds = None
    if cfg.encoder_layers:
        # the stubbed frontend's frames: zeros, as the reference's CLI
        enc_embeds = torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model),
                                 device=model.device)
    tokens, timing = generate(model, prompts, args.gen,
                              enc_embeds=enc_embeds)
    b = args.batch
    gen_s = sum(timing.decode_s)
    p50 = float(np.median(timing.decode_s)) if timing.decode_s else 0.0
    print(f"generated {tuple(tokens.shape)} on {model.device} in "
          f"{gen_s:.2f}s ({b * (args.gen - 1) / max(gen_s, 1e-9):.1f} "
          f"tok/s, decode p50 {p50 * 1e3:.2f} ms), prefill "
          f"{timing.prefill_s:.2f}s")
    print("sample:", tokens[0, :16].tolist())
    return tokens


if __name__ == "__main__":
    main()
