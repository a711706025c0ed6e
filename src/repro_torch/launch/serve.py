"""Batched LM serving: one prefill fills the KV cache, then greedy decoding.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --reduced --device cpu --batch 4 --prompt-len 32 --gen 16

The twin of the LM loop of ``repro.launch.serve.main``, with the same flags
and ``--device`` (default ``cuda``: the run needs the card unless the CPU
is asked for).  Weights and prompts come from ``--seed`` through
``torch.Generator``s, so they are not the reference's numbers.  The
subgraph serving tier (``--subgraphs``) is a later slice of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
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


def generate(model, prompts: torch.Tensor, gen: int):
    """Greedy decoding: one batched prefill of ``prompts`` fills the cache
    and yields the first token; ``gen - 1`` decode steps follow.  Returns
    ``(tokens (B, gen) int32, Timing)``; on the card each step ends in a
    synchronize, so the times are the steps' own."""
    b, prompt_len = prompts.shape
    serve_step = steps.make_serve_step(model)
    on_card = model.device.type == "cuda"

    def clock():
        if on_card:
            torch.cuda.synchronize(model.device)
        return time.perf_counter()

    cache = model.init_cache(b, prompt_len + gen)
    t0 = clock()
    next_tok, cache = serve_step(prompts, cache, 0)
    prefill_s = clock() - t0
    out, decode_s = [next_tok], []
    for i in range(gen - 1):
        t0 = clock()
        next_tok, cache = serve_step(next_tok[:, None], cache,
                                     prompt_len + i)
        decode_s.append(clock() - t0)
        out.append(next_tok)
    return torch.stack(out, dim=1), Timing(prefill_s, decode_s)


def main(argv=None):
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
                    help="the subgraph serving tier (not in the port yet)")
    args = ap.parse_args(argv)

    if args.subgraphs:
        raise NotImplementedError(
            "--subgraphs: the tile-fusion serving tier is a later slice of "
            "the port (ROADMAP Queue 1)")
    cfg = get_config(args.arch, reduced=args.reduced)
    model, prompts = build(cfg, batch=args.batch, prompt_len=args.prompt_len,
                           seed=args.seed, device=args.device)
    tokens, timing = generate(model, prompts, args.gen)
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
