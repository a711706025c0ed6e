#!/usr/bin/env python3
"""The LM over a mesh spread over distinct cards, beside the same mesh on
one card and the unsharded model.

Run from the root of a checkout, on a machine with four H100s:

    python3 benchmarks_torch/lm_mesh_multicard.py

granite-moe-3b-a800m at full width and depth, in f32, serves a 4 × 2048
prefill and 8 greedy decode steps on the meshes (2, 2) and (1, 4) over
``("data", "model")``, twice each: with the members on ``cuda:0`` ..
``cuda:3`` and with every member on ``cuda:0``.  The logits of the run
over the cards are held to the run on one card (relative to the largest
value, ≤ 1e-5: the members compute the same things, only on other
cards), must land on ``cuda:0``, and the flash kernel must launch once a
layer on each member; the run on one card is held to the unsharded model
on its routing (≤ 1e-3, as ``chip_smoke.py`` phase 20).  Then
stablelm-1.6b at full width, 4 of 24 layers, takes 2 ZeRO-1 AdamW steps
in f32 at 4 × 1024 on (2, 2) over the cards and on one card: losses, grad
norms and parameters held to each other (≤ 1e-5 relative, ≤ 1e-5).
Times: host clock around each step and a synchronize of every card,
prefill and decode p50, the runs in turns; collective bytes by kind; each
card's peak memory.  A failed check exits non-zero.  The last line is
each card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, TRAIN_ARCH = "granite-moe-3b-a800m", "stablelm-1.6b"
BATCH, PROMPT, DECODE = 4, 2048, 8
MESHES = ((2, 2), (1, 4))
SAME_TOL, REF_TOL = 1e-5, 1e-3
TRAIN_LAYERS, TRAIN_SHAPE, TRAIN_STEPS = 4, (4, 1024), 2


def main() -> None:
    import numpy as np
    import torch
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.partitioning import make_rules
    from repro_torch.models import layers as L
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, adamw

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 4:
        sys.exit("needs four CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = [f"cuda:{i}" for i in range(4)]
    dev = torch.device("cuda", 0)

    def sync():
        for i in range(4):
            torch.cuda.synchronize(i)

    def mesh(shape, spread):
        entries = np.array(cards if spread else [cards[0]] * 4,
                           dtype=object).reshape(shape)
        return sharding.Mesh(entries, ("data", "model"))

    def serve(lm, prompts, rules, feed=None):
        """Prefill, then DECODE greedy steps (fed ``feed``'s tokens where
        given): the logits of each, the tokens fed, the host times."""
        b, p = prompts.shape
        cache = lm.init_cache(b, p + DECODE, rules=rules)
        run = (steps.make_serve_step(lm, rules=rules).executor.decode_step
               if rules is not None else lm.decode_step)
        outs, fed, ms = [], [], []
        with torch.inference_mode():
            tok = prompts
            for i in range(DECODE + 1):
                sync()
                t0 = time.perf_counter()
                logits, cache = run(tok, cache, 0 if i == 0 else p + i - 1)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                outs.append(logits[:, -1:])
                if i < DECODE:
                    tok = (logits[:, -1].argmax(-1, keepdim=True)
                           if feed is None else feed[:, i:i + 1])
                    fed.append(tok)
        return outs, torch.cat(fed, 1), ms

    failed = []
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    lm = T.Transformer(cfg, device=dev, seed=0)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(20))
    for shape in MESHES:
        runs = {}
        for spread in (True, False, True, False):
            name = "cards" if spread else "one card"
            rules = make_rules(cfg, mesh(shape, spread))
            for i in range(4):
                torch.cuda.reset_peak_memory_stats(i)
            sharding.reset_comm_bytes()
            ops.reset_launch_counts()
            with C.record_routes(L) as calls:
                got, fed, ms = serve(lm, prompts, rules)
            flash = ops.launch_counts()["flash_attention"]
            peak = [torch.cuda.max_memory_allocated(i) / 2**30
                    for i in range(4)]
            runs.setdefault(name, []).append(
                dict(got=got, fed=fed, ms=ms, calls=calls, flash=flash,
                     comm=dict(sharding.comm_bytes), peak=peak))
        a, b = runs["cards"][0], runs["one card"][0]
        errs = [C.rel_err(x, y)[1] for x, y in zip(a["got"], b["got"])]
        on = {str(x.device) for x in a["got"]}
        with C.replay_picks(L, C.mesh_picks(b["calls"], shape[0],
                                            shape[1])):
            want, _, one_ms = serve(lm, prompts, None, feed=b["fed"])
        ref = [C.rel_err(x, y)[1] for x, y in zip(b["got"], want)]
        for name, rs in runs.items():
            prefill = ", ".join(f"{r['ms'][0]:.1f}" for r in rs)
            decode = ", ".join(f"{np.median(r['ms'][1:]):.1f}" for r in rs)
            print(f"[{ARCH} f32 {shape}] {name}: prefill {prefill} ms, "
                  f"decode p50 {decode} ms; flash {rs[0]['flash']} launches;"
                  f" collective bytes {rs[0]['comm']}; peak GiB by card "
                  f"{[round(x, 2) for x in rs[0]['peak']]}", flush=True)
        print(f"[{ARCH} f32 {shape}] unsharded: prefill {one_ms[0]:.1f} ms, "
              f"decode p50 {np.median(one_ms[1:]):.1f} ms; over the cards "
              f"against one card: rel err {max(errs):.2e} (limit "
              f"{SAME_TOL:.0e}), logits on {sorted(on)}; one card against "
              f"the unsharded model on its routing {max(ref):.2e} (limit "
              f"{REF_TOL:.0e}); greedy tokens alike: "
              f"{torch.equal(a['fed'], b['fed'])}", flush=True)
        if max(errs) > SAME_TOL or on != {"cuda:0"} or max(ref) > REF_TOL \
                or a["flash"] != cfg.n_layers * 4:
            failed.append(f"{ARCH} {shape}")
    del lm, runs
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32",
                              n_layers=TRAIN_LAYERS)
    b, s = TRAIN_SHAPE
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(22))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=20)
    out = {}
    for spread in (True, False):
        lm = T.Transformer(cfg, device=dev, seed=0)
        step = steps.make_train_step(
            lm, opt, rules=make_rules(cfg, mesh((2, 2), spread)))
        state = adamw.init(lm.parameters())
        metrics, ms = [], []
        sharding.reset_comm_bytes()
        for _ in range(TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics += [float(m["loss"]), float(m["grad_norm"])]
        # the step writes its update back into the model
        out[spread] = (metrics, [p.detach() for p in lm.parameters()])
        print(f"[{TRAIN_ARCH} f32 {TRAIN_LAYERS} layers ZeRO-1 (2, 2)] "
              f"{'cards' if spread else 'one card'}: loss, grad norm by step "
              f"{metrics}; step ms {', '.join(f'{t:.1f}' for t in ms)}; "
              f"collective bytes {dict(sharding.comm_bytes)}", flush=True)
        del lm, step, state
        torch.cuda.empty_cache()
    m_err = max(abs(x / y - 1) for x, y in zip(out[True][0], out[False][0]))
    p_err = max(float((x - y).abs().max())
                for x, y in zip(out[True][1], out[False][1]))
    print(f"[{TRAIN_ARCH}] over the cards against one card: losses and grad "
          f"norms {m_err:.2e}, parameters {p_err:.2e} (limits "
          f"{SAME_TOL:.0e})", flush=True)
    if m_err > SAME_TOL or p_err > SAME_TOL:
        failed.append(f"{TRAIN_ARCH} ZeRO-1")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if failed:
        sys.exit(f"FAILED: {failed}")


if __name__ == "__main__":
    main()
