"""Multi-pod dry run of the port: every (arch × shape) cell laid out on the
reference's production meshes and its full-depth step counted on ``meta``
tensors, the twin of ``repro.launch.dryrun``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--skip-existing]
  python -m repro_torch.launch.dryrun --arch qwen2-vl-72b \
      --shape decode_32k --mesh 1x4

The reference's flags, file names (``{arch}_{shape}_{256|512}.json``),
JSON keys and exit status; ``--mesh`` (the port's own) counts a cell on a
``meta`` mesh of another shape, ``data x model`` or ``pod x data x
model``, written to ``{arch}_{shape}_{mesh}.json``.

Per cell, ``launch.partitioning.plan`` lays the cell out on the mesh
(``launch.mesh.make_production_mesh``: 256 or 512 entries, all ``meta``),
the model is built on ``meta`` (no weight is drawn), and one step of
``launch.steps`` runs under ``roofline.analysis.StepCounter``: the train
step (AdamW under ZeRO-1), the prefill (the logits left on the members
that computed them, as the reference leaves them sharded) or one decode
step on a full cache.  No array is allocated and no card is needed; the
flash kernel's wrapper returns an empty output on ``meta`` and charges its
own work.  The executor runs every member in turn in one Python process,
so a cell takes seconds to tens of minutes (an sLSTM steps through time
one position at a time): the CLI prints each cell's seconds.

What a cell reports, under the reference's JSON keys:

- ``memory_analysis``: the fullest member's ``argument_bytes`` (its
  parameter blocks, optimizer moment blocks, batch shard and cache shard,
  counted from the specs), ``output_bytes`` (what it still holds when the
  step returns), ``peak_bytes`` (its arguments plus the most it held
  beyond them during the step) and ``temp_bytes`` (peak less arguments and
  outputs).  The reference's ``_peak_bytes`` has no twin: it reads XLA's
  ``CompiledMemoryStats``.
- ``cost_analysis`` (FLOPs and bytes accessed per device, the mean
  member), ``collectives`` (``roofline.collective_bytes``) and
  ``roofline`` on the H100's peaks, for the multi-pod cells too (the
  reference writes them for the single-pod cells only, whose extra
  shallow compiles they cost; here they come with the one count).
- ``depth_counted``, where the reference writes ``extrapolation``: an
  eager step counts every layer, so the full-depth run gives the cost
  terms directly.  XLA counted a ``while`` body once, which is why the
  reference compiled two shallow variants (``_depth_points``).
- ``lower_s``: seconds to lay the cell out and place the step's blocks;
  ``compile_s``: seconds of the counted step.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from ..configs import cells
from ..models import sharding
from ..models import transformer as T
from ..models.sharding import Mesh
from ..optim import OptConfig, adamw
from ..roofline import collective_bytes, model_flops, roofline
from ..roofline.analysis import StepCounter
from . import partitioning, steps
from .mesh import make_production_mesh


def _inputs(batch: dict, cfg, device, seed: int) -> dict:
    """The batch's specs as tensors on ``device``: the meta specs
    themselves on ``meta``; elsewhere tokens and labels drawn below the
    vocabulary and embeddings from a normal, from ``seed``."""
    if device.type == "meta":
        return batch
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, spec in batch.items():
        if spec.dtype.is_floating_point:
            t = torch.randn(spec.shape, generator=gen, dtype=spec.dtype)
        else:
            t = torch.randint(0, cfg.vocab_size, spec.shape, generator=gen,
                              dtype=spec.dtype)
        out[k] = t.to(device)
    return out


def _blocks(tree, specs, mem, itemsize=None) -> dict:
    """Member ``(j, m)`` of ``mem`` (``sharding.Members``) -> the bytes of
    its blocks of every leaf of ``tree`` (meta tensors) under ``specs``
    (``itemsize`` in place of each leaf's own)."""
    leaves = T._flatten(tree)
    per_spec = T._flatten(specs)
    out = {}
    for j, m in mem.all():
        total = 0
        for leaf, spec in zip(leaves, per_spec):
            reg = sharding.spec_region(leaf.shape, spec, mem.coords[j][m],
                                       mem.sizes)
            total += int(np.prod([b - a for a, b in reg])) * (
                itemsize or leaf.element_size())
        out[(j, m)] = total
    return out


def argument_bytes(pl_) -> dict:
    """Member -> the bytes it holds before a step of the cell ``pl_`` (a
    ``partitioning.plan``): its parameter blocks, for a train cell its two
    f32 AdamW moment blocks (``opt_shardings``), its batch shard and for a
    decode cell its cache shard, each from the specs."""
    mesh, mem = pl_["rules"].mesh, sharding.Members(pl_["rules"])
    out = _blocks(pl_["params"], pl_["param_shardings"], mem)
    parts = [_blocks(pl_["batch"], pl_["batch_shardings"], mem)]
    if pl_["shape"].kind == "train":
        moments = partitioning.opt_shardings(pl_["param_shardings"],
                                             pl_["params"], mesh)
        parts.append({w: 2 * n for w, n in _blocks(
            pl_["params"], moments, mem, itemsize=4).items()})
    if "cache" in pl_:
        parts.append(_blocks(pl_["cache"], pl_["cache_shardings"], mem))
    for part in parts:
        for who, n in part.items():
            out[who] += n
    return out


def _step(pl_, model, rules, batch: dict):
    """``(run, blocks by member)``: the cell's step ready to run once, and
    the blocks the step placed on each member before it runs (parameters,
    moments, cache; the batch is sliced by the step itself)."""
    shape = pl_["shape"]
    first = (0, 0)
    held = {first: []}
    if shape.kind == "train":
        step = steps.make_train_step(model, OptConfig(), rules=rules)
        state = adamw.init(model.parameters())
        ex = getattr(step, "executor", None)
        if ex is None:
            held[first] += list(model.parameters()) + state.mu + state.nu
        else:
            state = step.zero.place(state)
            for who in ex.mem.all():
                held.setdefault(who, []).extend(ex.pieces[who])
                held[who].extend(t[who] for t in state.mu + state.nu
                                 if t[who] is not None)
        return (lambda: step(state, batch)), held
    if shape.kind == "prefill":
        step = steps.make_prefill_step(model, rules=rules, gather=False)
        ex = step.executor
        run = (lambda: step(batch))
    else:
        step = steps.make_serve_step(model, rules=rules)
        ex = step.executor
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 rules=rules)
        if ex is None:
            held[first] += T._flatten(cache)
        else:
            for k in range(len(cache.leaves)):
                for who, t in cache.parts[k].items():
                    held.setdefault(who, []).append(t)

        def run():
            return step(batch, cache, shape.seq_len - 1)
    if ex is None:
        held[first] += list(model.parameters())
    else:
        for who in ex.mem.all():
            held.setdefault(who, []).extend(ex.pieces[who])
    return run, held


def _count(arch: str, shape_name, mesh, *, cfg_replace: dict | None = None,
           override_rules=None) -> dict:
    """Lay one cell out on ``mesh`` and count one step of it; the twin of
    the reference's ``_compile``.  ``shape_name`` may be a
    ``ShapeConfig``.  On a mesh of ``meta`` entries nothing is allocated;
    on one of real devices (``cpu``) the step runs on weights and inputs
    drawn from seed 0."""
    t0 = time.time()
    pl_ = partitioning.plan(arch, shape_name, mesh, cfg_replace=cfg_replace)
    cfg = pl_["cfg"]
    rules = override_rules if override_rules is not None else pl_["rules"]
    device = mesh.devices.flat[0]
    model = T.Transformer(cfg, device=device, seed=0)
    batch = _inputs(pl_["batch"], cfg, device, seed=0)
    run, held = _step(pl_, model, rules, batch)
    args = argument_bytes(pl_)
    t_lower = time.time() - t0
    sharding.reset_comm_bytes()
    counter = StepCounter()
    counter.own(batch.values(), (0, 0))
    for who, ts in held.items():
        counter.own(ts, who)
    t0 = time.time()
    with counter:
        out = run()
    t_count = time.time() - t0
    n_dev = mesh.devices.size
    coll = collective_bytes(n_dev)
    mem = {}
    for who, a in args.items():
        mem[who] = {"argument_bytes": a,
                    "output_bytes": counter.live[who],
                    "peak_bytes": a + counter.high[who]}
        mem[who]["temp_bytes"] = mem[who]["peak_bytes"] - a - \
            counter.live[who]
    del out
    return {
        "cfg": cfg, "shape": pl_["shape"], "plan": pl_, "blocks": held,
        "cost": {"flops": counter.flops / n_dev,
                 "bytes accessed": counter.bytes / n_dev},
        "coll": coll, "members": mem,
        "lower_s": t_lower, "compile_s": t_count,
    }


def _depth_points(cfg):
    """Two shallow depths for the affine-in-depth extrapolation."""
    if cfg.block_pattern == "mlstm7+slstm":
        return 8, 16
    return 2, 4


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             roofline_terms: bool = True, override_rules=None,
             extra_tag: str = "", cfg_replace: dict | None = None,
             verbose: bool = True, mesh=None) -> dict:
    """Count one cell at full depth on ``mesh`` (default: the production
    mesh, multi-pod or not) and report it in the reference's keys."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    full = _count(arch, shape_name, mesh, cfg_replace=cfg_replace,
                  override_rules=override_rules)
    cfg, shape = full["cfg"], full["shape"]
    n_dev = mesh.devices.size
    fullest = max(full["members"],
                  key=lambda w: full["members"][w]["peak_bytes"])
    mem = full["members"][fullest]
    result = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(map(str, mesh.devices.shape)),
        "multi_pod": multi_pod, "tag": extra_tag, "n_devices": n_dev,
        "lower_s": round(full["lower_s"], 1),
        "compile_s": round(full["compile_s"], 1),
        "memory_analysis": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "peak_bytes": mem["peak_bytes"],
            "fullest_member": list(fullest),
        },
    }
    if roofline_terms:
        rl = roofline(full["cost"], full["coll"],
                      model_flops_global=model_flops(cfg, shape),
                      n_devices=n_dev)
        result["cost_analysis"] = dict(full["cost"])
        result["collectives"] = {"bytes": full["coll"]["bytes"],
                                 "counts": full["coll"]["counts"],
                                 "total_bytes": full["coll"]["total_bytes"]}
        result["roofline"] = rl.to_dict()
        result["depth_counted"] = cfg.n_layers
    if verbose:
        print(json.dumps(result, indent=1, default=str))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--mesh", help="a meta mesh of this shape in place of "
                    "the production meshes: 1x4 (data x model), 2x2x2 "
                    "(pod x data x model)")
    args = ap.parse_args(argv)

    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    custom = None
    if args.mesh:
        dims = tuple(int(n) for n in args.mesh.split("x"))
        axes = ("data", "model") if len(dims) == 2 else \
            ("pod", "data", "model")
        custom = Mesh(np.full(dims, "meta", dtype=object), axes)
        meshes = [len(dims) == 3]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape_name in todo:
        for mp in meshes:
            size = args.mesh or ('512' if mp else '256')
            tag = f"{arch}_{shape_name}_{size}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {tag}", flush=True)
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                t0 = time.time()
                # roofline terms for every cell: the reference writes them
                # for the single-pod cells only, whose shallow compiles
                # they cost; here they come with the one count
                res = run_cell(arch, shape_name, multi_pod=mp,
                               verbose=False, mesh=custom)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1, default=str)
                secs = time.time() - t0
                r = res["roofline"]
                print(f"[ok] {tag}: bottleneck={r['bottleneck']} "
                      f"compute={r['compute_s']:.2e}s "
                      f"memory={r['memory_s']:.2e}s "
                      f"coll={r['collective_s']:.2e}s "
                      f"useful={r['useful_ratio']:.2f} peak="
                      f"{res['memory_analysis']['peak_bytes']} "
                      f"(counted in {secs:.1f}s)", flush=True)
            except Exception as e:
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e!r}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        sys.exit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
