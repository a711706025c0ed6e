"""Step-tagged, preemption-safe checkpointing in the reference's layout.

The twin of ``repro.checkpoint.ckpt``, without ``jax``: ``<dir>/step_<n>/``
holds one ``leaf_<i>.npy`` a leaf and ``manifest.json`` (``step``,
``n_leaves``, ``treedef``, ``dtypes`` as numpy names, ``extra``,
``complete``).  A write goes to ``step_<n>.tmp`` and is renamed, so a
preemption mid-write never corrupts the newest checkpoint, and
``latest_step`` picks the newest complete one.  bf16 leaves are stored as
their ``uint16`` bits under the dtype name ``"bfloat16"``.

The leaves go in ``jax.tree_util``'s flatten order, which this module
writes itself: dict keys sorted, tuples and lists (``NamedTuple``s such as
``OptState(step, mu, nu)`` too) in order, ``None`` an empty node, anything
else a leaf.  So a checkpoint of the reference resumes in the port, and one
of the port in the reference.  Leaves may be tensors (any device) or numpy
arrays; ``restore`` returns CPU tensors of the stored dtypes.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def _flatten(tree) -> tuple:
    """``(leaves, treedef string)`` in ``jax.tree_util``'s order; the
    string has ``str(PyTreeDef)``'s form."""
    leaves = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(walk(v) for v in node) + "])")
        if isinstance(node, (tuple, list)):
            inner = ", ".join(walk(v) for v in node)
            if isinstance(node, list):
                return f"[{inner}]"
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(tree_like, leaves):
    """``tree_like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree_like)


def _to_numpy(leaf) -> tuple:
    """``(array to write, dtype name)``; bf16 becomes its uint16 bits."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, arr.dtype.name
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.name != dtype:
        raise ValueError(f"a leaf of dtype {arr.dtype.name} where the "
                         f"manifest says {dtype}")
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Write ``tree`` as step ``step``; returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = _flatten(tree)
    dtypes = []
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        dtypes.append(dtype)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": treedef,
        "dtypes": dtypes,
        "extra": extra or {},
        "complete": True,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step with a manifest (``.tmp`` directories skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree_like) -> tuple:
    """``(tree, extra)``: step ``step`` in the structure of ``tree_like``
    (its leaves give the shapes, anything with ``.shape``), the leaves CPU
    tensors of the stored dtypes.  Raises ``ValueError`` when the leaf
    count or a shape differs."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, _ = _flatten(tree_like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint/model structure mismatch: "
                         f"{manifest['n_leaves']} leaves for {len(leaves)}")
    new_leaves = []
    for i, old in enumerate(leaves):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if tuple(old.shape) != tuple(arr.shape):
            raise ValueError(f"leaf {i} shape mismatch: {tuple(old.shape)} "
                             f"vs {arr.shape}")
        new_leaves.append(_to_tensor(arr, manifest["dtypes"][i]))
    return _unflatten(tree_like, new_leaves), manifest["extra"]


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints (bounded disk use)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
