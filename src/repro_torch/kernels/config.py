"""The one capability gate of the port's CUDA kernels.

Dispatch (``api.select_backend``) and the kernel wrappers both ask
``kernel_library``, so they can never disagree.  A device is capable when
it is a CUDA device of compute capability 9.0 or more (the kernels are
built for ``sm_90a``) and the kernel library is built; the build happens
on the first question about a CUDA device.  Anything else raises, so a
tensor off the CPU never falls back to a plain version quietly.  No
environment variable forces the plain path: the plain PyTorch versions
run for CPU tensors, or where a caller asks for ``backend="torch"``.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build

#: (major, minor) compute capability the kernels are compiled for
MIN_CAPABILITY = (9, 0)


def kernel_library(device) -> ctypes.CDLL:
    """The kernel library for a launch on ``device``, built on first use;
    raises unless the device is capable (a failed build raises too)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got a tensor "
                         f"on {device}")
    if torch.cuda.get_device_capability(device) < MIN_CAPABILITY:
        raise RuntimeError(
            f"the CUDA kernels are built for sm_90a; "
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{torch.cuda.get_device_capability(device)}")
    return _build.library()


def plain_arm(x: torch.Tensor, impl: str) -> bool:
    """Whether an LM kernel wrapper (flash attention, the FFN and MoE
    kernels) runs its plain version: for a CPU tensor, or ``impl="torch"``.
    """
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    return x.device.type == "cpu" or impl == "torch"


#: the dry run's step counter while it counts a step
#: (``roofline.analysis.StepCounter``), else None.  The LM kernel wrappers
#: charge their kernel's own work to it (``kernel_work``), and the mesh
#: collectives of ``models.sharding`` tell it which member a tensor
#: belongs to.
counter = None


def kernel_work(flops: int, nbytes: int):
    """In a dry run, charge a kernel's own work (``flops``, and ``nbytes``,
    its compulsory bytes) to the counter, and mute the operations of a
    plain version that computes the kernel's result inside (their
    allocations are still tracked); a no-op context otherwise."""
    if counter is None:
        return contextlib.nullcontext()
    return counter.kernel(flops, nbytes)


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and an input of
    a kernel without a backward requires grad: its output, written by the
    launcher into a fresh tensor, would leave the autograd graph and the
    inputs' gradients would be missing without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel has no backward (the JAX package's "
            f"Pallas kernel has none either), so under grad mode its output "
            f"would leave the autograd graph; run it under torch.no_grad() "
            f"or torch.inference_mode(), or take the differentiable plain "
            f"version with impl='torch'; to train, ask the model for its "
            f"training forward (Transformer.forward(..., train=True), as "
            f"launch.steps.make_train_step does), whose attention is "
            f"layers.scan_attention")


#: dtype codes the launchers take (``csrc/common.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Shared memory one block may use on an H100 (bytes), and the widest
#: column block a wavefront-0 kernel takes per block.
SMEM_BYTES = 232_448
MAX_COLUMN_BLOCK = 128


def column_block(smem_rows: int, c_col: int, fixed_bytes: int = 0) -> int:
    """Column block width ``cb`` of a wavefront-0 kernel: the block keeps
    ``smem_rows × cb`` f32 values in shared memory (D1 tile, plus C for
    GeMM-SpMM) beside ``fixed_bytes`` that do not depend on ``cb`` (the
    tile's ELL entries).  The widest block up to ``MAX_COLUMN_BLOCK`` that
    fits, halving down to 8; raises when even that does not fit."""
    cb = max(min(c_col, MAX_COLUMN_BLOCK), 1)

    def need(cb):
        return smem_rows * cb * 4 + fixed_bytes

    while need(cb) > SMEM_BYTES and cb > 8:
        cb = max(cb // 2, 8)
    if need(cb) > SMEM_BYTES:
        raise ValueError(
            f"a column block of {cb} f32 columns over {smem_rows} rows and "
            f"{fixed_bytes} bytes of entries need {need(cb)} bytes of shared "
            f"memory, more than the {SMEM_BYTES} a block may use; inspect "
            f"with a smaller tile (FusionSpec.ct_size / cache_size)")
    return cb


def check_launch(index: dict, values: dict) -> torch.device:
    """Validate a launch's tensors: one CUDA device, all contiguous, index
    tensors int32, value tensors f32 or bf16 of one dtype.  Returns the
    device."""
    tensors = {**index, **values}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in index.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    dtypes = {t.dtype for t in values.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPE_CODES:
        raise TypeError(f"value tensors must share one dtype of "
                        f"{list(DTYPE_CODES)}, got "
                        f"{ {k: t.dtype for k, t in values.items()} }")
    return devices.pop()


def raise_on_error(err: int, kernel: str) -> None:
    """Raise for a launcher's non-zero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_of(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device`` (for a launch)."""
    return torch.cuda.current_stream(device).cuda_stream
