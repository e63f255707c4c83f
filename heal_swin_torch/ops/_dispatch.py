"""Routing between a kernel and its plain version, and the kernels' launch plumbing
shared by the ops modules."""

from __future__ import annotations

import torch

from heal_swin_torch import _build


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the first
    CUDA device.  The CPU only when asked for (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU by default; pass "
                           "device='cpu' to run its plain versions on the CPU")
    return torch.device("cuda", 0)


def use_kernel(t: torch.Tensor, impl: str) -> bool:
    """Kernel or plain version for tensor ``t``: "auto" runs the kernel for a CUDA
    tensor and the plain version for a CPU tensor; "xla" runs the plain version on
    any device (the JAX package's name for its non-kernel path); "pallas" demands
    the kernel and raises on a CPU tensor.  A wrapper whose kernel runs refuses
    operands the kernel was not written for (``refuse``)."""
    if impl == "xla":
        return False
    if impl not in ("auto", "pallas"):
        raise ValueError(f"unknown impl {impl!r}: expected 'auto', 'xla' or 'pallas'")
    if t.is_cuda:
        return True
    if impl == "pallas":
        raise ValueError(f"impl='pallas' needs CUDA tensors; this one is on {t.device}")
    return False


def refuse(msg: str) -> None:
    """Raise a wrapper's refusal of operands (a shape or dtype) its kernel was not
    written for, naming the explicit plain route: on a CUDA tensor a wrapper runs its
    kernel or raises, under "auto" as under "pallas"."""
    raise ValueError(f"{msg}; impl='xla' (attention_impl='xla' on the model) runs the "
                     "plain version")


def f32_suffix(t: torch.Tensor) -> str:
    """The suffix of the f32 kernels' C entries and launch counters for operands ``t``."""
    return "_f32" if t.dtype == torch.float32 else ""


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entries take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (launch refused or failed)."""
    if code != 0:
        msg = _build.lib().hs_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def input_grads(ctx, pairs):
    """An autograd function's backward result: (gradient, operand) pairs in input
    order -> the gradients autograd asked for, each in its operand's dtype."""
    return tuple(None if g is None or t is None or not need else g.to(t.dtype)
                 for (g, t), need in zip(pairs, ctx.needs_input_grad))
