"""The trace encoding both kernels' plain versions and wrappers share: a
cell's 4 traceback bits, the step-major buffers and their allocation.
``core/traceback.py`` describes the layout and decodes it."""

from __future__ import annotations

import torch


def trace_bits(D11, C11, C11_open, R11, D11_open, zcol):
    """4 traceback bits per cell, (B, S) int64: ``t = (D == C) | (D == R)
    << 1`` and ``t2 = (C == C_open) | R_bit << 1``, where a row's R bit is
    ``R == D_open`` of the row above it, 0 in row 0 (reference:
    src/scan_block.rs:1166-1190)."""
    t = (D11 == C11).long() | ((D11 == R11).long() << 1)
    r_bit = torch.cat([zcol, (R11 == D11_open).to(zcol.dtype)[:, :-1]], 1)
    t2 = (C11 == C11_open).long() | (r_bit.long() << 1)
    return t | (t2 << 2)


def as_int32(x):
    """Bit pattern of an int64 tensor of 32-bit words, as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def stack_steps(per_step, shape, dev):
    """The per-step tensors as one (T, *shape) int32 tensor."""
    if not per_step:
        return torch.zeros((0, *shape), dtype=torch.int32, device=dev)
    return torch.stack(per_step)


def trace_buffers(out, cfg, rows):
    """The kernel's result, ``out`` or ``(out, words, desc, steps)`` in
    trace mode, and the trace pointers of its launch (null without trace).
    The buffers are left unfilled: a pair writes only the steps it runs."""
    if not cfg.trace:
        return out, (None, None, None)
    B, dev = out.shape[0], out.device
    words = torch.empty((cfg.max_steps, B, rows), dtype=torch.int32, device=dev)
    desc = torch.empty((cfg.max_steps, B, 4), dtype=torch.int32, device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev)
    return ((out, words, desc, steps),
            (words.data_ptr(), desc.data_ptr(), steps.data_ptr()))
