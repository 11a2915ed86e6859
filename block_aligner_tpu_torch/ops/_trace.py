"""The trace encoding both kernels' plain versions and wrappers share: a
cell's 4 traceback bits, the step-major buffers and their allocation.
``core/traceback.py`` describes the layout and decodes it."""

from __future__ import annotations

import torch


def trace_bits(D11, c_end, r_end, C11, C11_open, R11, D11_open, zcol):
    """4 traceback bits per cell, (B, S) int64: ``t = (D == C_end) | (D ==
    R_end) << 1`` and ``t2 = (C == C_open) | R_bit << 1``, where a row's R
    bit is ``R == D_open`` of the row above it, 0 in row 0 (reference:
    src/scan_block.rs:1166-1190).  ``c_end`` and ``r_end`` are C and R
    with the gap close cost of profile mode, else C and R themselves."""
    t = (D11 == c_end).long() | ((D11 == r_end).long() << 1)
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


# The big kernel's block-sized layout (``ops/big_kernel.py``): a step writes
# only the words of its rect height h, at the pair's running word counter
# (with local start its h trace words, then the h zero words of the same
# rows), and its descriptor carries the counter before the step as a fifth
# field.
DESC_FIELDS = 5


def block_trace_buffers(out, cfg):
    """The big kernel's result in trace mode, ``(out, words, desc, steps,
    used)``, and the trace pointers of its launch: words (B,
    ``cfg.trace_budget``, which counts words: twice a row budget with local
    start), desc (``cfg.max_steps``, B, 5), the steps each pair ran and the
    words it wrote (B,).  Left unfilled, as ``trace_buffers``."""
    B, dev = out.shape[0], out.device
    words = torch.empty((B, cfg.trace_budget), dtype=torch.int32, device=dev)
    desc = torch.empty((cfg.max_steps, B, DESC_FIELDS), dtype=torch.int32,
                       device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev)
    used = torch.empty(B, dtype=torch.int32, device=dev)
    return ((out, words, desc, steps, used),
            (words.data_ptr(), desc.data_ptr(), steps.data_ptr(),
             used.data_ptr()))


# The trace buffers one launch of a long route (``api.py``'s
# ``LongBatchAligner``, ``LongAdaptiveAligner`` and ``BatchAligner``'s long
# routes) may hold on the device: 4 GiB, a twentieth of the H100's 80 GB.  A
# batch whose pairs' buffers take more runs in sub-batches
# (``trace_sub_batch``); a sub-batch of one pair may pass it.  At 50 kbp a
# pair takes ~26 MB at lane block 512 and ~53 MB at (512, 8192) with the
# first budget of ``BigKernelConfig.walk_budget``, so 64 such pairs run in
# one launch.
LAUNCH_TRACE_BYTES = 4 << 30


def pair_trace_bytes(cfg) -> int:
    """Device bytes of one pair's trace buffers for ``cfg``: the big
    kernel's ``trace_budget`` words and 5 descriptor fields a step, or the
    dense layout's rows (``cfg.block``, twice with local start) and 4
    fields a step."""
    if hasattr(cfg, "trace_budget"):
        return 4 * (cfg.trace_budget + DESC_FIELDS * cfg.max_steps)
    rows = cfg.block * (2 if cfg.local_start else 1)
    return 4 * cfg.max_steps * (rows + 4)


def trace_sub_batch(cfg) -> int:
    """How many pairs of ``cfg`` one launch traces within
    ``LAUNCH_TRACE_BYTES`` (at least 1)."""
    return max(1, LAUNCH_TRACE_BYTES // pair_trace_bytes(cfg))


def compact_step(buf, used, word, h, ran, planes=1):
    """Write rows [0, h) of each of the ``planes`` words a row of one step's
    dense words ``word`` (B, planes * S) (local start: 2, the zero bits
    after the 4-bit cells) of the pairs in ``ran`` into ``buf`` (B, budget)
    at each pair's counter ``used``, plane after plane, and advance those
    counters by planes * h in place.  Returns the step's word offsets, the
    counters before it."""
    off = used.clone()
    S = word.shape[1] // planes
    rows = torch.arange(S, device=word.device)
    b, r = (ran[:, None] & (rows < h[:, None])).nonzero(as_tuple=True)
    for p in range(planes):
        buf[b, used[b] + p * h[b] + r] = word[b, p * S + r]
    used += torch.where(ran, planes * h, 0).to(used.dtype)
    return off


def compact_trace(words, desc, steps, budget, planes=1):
    """A dense trace ``(words, desc, steps)`` (``core/traceback.py``) with
    ``planes`` words a row in the block-sized layout: ``(words (B, budget),
    desc (T, B, 5), used (B,))`` through ``compact_step``, step by step;
    rows a pair did not write stay 0."""
    T, B, _ = words.shape
    buf = torch.zeros((B, budget), dtype=torch.int32, device=words.device)
    used = torch.zeros(B, dtype=torch.int32, device=words.device)
    offs = [compact_step(buf, used, words[t], desc[t, :, 3], t < steps,
                         planes)
            for t in range(T)]
    off = stack_steps(offs, (B,), words.device)
    return buf, torch.cat([desc, off[:, :, None]], 2), used
