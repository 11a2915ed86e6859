"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each reported on its own line, in this order: 1, 2 for the big
kernel's libraries (seconds), 25-37 while the lane and adaptive libraries
(minutes) build, 2's end, 3-24, 38-48:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile ``block_aligner_tpu_torch/csrc/{lane,adaptive}_kernel.cu``,
   their profile libraries ``{lane,adaptive}_profile.cu``, the flags
   libraries ``{lane,adaptive}_flags.cu`` and
   ``{lane,adaptive}_profile_flags.cu``, the big-block kernel
   ``big_kernel.cu``, its trace instances ``big_trace.cu``, its FLAGS
   instances ``big_flags.cu`` and ``big_trace_flags.cu``, its profile
   instances ``big_profile.cu`` and ``big_trace_profile.cu`` and its
   16384-row instances ``big_16384.cu`` and ``big_trace_16384.cu`` into
   ``build/`` (keyed on the sources), one ``nvcc -Xptxas -v`` each, all
   sixteen started together, with the registers, stack and spills of
   every kernel instance, each held to the counts pinned in
   ``chip_smoke_ptxas.txt`` once all are built; load the builds;
3. lane kernel vs plain: the lane kernel against its plain PyTorch version
   on the card, exact equality of score and suspect flag at blocks 16..512
   on seeded random protein and DNA pairs, and the reference's golden
   scores; then in x-drop mode (protein x 50, DNA x 100), equality of all
   four outputs (best score, its position, suspect), with the count of
   pairs whose best lies short of (qlen, rlen);
4. adaptive kernel vs plain: the adaptive kernel against its plain version,
   exact equality of score and overrun flag at ladders (16, 32) .. (64,
   256) on seeded protein and DNA pairs (lengths 0..600, half of them
   with structural indels), once more with a step cap low
   enough to overrun, and pinned adaptive scores that
   ``tests/test_torch_adaptive_kernel.py`` holds against ``BlockOracle``;
   then the same ladders and a capped run in x-drop mode, as in phase 3;
5. lane main path: 16384 random protein pairs 1000x1000 with k=100
   mutations (``bench.rand_protein_pairs``, seed 1234), BLOSUM62, gaps
   -11/-1, block 32, through ``BatchAligner.stage`` + ``align_staged`` and
   through ``align_all`` on twice as many pairs;
6. adaptive main path: the package's default size (32, 256) on 7000
   Uniclust30-style homolog pairs (``examples_tpu/common.py::load_uc_pairs``,
   seed 1234) through ``stage`` + ``align_staged`` and ``align_all``, and on
   16384 random protein pairs 1000x1000 k=100 (seed 1234);
7. ``align_exp_all`` at (32, 256) on 1024 of those homolog pairs, with the
   256-256 lane score as the target (and 8 unreachable targets, so the last
   level runs): every result must equal a direct ``BatchAligner`` run at the
   min size it reports;
8. lane x-drop main path: the JAX package's x-drop workload
   (``examples_tpu/run_results.py::bench_xdrop``): 8192 protein pairs of
   800..999 residues with len/10 substitutions (seed 7), BLOSUM62 -11/-1,
   x_drop 50, size (32, 32), seq_cap 1100, through ``stage`` +
   ``align_staged`` and ``align_all``;
9. adaptive x-drop main path: the reference's ``x_drop_accuracy``
   configuration (``examples_tpu/x_drop_accuracy.py``): 8192 DNA pairs of
   300 bases with 30 edits (seed 1234), ``NucMatrix.new_simple(1, -1)``,
   gaps -2/-1, x_drop 50, size (32, 64); and the default size (32, 256)
   with x_drop 50 on the 7000 homolog pairs of phase 6;
10. ``align_exp_all`` with x_drop 50 at (32, 256) on the 1024 pairs of
   phase 7, the target the x-drop 256-256 lane score, checked as there;
11. the trace instances of both kernels against their plain versions: lane
   blocks 16..512 and adaptive ladders (16, 32) .. (64, 256) and (32,
   512), global and x-drop, on seeded protein and DNA pairs (at (32, 512)
   with pairs that grow to 512), and a capped adaptive run: equal
   outputs, step counts, descriptors of every executed step and words
   inside each step's height, and equal CIGARs walked from the two; the
   adaptive runs must emit checkpoint saves and grow restores;
12. lane trace main paths, the JAX package's traced short-read workloads
   (``examples_tpu/run_results.py::bench_short_reads``, seed 77):
   ``NucMatrix.new_simple(2, -4)``, gaps -6/-2, size (32, 32), 8192
   nanopore-like pairs of 800..999 bases with 10% edits (seq_cap 1100) and
   16384 Illumina-like pairs of 100..150 bases with 1% edits (seq_cap
   180);
13. the lane x-drop trace main path: phase 8's pairs with trace;
14. adaptive trace main paths on the homolog pairs of phase 6 in batches
   of 2048: (32, 256) (the reference's traced uc_bench row), (32, 512)
   and (32, 256) with x_drop 50;
15. the profile instances of both kernels (sequence-to-PSSM) against their
   plain versions: lane blocks 16, 32, 128, 512 and adaptive (32, 256) and
   (32, 512), global, x-drop 50, trace and x-drop trace, on profiles with
   gap opens and close costs that vary by position and queries with a few
   bytes outside A..Z (at (32, 512) with 4 pairs whose blocks grow to 512,
   global and x-drop); outputs equal and, with trace, step counts,
   descriptors, words and CIGARs; then the reference's PSSM format
   (``data/scop/pairs.mini.pssm``) on both routes;
16. lane profile main paths, ``examples_tpu/run_results.py::bench_pssm``'s
   workload: 8192 simulated SCOP (query, profile) pairs
   (``examples_tpu/common.py::load_scop_profiles``' simulation, seed 1234,
   drawn here with the port's ``AAProfile``) through
   ``ProfileAligner.stage`` + ``align_staged`` and ``align_all`` at (32,
   32) and (128, 128), and at (32, 32) with x_drop 50;
17. adaptive profile main paths: the same pairs at the default (32, 256),
   and with x_drop 50; ``align_profile_exp_all`` at (32, 256) on 1024 of
   them, with the 256-256 lane score as the target (8 unreachable), every
   result held against the plain version at the min size it reports;
18. profile trace paths: the same pairs in batches of 2048, lane (32, 32)
   and adaptive (32, 256), global and x_drop 50; each pair's CIGAR;
19. the instances of the flags libraries against their plain versions:
   ``ByteMatrix(1, -1)`` (pairs over all 256 bytes, byte 0 and the golden
   pair (b"AAAAAA", b"AAAaaA") included) global and traced; local start
   and free query start gaps global, x-drop 50, trace and x-drop trace;
   free query end gaps (queries shorter than the min size) global and
   traced; sequences and profiles; lane blocks 16, 32, 128, 512 and
   adaptive (32, 256) and (32, 512) (there with trace or profiles, and 2
   pairs that grow to 512): outputs, and with trace step counts,
   descriptors, words (local start's zero bits) and CIGARs, equal, the
   plain versions run in the CPU workers of phases 43-47 and held against
   the kernels' outputs before phase 43;
20. ByteMatrix main paths: 16384 pairs of 1000 random bytes 0..255 with
   k=100 mutations (``bench.rand_protein_pairs``' model over bytes, seed
   1234), ``ByteMatrix(1, -1)``, gaps -11/-1, block 32; the 7000 uc30 pairs
   at (32, 256); traced, the Illumina-like reads of phase 12 at (32, 32)
   with ``ByteMatrix(2, -4)``, -6/-2, whose results must equal the
   ``NucMatrix(2, -4)`` lane path's, and the uc30 pairs at (32, 256);
21. local start: the uc30 pairs at (32, 256), global and traced (batches
   of 2048), and with x_drop 50; phase 8's x-drop protein pairs at (32,
   32) with x_drop 50, global and traced;
22. free query start gaps: phase 12's nanopore-like reads at (32, 32),
   traced;
23. free query end gaps: phase 12's Illumina-like reads (100..150 < 256)
   at lane (256, 256), global and traced;
24. profile flags: the SCOP-style pairs of phase 16 at lane (32, 32) with
   local start and at (256, 256) with free query end gaps, adaptive (32,
   256) with free query start gaps, the first and the last also with
   x_drop 50 and traced (2048 pairs);
25. the big-block kernel (``csrc/big_kernel.cu``) against its plain
   version, global: seeded protein and DNA pairs with structural indels at
   (32, 512), (64, 1024), (512, 1024) and fixed (1024, 1024), 4 growth
   pairs (phase 29's) at fixed (2048, 4096), and a capped run that
   overruns; its launch shapes (threads, dynamic shared bytes, blocks per
   SM);
26. the same in x-drop mode (protein x 0 and 100, DNA x 20), and the 4
   shortest of the first 8 growth pairs at (512, 8192) with x_drop 1000:
   all four outputs equal;
27. the big main path, the reference's <10 kbp 1%-10% band: 1024
   nanopore-like pairs of 5..10 kbp with 10% edits
   (``examples_tpu/common.py::load_nanopore_pairs``, seed 1234; the JAX
   package's ``run_results.py::bench_nanopore_band10k``),
   ``NucMatrix.new_simple(2, -4)``, gaps -6/-2, size (128, 1024), global,
   then with x_drop 50 (the pairs that end short of their ends counted);
28. the uc30 pairs of phase 6 at (32, 512) without trace, which
   ``pick_route`` sends to the big kernel;
29. 32 DNA growth pairs (``growth_pairs``: a random middle between two
   flanks) at (512, 8192) with the whole 16384-position code budget, whose
   blocks must grow to 4096 and to 8192;
30. the big kernel's trace instances (``csrc/big_trace.cu``) against the
   plain version: the structural pairs of phase 25 at (64, 1024), (512,
   1024) and (1024, 1024), protein and DNA, global and x 20 and 100, and
   4 growth pairs at fixed (2048, 4096): outputs, step
   counts, word counters, the descriptors of every executed step and the
   words below each counter equal, and the CIGARs walked from both; a run
   under a reduced trace budget where some pairs overrun; the trace
   instances' launch shapes;
31. the traced nanopore band: the first 512 of phase 27's pairs at (128,
   1024) through ``align_all_trace`` in batches of 256, global and x 50,
   held
   against phase 27's non-trace instance and plain version, the CIGARs of
   the 32 pairs with the fewest cells against the plain version's trace
   (its time is its longest pair's steps); the trace bytes copied per
   pair against what the cells need (4 bits each), the budget and a dense
   layout;
32. traced growth: four of phase 29's growth pairs at (512, 8192), whose
   traced steps reach 4096 and 8192 rows, the CIGARs of the two with the
   fewest cells against the plain version's; and after phase 45 the
   outputs, step counts, word counters, descriptors, words and CIGARs of
   all four against the plain version's trace from a CPU worker;
33. the big kernel's FLAGS instances (``csrc/big_flags.cu``,
   ``csrc/big_trace_flags.cu``) against the plain version: 32-pair
   structural batches at (128, 1024), (512, 1024) and (1024, 1024) with
   ``ByteMatrix(1, -1)`` (all 256 bytes, byte 0) global and traced, local
   start global, x 20 / 100 and traced, free query start gaps traced and
   x 20 / 100, free query end gaps (queries shorter than the min size)
   global and traced, and 2 growth pairs at (512, 8192) with traced local
   start, whose steps reach 8192 rows (the largest shared memory, 16 bytes
   a row): outputs, step counts, word counters, descriptors, words (the
   zero words too) and CIGARs equal; the FLAGS instances' launch shapes at
   1024, 4096 and 8192 rows.  The plain versions of phases 25, 26, 30 and
   33 run in the CPU workers (but under a capped step count or trace
   budget) and are held against the kernels' outputs after phase 42;
34. the byte band: phase 27's pairs with ``ByteMatrix(2, -4)``, -6/-2,
   global and (the first 512) traced (``align_all_trace`` in batches of
   256): on ACGT
   reads byte equality scores as ``NucMatrix(2, -4)`` does, so every
   result must equal phase 27's plain version's and every CIGAR phase
   31's, pair for pair;
35. local start with x_drop 50 on the same band, global and (the first
   512) traced (the CIGARs of the 32 pairs with the fewest cells against
   the plain version's);
36. glocal read-to-window: 1024 reads of 600..999 bases cut from the
   nanopore pairs (``read_window_pairs``), each against its reference
   window with 500..1499 random bases of flank a side, at (1024, 1024)
   with free query start and end gaps, global and traced (the first 256
   CIGARs against the plain version's);
37. the (32, 512) band without trace on the uc30 pairs with
   ``ByteMatrix(1, -1)``, and with local start under BLOSUM62;
38. the reference's PSSM self-oracle (``examples/pssm_accuracy.rs:80-82``;
   the JAX package's ``examples_tpu/pssm_accuracy.py``) on the big
   kernel's profile instances (``csrc/big_profile.cu``): phase 16's 8192
   SCOP-style pairs through ``ProfileAligner((2048, 2048), seq_cap=max_q +
   16, prof_len=max_p + 16)``, global and (the first 2048, each of which
   runs the first rect's 2048 columns) x 50, then ``pssm_accuracy.py``'s
   table: how many lane and adaptive results at (32, 32), (32, 64), (64,
   64), (64, 128) and (128, 128) equal the self-oracle's;
39. growth: 4 strong-consensus profiles with random middles of 500..1400
   positions, 2 more whose gap opens and closes vary by position and 2
   such profiles whose queries miss a stretch of them, at (32, 2048),
   global (blocks must reach 1024 and 2048, the varied ones too) and x 50,
   and 2 at (512, 4096) whose blocks must reach 4096, against the plain
   version; the profile instances' launch shapes at 1024..8192 rows;
40. trace (``csrc/big_trace_profile.cu``): the self-oracle pairs traced in
   batches of 256, global (all 8192) and x 50 (the first 1024), each
   CIGAR rescored (``check_profile_cigars``) and the first 256 against the
   plain version's; the (32, 2048) pairs of phase 39 traced, global and x
   50, against the plain version down to the CIGARs;
41. the flags on the self-oracle pairs: local start (and traced, 2048
   pairs, and traced with x 50, 1024), on 2048 of them free query end gaps
   and free query start gaps with x 50; on the (32, 2048) pairs of phase
   39 traced local start and free start gaps against the plain version;
42. ``align_profile_exp_all`` on 1024 of the self-oracle pairs over a
   (256, 2048) ladder, the self-oracle's score as the target (8
   unreachable), every result held against the plain version at its size;
43. (the plain versions of phases 43, 45 and 47 run on the host's CPU in
   three niced worker processes, spawned once the builds are done, while
   the card runs phases 3-42) the lane kernel on codes past 16384
   positions (the TPU kernel's segmented windows, A7):
   ``LongBatchAligner`` at block 512
   (``nanopore_accuracy.rs``' 1% band for 50 kbp reads) against its plain
   version on 2 ONT-like pairs of 17-20 kbp (``long_pairs``), global, x 100,
   traced and x 100 traced (step counts, descriptors, words, CIGARs), and
   on 2 (query, profile) pairs of 16.5-17.5k positions
   (``long_profile_pairs``);
44. the long lane main paths: 64 simulated ONT-like pairs of 25-50 kbp
   with 10% edits (``examples_tpu/common.py::load_nanopore_pairs`` under a
   name with no file), ``NucMatrix.new_simple(2, -4)``, gaps -6/-2, block
   512, global and x 100, through ``align_staged`` and ``align_all``; each
   traced on all 64 pairs (``align_batch``, sub-batches by
   ``ops/_trace.py``'s byte budget), its results equal to the untraced
   ones, the first 16 CIGARs spanning to their ends and rescoring, its
   descriptors giving the cells of the bounds; the traced kernel timed
   with the first trace budget ``align_batch`` gives it and with the JAX
   default budget;
45. the big kernel on codes past 16384 positions (its segmented windows):
   ``LongAdaptiveAligner`` at (512, 8192) against its plain version on the
   pairs of phase 43, global, x 100, traced and x 100 traced;
46. the long adaptive main paths: phase 44's pairs at (512, 8192), global
   and x 100, each traced as there;
47. the 16384-row band (``percent_len``'s clamp): 2 growth pairs
   (``growth_pairs_16384``) at (512, 16384) through the 16384-row
   instances (``big_16384.cu``, ``big_trace_16384.cu``) against the plain
   version, global (blocks must reach 16384), traced (step counts, word
   counters, descriptors, words, CIGARs), with an x that ends no pair
   before its block reaches 16384, traced with that x, traced with local
   start (whose blocks reach 8192) and with ``ByteMatrix(2, -4)`` (results
   equal the global band's); their launch shapes;
48. the API: ``BatchAligner(seq_cap=65536)`` at (512, 8192) and (512, 512)
   takes the "long" and "long_lane" routes and equals the long classes on
   phase 44's pairs; ``align_exp_all`` over (128, 8192) at ``seq_cap``
   65536 on 16 of them, each result equal to ``LongAdaptiveAligner`` at the
   min size it reports.

On every main path the kernels must have launched (their counts are set to
0 just before the path and read just after) and every result must equal the
plain version's; kernel times come from CUDA events, packing and decoding
are timed apart.  A trace main path runs ``align_all_trace``; its results
must equal the non-trace instance's (none exists at max size 512), every
CIGAR must sum to its end position and rescore to its score (with local
start from wherever it starts, with free query start gaps from query row 0;
with free query end gaps to at most its score, every CIGAR then held
against the plain version's on the lane and adaptive routes, the first 256
on the big route), and the first 512 (on the big route those of the 32
pairs with the fewest cells) must equal those walked from the plain
version's trace; pack, the trace's copy-back and the walk
are timed on the host clock.  A profile trace path holds every CIGAR to its
end and to its score under the reference's profile costs
(``rescore_profile``); a CIGAR that does not rescore (the reference's own
walk misses on some pairs with position-specific gap opens) must equal the
plain version's.  The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises, so the script exits non-zero and prints no result.  It needs the
repository around it and a CUDA device; without either it fails.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from itertools import product
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
DNA = np.frombuffer(b"ACGT", dtype=np.uint8)

# the reference's hand-checked fixed-block scores (reference:
# src/scan_block.rs:1902-1940, src/lib.rs:8-35): (matrix, gaps, block, pairs)
GOLDEN = [
    ("BLOSUM62", (-11, -1), 16, [
        (b"", b"", 0), (b"", b"AAAA", -14), (b"AAAA", b"", -14),
        (b"AARA", b"AAAA", 11), (b"AARAAAA", b"AAAAAAAA", 12),
        (b"AAAA", b"AAAA", 16), (b"RRRR", b"AAAA", -4), (b"AAA", b"AAAA", 1),
    ]),
    ("NW1", (-2, -1), 16, [
        (b"ATAA", b"AAAN", 0), (b"A" * 32, b"A" * 32, 32),
        (b"T" * 32, b"A" * 32, -32), (b"TA" * 16, b"A" * 32, 0),
        (b"TTTTTTTTAAAAAAATTTTTTTTT", b"TTAAAAAAATTTTTTTTTTTT", 7),
        (b"C", b"AAAA", -5), (b"AAAA", b"C", -5),
    ]),
    # the README example at block 32
    ("NW1", (-2, -1), 32, [
        (b"TTTTTTTTAAAAAAATTTTTTTTT", b"TTAAAAAAATTTTTTTTTTTT", 7),
    ]),
]

# adaptive scores pinned from BlockOracle (tests/test_torch_adaptive_kernel.py
# asserts them): (matrix, gaps, (min, max), pairs).  All but the first and
# the edge cases score higher than the oracle at the fixed min size, so
# their blocks grew.
GOLDEN_ADAPTIVE = [
    ("BLOSUM62", (-11, -1), (16, 32), [
        (b"CAGGATTAGCGGATCACG", b"CTGGAGTCTTTTAGCGGATCACGC", 77),
        (b"QCFHHWSWYCDVCEEWIGELNTPYDLNQAFLCYPSMNHHDFSKTGRVTFIGS",
         b"QCFGHWSGYCDVCEEWIGELGTISILLLLYFVECHFPEPTDLNQAFLCYPSMNHHDCSKTGR"
         b"VTFILS", 235),
        (b"AARILQNQDSTNIGKSNEGEKGDPRHDKGIFADTMMEQSWGAYVNYCNPFFMIMFKGMPLMG",
         b"ITRPLPVWSMFDIPEPTIARILQNQDSTNIGKSNEGEKGDPRHLFGIFADTMMEWSWGAYVNY"
         b"CNPFFMDMFKGMPLMG", 275),
    ]),
    ("BLOSUM62", (-11, -1), (16, 64), [
        (b"AQENVQTILMHKGNVPLQETIEHFKHKWSPVDRHSRVFERYWVWALFHQESDFCITCHVFHVWD"
         b"CDYGATFDQFTWHVSQMDMRHYIQ",
         b"AQENVQTILMHKGNVPLQETIEHFKHKWSPVDRHSRPFERYWVWALVFHVKHCDYGATFDQFTW"
         b"HVSRMDMRHYIQ", 386),
    ]),
    ("BLOSUM62", (-11, -1), (32, 256), [
        (b"CWDYANARQSEKVYSQRNQSWEMDGCRDDPGHAAYNGYVLVFMERNHEKLWKYGCFTSSLKTAV"
         b"LNQADMNTWEDLQPIMSI",
         b"CWDYANARQPEKVYSQRNHSWELDGCRDDPGSSLKTAVLNQADMNTWEDLQPIMSI", 260),
        (b"", b"", 0), (b"A", b"", -11), (b"", b"ACGT", -14),
    ]),
    ("NW1", (-2, -1), (16, 64), [
        (b"GAGCAGGATATCCGGAACGAGCAACATTAGCGCTAGCACTCGGCTTCAGGAATGCTTC",
         b"GAGCAGGATATCCGGAACGAGCAACATTAGCGCTAGCACTGTAGTATTGCAGCTAACTCATTTG"
         b"ACATTGCTGGCGGCTTCAGGAATGCTTC", 23),
        (b"", b"ACGT", -5),
    ]),
]

# The least time for a kernel's work: bytes over the memory rate, integer
# operations over the int32 rate.  3.35 TB/s is the H100 SXM's HBM rate
# (NVIDIA's data sheet).  A Hopper SM issues 64 int32 operations per clock
# (four sub-partitions of 16 INT32 lanes; NVIDIA's Hopper architecture white
# paper); the SM count and the maximum SM clock are read from the card.
# A DP cell of the recurrence needs 12 int32 adds and maxes, whatever the
# kernel's layout: the score add (its clamp is absorbed by the merge with
# C, which is never below the rail); for C two adds, one max and one clamp
# (the two clamps fold into one); the merge max(D, C); a serial max-plus
# scan's add, add and max; the zero correction; the final merge and the
# rect maximum.  Carries between a kernel's scan segments are its own cost.
HBM_BYTES_PER_S = 3.35e12
INT32_PER_SM_CLOCK = 64
OPS_PER_CELL = 12
# x-drop adds the 16-residue tracker: the cell's max into its residue's
# running max, and the compare that says whether the cell reached it
OPS_PER_CELL_XDROP = OPS_PER_CELL + 2


# trace adds, per cell: the four compares of its bits (D == C, D == R,
# C == C_open, R == D_open), the shift that hands the R bit to the row
# below, and the shift and or that put the cell's bits into its word
OPS_PER_CELL_TRACE = 7
# profile mode adds, per cell, the gap close on C (right steps) or R (down
# steps): one add.  Whatever the layout, the score is a lookup and the
# position's opens replace constants; the clamps of the closed value and of
# D plus its R open fold into the merges into D, which is never below the
# rail.  Unpacking a score byte from its word is this layout's own cost.
# Its profile rows are 32 bytes a position.
OPS_PER_CELL_PROFILE = 1
# where the TPU kernels compute ByteMatrix scores and the flags
LANE_BYTE = "block_aligner_tpu/ops/lane_kernel.py:800"
LANE_FLAGS = "block_aligner_tpu/ops/lane_kernel.py:823"
LANE_FREE_END = "block_aligner_tpu/ops/lane_kernel.py:957"
LANE_ZERO_BIT = "block_aligner_tpu/ops/lane_kernel.py:895"
AD_BYTE = "block_aligner_tpu/ops/adaptive_kernel.py:635"
AD_FLAGS = "block_aligner_tpu/ops/adaptive_kernel.py:658"
AD_ZERO_BIT = "block_aligner_tpu/ops/adaptive_kernel.py:736"
# kernel C's byte compare, its relative-zero seeds (origin, free start gaps,
# local start), its zero bit and its free-end tracker
C_BYTE = "block_aligner_tpu/ops/big_kernel.py:1321"
C_FLAGS = "block_aligner_tpu/ops/big_kernel.py:1337"
C_ZERO_BIT = "block_aligner_tpu/ops/big_kernel.py:1406"
C_FREE_END = "block_aligner_tpu/ops/big_kernel.py:1434"
# kernel C's profile fetch and per-cell gap costs, and its profile trace
# against the gap-closed values
C_PROFILE = "block_aligner_tpu/ops/big_kernel.py:1283"
C_PROFILE_TRACE = "block_aligner_tpu/ops/big_kernel.py:1394"
# byte mode compares the lane's byte with the entering one where the score
# was a lookup: one compare-select.  Local start raises D to the relative
# zero: one max; with trace its zero bit is a compare, a shift and an or.
# Free start gaps touch row 0 only, so nothing per cell; free end gaps run
# the x-drop tracker (OPS_PER_CELL_XDROP).
OPS_PER_CELL_BYTE = 1
OPS_PER_CELL_LOCAL = 1
OPS_PER_CELL_ZERO_BIT = 3
# the TPU kernels' long-sequence modes: the lane kernel's segmented windows
# (A7), kernel C's, and its HBM-streamed planes past 8192 rows
A7_WINDOWS = "block_aligner_tpu/ops/lane_kernel.py:1192"
C_WINDOWS = "block_aligner_tpu/ops/big_kernel.py:187"
C_16384 = "block_aligner_tpu/ops/big_kernel.py:338"
# the 16384-row band (phase 47): its min size, and an x that ends no pair
# before its block reaches 16384 rows
BAND_MIN = 512
BAND_X = 50000


def random_pairs(rng, alphabet, n, max_len):
    """Half related (substitutions and indels), half unrelated pairs, with
    lengths 0..max_len, plus empty and length-1 sequences."""
    pairs = [(b"", b""), (b"", b"A"), (b"A", b""), (b"A", b"A")]
    while len(pairs) < n:
        q = rng.choice(alphabet, size=int(rng.integers(0, max_len + 1)))
        if rng.random() < 0.5 or len(q) == 0:
            r = rng.choice(alphabet, size=int(rng.integers(0, max_len + 1)))
        else:
            k = len(q) // 8 + 1
            r = q.copy()
            r[rng.integers(0, len(q), size=k)] = rng.choice(alphabet, size=k)
            r = np.delete(r, rng.integers(0, len(r), size=k // 4))
            r = np.insert(r, rng.integers(0, len(r) + 1, size=k // 4),
                          rng.choice(alphabet, size=k // 4))[:max_len]
        pairs.append((q.tobytes(), r.tobytes()))
    return pairs


def rand_byte_pairs(rng, n_pairs, length, k):
    """``bench.rand_protein_pairs``' pairs over all 256 byte values: a
    random query of ``length`` bytes, the reference a copy with ``k``
    substitutions and up to k/4 deletions and k/4 insertions."""
    alphabet = np.arange(256, dtype=np.uint8)
    pairs = []
    qs = rng.choice(alphabet, size=(n_pairs, length))
    for q in qs:
        r = q.copy()
        r[rng.integers(0, length, size=k)] = rng.choice(alphabet, size=k)
        ndel = int(rng.integers(0, k // 4 + 1))
        if ndel:
            keep = np.ones(length, dtype=bool)
            keep[rng.integers(0, length, size=ndel)] = False
            r = r[keep]
        nins = int(rng.integers(0, k // 4 + 1))
        if nins:
            r = np.insert(r, rng.integers(0, len(r), size=nins),
                          rng.choice(alphabet, size=nins))
        pairs.append((q.tobytes(), r.tobytes()))
    return pairs


def byte_pairs(rng, n, max_len):
    """``ByteMatrix`` pairs over all 256 byte values, byte 0 (the padding
    code) included: the JAX package's golden pair (b"AAAAAA", b"AAAaaA"),
    runs of byte 0, then ``random_pairs`` over the byte alphabet."""
    zero = bytes(1)
    pairs = [(b"AAAAAA", b"AAAaaA"), (zero * 5, zero * 7),
             (b"\x00A\x00", b"A\x00\x00\x00")]
    alphabet = np.arange(256, dtype=np.uint8)
    return pairs + random_pairs(rng, alphabet, n - len(pairs), max_len)


def xdrop_protein_pairs(rng, n):
    """The JAX package's x-drop workload (examples_tpu/run_results.py::
    bench_xdrop, seed 7 there): protein pairs of 800..999 residues, the
    reference a copy of the query with len/10 random substitutions."""
    aa = list(b"ACDEFGHIKLMNPQRSTVWY")
    pairs = []
    for _ in range(n):
        k = int(rng.integers(800, 1000))
        q = bytes(rng.choice(aa, size=k).tolist())
        r = bytearray(q)
        for _ in range(k // 10):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(aa))
        pairs.append((q, bytes(r)))
    return pairs


def short_read_pairs(rng):
    """The JAX package's traced short-read workloads
    (examples_tpu/run_results.py::bench_short_reads, seed 77 there), drawn
    in its order: 16384 Illumina-like pairs of 100..150 bases with 1%
    edits, then 8192 nanopore-like pairs of 800..999 bases with 10% edits;
    each pair is (mutated copy, original)."""
    dna = b"ACGT"

    def mutated(n, err):
        r = bytes(rng.choice(list(dna), size=n).tolist())
        q = bytearray(r)
        for _ in range(max(1, int(n * err))):
            op = int(rng.integers(0, 3))
            pos = int(rng.integers(0, max(len(q), 1)))
            if op == 0:
                q[pos % len(q)] = int(rng.choice(list(dna)))
            elif op == 1 and len(q) > 1:
                del q[pos % len(q)]
            else:
                q.insert(pos, int(rng.choice(list(dna))))
        return bytes(q), r

    ill = [mutated(int(rng.integers(100, 151)), 0.01) for _ in range(16384)]
    ont = [mutated(int(rng.integers(800, 1000)), 0.1) for _ in range(8192)]
    return ill, ont


def grow_to_512_pairs(rng, n, length=700, inserted=450):
    """Protein pairs whose adaptive blocks grow to 512: a ``length``-residue
    query and the same with ``inserted`` random residues inserted in its
    middle (560 and 300 suffice)."""
    pairs = []
    for _ in range(n):
        q = rng.choice(AA, size=length)
        mid = length // 2
        pairs.append((q.tobytes(), np.concatenate(
            [q[:mid], rng.choice(AA, size=inserted), q[mid:]]).tobytes()))
    return pairs


def structural_pairs(rng, alphabet, n, max_len):
    """``random_pairs``, where every other pair's reference also gains or
    loses 1..3 blocks of 8..len/3 residues, which makes adaptive blocks
    grow."""
    pairs = random_pairs(rng, alphabet, n, max_len)
    for k in range(4, n, 2):
        q, r = pairs[k]
        r = np.frombuffer(r, dtype=np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            ln = int(rng.integers(8, max(9, len(r) // 3 + 1)))
            pos = int(rng.integers(0, max(len(r) - ln, 1)))
            if rng.random() < 0.5 and len(r) > ln + 8:
                r = np.concatenate([r[:pos], r[pos + ln:]])
            else:
                r = np.concatenate([r[:pos], rng.choice(alphabet, size=ln),
                                    r[pos:]])
        pairs[k] = (q, r[:max_len].tobytes())
    return pairs


def profile_of(rng, cons):
    """A profile of the consensus ``cons`` shaped as the JAX package's
    simulated SCOP profiles (``examples_tpu/common.py::load_scop_profiles``):
    scores -4..2, the consensus residue 4..11; gap opens -13..-9 and close
    costs -3..0 (0 there) that vary by position."""
    from block_aligner_tpu_torch.core.scores import AAProfile

    cons = np.frombuffer(cons, np.uint8)
    n = len(cons)
    prof = AAProfile(n, 2048, -1)
    base = rng.integers(-4, 3, size=(n, 26))
    base[np.arange(n), cons - 65] = rng.integers(4, 12, size=n)
    prof.pos_scores[1 : n + 1, :26] = base
    prof.gap_open_C[: n + 1] = rng.integers(-13, -8, size=n + 1)
    prof.gap_close_C[: n + 1] = rng.integers(-3, 1, size=n + 1)
    prof.gap_open_R[: n + 1] = rng.integers(-13, -8, size=n + 1)
    return prof


# query bytes outside A..Z (lower case is upper-cased): codes 26 and 27
# score by the profile's NULL and next column, every other one -128
def deletion_profile_pairs(rng, length=300):
    """Two (query, profile) pairs whose queries miss 70 and 80 positions of
    their profile (``profile_of`` a random sequence of ``length``): their
    profile gaps run along a down rect's rows, across its warps."""
    cons = rng.choice(AA, size=length).tobytes()
    return [(cons[:50] + cons[120:], profile_of(rng, cons)),
            (cons[:150] + cons[230:], profile_of(rng, cons))]


ODD_BYTES = np.frombuffer(b"[\\*-@x~", dtype=np.uint8)


def profile_pairs(rng, n, max_len, odd=True):
    """(query, AAProfile) pairs with varied gap opens and nonzero close
    costs: ``random_pairs``, each reference made the consensus of a
    profile; with ``odd`` every tenth query holds a few bytes outside
    A..Z."""
    pairs = []
    for k, (q, r) in enumerate(random_pairs(rng, AA, n, max_len)):
        if odd and k % 10 == 9 and q:
            b = np.frombuffer(q, np.uint8).copy()
            b[rng.integers(0, len(b), size=3)] = rng.choice(ODD_BYTES, size=3)
            q = b.tobytes()
        pairs.append((q, profile_of(rng, r)))
    return pairs


def scop_profiles(n_pairs, seed=1234, max_len=200):
    """The JAX package's simulated SCOP (query, profile) pairs
    (``examples_tpu/common.py::load_scop_profiles`` without its data file),
    drawn in its order with the port's ``AAProfile``: profiles of random
    consensus sequences of 30..max_len-1 residues, queries with n/5 edits,
    gap opens -13..-9 by position and close costs 0."""
    from block_aligner_tpu_torch.core.scores import AAProfile
    from examples_tpu.common import rand_mutate, rand_seq

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_pairs):
        n = int(rng.integers(30, max_len))
        cons = rand_seq(rng, AA.tobytes(), n)
        prof = AAProfile(n, 2048, -1)
        base = rng.integers(-4, 3, size=(n, 26))
        base[np.arange(n), np.frombuffer(cons, np.uint8) - 65] = (
            rng.integers(4, 12, size=n))
        prof.pos_scores[1 : n + 1, :26] = base
        prof.gap_open_C[: n + 1] = rng.integers(-13, -8, size=n + 1)
        prof.gap_close_C[: n + 1] = 0
        prof.gap_open_R[: n + 1] = rng.integers(-13, -8, size=n + 1)
        out.append((rand_mutate(rng, cons, n // 5, AA.tobytes()), prof))
    return out


def read_pssm(path):
    """(query, AAProfile) records of a SCOP PSSM file in the reference's
    format (scripts/scop_seq_profile_pairs.py; parsed as
    examples_tpu/common.py and examples/pssm_accuracy.rs:38-69 parse it):
    per record a ``#query`` line, a ``#consensus`` line whose length is the
    profile's, a header line, then one ``pos aa s1 .. s20`` line per
    position, scores in ACDEFGHIKLMNPQRSTVWY order; gap open -10 and close
    0 at positions 1..len."""
    from block_aligner_tpu_torch.core.scores import AAProfile

    with open(path) as f:
        lines = f.read().splitlines()
    out, k = [], 0
    while k + 1 < len(lines):
        seq = lines[k][1:].encode()
        plen = len(lines[k + 1]) - 1
        prof = AAProfile(plen, 2048, -1)
        for i in range(1, plen + 1):
            for c, v in zip(AA, lines[k + 2 + i].split()[2:22]):
                prof.set(i, int(c), int(v))
            prof.set_gap_open_C(i, -10)
            prof.set_gap_close_C(i, 0)
            prof.set_gap_open_R(i, -10)
        k += plen + 3
        out.append((seq, prof))
    return out


def blosum_profile(rng, seq):
    """The profile of ``seq`` under BLOSUM62 (its row of each residue),
    with gap opens -12..-9 and close costs -2..0 that vary by position."""
    from block_aligner_tpu_torch.core.scores import BLOSUM62, AAProfile

    r = np.frombuffer(seq, np.uint8)
    n = len(r)
    prof = AAProfile(n, 2048, -1)
    prof.pos_scores[1 : n + 1, :27] = BLOSUM62.table[r - 65, :27]
    prof.gap_open_C[: n + 1] = rng.integers(-12, -8, size=n + 1)
    prof.gap_open_R[: n + 1] = rng.integers(-12, -8, size=n + 1)
    prof.gap_close_C[: n + 1] = rng.integers(-2, 1, size=n + 1)
    return prof


def grow_profile_pairs(rng, n, length=560, inserted=300):
    """``grow_to_512_pairs`` as (query, profile) pairs: the profile is the
    reference's with the inserted residues (``blosum_profile``), and
    adaptive blocks grow to 512 rows to cross it."""
    return [(q, blosum_profile(rng, r)) for q, r in
            grow_to_512_pairs(rng, n, length, inserted)]


def consensus_growth_pairs(rng, n, flank, middle, varied=False):
    """(query, profile) pairs whose blocks grow past 512: a strong-consensus
    profile (``AAProfile.from_bytes``: 5 on the consensus residue, -4
    elsewhere, gap opens -11, close 0, extend -1; the JAX package's
    ``tests/test_big_profile.py::growth_pair``) of a flank, a random middle
    of ``middle`` residues and a second flank, and as the query the same
    flanks around a middle drawn apart, as ``growth_pairs`` builds DNA
    pairs (an insert alone grows the blocks to 512 at most).  Flanks of
    ``flank`` residues.  With ``varied`` the gap opens (-13..-9, C and R
    apart) and close costs (-3..0) vary by position, as ``profile_of``'s
    do."""
    from block_aligner_tpu_torch.core.scores import AAProfile

    pairs = []
    for _ in range(n):
        a, c, m1, m2 = (rng.choice(AA, size=k).tobytes()
                        for k in (flank, flank, middle, middle))
        prof = AAProfile.from_bytes(a + m1 + c, 2048, 5, -4, -11, 0, -11, -1)
        if varied:
            k = prof.str_len + 1
            prof.gap_open_C[:k] = rng.integers(-13, -8, size=k)
            prof.gap_close_C[:k] = rng.integers(-3, 1, size=k)
            prof.gap_open_R[:k] = rng.integers(-13, -8, size=k)
        pairs.append((a + m2 + c, prof))
    return pairs


def growth_pairs(rng, n):
    """DNA pairs whose blocks grow to 4096 or 8192 at (512, 8192): a flank,
    a random middle of 1200..3200 bases drawn apart for each side, and a
    second flank, the flanks with 5% edits on the reference side (the JAX
    package's 4096-growth test builds its pair so; the middle stalls the
    y-drop counter, and no grown block finds a new best before it spans
    the middle).  At most 8100 bases a side, within (512, 8192)'s code
    budget of 16384."""
    from examples_tpu.common import rand_mutate, rand_seq

    pairs = []
    for k in range(n):
        a, m, c = ((600, 3000, 4500), (600, 1500, 2500), (300, 3200, 4600),
                   (1000, 1200, 1500))[k % 4]
        A, C = rand_seq(rng, b"ACGT", a), rand_seq(rng, b"ACGT", c)
        pairs.append((A + rand_seq(rng, b"ACGT", m) + C,
                      rand_mutate(rng, A, a // 20, b"ACGT")
                      + rand_seq(rng, b"ACGT", m)
                      + rand_mutate(rng, C, c // 20, b"ACGT")))
    return pairs


def growth_pairs_16384(rng, n):
    """DNA pairs whose blocks grow to 16384 (``percent_len``'s clamp):
    ``growth_pairs`` scaled up, a flank, a random middle of 6000..8000 bases
    drawn apart for each side, and a second flank, the flanks with 5% edits
    on the reference side."""
    from examples_tpu.common import rand_mutate, rand_seq

    pairs = []
    for k in range(n):
        a, m, c = ((600, 7000, 4000), (800, 6000, 3000), (400, 8000,
                                                            3500))[k % 3]
        A, C = rand_seq(rng, b"ACGT", a), rand_seq(rng, b"ACGT", c)
        pairs.append((A + rand_seq(rng, b"ACGT", m) + C,
                      rand_mutate(rng, A, a // 20, b"ACGT")
                      + rand_seq(rng, b"ACGT", m)
                      + rand_mutate(rng, C, c // 20, b"ACGT")))
    return pairs


def long_pairs(rng, n, lo, hi):
    """ONT-like DNA pairs of lo..hi-1 bases with 10% edits
    (``examples_tpu/common.py::load_nanopore_pairs``' simulation)."""
    from examples_tpu.common import rand_mutate, rand_seq

    pairs = []
    for _ in range(n):
        q = rand_seq(rng, b"ACGT", int(rng.integers(lo, hi)))
        pairs.append((q, rand_mutate(rng, q, len(q) // 10, b"ACGT")))
    return pairs


def long_profile_pairs(rng, n, lo, hi):
    """(query, profile) pairs of lo..hi-1 positions: ``profile_of`` a random
    consensus, its query the consensus with len/10 substitutions."""
    pairs = []
    for _ in range(n):
        cons = rng.choice(AA, size=int(rng.integers(lo, hi)))
        q = cons.copy()
        at = rng.integers(0, len(q), size=len(q) // 10)
        q[at] = rng.choice(AA, size=len(at))
        pairs.append((q.tobytes(), profile_of(rng, cons.tobytes())))
    return pairs


def plain_job(route, cfg, pack):
    """Run in a worker process: the plain version of ``route``'s kernel on a
    packed batch of CPU tensors, on one thread; returns its output and its
    milliseconds.  On the big route the output ends with the largest
    blocks reached (and without trace each pair's DP cells before them);
    its trace keeps only the words each pair wrote and the executed
    descriptors."""
    import torch

    from block_aligner_tpu_torch.ops import adaptive_kernel as ak
    from block_aligner_tpu_torch.ops import big_kernel as bk
    from block_aligner_tpu_torch.ops import lane_kernel as lk

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if route == "big":
        res = bk.big_align_plain(*pack, cfg, count_cells=not cfg.trace,
                                 top_size=True)
    else:
        res = {"lane": lk.lane_align_plain,
               "adaptive": ak.adaptive_align_plain}[route](*pack, cfg)
    ms = (time.perf_counter() - t0) * 1e3
    if route == "big" and cfg.trace:
        out, words, desc, steps, used, top = res
        res = (out, words[:, : int(used.max())].clone(),
               desc[: int(steps.max())].clone(), steps, used, top)
    return res, ms


def instance(route, cfg):
    """The name ``expect_launches`` gives the kernel instance that runs
    ``cfg`` on ``route``."""
    name = {"lane": "lane_align", "adaptive": "adaptive_align",
            "big": "big_align"}[route]
    if getattr(cfg, "max_size", 0) > 8192:
        name += "_16384"
    flags = (cfg.local_start or cfg.free_query_start_gaps
             or cfg.free_query_end_gaps)
    for mode, on in (("profile", cfg.profile), ("byte", cfg.byte_mode),
                     ("flags", flags), ("xdrop", cfg.x_drop),
                     ("trace", cfg.trace)):
        if on:
            name += "_" + mode
    return name


def trace_cells(tr, n):
    """Each of the first ``n`` pairs' DP cells by a trace's executed
    descriptors (a ``Trace`` or ``TraceParts``): 8 columns of its step's
    height a step, (n,) int64."""
    from block_aligner_tpu_torch.core.traceback import TraceParts

    cells = np.zeros(n, np.int64)
    parts = (zip(tr.traces, tr.pairs) if isinstance(tr, TraceParts)
             else [(tr, np.arange(n))])
    for t, idx in parts:
        ran = np.arange(t.desc.shape[0])[:, None] < t.steps[None, :]
        per = 8 * np.where(ran, t.desc[:, :, 3], 0).sum(0).astype(np.int64)
        mine = (idx >= 0) & (idx < n)
        cells[idx[mine]] = per[: len(idx)][mine]
    return cells


def read_window_pairs(rng, pairs, lo=600, hi=1000, flank=(500, 1500)):
    """Read-to-window pairs from long-read pairs ``(q, r)``: a read of
    lo..hi-1 bases cut from each ``r`` at a random start, and as its
    reference the stretch of ``q`` it came from (positions scaled by the
    length ratio, 100 bases of margin a side) between two random flanks of
    flank[0]..flank[1]-1 bases."""
    from examples_tpu.common import rand_seq

    out = []
    for q, r in pairs:
        n = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(r) - n))
        a = max(0, s * len(q) // len(r) - 100)
        b = min(len(q), (s + n) * len(q) // len(r) + 100)
        out.append((r[s : s + n], rand_seq(rng, b"ACGT", int(rng.integers(
            *flank))) + q[a:b] + rand_seq(rng, b"ACGT",
                                          int(rng.integers(*flank)))))
    return out


def x_dropped(out, staged):
    """How many pairs of an x-drop run ended short of (qlen, rlen): their
    best position lies before the end of the query or the reference."""
    ends = (out[:, 1].cpu() < staged.qlen.cpu()) | (out[:, 2].cpu()
                                                     < staged.rlen.cpu())
    return int(ends.sum())


def capped(cfg, **limits):
    """``cfg`` with the properties named in ``limits`` (its step cap
    ``max_steps``, a big-kernel trace budget ``trace_budget``) lowered."""
    cls = type("Capped", (type(cfg),), limits)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def with_step_cap(cfg, steps):
    """``cfg`` with its step cap lowered to ``steps``."""
    return capped(cfg, max_steps=steps)


def with_trace_budget(cfg, words):
    """A big-kernel ``cfg`` with its trace budget lowered to ``words`` a
    pair."""
    return capped(cfg, trace_budget=words)


def build_and_report(_build, name):
    """Build ``csrc/<name>.cu`` (``_build.build``) and return its path and
    one line per kernel instance: its registers, stack frame and spills as
    ``nvcc -Xptxas -v`` reports them with the build's flags (from the
    build's own log, or, if the library was built already, from a cubin
    compiled under ``build/``)."""
    path, log = _build.build(name, report=True)
    return path, (parse_ptxas(log, name) if log
                  else ptxas_report(_build, name))


def ptxas_report(_build, name):
    """``build_and_report``'s lines from a cubin of ``csrc/<name>.cu``."""
    flags = [f for f in _build.FLAGS if f not in ("-shared", "-Xcompiler",
                                                  "-fPIC")]
    _build.BUILD.mkdir(exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
         str(_build.BUILD / f"{name}.cubin"), str(_build.CSRC / f"{name}.cu")],
        capture_output=True, text=True, check=True)
    return parse_ptxas(proc.stderr, name)


def parse_ptxas(log, name):
    """The per-instance lines of a ``-Xptxas -v`` log of library ``name``;
    an instance of the flags libraries (``csrc/*_flags.cu``) is marked
    ``flags``, one of the big kernel's trace libraries (``csrc/big_trace.cu``,
    ``csrc/big_trace_flags.cu``, ``csrc/big_trace_profile.cu``,
    ``csrc/big_trace_16384.cu``) ``trace``, one of its profile libraries
    (``csrc/big_profile.cu``, ``csrc/big_trace_profile.cu``, which read the
    flags too) ``profile, flags``, one of its 16384-row libraries
    (``csrc/big_16384.cu``, ``csrc/big_trace_16384.cu``, which read the
    flags too) ``flags, 16384``."""
    profile = (", profile" if name.startswith("big") and "profile" in name
               else "")
    rows = ", 16384" if name.endswith("16384") else ""
    flags = ", flags" if name.endswith("_flags") or profile or rows else ""
    trace = ", trace" if name.startswith("big_trace") else ""
    lines, fn, frame = [], None, ""
    for line in log.splitlines():
        # the lane kernel's instances name their warps a pair too
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)"
                      r"ILi(\d+)E(?:Li(\d+)E)?Lb([01])ELb([01])ELb([01])E",
                      line)
        if m:
            fn = (f"{m[1]}<{m[2]}, {m[3] + ' warps, ' if m[3] else ''}"
                  f"{'x_drop' if m[4] == '1' else 'global'}"
                  f"{', trace' if m[5] == '1' else ''}"
                  f"{', profile' if m[6] == '1' else ''}{flags}>")
        # csrc/big_kernel.cu's instances: x-drop or global, by the rows a
        # thread holds at most
        m = re.search(r"Compiling entry function '\w*?\d(big_align_kernel)"
                      r"ILb([01])ELi(\d+)E", line)
        if m:
            fn = (f"{m[1]}<{'x_drop' if m[2] == '1' else 'global'}, {m[3]} "
                  f"rows{trace}{profile}{flags}{rows}>")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = (f"{m[1]} bytes stack, {m[2]} bytes spill stores, {m[3]} "
                     "bytes spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            lines.append(f"{fn}: {m[1]} registers, {frame}")
            fn = None
    if not lines:
        raise AssertionError(f"no ptxas report for {name}:\n{log}")
    return lines


PINNED_PTXAS = "chip_smoke_ptxas.txt"


def check_pinned_ptxas(reports):
    """Every instance of the sixteen libraries must keep the registers, stack
    and spills pinned in ``chip_smoke_ptxas.txt`` (their sources' counts
    with this toolkit; a kernel edit must leave the other instances' counts
    alone).  A new ``nvcc`` may move them all: re-pin from a run of
    unchanged sources."""
    with open(os.path.join(ROOT, PINNED_PTXAS)) as f:
        pinned = sorted(line.strip() for line in f if line.strip())
    got = sorted(reports)
    if got != pinned:
        raise AssertionError(
            f"ptxas counts differ from {PINNED_PTXAS}: new "
            f"{sorted(set(got) - set(pinned))[:6]}, pinned "
            f"{sorted(set(pinned) - set(got))[:6]}")
    print(f"[ptxas] the {len(got)} lane, adaptive and big instances keep the "
          f"counts pinned in {PINNED_PTXAS}")


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs."""
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    """Milliseconds of ``fn()`` on the host clock, ending in a synchronise;
    returns (result, ms)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    return got, (time.perf_counter() - t0) * 1e3


def bound(staged, cells, int32_per_s, x_drop=False, ops=None):
    """(bound_ms, bound_by) for one launch on ``staged``: each input read
    once and the int32 output, (B, 2) or in x-drop mode (B, 4), written
    once, against the DP cells the pairs need at ``ops`` per cell (by
    default the global or x-drop count)."""
    nbytes = (staged.codes.numel() + 4 * (staged.qlen.numel()
              + staged.rlen.numel() + staged.table.numel())
              + (16 if x_drop else 8) * staged.codes.shape[0])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if ops is None:
        ops = OPS_PER_CELL_XDROP if x_drop else OPS_PER_CELL
    t_ops = int(cells.sum()) * ops / int32_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wrappers(lk, ak):
    """The kernel wrappers whose launches a path counts."""
    from block_aligner_tpu_torch.ops import big_kernel

    return lk.lane_align, ak.adaptive_align, big_kernel.big_align


def reset_launches(lk, ak):
    for fn in wrappers(lk, ak):
        lk.reset_counts(fn)


def expect_launches(lk, ak, what, *launched):
    """The launch counts by kernel instance since ``reset_launches``; fails
    unless exactly the instances named in ``launched`` ran.  An instance's
    name is its wrapper's, then ``_profile``, ``_byte``, ``_flags``,
    ``_xdrop``, ``_trace``."""
    counts = {}
    for fn in wrappers(lk, ak):
        for c in lk.COUNTERS:
            name = fn.__name__ + "".join(
                f"_{m}" for m in ("16384", "profile", "byte", "flags",
                                  "xdrop", "trace") if f"{m}_" in c)
            counts[name] = getattr(fn, c)
    if any((counts[k] > 0) != (k in launched) for k in counts):
        ran = {k: v for k, v in counts.items() if v}
        raise AssertionError(f"{what}: launches {ran}, expected only "
                             f"{launched}")
    return counts


def check_equal(got, want, what):
    import torch

    if not torch.equal(got, want):
        bad = (got != want).any(1).nonzero()[:5, 0].tolist()
        raise AssertionError(f"kernel != plain {what}: pairs {bad}: "
                             f"{got[bad].tolist()} vs {want[bad].tolist()}")


def check_trace(got, want, what, words_per_row=1):
    """A trace instance's ``(out, words, desc, steps)`` against its plain
    version's: equal outputs and step counts, equal descriptors of every
    step a pair executed and equal words of those steps in the rows inside
    each step's height (``words_per_row`` 2 in local-start mode: the zero
    bits follow the 4-bit cells).  Returns the count of checkpoint saves
    and restores in the executed descriptors."""
    import torch

    check_equal(got[0], want[0], what)
    out, words, desc, steps = want
    if not torch.equal(got[3], steps):
        bad = (got[3] != steps).nonzero()[:5, 0].tolist()
        raise AssertionError(f"kernel != plain {what}: step counts of pairs "
                             f"{bad}: {got[3][bad].tolist()} vs "
                             f"{steps[bad].tolist()}")
    T, B, S = words.shape
    ran = torch.arange(T, device=steps.device)[:, None] < steps[None, :]
    gd = got[2][:T]
    if not torch.equal(gd[ran], desc[ran]):
        t, b = ((gd != desc).any(2) & ran).nonzero()[0].tolist()
        raise AssertionError(f"kernel != plain {what}: descriptor of pair {b} "
                             f"step {t}: {gd[t, b].tolist()} vs "
                             f"{desc[t, b].tolist()}")
    rows = torch.arange(S, device=steps.device) % (S // words_per_row)
    inside = ran[:, :, None] & (rows < desc[:, :, 3:4])
    diff = (got[1][:T] != words) & inside
    if bool(diff.any()):
        t, b, r = diff.nonzero()[0].tolist()
        raise AssertionError(f"kernel != plain {what}: word of pair {b} step "
                             f"{t} row {r}: {int(got[1][t, b, r])} vs "
                             f"{int(words[t, b, r])}")
    fl = torch.where(ran, desc[:, :, 0], 0)
    return int(((fl >> 2) & 1).sum()), int(((fl >> 3) & 1).sum())


def check_big_trace(got, want, what):
    """A big trace instance's ``(out, words, desc, steps, used)`` against
    its plain version's: equal outputs, step counts and word counters,
    equal descriptors of every step a pair executed (its word offset
    included), and equal words below each pair's counter, which are the
    rows of its steps' heights.  Returns the count of checkpoint saves and
    restores in the executed descriptors."""
    import torch

    check_equal(got[0], want[0], what)
    out, words, desc, steps, used = want
    for k, name in ((3, "step counts"), (4, "word counters")):
        if not torch.equal(got[k], want[k]):
            bad = (got[k] != want[k]).nonzero()[:5, 0].tolist()
            raise AssertionError(f"kernel != plain {what}: {name} of pairs "
                                 f"{bad}: {got[k][bad].tolist()} vs "
                                 f"{want[k][bad].tolist()}")
    T = desc.shape[0]
    ran = torch.arange(T, device=steps.device)[:, None] < steps[None, :]
    gd = got[2][:T]
    if not torch.equal(gd[ran], desc[ran]):
        t, b = ((gd != desc).any(2) & ran).nonzero()[0].tolist()
        raise AssertionError(f"kernel != plain {what}: descriptor of pair {b} "
                             f"step {t}: {gd[t, b].tolist()} vs "
                             f"{desc[t, b].tolist()}")
    for b in range(words.shape[0]):
        u = int(used[b])
        diff = (got[1][b, :u] != words[b, :u]).nonzero()
        if len(diff):
            r = int(diff[0, 0])
            raise AssertionError(f"kernel != plain {what}: word {r} of pair "
                                 f"{b}: {int(got[1][b, r])} vs "
                                 f"{int(words[b, r])}")
    fl = torch.where(ran, desc[:, :, 0], 0)
    return int(((fl >> 2) & 1).sum()), int(((fl >> 3) & 1).sum())


def block_trace(res, matrix, cfg=None):
    """The host ``Trace`` of a big trace instance's ``(out, words, desc,
    steps, used)``, computed with ``cfg``'s flags, as ``BatchAligner``
    builds it."""
    from block_aligner_tpu_torch import api
    from block_aligner_tpu_torch.core.traceback import Trace

    words, desc, steps, offsets = api._block_trace(*res[1:])
    return Trace(words, desc, steps, matrix, offsets=offsets,
                 **trace_flags(cfg))


def score_table(matrix):
    """256 x 256 scores of letter pairs, by raw byte (``matrix.get``); a
    ``ByteMatrix`` scores every byte pair."""
    if matrix.kind == "byte":
        same = np.eye(256, dtype=bool)
        return np.where(same, matrix.match_score, matrix.mismatch_score)
    tab = np.zeros((256, 256), np.int64)
    letters = list(range(65, 91)) + list(range(97, 123))
    for a in letters:
        for c in letters:
            tab[a, c] = matrix.get(a, c)
    return tab


def check_cigars(cigars, pairs, results, matrix, gaps, what, start="origin",
                 at_most=False):
    """The reference's trace check (examples_tpu/verify_trace.py:42-54, and
    the rescoring of tests/test_accuracy_random.py:151-167) on every pair:
    a CIGAR's ops sum to the result's end position, and its matches and
    mismatches scored with the matrix plus each gap run's open + (len - 1)
    * extend give the result's score.  Numpy over all pairs at once.  A
    CIGAR starts at (0, 0) (``start="origin"``), or with free query start
    gaps at query row 0 (``"query0"``), or with local start anywhere
    (``"any"``): where its ops sum to short of the end, it is scored from
    there.  With ``at_most`` (free query end gaps) a CIGAR may rescore
    below its score: the reference's result is the best of every row in
    row qlen's residue class (qlen % 16), at row qlen, so the score may be
    another row's.  Returns the count of ops and of CIGARs that rescore
    below their score."""
    from block_aligner_tpu_torch import Operation as Op

    runs = [np.array([(int(o.op), o.len) for o in c.to_vec()],
                     np.int64).reshape(-1, 2) for c in cigars]
    B = len(runs)
    nrun = np.array([len(r) for r in runs], np.int64)
    allr = np.concatenate(runs) if B else np.zeros((0, 2), np.int64)
    pair = np.repeat(np.arange(B), nrun)
    op, ln = allr[:, 0], allr[:, 1]
    diag = (op == Op.M) | (op == Op.Eq) | (op == Op.X)
    di = np.where(diag | (op == Op.I), ln, 0)
    dj = np.where(diag | (op == Op.D), ln, 0)
    ends = np.stack([np.bincount(pair, di, B), np.bincount(pair, dj, B)],
                    1).astype(np.int64)
    want_ends = np.array([(r.query_idx, r.reference_idx) for r in results],
                         np.int64).reshape(-1, 2)
    starts = want_ends - ends
    ok = {"origin": (starts == 0).all(1),
          "query0": (starts[:, 0] == 0) & (starts[:, 1] >= 0),
          "any": (starts >= 0).all(1)}[start]
    if not ok.all():
        k = int(np.flatnonzero(~ok)[0])
        raise AssertionError(f"{what}: pair {k}: CIGAR {cigars[k]} spans "
                             f"{tuple(ends[k])}, result {results[k]}")
    gap = np.where((op == Op.I) | (op == Op.D),
                   gaps.open + (ln - 1) * gaps.extend, 0)
    # each diagonal op's query and reference index
    first = np.concatenate([[0], np.cumsum(nrun)[:-1]])
    i0 = np.cumsum(di) - di
    j0 = np.cumsum(dj) - dj
    i0 -= i0[first[pair]] - starts[pair, 0] if len(pair) else 0
    j0 -= j0[first[pair]] - starts[pair, 1] if len(pair) else 0
    rep = np.repeat(np.flatnonzero(diag), ln[diag])
    run0 = np.repeat(np.cumsum(ln[diag]) - ln[diag], ln[diag])
    off = np.arange(rep.size) - run0
    width = max([len(q) for q, _ in pairs] + [len(r) for _, r in pairs] + [1])
    qb = np.zeros((B, width), np.uint8)
    rb = np.zeros((B, width), np.uint8)
    for k, (q, r) in enumerate(pairs):
        qb[k, : len(q)] = np.frombuffer(q, np.uint8)
        rb[k, : len(r)] = np.frombuffer(r, np.uint8)
    pr = pair[rep]
    sub = score_table(matrix)[qb[pr, i0[rep] + off], rb[pr, j0[rep] + off]]
    score = (np.bincount(pair, gap, B) + np.bincount(pr, sub, B)).astype(
        np.int64)
    want = np.array([r.score for r in results], np.int64)
    bad = score > want if at_most else score != want
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        raise AssertionError(f"{what}: pair {k}: CIGAR {cigars[k]} rescores "
                             f"to {score[k]}, result {results[k]}")
    return int(ln.sum()), int((score < want).sum())


def cigar_span(cigar):
    """(query, reference) positions a CIGAR's ops advance."""
    from block_aligner_tpu_torch import Operation as Op

    i = j = 0
    for r in cigar.to_vec():
        i += r.len * (int(r.op) != Op.D)
        j += r.len * (int(r.op) != Op.I)
    return i, j


def profile_gap_rects(tr, b, cigar, result=None):
    """For each D run of pair ``b``'s CIGAR, in forward order: whether the
    walk read the run's first cell from a right rect, and whether the run
    passes from a down rect's last lane into a right rect (a hand-off).
    The rects are those the walk takes (``Trace.cigars_all``): walking back
    from the end, a pair keeps its rect until a cell leaves the rect's
    lower bounds, then takes the latest earlier rect that holds it.  With
    a ``result`` the CIGAR ends at its position and starts where its ops
    lead back to (not at (0, 0) with local start or free start gaps);
    without, it starts at (0, 0)."""
    from block_aligner_tpu_torch import Operation as Op

    rects = tr.rects_for(b)
    runs = [(int(r.op), r.len) for r in cigar.to_vec()]
    cells, (i, j) = [], (0, 0)
    if result is not None:
        di, dj = cigar_span(cigar)
        i, j = result.query_idx - di, result.reference_idx - dj
    for op, n in runs:
        for _ in range(n):
            i += op != Op.D
            j += op != Op.I
            cells.append((i, j))
    at, k = [0] * len(cells), len(rects) - 1
    for t in range(len(cells) - 1, -1, -1):
        ci, cj = cells[t]
        while ci < rects[k].row or cj < rects[k].col:
            k -= 1
        at[t] = k
    out, s = [], 0
    for op, n in runs:
        if op == Op.D:
            hand = False
            for t in range(s, s + n - 1):
                a, z = rects[at[t]], rects[at[t + 1]]
                hand |= (not a.right and z.right
                         and cells[t][1] - a.col == a.h - 1)
            out.append((rects[at[s]].right, hand))
        s += n
    return out


def rescore_profile(cigar, gap_rects, query, prof, start=(0, 0)):
    """``(score, end)`` of a profile CIGAR under the block DP's profile
    costs: a matched query code c at profile position j scores
    ``pos_scores[j, c]`` (codes past 27 -128); a run of n query residues
    (I) at position j costs ``gap_open_R[j] + n * extend``; a run of n
    profile positions (D) costs its open, ``n * extend`` and
    ``gap_close_C`` of its last position.  A right rect charges the open
    at the gap's first position, a down rect at the position before it
    (oracle.py::_SeqProfileFetch: a down rect opens a profile gap from its
    lane's own cost); ``gap_rects`` (``profile_gap_rects``) says which
    rect read each D run's first cell.  The CIGAR starts at ``start``."""
    from block_aligner_tpu_torch import Operation as Op

    codes = prof.convert(query).astype(np.int64)
    e = prof.get_gap_extend()
    (i, j), score = start, 0
    gaps = iter(gap_rects)
    for run in cigar.to_vec():
        op, n = int(run.op), run.len
        if op in (Op.M, Op.Eq, Op.X):
            c = codes[i : i + n]
            sc = prof.pos_scores[np.arange(j + 1, j + 1 + n),
                                 np.minimum(c, 31)]
            score += int(np.where(c < 28, sc, -128).sum())
            i, j = i + n, j + n
        elif op == Op.I:
            score += int(prof.gap_open_R[j]) + n * e
            i += n
        else:
            first = j + 1 if next(gaps)[0] else j
            score += (int(prof.gap_open_C[first]) + n * e
                      + int(prof.gap_close_C[j + n]))
            j += n
    return score, (i, j)


def check_profile_cigars(cigars, gap_rects, pairs, results, what,
                         start="origin"):
    """Every profile CIGAR must sum to its result's end and rescore to its
    score under ``rescore_profile``, but for one case the reference's trace
    cannot show: a down rect's last lane hands its R, which holds that
    lane's own gap open (its inclusive scan's zero-length term), to the
    next right rect as the C of a gap in progress.  Where the right rect
    extends it, the trace says "no open here" and the walk goes on back
    through the down rect's gap, one position too far, so the walked path
    is not the one the DP scored.  A pair that misses must have such a
    hand-off in a D run, and rescore below its score (the walked path is a
    real path, only not the best).  A CIGAR starts as ``check_cigars``'
    ``start`` says.  Returns (the pairs that miss, the pairs with a
    hand-off)."""
    miss, hand = [], 0
    for k, (cig, gr, (q, prof), res) in enumerate(zip(cigars, gap_rects,
                                                      pairs, results)):
        di, dj = cigar_span(cig)
        i0, j0 = res.query_idx - di, res.reference_idx - dj
        if not {"origin": i0 == j0 == 0, "query0": i0 == 0 and j0 >= 0,
                "any": i0 >= 0 and j0 >= 0}[start]:
            raise AssertionError(f"{what}: pair {k}: CIGAR {cig} spans "
                                 f"{(di, dj)}, result {res}")
        score, end = rescore_profile(cig, gr, q, prof, (i0, j0))
        if end != (res.query_idx, res.reference_idx):
            raise AssertionError(f"{what}: pair {k}: CIGAR {cig} ends at "
                                 f"{end}, result {res}")
        handoff = any(h for _, h in gr)
        hand += handoff
        if score == res.score:
            continue
        if not handoff or score > res.score:
            raise AssertionError(f"{what}: pair {k}: CIGAR {cig} rescores "
                                 f"to {score}, result {res}, and has no "
                                 "down-to-right gap hand-off")
        miss.append(k)
    return miss, hand


def walk_both(got, want, ends, matrix, what, cfg=None):
    """CIGARs walked from a kernel's trace and from its plain version's
    trace (computed with ``cfg``'s flags) must be equal."""
    from block_aligner_tpu_torch.core.traceback import Trace

    cig = []
    for res in (got, want):
        if len(res) == 5:  # the big kernel's block-sized trace
            tr = block_trace(res, matrix, cfg)
        else:
            out, words, desc, steps = res
            st = steps.cpu().numpy()
            T = int(st.max())
            tr = Trace(words[:T].cpu().numpy(), desc[:T].cpu().numpy(), st,
                       matrix, **trace_flags(cfg))
        cig.append([str(c) for c in tr.cigars_all(ends)])
    if cig[0] != cig[1]:
        k = next(k for k in range(len(ends)) if cig[0][k] != cig[1][k])
        raise AssertionError(f"{what}: CIGAR of pair {k}: kernel {cig[0][k]} "
                             f"vs plain {cig[1][k]}")


def trace_flags(cfg):
    """The flags a ``Trace`` of ``cfg``'s output needs."""
    return dict(local_start=getattr(cfg, "local_start", False),
                free_query_start_gaps=getattr(cfg, "free_query_start_gaps",
                                              False))


def cigar_start(cfg):
    """Where ``cfg``'s CIGARs start (``check_cigars``' ``start``)."""
    if cfg.local_start:
        return "any"
    return "query0" if cfg.free_query_start_gaps else "origin"


def ops_per_cell(cfg):
    """The int32 operations a DP cell of ``cfg``'s mode needs at least."""
    ops = OPS_PER_CELL
    if cfg.x_drop or cfg.free_query_end_gaps:
        ops += OPS_PER_CELL_XDROP - OPS_PER_CELL  # the tracker
    if cfg.trace:
        ops += OPS_PER_CELL_TRACE
        if cfg.local_start:
            ops += OPS_PER_CELL_ZERO_BIT
    if cfg.profile:
        ops += OPS_PER_CELL_PROFILE
    if cfg.byte_mode:
        ops += OPS_PER_CELL_BYTE
    if cfg.local_start:
        ops += OPS_PER_CELL_LOCAL
    return ops


def check_goldens(golden, BatchAligner, Gaps, scores, dev):
    n = 0
    for name, (go, ge), size, cases in golden:
        size = size if isinstance(size, tuple) else (size, size)
        al = BatchAligner(getattr(scores, name), Gaps(go, ge), size=size,
                          batch=len(cases), seq_cap=128, device=dev)
        got = al.align_batch([(q, r) for q, r, _ in cases])
        for (q, r, want), res in zip(cases, got):
            if res.score != want:
                raise AssertionError(f"golden {name} {size} {q!r} {r!r}: "
                                     f"{res.score} != {want}")
        n += len(cases)
    return n


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from bench import rand_protein_pairs
    from block_aligner_tpu_torch import BatchAligner, Gaps, align_exp_all, api
    from block_aligner_tpu_torch.core import scores
    from block_aligner_tpu_torch.ops import _build
    from block_aligner_tpu_torch.ops import adaptive_kernel as ak
    from block_aligner_tpu_torch.ops import big_kernel as bk
    from block_aligner_tpu_torch.ops import lane_kernel as lk
    from examples_tpu.common import (load_nanopore_pairs, load_uc_pairs,
                                     rand_mutate, rand_seq)

    last = [time.perf_counter()]

    def phase(what):
        """Print the seconds since the previous phase ended."""
        now = time.perf_counter()
        print(f"[phase] {what}: {now - last[0]:.1f} s")
        last[0] = now

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_per_s = sms * INT32_PER_SM_CLOCK * float(clock) * 1e6
    print(f"[device] torch: {kind}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; {sms} SMs, "
          f"max SM clock {clock} MHz: int32 peak {int32_per_s / 1e12:.2f} "
          "Tops/s")
    print(card)
    dev = torch.device("cuda")

    # 2. build: one nvcc per library, all started together, each with
    # ptxas's report.  The big kernel's libraries take seconds and the lane
    # and adaptive ones minutes, so phases 25-37 run on the big kernel
    # while those finish; the pinned counts are checked once all are in
    t0 = time.perf_counter()

    def timed_build(name):
        """``build_and_report`` and the seconds from t0 to its end."""
        return build_and_report(_build, name), time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(lk.LIBRARIES) + len(bk.LIBRARIES))
    builds = {name: pool.submit(timed_build, name)
              for name in (*lk.LIBRARIES, *bk.LIBRARIES)}
    reports = []

    def finish_builds(names):
        """Wait for the builds of ``names``, load them, print their paths,
        build time and ptxas lines."""
        done = [builds[name].result() for name in names]
        for name in names:
            mod = {"lane": lk, "adaptive": ak}.get(name.split("_")[0], bk)
            mod._lib(name)
        libs = ", ".join(os.path.relpath(p, ROOT) for (p, _), _ in done)
        print(f"[build] {libs} built {max(t for _, t in done):.1f} s after "
              f"the builds started, loaded after "
              f"{time.perf_counter() - t0:.1f} s")
        for (_, lines), _ in done:
            for line in lines:
                print(f"[ptxas] {line}")
            reports.extend(lines)

    finish_builds(bk.LIBRARIES)
    phase("1-2, device and the big kernel's builds")

    # what phases 25-37 share with the others: the uc30 pairs (phase 6),
    # the scoring of the DNA and byte paths, the main-path helpers
    from block_aligner_tpu_torch.core.traceback import Trace
    uc = [(q, r) for q, r, _ in load_uc_pairs("uc30", per_bucket=1000, seed=1234)]
    nuc, ngaps = scores.NucMatrix.new_simple(2, -4), Gaps(-6, -2)
    byte1, byte2 = scores.ByteMatrix(1, -1), scores.ByteMatrix(2, -4)
    rng = np.random.default_rng(25)  # phases 25-37 draw from their own

    def main_path(al, work, what, name, plain_fn, kernel_fn, top=False,
                  keep=None, plain=None):
        """Drive a main path (stage + align_staged, then align_all) with
        the launch counts reset just before it and read just after, hold
        every result against the plain version on the card, and time it
        (the kernel with CUDA events; pack, align_staged and decode on the
        host clock); returns the path's numbers for the kernels line, and
        with ``top`` the largest block size each pair reached.  ``keep``, a
        dict, takes the plain version's output, cell counts and time;
        ``plain``, such a dict from a path whose plain version computes the
        same DP on the same pairs, stands for running it again."""
        torch.cuda.synchronize()
        reset_launches(lk, ak)
        staged, pack_ms = host_ms(lambda: al.stage(work))
        res, run_ms = host_ms(lambda: al.align_staged(staged))
        flags = None if al.last_suspect is None else al.last_suspect.copy()
        res_all = al.align_all(work)
        launches = expect_launches(lk, ak, what, name)[name]
        if res_all != res:
            raise AssertionError(f"{what}: align_all disagrees with stage + "
                                 "align_staged")
        if flags is not None and not np.array_equal(al.last_suspect, flags):
            raise AssertionError(f"{what}: align_all suspect flags disagree")
        if plain is None:
            (want, cells, *tops), plain_ms = host_ms(
                lambda: plain_fn(*staged, al.cfg, count_cells=True,
                                 **({"top_size": True} if top else {})))
        else:
            want, cells, plain_ms = (plain["want"], plain["cells"],
                                     plain["plain_ms"])
        if keep is not None:
            keep.update(want=want, cells=cells, plain_ms=plain_ms)
        last = np.zeros(len(res), np.int32) if flags is None else flags
        got = torch.from_numpy(np.column_stack(
            [[(r.score, r.query_idx, r.reference_idx) for r in res], last])
            .astype(np.int32))
        wide = lk.wide(al.cfg)
        want = want.cpu()
        if not wide:
            want = torch.stack([want[:, 0], staged.qlen.cpu(),
                                staged.rlen.cpu(), want[:, 1]], 1)
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f"{what}: differs from the plain version: max "
                                 f"abs err {err}")
        kernel_ms = cuda_ms(lambda: kernel_fn(*staged, al.cfg), 10)
        out = al._dispatch(staged)
        _, decode_ms = host_ms(lambda: al._decode(staged, out))
        bnd, by = bound(staged, cells, int32_per_s, x_drop=wide,
                        ops=ops_per_cell(al.cfg))
        B, n_cells = len(work), int(cells.sum())
        sc = got[:, 0].numpy()
        print(f"[{name}-main] {B} pairs, {what}: stage+align_staged and "
              f"align_all agree and equal the plain version; {name} launches "
              f"{launches}; scores {sc.min()}..{sc.max()} (mean "
              f"{sc.mean():.1f}); "
              + (f"best short of (qlen, rlen) in {x_dropped(want, staged)}; "
                 if wide else "")
              + f"{n_cells} DP cells, {n_cells / B:.0f} per pair" + (
                  "" if flags is None else f"; suspect {int(flags.sum())}"))
        print(f"[time] {card}: {name}, {what}: kernel "
              f"{kernel_ms * 1e3 / B:.4f} us/pair ({kernel_ms:.3f} ms per "
              f"launch of {B} pairs, CUDA events, mean of 10); bound "
              f"{bnd:.4f} ms by {by}; pack {pack_ms * 1e3 / B:.4f} us/pair; "
              f"align_staged {run_ms * 1e3 / B:.4f} us/pair (decode "
              f"{decode_ms * 1e3 / B:.4f}); plain "
              f"{plain_ms * 1e3 / B:.4f} us/pair ({plain_ms:.1f} ms)"
              + big_fill(al.cfg, B))
        numbers = {"launches": launches, "max_abs_err": err, "ms": kernel_ms,
                   "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by}
        return (numbers, tops[0]) if top else numbers

    def trace_path(al, work, what, name, base, plain=None, n_cmp=512,
                   shortest=False, like=None, keep=None):
        """Drive a trace main path through ``align_all_trace`` with the
        launch counts reset just before it and read just after; hold its
        results against the non-trace instance (``base``; None at max size
        512, which without trace is the big kernel's route) and the plain
        version on the card (``plain``: the non-trace plain version's output,
        cells and time from a main path on the same pairs, its time over
        ``plain["pairs"]`` pairs where that path had more; else run here),
        every CIGAR against its result, and the first ``n_cmp`` CIGARs (with
        ``shortest`` those of the ``n_cmp`` pairs with the fewest DP cells
        in ``plain``, whose plain trace takes the fewest steps) against
        those of the plain version's trace; with ``like``, CIGAR strings of another path on the same
        pairs, every CIGAR must equal its counterpart; ``keep``, a dict,
        takes this path's CIGAR strings.  Time it per batch.  Returns the
        path's numbers for the kernels line."""
        big = al.route == "big"
        plain_fn = {"lane": lk.lane_align_plain,
                    "adaptive": ak.adaptive_align_plain,
                    "big": bk.big_align_plain}[al.route]
        kernel_fn = {"lane": lk.lane_align, "adaptive": ak.adaptive_align,
                     "big": bk.big_align}[al.route]
        x = al.x_drop or 0
        torch.cuda.synchronize()
        reset_launches(lk, ak)
        (res, cigars), path_ms = host_ms(lambda: al.align_all_trace(work))
        launches = expect_launches(lk, ak, what, name)[name]
        if base is not None and base.align_all(work, sort=False) != res:
            raise AssertionError(f"{what}: results differ from the non-trace "
                                 "instance's")
        fend = al.cfg.free_query_end_gaps
        n_ops, below = check_cigars(cigars, work, res, al.matrix, al.gaps,
                                    what, cigar_start(al.cfg), at_most=fend)
        strs = [str(c) for c in cigars]
        if keep is not None:
            keep["cigars"] = strs
        if like is not None and strs != like:
            k = next(k for k in range(len(strs)) if strs[k] != like[k])
            raise AssertionError(f"{what}: CIGAR of pair {k} {strs[k]} "
                                 f"differs from {like[k]}")
        # the plain version: every result, and the first n_cmp CIGARs
        cfg0 = al.cfg if base is None else dataclasses.replace(al.cfg,
                                                               trace=False)
        if plain is None:
            pk = lk.pack_lane(work, al.matrix, cfg0, al.gaps, dev, x_drop=x)
            plain_res, plain_ms = host_ms(
                lambda: plain_fn(*pk, cfg0, count_cells=True))
            want, cells = plain_res[0], plain_res[-1]
            del plain_res
        else:
            want, cells, plain_ms = (plain["want"], plain["cells"],
                                     plain["plain_ms"])
        # the pairs the plain version's time covers
        n_plain = (plain or {}).get("pairs", len(work))
        got = torch.tensor([(r.score, r.query_idx, r.reference_idx)
                            for r in res], dtype=torch.int32)
        want = want.cpu()
        if lk.wide(al.cfg):
            err = int((got - want[:, :3]).abs().max())
        else:
            err = int((got[:, 0] - want[:, 0]).abs().max())
        if err:
            raise AssertionError(f"{what}: differs from the plain version: "
                                 f"max abs err {err}")
        # the first n_cmp CIGARs (or the fewest-cell pairs'; with free end gaps
        # on the lane and adaptive routes all) against the plain version's
        n_cmp = len(work) if fend and not big else min(n_cmp, len(work))
        order = (np.argsort(cells.cpu().numpy(), kind="stable").tolist()
                 if shortest else range(len(work)))
        picked = list(order)[:n_cmp]
        trace_plain_ms = 0.0
        for k in range(0, n_cmp, al.batch_size):
            idx = picked[k : k + al.batch_size]
            sub = [work[i] for i in idx]
            pk = lk.pack_lane(sub, al.matrix, al.cfg, al.gaps, dev,
                              x_drop=x)
            got_p, ms = host_ms(lambda: plain_fn(*pk, al.cfg))
            trace_plain_ms += ms
            if big:
                tr = block_trace(got_p, al.matrix, al.cfg)
            else:
                _, words, desc, steps = got_p
                tr = Trace(words.cpu().numpy(), desc.cpu().numpy(),
                           steps.cpu().numpy(), al.matrix,
                           **trace_flags(al.cfg))
            del got_p
            ends = [(res[i].query_idx, res[i].reference_idx) for i in idx]
            if [str(c) for c in tr.cigars_all(ends)] != [strs[i]
                                                         for i in idx]:
                raise AssertionError(f"{what}: CIGARs differ from the plain "
                                     f"version's in pairs {idx[:4]}..")
        # times per batch: pack, kernel (CUDA events; the non-trace twin on
        # the same batches beside it), the trace's copy to the host alone,
        # _decode (that copy, the replay of the events, the results), walk
        # (cigars_all)
        t = {"pack": 0.0, "kernel": 0.0, "twin": 0.0, "copy": 0.0,
             "decode": 0.0, "walk": 0.0}
        nbytes = copied = 0
        for k in range(0, len(work), al.batch_size):
            chunk = work[k : k + al.batch_size]
            staged, ms = host_ms(lambda: al._pack(chunk))
            t["pack"] += ms
            t["kernel"] += cuda_ms(lambda: kernel_fn(*staged, al.cfg), 3)
            if base is not None:
                t["twin"] += cuda_ms(lambda: kernel_fn(*staged, cfg0), 3)
            disp = kernel_fn(*staged, al.cfg)
            if big:
                _, ms = host_ms(lambda: api._block_trace(*disp[1:]))
            else:
                T = int(disp[3].max())
                _, ms = host_ms(lambda: [api.to_host(disp[1][:T]),
                                         api.to_host(disp[2][:T])])
            t["copy"] += ms
            got_b, ms = host_ms(lambda: al._decode(staged, disp))
            t["decode"] += ms
            ends = [(r.query_idx, r.reference_idx) for r in got_b]
            _, ms = host_ms(lambda: al.trace().cigars_all(ends))
            t["walk"] += ms
            # bytes the launch must move: codes, lengths and table read
            # once; out, steps, and each executed step's descriptor and
            # words of its rows inside the height written once
            trb = al.trace()
            ran = np.arange(trb.desc.shape[0])[:, None] < trb.steps[None, :]
            # the big route: 5 descriptor fields, the word counters, and the
            # words of each step's rows (those that cross to the host)
            moved = (4 * trb.desc.shape[2] * int(ran.sum())
                     + 4 * lk.trace_words(al.cfg)
                     * int(np.where(ran, trb.desc[:, :, 3], 0).sum()))
            copied += moved
            nbytes += (staged.codes.numel() + 4 * (2 * len(chunk)
                       + staged.table.numel())
                       + (16 if lk.wide(al.cfg) else 8) * len(chunk)
                       + (8 if big else 4) * len(chunk) + moved)
        ops = ops_per_cell(al.cfg)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = int(cells.sum()) * ops / int32_per_s * 1e3
        bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                              "operations")
        B = len(work)
        sc = got[:, 0].numpy()
        if big:
            # the trace's bytes against what its cells need (4 bits a cell,
            # 5 with local start), the budget allocated and a dense (steps,
            # B, max_size) layout
            need = int(cells.sum()) * (5 if al.cfg.local_start else 4) / 8
            dense = (4 * lk.trace_words(al.cfg) * al.cfg.max_steps
                     * al.cfg.max_size)
            if not copied <= 2 * need:
                raise AssertionError(f"{what}: {copied} trace bytes copied, "
                                     f"more than twice the {need:.0f} its "
                                     "cells need")
            print(f"[{name}-bytes] {what}: trace bytes per pair: copied "
                  f"{copied / B:.0f} (words and executed descriptors), cells "
                  f"x {5 if al.cfg.local_start else 4} bits {need / B:.0f}, "
                  "budget allocated "
                  f"{4 * al.cfg.trace_budget}, dense layout "
                  f"{dense}")
        print(f"[{name}-main] {B} pairs, {what}: align_all_trace in batches "
              f"of {al.batch_size}; {name} launches {launches}; results equal "
              + ("the non-trace instance's and " if base is not None else "")
              + "the plain version's; every CIGAR "
              f"spans to its end from its start ({cigar_start(al.cfg)}) and "
              + (f"rescores to at most its score, {below} below (the best of "
                 "another row of row qlen's residue class); " if fend else
                 f"rescores to its score ({n_ops} ops); ")
              + (f"the {n_cmp} with the fewest cells" if shortest
                 else f"the first {n_cmp}")
              + " equal the plain version's; "
              + ("all equal the other path's; " if like is not None else "")
              + "scores "
              f"{sc.min()}..{sc.max()} (mean {sc.mean():.1f}); "
              f"{int(cells.sum())} DP cells, {int(cells.sum()) / B:.0f} per "
              f"pair; {nbytes / B:.0f} bytes per pair")
        twin = (f"the non-trace twin on the same batches "
                f"{t['twin'] * 1e3 / B:.4f} us/pair ({t['twin']:.3f} ms)"
                if base is not None else "no non-trace twin")
        print(f"[time] {card}: {name}, {what}: kernel "
              f"{t['kernel'] * 1e3 / B:.4f} us/pair ({t['kernel']:.3f} ms for "
              f"{B} pairs, CUDA events, mean of 3 per batch), {twin}; bound "
              f"{bnd:.4f} ms by {by}; host clock, us/pair: pack "
              f"{t['pack'] * 1e3 / B:.4f}, trace copy to the host "
              f"{t['copy'] * 1e3 / B:.4f}, _decode (copy, replay, results) "
              f"{t['decode'] * 1e3 / B:.4f}, walk (cigars_all) "
              f"{t['walk'] * 1e3 / B:.4f}, align_all_trace "
              f"{path_ms * 1e3 / B:.4f}, plain {plain_ms * 1e3 / n_plain:.4f} "
              f"({plain_ms:.1f} ms for {n_plain} pairs; with trace, "
              f"{n_cmp} pairs: {trace_plain_ms:.1f} ms)"
              + big_fill(al.cfg, min(B, al.batch_size)))
        phase(f"{name}, {what}")
        return {"launches": launches, "max_abs_err": err, "ms": t["kernel"],
                "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by}

    def big_fill(cfg, pairs):
        """The big route's launch shape (``bk.launch_shape``) and the SM fill
        of a launch of ``pairs`` pairs, min(1, pairs / (SMs x pairs an
        SM)); empty for the other routes."""
        if not isinstance(cfg, bk.BigKernelConfig):
            return ""
        _, _, blocks, tp, pb, ps = bk.launch_shape(cfg)
        return (f"; {tp} threads a pair, {pb} pairs a block, {blocks} blocks "
                f"and {ps} pairs an SM: SM fill "
                f"{min(1.0, pairs / (sms * ps)):.3f} at {pairs} pairs a "
                "launch")

    def lane_shape(what, cfg, pairs):
        """A ``[lane-shape]`` line: the lane kernel's launch shape at
        ``cfg`` (``lk.launch_shape``) and the SM fill of a launch of
        ``pairs`` pairs, min(1, pairs / (SMs x pairs an SM))."""
        threads, blocks, warps, pb, ps = lk.launch_shape(cfg, pairs)
        print(f"[lane-shape] {what}: {warps} warps a pair, "
              f"{pb} pairs a block, {threads} threads a block, {blocks} "
              f"blocks and {ps} pairs an SM: SM fill "
              f"{min(1.0, pairs / (sms * ps)):.3f} at {pairs} pairs a launch")

    # at block 512 the lane kernel gives a pair 4 warps in a launch of at
    # most one pair an SM and 2 in a larger one (csrc/lane_kernel.cu):
    # phases 3, 11, 15 and 19 hold each instance there at both, the larger
    # batches of wide_n pairs drawn from wide_rng
    warps_held = {}
    wide_rng = np.random.default_rng(512)
    wide_n = sms + 8

    def held_warps(cfg, pairs):
        """Note the warps a pair of a lane launch of ``pairs`` at block
        512 takes, under its instance's name."""
        if cfg.block == 512:
            warps_held.setdefault(instance("lane", cfg), set()).add(
                lk.launch_shape(cfg, len(pairs))[2])

    def merged(*paths):
        """One kernels-line entry for an instance that ran several paths:
        the launches of all, the numbers of the first."""
        return {**paths[0], "launches": sum(p["launches"] for p in paths),
                "max_abs_err": max(p["max_abs_err"] for p in paths)}

    # the CPU workers, at a lower priority: the plain versions of phases
    # 25, 26, 30 and 33 run there while the card goes on, and their checks
    # (``held``) wait until phase 42 has ended; then those of phases 19,
    # 43, 45 and 47
    cpu = ProcessPoolExecutor(4, mp_context=multiprocessing.get_context(
        "spawn"), initializer=os.nice, initargs=(10,))
    held = []

    def on_host(pk):
        """A packed batch's tensors on the host, for a worker."""
        return type(pk)(*(t.cpu() if torch.is_tensor(t) else t for t in pk))

    # 25-26. the big kernel vs its plain version, global then x-drop: the
    # structural pairs at (32, 512), (64, 1024), (512, 1024) and (1024,
    # 1024), fixed (2048, 4096) and the growth pairs of phase 29, and a
    # capped run; the nanopore pairs of phase 27 are held on every pair
    # there
    grow = growth_pairs(np.random.default_rng(3), 32)
    dna = (nuc, ngaps)
    big_sizes = ((32, 512), (64, 1024), (512, 1024), (1024, 1024))

    def big_cfg(pairs, size, matrix, x, cap, **modes):
        """The big kernel's configuration for ``pairs`` with ``matrix``
        (a ByteMatrix: byte mode) and the modes given."""
        maxlen = max(max(len(q), len(r)) for q, r in pairs)
        return bk.BigKernelConfig(
            *size, cap or max(256, -(-(1 + maxlen + size[1] + 16) // 128)
                              * 128),
            {"nuc": 16, "byte": 256}.get(matrix.kind, 32),
            x_drop=x is not None, byte_mode=matrix.kind == "byte", **modes)

    def big_vs_plain(pairs, size, matrix, gaps, x, cap=None, **flags):
        """big_align on the card against big_align_plain in a CPU worker,
        with ``flags`` (the FLAGS instances'); returns a function that
        waits for the plain version, holds the two equal and returns the
        pairs whose best lies short of their ends and the largest block
        sizes reached."""
        cfg = big_cfg(pairs, size, matrix, x, cap, **flags)
        pk = bk.pack_big(pairs, matrix, cfg, gaps, dev, x or 0)
        got = bk.big_align(*pk, cfg).cpu()
        job = cpu.submit(plain_job, "big", cfg, on_host(pk))

        def check():
            (want, _, top), _ = job.result()
            check_equal(got, want, f"big {size} x_drop={x} {matrix.kind} "
                        f"{sorted(flags)}")
            if got[:, -1].any():
                raise AssertionError(f"big {size}: a pair hit the step cap")
            return (x_dropped(got, pk) if x is not None else 0), top
        return check

    def big_capped(x, steps):
        cfg = with_step_cap(bk.BigKernelConfig(32, 1024, 1792,
                                               x_drop=x is not None), steps)
        pk = bk.pack_big(structural_pairs(rng, AA, 96, 600), scores.BLOSUM62,
                         cfg, Gaps(-11, -1), dev, x or 0)
        got = bk.big_align(*pk, cfg)
        torch.cuda.synchronize()
        check_equal(got, bk.big_align_plain(*pk, cfg), f"big, {steps} steps")
        over = int(got[:, -1].sum())
        if not 0 < over < len(got):
            raise AssertionError(f"big: {over} of {len(got)} pairs overran "
                                 f"{steps} steps")
        return over, len(got)

    def big_shapes(what, sizes, sets=({},), **modes):
        """A ``[big-shape]`` line: for each (min, max) size, the threads a
        pair, pairs a block, blocks an SM
        (cudaOccupancyMaxActiveBlocksPerMultiprocessor), pairs an SM,
        threads a block and dynamic shared bytes of the instances that
        ``modes`` with each keyword set of ``sets`` name (joined by
        " / ")."""
        print(f"[big-shape] {what}: threads a pair, pairs a block, blocks an "
              "SM, pairs an SM (threads a block, dynamic shared bytes) by "
              "(min, max) size: " + "; ".join(
                  f"{size}: " + " / ".join(
                      "{3}, {4}, {2}, {5} ({0}, {1})".format(
                          *bk.launch_shape(bk.BigKernelConfig(
                              *size, max(16512, size[1] + 128), **modes,
                              **kw)))
                      for kw in sets)
                  for size in sizes))

    big_shapes("global, x-drop", ((32, 512), (64, 1024), (128, 1024),
                                  (256, 2048), (512, 1024), (1024, 1024),
                                  (2048, 2048), (2048, 4096), (512, 8192)),
               sets=[{}, {"x_drop": True}])
    checks, checked = [], 0
    for size in big_sizes:
        for matrix, gaps, alphabet in ((scores.BLOSUM62, Gaps(-11, -1), AA),
                                       (*dna, DNA)):
            pairs = structural_pairs(rng, alphabet, 96, 700)
            checks.append(big_vs_plain(pairs, size, matrix, gaps, None))
            checked += len(pairs)
    grown = big_vs_plain(grow[:4], (2048, 4096), *dna, None)
    over, n_capped = big_capped(None, 40)

    def hold_25(checks=checks, checked=checked, grown=grown, over=over,
                n_capped=n_capped):
        tops = set()
        for check in checks:
            tops |= set(check()[1].tolist())
        _, top = grown()
        print(f"[big-vs-plain] {checked} pairs at "
              f"{', '.join(map(str, big_sizes))} (protein BLOSUM62 -11/-1 "
              "and DNA NucMatrix(2, -4) -6/-2, lengths 0..700, structural "
              f"indels; blocks reached {sorted(tops)}), and 4 growth pairs "
              f"at fixed (2048, 4096) (blocks {top.tolist()}): score and "
              f"overrun equal; with a 40-step cap on {n_capped} pairs, "
              f"{over} of which overran; the lane and adaptive instances "
              "keep their pinned ptxas counts (phase 2)")

    held.append(hold_25)
    phase("25, big kernel vs plain (held at phase 42's end)")

    checks, checked = [], 0
    for size in big_sizes:
        for (matrix, gaps, alphabet), x in (
                ((scores.BLOSUM62, Gaps(-11, -1), AA), 0),
                ((*dna, DNA), 20), ((scores.BLOSUM62, Gaps(-11, -1), AA), 100)):
            pairs = structural_pairs(rng, alphabet, 96, 700)
            checks.append(big_vs_plain(pairs, size, matrix, gaps, x))
            checked += len(pairs)
    # the growth pairs with the shorter middles and flanks (3700 and 4600
    # bases a side), whose plain run takes the fewest steps
    grown = big_vs_plain([grow[k] for k in (1, 3, 5, 7)], (512, 8192),
                         *dna, 1000, cap=16384)
    over, n_capped = big_capped(50, 25)

    def hold_26(checks=checks, checked=checked, grown=grown, over=over,
                n_capped=n_capped):
        dropped = sum(check()[0] for check in checks)
        if not dropped:
            raise AssertionError("no big x-drop pair ended short of its ends")
        gdrop, gtop = grown()
        print(f"[big-xdrop-vs-plain] {checked} pairs at "
              f"{', '.join(map(str, big_sizes))} (protein x 0 and 100, DNA x "
              f"20): best, position and overrun equal; {dropped} best "
              "positions short of (qlen, rlen); 4 of the growth pairs at "
              f"(512, 8192) with x 1000 ({gdrop} short of their ends, blocks "
              f"reached {sorted(set(gtop.tolist()))}); with a 25-step cap on "
              f"{n_capped} pairs, {over} of which overran")

    held.append(hold_26)
    phase("26, big x-drop kernel vs plain (held at phase 42's end)")

    # 27. the big main path: the reference's <10 kbp 1%-10% band (128,
    # 1024) on the JAX package's nanopore workload
    # (run_results.py::bench_nanopore_band10k), global and x-drop
    nano = load_nanopore_pairs(n_pairs=1024, max_len=10000, seed=1234)
    ncap = max(max(len(q), len(r)) for q, r in nano)
    what = ("nanopore-like 5000..9999 bases, 10% edits, NucMatrix(2, -4) "
            "-6/-2, (128, 1024)")
    nano_g, nano_x = {}, {}  # the plain version's, for phase 31
    big_g = main_path(BatchAligner(*dna, size=(128, 1024), batch=len(nano),
                                   seq_cap=ncap, device=dev), nano, what,
                      "big_align", bk.big_align_plain, bk.big_align,
                      keep=nano_g)
    phase("27, big_align main path")
    big_x = main_path(BatchAligner(*dna, size=(128, 1024), batch=len(nano),
                                   seq_cap=ncap, x_drop=50, device=dev), nano,
                      f"{what}, x_drop 50", "big_align_xdrop",
                      bk.big_align_plain, bk.big_align, keep=nano_x)
    phase("27, big_align_xdrop main path")

    # 28. uc30 at (32, 512) without trace, which pick_route sends to the
    # big kernel
    big_uc = main_path(
        BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 512),
                     batch=len(uc), seq_cap=512, device=dev), uc,
        "uc30 homologs 50-256 + indels, BLOSUM62 -11/-1, (32, 512)",
        "big_align", bk.big_align_plain, bk.big_align)
    phase("28, big_align uc30 (32, 512)")

    # 29. growth: DNA pairs whose long random middles make the blocks grow
    # to 4096 and 8192, at (512, 8192) with the whole code budget
    gal = BatchAligner(*dna, size=(512, 8192), batch=len(grow), seq_cap=8175,
                       device=dev)
    if gal.cfg.seq_cap != 16384:
        raise AssertionError(f"growth seq_cap {gal.cfg.seq_cap}")
    grow_plain = {}  # the plain version's, for phase 32
    big_gr, gtop = main_path(
        gal, grow, "DNA growth pairs: a flank, a random middle of 1200..3200 "
        "on both sides, a flank (5% edits), NucMatrix(2, -4) -6/-2, (512, "
        "8192)", "big_align", bk.big_align_plain, bk.big_align, top=True,
        keep=grow_plain)
    reached = {int(t): int((gtop == t).sum()) for t in gtop.unique()}
    if not {4096, 8192} <= set(reached):
        raise AssertionError(f"growth pairs reached {reached}")
    print(f"[big-growth] blocks reached (size: pairs) {reached}")
    phase("29, big_align growth main path")
    big_g = merged(big_g, big_uc, big_gr)

    # 30. the big trace instances (csrc/big_trace.cu) vs the plain version:
    # structural pairs at (64, 1024), (512, 1024) and (1024, 1024), global
    # and x 20 and 100, 4 growth pairs at fixed (2048, 4096), and a reduced
    # trace budget
    def big_trace_vs_plain(pairs, size, matrix, gaps, x, cap=None,
                           budget=None, **flags):
        """big_align against big_align_plain with trace, with ``flags``
        (the FLAGS instances'), the plain version in a CPU worker (on the
        card under a reduced ``budget``, whose configuration does not
        pickle); returns a function that waits for it and holds equal
        outputs, step counts, word counters, executed descriptors and words
        (local start's zero words too), and equal CIGARs walked from both
        for the pairs that did not overrun, and returns (saves, restores,
        overruns, the tallest step)."""
        cfg = big_cfg(pairs, size, matrix, x, cap, trace=True, **flags)
        if budget:
            cfg = with_trace_budget(cfg, budget)
        pk = bk.pack_big(pairs, matrix, cfg, gaps, dev, x or 0)
        out, words, desc, steps, used = bk.big_align(*pk, cfg)
        # the words below the counters and the steps run, all that the
        # checks read
        got = (out.cpu(), words[:, : int(used.max())].cpu(),
               desc[: int(steps.max())].cpu(), steps.cpu(), used.cpu())
        if budget:
            plain = bk.big_align_plain(*pk, cfg)
            plain = tuple(t.cpu() for t in plain)
        else:
            job = cpu.submit(plain_job, "big", cfg, on_host(pk))
        what = f"big trace {size} x_drop={x} {matrix.kind} {sorted(flags)}"

        def check():
            want = plain if budget else tuple(job.result()[0][:5])
            saves, restores = check_big_trace(got, want, what)
            out = want[0]
            done = (out[:, -1] == 0).nonzero()[:, 0].tolist()
            ends = [(int(out[k, 1]), int(out[k, 2])) if lk.wide(cfg)
                    else (len(pairs[k][0]), len(pairs[k][1])) for k in done]

            def sub(res):
                return tuple(t[:, done] if t.dim() == 3 else t[done]
                             for t in res)

            walk_both(sub(got), sub(want), ends, matrix, what, cfg)
            desc, steps = want[2], want[3]
            ran = torch.arange(desc.shape[0])[:, None] < steps
            return (saves, restores, int(out[:, -1].sum()),
                    int(torch.where(ran, desc[:, :, 3], 0).max()))
        return check

    checks, checked = [], 0
    protein_aa = (scores.BLOSUM62, Gaps(-11, -1), AA)
    for size in ((64, 1024), (512, 1024), (1024, 1024)):
        for (matrix, gaps, alphabet), x in product(
                (protein_aa, (*dna, DNA)), (None, 20, 100)):
            pairs = structural_pairs(rng, alphabet, 32, 700)
            checks.append(big_trace_vs_plain(pairs, size, matrix, gaps, x))
            checked += len(pairs)
    grown = big_trace_vs_plain(grow[:4], (2048, 4096), *dna, None)
    budgeted = big_trace_vs_plain(structural_pairs(rng, AA, 64, 600),
                                  (32, 1024), scores.BLOSUM62, Gaps(-11, -1),
                                  None, budget=6000)
    big_shapes("trace instances, global / x-drop",
               ((32, 1024), (64, 1024), (128, 1024), (512, 1024),
                (1024, 1024), (2048, 4096), (512, 8192)), trace=True,
               sets=[{}, {"x_drop": True}])

    def hold_30(checks=checks, checked=checked, grown=grown,
                budgeted=budgeted):
        events, tall = [0, 0], set()
        for check in checks:
            sv, rs, _, h = check()
            events[0] += sv
            events[1] += rs
            tall.add(h)
        grew = grown()[3]
        over = budgeted()[2]
        if not 0 < over < 64 or not all(events) or grew != 4096:
            raise AssertionError(f"big trace: {over} of 64 pairs overran the "
                                 f"budget; events {events}; growth steps to "
                                 f"{grew}")
        print(f"[big-trace-vs-plain] {checked} pairs at (64, 1024), (512, "
              "1024) and (1024, 1024) (protein BLOSUM62 -11/-1 and DNA "
              "NucMatrix(2, -4) -6/-2, lengths 0..700, structural indels), "
              f"global and x 20 and 100 (steps up to {max(tall)} rows), and "
              "4 growth pairs at fixed (2048, 4096), global: outputs, step "
              "counts, word counters, descriptors and words equal, and the "
              f"CIGARs walked from both; {events[0]} checkpoint saves and "
              f"{events[1]} grow restores; under a budget of 6000 words on "
              f"64 pairs at (32, 1024), {over} of which overran, the traces "
              "equal too")

    held.append(hold_30)
    phase("30, big trace instances vs plain (held at phase 42's end)")

    # 31. the traced nanopore band: the first 512 of phase 27's pairs
    # through align_all_trace in batches of 256, global and x 50, held
    # against phase 27's non-trace instance and plain version; the CIGARs
    # of the 32 pairs with the fewest cells against the plain version's
    # trace (whose time is its step count's, not its pair count's)
    def first(plain, n):
        """The first ``n`` pairs' part of a main path's plain output; its
        time stays that of the path's ``pairs``."""
        return dict(plain, want=plain["want"][:n], cells=plain["cells"][:n],
                    pairs=len(plain["want"]))

    tnano = nano[:512]
    tkw = dict(size=(128, 1024), batch=256, seq_cap=ncap, device=dev)
    nano_t = {}  # the CIGARs, for phase 34
    big_t = trace_path(BatchAligner(*dna, trace=True, **tkw), tnano, what,
                       "big_align_trace", BatchAligner(*dna, **tkw),
                       plain=first(nano_g, 512), n_cmp=32, shortest=True,
                       keep=nano_t)
    big_xt = trace_path(
        BatchAligner(*dna, trace=True, x_drop=50, **tkw), tnano,
        f"{what}, x_drop 50", "big_align_xdrop_trace",
        BatchAligner(*dna, x_drop=50, **tkw), plain=first(nano_x, 512),
        n_cmp=32, shortest=True)

    # 32. traced growth: two of phase 29's growth pairs whose blocks reach
    # 4096 and two that reach 8192, at (512, 8192) with trace; the CIGARs of
    # the two with the fewest cells against the plain version's trace here,
    # and the words, descriptors and CIGARs of all four against its trace
    # from a CPU worker at phase 45 ("grow_t")
    pick = ([k for k in range(len(grow)) if gtop[k] == 4096][:2]
            + [k for k in range(len(grow)) if gtop[k] == 8192][:2])
    gkw = dict(size=(512, 8192), batch=4, seq_cap=8175, device=dev)
    tal = BatchAligner(*dna, trace=True, **gkw)
    big_gt = trace_path(
        tal, [grow[k] for k in pick], "DNA growth pairs of phase 29 (two "
        "reach 4096, two 8192), NucMatrix(2, -4) -6/-2, (512, 8192)",
        "big_align_trace", BatchAligner(*dna, **gkw),
        plain=dict(grow_plain, want=grow_plain["want"][pick],
                   cells=grow_plain["cells"][pick], pairs=len(grow)),
        n_cmp=2, shortest=True)
    tr = tal.trace()
    heights = [int(tr.desc[: tr.steps[b], b, 3].max()) for b in range(4)]
    if sorted(heights) != [4096, 4096, 8192, 8192]:
        raise AssertionError(f"traced growth reached {heights}")
    print(f"[big-trace-growth] traced steps reached {heights} rows")
    big_t = merged(big_t, big_gt)

    # 33. the big kernel's FLAGS instances (csrc/big_flags.cu,
    # csrc/big_trace_flags.cu) vs the plain version: 32-pair structural
    # batches at (128, 1024), (512, 1024) and (1024, 1024), each mode at
    # two sizes or more, traced and not, x-drop where the mode allows it;
    # two growth pairs at (512, 8192) with traced local start, the
    # instance whose shared memory is the largest; the launch shapes
    protein = (scores.BLOSUM62, Gaps(-11, -1))
    local, fstart = dict(local_start=True), dict(free_query_start_gaps=True)
    fend = dict(free_query_end_gaps=True)
    flag_cases = {
        (128, 1024): (("byte", None, False), ("byte", None, True),
                      ("local", None, True), ("local", 20, False),
                      ("fstart", 100, True), ("fend", None, True)),
        (512, 1024): (("byte", None, True), ("local", 100, True),
                      ("fstart", None, True), ("fend", None, False)),
        (1024, 1024): (("byte", None, False), ("local", None, False),
                       ("local", 20, True), ("fstart", 20, False),
                       ("fstart", None, True), ("fend", None, True)),
    }
    checks, traced, checked = [], [], 0
    for size, cases in flag_cases.items():
        for k, (mode, x, tr) in enumerate(cases):
            flags = {"byte": {}, "local": local, "fstart": fstart,
                     "fend": fend}[mode]
            if mode == "byte":
                matrix, gaps = byte1, Gaps(-11, -1)
                pairs = byte_pairs(rng, 32, 700)
            else:
                matrix, gaps = (protein, dna)[k % 2]
                pairs = structural_pairs(rng, AA if k % 2 == 0 else DNA, 32,
                                         700)
            if mode == "fend":
                pairs = [(q[: size[0] - 1], r) for q, r in pairs]
            if tr:
                traced.append(big_trace_vs_plain(pairs, size, matrix, gaps,
                                                 x, **flags))
            else:
                checks.append(big_vs_plain(pairs, size, matrix, gaps, x,
                                           **flags))
            checked += len(pairs)
    grown = big_trace_vs_plain(grow[:2], (512, 8192), *dna, None, cap=16384,
                               **local)
    big_shapes("FLAGS instances (global, x-drop, trace without and with "
               "local start, x-drop trace with local start)",
               ((32, 512), (128, 1024), (512, 1024), (1024, 1024),
                (512, 8192)),
               sets=[dict(local), dict(local, x_drop=True),
                     dict(fend, trace=True), dict(local, trace=True),
                     dict(local, x_drop=True, trace=True)])

    def hold_33(checks=checks, traced=traced, checked=checked, grown=grown):
        for check in checks:
            check()
        tall = max(check()[3] for check in traced)
        h8 = grown()[3]
        if h8 != 8192 or tall != 1024:
            raise AssertionError(f"big flags: traced steps reached {tall} "
                                 f"rows, the local-start growth pairs {h8}")
        print(f"[big-flags-vs-plain] {checked} pairs at (128, 1024), (512, "
              "1024) and (1024, 1024): ByteMatrix(1, -1) -11/-1 (all 256 "
              "bytes, byte 0) global and traced; local start global, x 20 "
              "and 100, traced; free start gaps traced, x 20 and 100; free "
              "end gaps (queries shorter than the min size) global and "
              "traced; protein BLOSUM62 -11/-1 and DNA NucMatrix(2, -4) "
              "-6/-2, lengths 0..700, structural indels (steps up to "
              f"{tall} rows); and 2 growth pairs at (512, 8192) with traced "
              f"local start (steps up to {h8} rows): outputs equal, and "
              "traced step counts, word counters, descriptors, words (the "
              "zero words too) and CIGARs")

    held.append(hold_33)
    phase("33, big FLAGS instances vs plain (held at phase 42's end)")

    # 34. the byte band: phase 27's pairs with ByteMatrix(2, -4), which on
    # ACGT reads scores as NucMatrix(2, -4) does, so phase 27's plain
    # version is this path's: every result and (traced) every CIGAR must
    # equal phase 27's and 31's, pair for pair
    bkw = dict(size=(128, 1024), seq_cap=ncap, device=dev)
    bwhat = ("nanopore-like 5000..9999 bases, 10% edits, ByteMatrix(2, -4) "
             "-6/-2, (128, 1024)")
    big_b = main_path(BatchAligner(byte2, ngaps, batch=len(nano), **bkw),
                      nano, bwhat, "big_align_byte", bk.big_align_plain,
                      bk.big_align, plain=nano_g)
    print(f"[big-byte-vs-nuc] {len(nano)} nanopore-like pairs: ByteMatrix(2, "
          "-4) results equal NucMatrix(2, -4)'s (phase 27) pair for pair")
    phase("34, big_align_byte main path")
    big_bt = trace_path(
        BatchAligner(byte2, ngaps, trace=True, batch=256, **bkw), tnano,
        bwhat, "big_align_byte_trace",
        BatchAligner(byte2, ngaps, batch=256, **bkw),
        plain=first(nano_g, 512), n_cmp=0, like=nano_t["cigars"])

    # 35. local start with x_drop 50 on the same band: long-read
    # extensions that may start anywhere
    lkw = dict(size=(128, 1024), seq_cap=ncap, x_drop=50, device=dev,
               **local)
    lwhat = f"{what}, x_drop 50, local start"
    nano_l = {}
    big_fx = main_path(BatchAligner(*dna, batch=len(nano), **lkw), nano,
                       lwhat, "big_align_flags_xdrop", bk.big_align_plain,
                       bk.big_align, keep=nano_l)
    phase("35, big_align_flags_xdrop main path")
    big_fxt = trace_path(
        BatchAligner(*dna, trace=True, batch=256, **lkw), tnano, lwhat,
        "big_align_flags_xdrop_trace", BatchAligner(*dna, batch=256, **lkw),
        plain=first(nano_l, 512), n_cmp=32, shortest=True)

    # 36. glocal read-to-window: 1024 reads of 600..999 bases cut from the
    # nanopore pairs, each against its reference window with 500..1499
    # random bases of flank on either side, free query start and end gaps
    # at (1024, 1024): the whole read aligns, the window's overhangs are
    # free
    win = read_window_pairs(np.random.default_rng(1234), nano)
    wcap = max(len(r) for _, r in win)
    gkw = dict(size=(1024, 1024), seq_cap=wcap, device=dev, **fstart, **fend)
    gwhat = ("reads 600..999 of the nanopore-like pairs against their "
             "windows with 500..1499 random bases of flank a side, "
             "NucMatrix(2, -4) -6/-2, (1024, 1024), free query start and end "
             "gaps")
    glocal = {}
    big_f = main_path(BatchAligner(*dna, batch=len(win), **gkw), win, gwhat,
                      "big_align_flags", bk.big_align_plain, bk.big_align,
                      keep=glocal)
    phase("36, big_align_flags main path")
    big_ft = trace_path(
        BatchAligner(*dna, trace=True, batch=256, **gkw), win, gwhat,
        "big_align_flags_trace", BatchAligner(*dna, batch=256, **gkw),
        plain=glocal, n_cmp=256)

    # 37. the (32, 512) band without trace, which pick_route sends to the
    # big kernel: the uc30 pairs with ByteMatrix(1, -1), and with local
    # start under BLOSUM62
    ukw = dict(size=(32, 512), batch=len(uc), seq_cap=512, device=dev)
    big_ub = main_path(
        BatchAligner(byte1, Gaps(-11, -1), **ukw), uc,
        "uc30 homologs 50-256 + indels, ByteMatrix(1, -1) -11/-1, (32, 512)",
        "big_align_byte", bk.big_align_plain, bk.big_align)
    big_ul = main_path(
        BatchAligner(*protein, local_start=True, **ukw), uc,
        "uc30 homologs 50-256 + indels, BLOSUM62 -11/-1, (32, 512), local "
        "start", "big_align_flags", bk.big_align_plain, bk.big_align)
    phase("37, big (32, 512) byte and local start")
    big_b = merged(big_b, big_ub)
    big_f = merged(big_f, big_ul)

    # 2, continued: the lane and adaptive libraries, built meanwhile
    finish_builds(lk.LIBRARIES)
    pool.shutdown()
    check_pinned_ptxas(reports)
    phase("2, the lane and adaptive builds (after phases 25-37)")

    # the plain versions of phases 43, 45 and 47 run in the CPU workers
    # too, while the card runs phases 3-42: each takes 4000
    # to 12000 lockstep steps of a few small tensors, which run no faster on
    # the card (a step at 16384 rows: 9.3 ms there, 7.3 ms on one CPU core)
    from block_aligner_tpu_torch import LongAdaptiveAligner, LongBatchAligner
    lrng = np.random.default_rng(43)  # phases 43-47 draw from their own
    # kernel vs plain: 2 ONT-like pairs of 17-20 kbp (codes past 16384),
    # 2 profile pairs past 16384 positions, 2 pairs growing to 16384 rows
    cmp_pairs = long_pairs(lrng, 2, 17000, 20000)
    prof_long = long_profile_pairs(lrng, 2, 16500, 17500)
    band_pairs = growth_pairs_16384(np.random.default_rng(47), 2)

    def lane_long(device=dev, **kw):
        return LongBatchAligner(nuc, ngaps, 512, batch=64, device=device,
                                **kw)

    def prof_lane_long(device=dev, **kw):
        return LongBatchAligner(scores.BLOSUM62, Gaps(-11, -1), 512,
                                profile=True, device=device, **kw)

    def ad_long(device=dev, **kw):
        return LongAdaptiveAligner(nuc, ngaps, (512, 8192), batch=64,
                                   device=device, **kw)

    def band_long(device=dev, matrix=nuc, **kw):
        return LongAdaptiveAligner(matrix, ngaps, (BAND_MIN, 16384),
                                   batch=len(band_pairs), device=device, **kw)

    def grow_traced(device=dev, **kw):
        return BatchAligner(nuc, ngaps, (512, 8192), batch=4, seq_cap=8175,
                            trace=True, device=device, **kw)

    long_checks = {
        "grow_t": (grow_traced, {}, [grow[k] for k in pick]),
        "lane": (lane_long, {}, cmp_pairs),
        "lane_x": (lane_long, dict(x_drop=100), cmp_pairs),
        "lane_t": (lane_long, dict(trace=True), cmp_pairs),
        "lane_x_t": (lane_long, dict(x_drop=100, trace=True), cmp_pairs),
        "lane_p": (prof_lane_long, {}, prof_long),
        "ad": (ad_long, {}, cmp_pairs),
        "ad_x": (ad_long, dict(x_drop=100), cmp_pairs),
        "ad_t": (ad_long, dict(trace=True), cmp_pairs),
        "ad_x_t": (ad_long, dict(x_drop=100, trace=True), cmp_pairs),
        "band": (band_long, {}, band_pairs),
        "band_x": (band_long, dict(x_drop=BAND_X), band_pairs),
        "band_t": (band_long, dict(trace=True), band_pairs),
        "band_x_t": (band_long, dict(x_drop=BAND_X, trace=True), band_pairs),
        "band_l_t": (band_long, dict(local_start=True, trace=True),
                     band_pairs),
        "band_b": (band_long, dict(matrix=byte2), band_pairs),
    }
    plain_jobs = {}
    # the longest first, so that the workers end together
    for key, (make, kw, pairs) in sorted(
            long_checks.items(), key=lambda kv: not kv[0].startswith("band")):
        al = make(device="cpu", **kw)
        pk = al._pack(pairs)
        plain_jobs[key] = cpu.submit(plain_job, al.route, al._staged_cfg(pk),
                                     pk)

    # 3. lane kernel vs plain version on the card (these launches are not
    # a main path's and are not counted)
    rng = np.random.default_rng(7)
    checked = 0
    for S in (16, 32, 64, 256, 512):
        for matrix, gaps, alphabet in ((scores.BLOSUM62, Gaps(-11, -1), AA),
                                       (scores.NW1, Gaps(-2, -1), DNA)):
            pairs = random_pairs(rng, alphabet, 192, 600)
            cfg = lk.LaneKernelConfig(
                S, -(-(1 + 600 + S + 16) // 128) * 128,
                32 if matrix.kind == "aa" else 16)
            # at 512 the 192 pairs take 2 warps a pair, their first 64 4
            for batch in (pairs, pairs[:64]) if S == 512 else (pairs,):
                pk = lk.pack_lane(batch, matrix, cfg, gaps, dev)
                got = lk.lane_align(*pk, cfg)
                torch.cuda.synchronize()
                check_equal(got, lk.lane_align_plain(*pk, cfg),
                            f"at S={S} {matrix.kind}, {len(batch)} pairs")
                held_warps(cfg, batch)
                checked += len(batch)
    print(f"[lane-vs-plain] {checked} pairs at S in 16,32,64,256,512 "
          "(protein and DNA, lengths 0..600; at 512 192 pairs and their "
          "first 64): score and suspect equal")
    n_gold = check_goldens(GOLDEN, BatchAligner, Gaps, scores, dev)
    print(f"[lane-golden] {n_gold} pinned reference scores equal "
          "(incl. README example NW1 -2/-1 block 32 -> 7)")
    phase("3, lane kernel vs plain")

    # 4. adaptive kernel vs plain version on the card
    checked = overran = 0
    ladders = ((16, 32), (16, 64), (32, 128), (32, 256), (64, 256))
    for lo, hi in ladders:
        for matrix, gaps, alphabet in ((scores.BLOSUM62, Gaps(-11, -1), AA),
                                       (scores.NW1, Gaps(-2, -1), DNA)):
            pairs = structural_pairs(rng, alphabet, 192, 600)
            cfg = ak.AdaptiveKernelConfig(
                lo, hi, -(-(1 + 600 + hi + 16) // 128) * 128,
                32 if matrix.kind == "aa" else 16)
            pk = lk.pack_lane(pairs, matrix, cfg, gaps, dev)
            got = ak.adaptive_align(*pk, cfg)
            torch.cuda.synchronize()
            check_equal(got, ak.adaptive_align_plain(*pk, cfg),
                        f"at ({lo}, {hi}) {matrix.kind}")
            checked += len(pairs)

    cfg = with_step_cap(ak.AdaptiveKernelConfig(16, 64, 768), 40)
    pk = lk.pack_lane(structural_pairs(rng, AA, 192, 600), scores.BLOSUM62,
                      cfg, Gaps(-11, -1), dev)
    got = ak.adaptive_align(*pk, cfg)
    torch.cuda.synchronize()
    check_equal(got, ak.adaptive_align_plain(*pk, cfg), "with 40 steps")
    overran = int(got[:, 1].sum())
    if not 0 < overran < len(got):
        raise AssertionError(f"{overran} of {len(got)} pairs overran 40 steps")
    print(f"[adaptive-vs-plain] {checked} pairs at ladders "
          f"{', '.join(map(str, ladders))} (protein and DNA, lengths 0..600, "
          f"structural indels): score and overrun equal; and with a 40-step "
          f"cap on {len(got)} pairs, {overran} of which overran")
    n_gold = check_goldens(GOLDEN_ADAPTIVE, BatchAligner, Gaps, scores, dev)
    print(f"[adaptive-golden] {n_gold} pinned adaptive scores equal")
    phase("4, adaptive kernel vs plain")

    # 3-4, x-drop: both kernels' x-drop instances vs their plain versions
    xsetups = ((scores.BLOSUM62, Gaps(-11, -1), AA, 50),
               (scores.NW1, Gaps(-2, -1), DNA, 100))
    checked = dropped = 0
    for S in (16, 32, 64, 256, 512):
        for matrix, gaps, alphabet, x in xsetups:
            pairs = random_pairs(rng, alphabet, 192, 600)
            cfg = lk.LaneKernelConfig(
                S, -(-(1 + 600 + S + 16) // 128) * 128,
                32 if matrix.kind == "aa" else 16, x_drop=True)
            for batch in (pairs, pairs[:64]) if S == 512 else (pairs,):
                pk = lk.pack_lane(batch, matrix, cfg, gaps, dev, x_drop=x)
                got = lk.lane_align(*pk, cfg)
                torch.cuda.synchronize()
                check_equal(got, lk.lane_align_plain(*pk, cfg),
                            f"x-drop at S={S} {matrix.kind}, {len(batch)} "
                            "pairs")
                held_warps(cfg, batch)
                checked += len(batch)
                dropped += x_dropped(got, pk)
    if not dropped:
        raise AssertionError("no lane x-drop pair ended short of its ends")
    print(f"[lane-xdrop-vs-plain] {checked} pairs at S in 16,32,64,256,512 "
          "(protein x 50 and DNA x 100, lengths 0..600; at 512 192 pairs "
          "and their first 64): best, position and "
          f"suspect equal; {dropped} best positions short of (qlen, rlen)")

    checked = dropped = 0
    for lo, hi in ladders:
        for matrix, gaps, alphabet, x in xsetups:
            pairs = structural_pairs(rng, alphabet, 192, 600)
            cfg = ak.AdaptiveKernelConfig(
                lo, hi, -(-(1 + 600 + hi + 16) // 128) * 128,
                32 if matrix.kind == "aa" else 16, x_drop=True)
            pk = lk.pack_lane(pairs, matrix, cfg, gaps, dev, x_drop=x)
            got = ak.adaptive_align(*pk, cfg)
            torch.cuda.synchronize()
            check_equal(got, ak.adaptive_align_plain(*pk, cfg),
                        f"x-drop at ({lo}, {hi}) {matrix.kind}")
            checked += len(pairs)
            dropped += x_dropped(got, pk)
    if not dropped:
        raise AssertionError("no adaptive x-drop pair ended short of its ends")
    cfg = with_step_cap(ak.AdaptiveKernelConfig(16, 64, 768, x_drop=True), 25)
    pk = lk.pack_lane(structural_pairs(rng, AA, 192, 600), scores.BLOSUM62,
                      cfg, Gaps(-11, -1), dev, x_drop=50)
    got = ak.adaptive_align(*pk, cfg)
    torch.cuda.synchronize()
    check_equal(got, ak.adaptive_align_plain(*pk, cfg), "x-drop, 25 steps")
    overran = int(got[:, 3].sum())
    if not 0 < overran < len(got):
        raise AssertionError(f"{overran} of {len(got)} x-drop pairs overran "
                             "25 steps")
    print(f"[adaptive-xdrop-vs-plain] {checked} pairs at ladders "
          f"{', '.join(map(str, ladders))} (protein x 50 and DNA x 100, "
          "lengths 0..600, structural indels): best, position and overrun "
          f"equal; {dropped} best positions short of (qlen, rlen); with a "
          f"25-step cap on {len(got)} pairs, {overran} of which overran")
    phase("3-4, x-drop instances vs plain")

    # 5. the lane main path
    pairs = rand_protein_pairs(np.random.default_rng(1234), 16384, 1000, 100)
    more = rand_protein_pairs(np.random.default_rng(1235), 16384, 1000, 100)
    al = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 32),
                      batch=16384, seq_cap=1024, device=dev)
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    staged, pack_ms = host_ms(lambda: al.stage(pairs))
    res, run_ms = host_ms(lambda: al.align_staged(staged))
    suspect = al.last_suspect.copy()
    res_all = al.align_all(pairs + more)
    lane_launches = expect_launches(lk, ak, "lane main path",
                                    "lane_align")["lane_align"]
    for k, (q, r) in enumerate(pairs):
        if (res[k].query_idx, res[k].reference_idx) != (len(q), len(r)):
            raise AssertionError(f"pair {k}: end {res[k]} != ({len(q)}, {len(r)})")
    if res_all[: len(pairs)] != res:
        raise AssertionError("align_all disagrees with stage + align_staged")
    if not np.array_equal(al.last_suspect[: len(pairs)], suspect):
        raise AssertionError("align_all suspect flags disagree")
    sc = np.array([x.score for x in res])
    print(f"[lane-main] {len(pairs)} pairs 1000x1000 k=100 BLOSUM62 -11/-1 "
          f"block 32: stage+align_staged and align_all({len(pairs) + len(more)}) "
          f"agree; lane_align launches {lane_launches}; scores "
          f"{sc.min()}..{sc.max()} (mean {sc.mean():.1f}); suspect "
          f"{int(suspect.sum())}")

    # the kernel against the plain version on the main path's own inputs
    cfg = al.cfg
    args = (staged.codes, staged.qlen, staged.rlen, staged.table, staged.gaps)
    (want, cells), plain_ms = host_ms(
        lambda: lk.lane_align_plain(*args, cfg, count_cells=True))
    got = torch.from_numpy(np.stack([sc, suspect], 1).astype(np.int32))
    lane_err = int((got - want.cpu()).abs().max())
    if lane_err:
        raise AssertionError(f"lane main path differs from the plain version: "
                             f"max abs err {lane_err}")
    sub = al.stage(pairs[:512])
    sub_args = (sub.codes, sub.qlen, sub.rlen, sub.table, sub.gaps)
    want512, plain512_ms = host_ms(lambda: lk.lane_align_plain(*sub_args, cfg))
    if not torch.equal(want512.cpu(), got[:512]):
        raise AssertionError("first 512 main-path results differ from plain")
    print(f"[lane-main-vs-plain] all {len(pairs)} results (incl. the first "
          "512) equal the plain version on the card")

    lane_ms = cuda_ms(lambda: lk.lane_align(*args, cfg), 10)
    kernel512_ms = cuda_ms(lambda: lk.lane_align(*sub_args, cfg), 10)
    lane_bound, lane_by = bound(staged, cells, int32_per_s)
    B = len(pairs)
    print(f"[time] {card}: lane kernel {lane_ms * 1e3 / B:.4f} us/pair "
          f"({lane_ms:.3f} ms per launch of {B} pairs, CUDA events, mean of "
          f"10); bound {lane_bound:.4f} ms by {lane_by} "
          f"({int(cells.sum())} DP cells)")
    print(f"[time] {card}: pack (stage, host clock) {pack_ms * 1e3 / B:.4f} us/pair")
    print(f"[time] {card}: align_staged (launch, kernel, copy back, decode; "
          f"host clock) {run_ms * 1e3 / B:.4f} us/pair")
    print(f"[time] {card}: lane plain version {plain_ms * 1e3 / B:.4f} us/pair "
          f"on all {B} pairs ({plain_ms:.1f} ms, host clock)")
    print(f"[time] {card}: 512-pair subset: plain {plain512_ms * 1e3 / 512:.4f} "
          f"us/pair, kernel {kernel512_ms * 1e3 / 512:.4f} us/pair")
    lane_shape("lane main path (phase 5), block 32", cfg, B)
    lane_plain_ms = plain_ms
    phase("5, lane main path")

    # 6. the adaptive main path: the default size on homolog pairs, then on
    # the long random pairs
    ucal = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 256),
                        batch=len(uc), seq_cap=512, device=dev)
    lrand = rand_protein_pairs(np.random.default_rng(1234), 16384, 1000, 100)
    lral = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 256),
                        batch=len(lrand), seq_cap=1024, device=dev)
    if ucal.route != "adaptive" or lral.route != "adaptive":
        raise AssertionError("(32, 256) did not take the adaptive route")
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    runs = []
    for al, work, what in ((ucal, uc, "uc30 homologs 50-256 + indels"),
                           (lral, lrand, "random 1000x1000 k=100")):
        staged, pack_ms = host_ms(lambda: al.stage(work))
        res, run_ms = host_ms(lambda: al.align_staged(staged))
        res_all = al.align_all(work)
        runs.append((al, work, what, staged, res, pack_ms, run_ms, res_all))
    ad_launches = expect_launches(lk, ak, "adaptive main path",
                                  "adaptive_align")["adaptive_align"]
    ad_err = 0
    for al, work, what, staged, res, pack_ms, run_ms, res_all in runs:
        B = len(work)
        if res_all != res:
            raise AssertionError(f"{what}: align_all disagrees with "
                                 "stage + align_staged")
        for k, (q, r) in enumerate(work):
            if (res[k].query_idx, res[k].reference_idx) != (len(q), len(r)):
                raise AssertionError(f"{what} pair {k}: end {res[k]}")
        cfg = al.cfg
        args = (staged.codes, staged.qlen, staged.rlen, staged.table,
                staged.gaps)
        (want, cells), plain_ms = host_ms(
            lambda: ak.adaptive_align_plain(*args, cfg, count_cells=True))
        sc = np.array([x.score for x in res])
        got = torch.from_numpy(np.stack([sc, np.zeros_like(sc)], 1)
                               .astype(np.int32))
        err = int((got - want.cpu()).abs().max())
        if err:
            raise AssertionError(f"{what}: adaptive main path differs from the "
                                 f"plain version: max abs err {err}")
        ad_err = max(ad_err, err)
        kernel_ms = cuda_ms(lambda: ak.adaptive_align(*args, cfg), 10)
        bnd, by = bound(staged, cells, int32_per_s)
        print(f"[adaptive-main] {B} pairs, {what}, BLOSUM62 -11/-1 (32, 256): "
              "stage+align_staged and align_all agree and equal the plain "
              f"version; scores {sc.min()}..{sc.max()} (mean {sc.mean():.1f}); "
              f"{int(cells.sum())} DP cells, {int(cells.sum()) / B:.0f} per pair")
        print(f"[time] {card}: adaptive, {what}: kernel "
              f"{kernel_ms * 1e3 / B:.4f} us/pair ({kernel_ms:.3f} ms per "
              f"launch of {B} pairs, CUDA events, mean of 10); bound "
              f"{bnd:.4f} ms by {by}; pack {pack_ms * 1e3 / B:.4f} us/pair; "
              f"align_staged {run_ms * 1e3 / B:.4f} us/pair; plain "
              f"{plain_ms * 1e3 / B:.4f} us/pair ({plain_ms:.1f} ms)")
        if what.startswith("uc30"):
            ad_ms, ad_plain_ms, ad_bound, ad_by = kernel_ms, plain_ms, bnd, by
    print(f"[adaptive-main] adaptive_align launches {ad_launches}")
    phase("6, adaptive main path")

    # 7. align_exp_all at (32, 256) on 1024 homolog pairs
    pick = np.random.default_rng(5).choice(len(uc), 1024, replace=False)
    exp_pairs = [uc[k] for k in pick]
    fixed = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(256, 256),
                         batch=1024, seq_cap=512, device=dev)
    targets = [x.score for x in fixed.align_all(exp_pairs)]
    for k in range(8):
        targets[k] = 1 << 30  # never reached: these pairs run every level
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    exp_res, exp_min = align_exp_all(scores.BLOSUM62, Gaps(-11, -1), exp_pairs,
                                     targets, (32, 256), batch=1024,
                                     seq_cap=512, device=dev)
    counts = expect_launches(lk, ak, "align_exp_all", "lane_align",
                             "adaptive_align")
    exp_launches = (counts["lane_align"], counts["adaptive_align"])

    def check_exp_all(res, mins, targets, x_drop=None):
        """Every result equals a direct BatchAligner run at the min size it
        reports (None: the last level, 256); returns the count per size."""
        settled = {}
        for m in (32, 64, 128, 256, None):
            idx = [k for k in range(len(exp_pairs)) if mins[k] == m]
            settled[m] = len(idx)
            if not idx:
                continue
            direct = BatchAligner(
                scores.BLOSUM62, Gaps(-11, -1), size=(m or 256, 256),
                batch=1024, seq_cap=512, x_drop=x_drop,
                device=dev).align_all([exp_pairs[k] for k in idx])
            for k, d in zip(idx, direct):
                if res[k] != d or (m is None) != (d.score < targets[k]):
                    raise AssertionError(
                        f"align_exp_all pair {k} (min size {m}, x_drop "
                        f"{x_drop}): {res[k]} vs direct {d}, target "
                        f"{targets[k]}")
        return settled

    settled = check_exp_all(exp_res, exp_min, targets)
    print(f"[align_exp_all] {len(exp_pairs)} uc30 pairs at (32, 256), target "
          f"the 256-256 lane score: settled per min size {settled}; every "
          f"result equals a direct BatchAligner run at its size; launches "
          f"(lane, adaptive) {exp_launches}")
    phase("7, align_exp_all")

    # 8. the lane x-drop main path
    xal = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 32),
                       batch=8192, seq_cap=1100, x_drop=50, device=dev)
    lane_x = main_path(
        xal, xdrop_protein_pairs(np.random.default_rng(7), 8192),
        "protein 800..999 with len/10 substitutions, BLOSUM62 -11/-1, "
        "x_drop 50, (32, 32)", "lane_align_xdrop", lk.lane_align_plain,
        lk.lane_align)
    phase("8, lane x-drop main path")

    # 9. the adaptive x-drop main path: x_drop_accuracy's configuration,
    # then the default size on the homolog pairs
    drng = np.random.default_rng(1234)
    dna = []
    for _ in range(8192):
        q = rand_seq(drng, b"ACGT", 300)
        dna.append((q, rand_mutate(drng, q, 30, b"ACGT")))
    xal = BatchAligner(scores.NucMatrix.new_simple(1, -1), Gaps(-2, -1),
                       size=(32, 64), batch=8192, seq_cap=300 + 300 // 8 + 32,
                       x_drop=50, device=dev)
    ad_x = main_path(
        xal, dna, "DNA 300 with 30 edits, NucMatrix(1, -1) -2/-1, x_drop 50, "
        "(32, 64)", "adaptive_align_xdrop", ak.adaptive_align_plain,
        ak.adaptive_align)
    xal = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 256),
                       batch=len(uc), seq_cap=512, x_drop=50, device=dev)
    main_path(xal, uc, "uc30 homologs 50-256 + indels, BLOSUM62 -11/-1, "
               "x_drop 50, (32, 256)", "adaptive_align_xdrop",
               ak.adaptive_align_plain, ak.adaptive_align)
    phase("9, adaptive x-drop main paths")

    # 10. align_exp_all with x-drop on the pairs of phase 7
    fixed = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(256, 256),
                         batch=1024, seq_cap=512, x_drop=50, device=dev)
    targets = [x.score for x in fixed.align_all(exp_pairs)]
    for k in range(8):
        targets[k] = 1 << 30  # never reached: these pairs run every level
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    exp_res, exp_min = align_exp_all(scores.BLOSUM62, Gaps(-11, -1), exp_pairs,
                                     targets, (32, 256), x_drop=50,
                                     batch=1024, seq_cap=512, device=dev)
    counts = expect_launches(lk, ak, "align_exp_all x-drop",
                             "lane_align_xdrop", "adaptive_align_xdrop")
    settled = check_exp_all(exp_res, exp_min, targets, x_drop=50)
    print(f"[align_exp_all-xdrop] {len(exp_pairs)} uc30 pairs at (32, 256), "
          f"x_drop 50, target the x-drop 256-256 lane score: settled per min "
          f"size {settled}; every result equals a direct BatchAligner(x_drop"
          f"=50) run at its size; launches (lane, adaptive) "
          f"{(counts['lane_align_xdrop'], counts['adaptive_align_xdrop'])}")
    phase("10, align_exp_all with x-drop")

    # 11. the trace instances of both kernels vs their plain versions

    def kernel_vs_plain_trace(cfg, pairs, matrix, gaps, x, what, walk=True):
        pk = lk.pack_lane(pairs, matrix, cfg, gaps, dev, x_drop=x)
        kernel = lk.lane_align if isinstance(cfg, lk.LaneKernelConfig) \
            else ak.adaptive_align
        plain = lk.lane_align_plain if kernel is lk.lane_align \
            else ak.adaptive_align_plain
        got = kernel(*pk, cfg)
        torch.cuda.synchronize()
        want = plain(*pk, cfg)
        events = check_trace(got, want, what)
        if walk:
            out = want[0].cpu().numpy()
            ends = ([(int(o[1]), int(o[2])) for o in out] if cfg.x_drop else
                    [(len(q), len(r)) for q, r in pairs])
            walk_both(got, want, ends, matrix, what)
        return got, events

    setups = ((scores.BLOSUM62, Gaps(-11, -1), AA, 50),
              (scores.NW1, Gaps(-2, -1), DNA, 100))
    checked = 0
    for S in (16, 32, 64, 256, 512):
        for xd in (False, True):
            for matrix, gaps, alphabet, x in setups:
                pairs = random_pairs(rng, alphabet, 64, 400)
                cfg = lk.LaneKernelConfig(
                    S, -(-(1 + 400 + S + 16) // 128) * 128,
                    32 if matrix.kind == "aa" else 16, x_drop=xd, trace=True)
                kernel_vs_plain_trace(cfg, pairs, matrix, gaps, x if xd else 0,
                                      f"lane trace S={S} x_drop={xd}")
                held_warps(cfg, pairs)
                checked += len(pairs)
                if S < 512:
                    continue
                pairs = random_pairs(wide_rng, alphabet, wide_n, 400)
                kernel_vs_plain_trace(cfg, pairs, matrix, gaps, x if xd else 0,
                                      f"lane trace S={S} x_drop={xd}, "
                                      f"{wide_n} pairs", walk=False)
                held_warps(cfg, pairs)
                checked += len(pairs)
    print(f"[lane-trace-vs-plain] {checked} pairs at S in 16,32,64,256,512, "
          "global and x-drop (protein x 50 and DNA x 100, lengths 0..400; "
          f"at 512 also {wide_n} pairs, not walked): outputs, step counts, "
          "descriptors and words of every executed step equal, and the "
          "CIGARs walked from both")
    checked, saves, restores = 0, 0, 0
    ladders_t = ladders + ((32, 512),)
    for lo, hi in ladders_t:
        for xd in (False, True):
            for matrix, gaps, alphabet, x in setups:
                pairs = structural_pairs(rng, alphabet, 64, 400)
                if hi == 512 and matrix.kind == "aa":
                    pairs += grow_to_512_pairs(rng, 4)
                cfg = ak.AdaptiveKernelConfig(
                    lo, hi, -(-(1 + 1150 + hi + 16) // 128) * 128,
                    32 if matrix.kind == "aa" else 16, x_drop=xd, trace=True)
                got, (sv, rs) = kernel_vs_plain_trace(
                    cfg, pairs, matrix, gaps, x if xd else 0,
                    f"adaptive trace ({lo}, {hi}) x_drop={xd}")
                if hi == 512 and matrix.kind == "aa":
                    # every one of the 4 pairs, global and x-drop
                    ran = (torch.arange(got[2].shape[0], device=dev)[:, None]
                           < got[3][None, -4:])
                    grown = torch.where(ran, got[2][:, -4:, 3], 0).amax(0)
                    if not bool((grown == 512).all()):
                        raise AssertionError(f"x_drop={xd}: blocks grew to "
                                             f"{grown.tolist()}, not 512")
                checked += len(pairs)
                saves += sv
                restores += rs
    cfg = with_step_cap(ak.AdaptiveKernelConfig(16, 64, 768, trace=True), 40)
    got, _ = kernel_vs_plain_trace(
        cfg, structural_pairs(rng, AA, 192, 600), scores.BLOSUM62,
        Gaps(-11, -1), 0, "adaptive trace, 40 steps", walk=False)
    overran = int(got[0][:, 1].sum())
    if not 0 < overran < len(got[0]) or not saves or not restores:
        raise AssertionError(f"trace: {overran} pairs overran 40 steps; "
                             f"{saves} saves, {restores} restores")
    print(f"[adaptive-trace-vs-plain] {checked} pairs at ladders "
          f"{', '.join(map(str, ladders_t))}, global and x-drop (lengths "
          "0..400, structural indels; at (32, 512) 4 pairs that grow to "
          "512 in both modes): outputs, step counts, descriptors and words "
          f"equal, and the CIGARs; the descriptors held {saves} checkpoint "
          f"saves and {restores} grow restores; with a 40-step cap on "
          f"{len(got[0])} pairs, {overran} of which overran, the traces "
          "equal too")
    phase("11, trace instances vs plain")

    # 12. the lane trace main paths: the reference's traced short reads
    ill, ont = short_read_pairs(np.random.default_rng(77))
    paths = []
    for work, cap, what in (
            (ont, 1100, "nanopore-like 800..999 bases, 10% edits"),
            (ill, 180, "Illumina-like 100..150 bases, 1% edits")):
        kw = dict(size=(32, 32), batch=len(work), seq_cap=cap, device=dev)
        paths.append(trace_path(
            BatchAligner(nuc, ngaps, trace=True, **kw), work,
            f"{what}, NucMatrix(2, -4) -6/-2, (32, 32)", "lane_align_trace",
            BatchAligner(nuc, ngaps, **kw)))
    lane_t = merged(*paths)

    # 13. the lane x-drop trace main path: the pairs of phase 8
    kw = dict(size=(32, 32), batch=8192, seq_cap=1100, x_drop=50, device=dev)
    lane_xt = trace_path(
        BatchAligner(scores.BLOSUM62, Gaps(-11, -1), trace=True, **kw),
        xdrop_protein_pairs(np.random.default_rng(7), 8192),
        "protein 800..999 with len/10 substitutions, BLOSUM62 -11/-1, "
        "x_drop 50, (32, 32)", "lane_align_xdrop_trace",
        BatchAligner(scores.BLOSUM62, Gaps(-11, -1), **kw))

    # 14. the adaptive trace main paths: the homolog pairs of phase 6 at
    # the reference's traced (32, 256), at (32, 512), and with x-drop
    paths = []
    for size, x, name in (((32, 256), None, "adaptive_align_trace"),
                          ((32, 512), None, "adaptive_align_trace"),
                          ((32, 256), 50, "adaptive_align_xdrop_trace")):
        kw = dict(size=size, batch=2048, seq_cap=512, x_drop=x, device=dev)
        al = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), trace=True, **kw)
        if al.route != "adaptive" or al.cfg.max_size != size[1]:
            raise AssertionError(f"{size} with trace did not take the "
                                 "adaptive route")
        base = None if size[1] == 512 else BatchAligner(
            scores.BLOSUM62, Gaps(-11, -1), **kw)
        paths.append(trace_path(
            al, uc, f"uc30 homologs 50-256 + indels, BLOSUM62 -11/-1, {size}"
            + (f", x_drop {x}" if x else ""), name, base))
    ad_t = merged(paths[0], paths[1])
    ad_xt = paths[2]

    # 15. the profile instances of both kernels vs their plain versions
    from block_aligner_tpu_torch import ProfileAligner, align_profile_exp_all
    from block_aligner_tpu_torch.ops._profile import pack_profile

    def profile_vs_plain(cfg, pairs, x, what):
        """A profile instance against its plain version on the same packed
        pairs: equal outputs and, in trace mode, step counts, descriptors,
        words and CIGARs; returns the kernel's output, the packed pairs and
        the plain version's DP cells per pair."""
        pk = pack_profile(pairs, cfg, dev, x_drop=x)
        lane = isinstance(cfg, lk.LaneKernelConfig)
        got = (lk.lane_align if lane else ak.adaptive_align)(*pk, cfg)
        torch.cuda.synchronize()
        *want, cells = (lk.lane_align_plain if lane
                        else ak.adaptive_align_plain)(*pk, cfg,
                                                      count_cells=True)
        if not cfg.trace:
            check_equal(got, want[0], what)
            return got, pk, cells
        check_trace(got, tuple(want), what)
        out = want[0].cpu().numpy()
        ends = ([(int(o[1]), int(o[2])) for o in out] if cfg.x_drop else
                [(len(q), p.str_len) for q, p in pairs])
        walk_both(got, tuple(want), ends, None, what)
        return got, pk, cells

    modes = ((False, False), (True, False), (False, True), (True, True))
    checked = dropped = 0
    for S in (16, 32, 128, 512):
        for xd, tr in modes:
            cfg = lk.LaneKernelConfig(S, -(-(1 + 400 + S + 16) // 128) * 128,
                                      x_drop=xd, trace=tr, profile=True)
            batches = [profile_pairs(rng, 96, 400)]
            if S == 512:
                batches.append(profile_pairs(wide_rng, wide_n, 400))
            for pairs in batches:
                got, pk, _ = profile_vs_plain(
                    cfg, pairs, 50 if xd else 0,
                    f"lane profile S={S} x_drop={xd} trace={tr}, "
                    f"{len(pairs)} pairs")
                held_warps(cfg, pairs)
                checked += len(pairs)
                dropped += x_dropped(got[0] if tr else got, pk) if xd else 0
    if not dropped:
        raise AssertionError("no lane profile x-drop pair ended short")
    print(f"[lane-profile-vs-plain] {checked} (query, profile) pairs at S in "
          f"16,32,128,512 (at 512 96 and {wide_n} pairs), global, x-drop 50, "
          "trace and x-drop trace (lengths "
          "0..400, gap opens -13..-9 and close costs -3..0 varying by "
          "position, odd query bytes): outputs equal, and in trace mode step "
          f"counts, descriptors, words and CIGARs; {dropped} x-drop best "
          "positions short of the ends")
    checked = dropped = 0
    for size in ((32, 256), (32, 512)):
        for xd in (False, True):
            # at (32, 512) the instances with and without trace run the
            # same pairs: 4 whose blocks grow to 512, as the trace's
            # descriptors show; without trace, the plain version that the
            # kernel equals computes the same DP cells for each of the 4
            pairs = profile_pairs(rng, 96, 400) + (
                grow_profile_pairs(rng, 4) if size[1] == 512 else [])
            grow_cells = []
            for tr in (True, False):
                cfg = ak.AdaptiveKernelConfig(
                    *size, -(-(1 + 1150 + size[1] + 16) // 128) * 128,
                    x_drop=xd, trace=tr, profile=True)
                got, pk, cells = profile_vs_plain(
                    cfg, pairs, 50 if xd else 0,
                    f"adaptive profile {size} x_drop={xd} trace={tr}")
                checked += len(pairs)
                dropped += x_dropped(got[0] if tr else got, pk) if xd else 0
                if size[1] < 512:
                    continue
                grow_cells.append(cells[-4:].tolist())
                if tr:
                    ran = (torch.arange(got[2].shape[0], device=dev)[:, None]
                           < got[3][None, -4:])
                    grown = torch.where(ran, got[2][:, -4:, 3], 0).amax(0)
                    if not bool((grown == 512).all()):
                        raise AssertionError(
                            f"profile x_drop={xd}: blocks grew to "
                            f"{grown.tolist()}, not 512")
            if grow_cells and grow_cells[0] != grow_cells[1]:
                raise AssertionError(
                    f"profile (32, 512) x_drop={xd}: the grow pairs' cells "
                    f"{grow_cells[1]} without trace, {grow_cells[0]} with")
    if not dropped:
        raise AssertionError("no adaptive profile x-drop pair ended short")
    print(f"[adaptive-profile-vs-plain] {checked} pairs at (32, 256) and "
          "(32, 512) in the same four modes (at (32, 512) 4 pairs whose "
          "blocks grow to 512 in all four: the trace's descriptors, and "
          "without trace the same DP cells per pair): outputs, step counts, "
          "descriptors, words and CIGARs equal; "
          f"{dropped} x-drop best positions short of the ends")
    mini = read_pssm(os.path.join(ROOT, "data", "scop", "pairs.mini.pssm"))
    for cfg in (lk.LaneKernelConfig(32, 640, profile=True),
                ak.AdaptiveKernelConfig(32, 256, 640, profile=True)):
        profile_vs_plain(cfg, mini, 0, f"pairs.mini.pssm {cfg}")
    print(f"[profile-fixture] data/scop/pairs.mini.pssm: {len(mini)} "
          "records of the reference's PSSM format, lane (32, 32) and "
          "adaptive (32, 256): kernel equal to plain")
    phase("15, profile instances vs plain")

    def profile_bound(pk, cells, cfg, trace_bytes=0):
        """(bound_ms, bound_by) of a profile launch: each pair's query
        codes and the 32-byte rows of its profile positions 0..rlen read
        once, the output written once (and the trace's bytes), against the
        DP cells at ``cfg``'s operations per cell."""
        B = pk.qlen.shape[0]
        nbytes = (int(pk.qlen.sum()) + int(pk.rlen.sum()) * 32 + 33 * B
                  + 8 * B + (16 if lk.wide(cfg) else 8) * B + trace_bytes)
        ops = ops_per_cell(cfg)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = int(cells.sum()) * ops / int32_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    profile_plain = {"lane": lk.lane_align_plain,
                     "adaptive": ak.adaptive_align_plain,
                     "big": bk.big_align_plain}
    profile_kernel = {"lane": lk.lane_align, "adaptive": ak.adaptive_align,
                      "big": bk.big_align}

    def profile_path(al, work, what, name, keep=None):
        """Drive a profile main path (stage + align_staged, then align_all)
        with the launch counts reset just before it and read just after;
        every result must equal the plain version's on the card; time it.
        ``keep``, a dict, takes the results.  Returns the path's numbers for
        the kernels line."""
        torch.cuda.synchronize()
        reset_launches(lk, ak)
        staged, pack_ms = host_ms(lambda: al.stage(work))
        res, run_ms = host_ms(lambda: al.align_staged(staged))
        flags = None if al.last_suspect is None else al.last_suspect.copy()
        res_all = al.align_all(work)
        launches = expect_launches(lk, ak, what, name)[name]
        if res_all != res:
            raise AssertionError(f"{what}: align_all disagrees with stage + "
                                 "align_staged")
        if keep is not None:
            keep["res"] = res
        plain_fn = profile_plain[al.route]
        kernel_fn = profile_kernel[al.route]
        (want, cells), plain_ms = host_ms(
            lambda: plain_fn(*staged, al.cfg, count_cells=True))
        last = np.zeros(len(res), np.int32) if flags is None else flags
        got = torch.from_numpy(np.column_stack(
            [[(r.score, r.query_idx, r.reference_idx) for r in res], last])
            .astype(np.int32))
        want = want.cpu()
        if not lk.wide(al.cfg):
            want = torch.stack([want[:, 0], staged.qlen.cpu(),
                                staged.rlen.cpu(), want[:, 1]], 1)
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f"{what}: differs from the plain version: max "
                                 f"abs err {err}")
        kernel_ms = cuda_ms(lambda: kernel_fn(*staged, al.cfg), 10)
        bnd, by = profile_bound(staged, cells, al.cfg)
        B, n_cells = len(work), int(cells.sum())
        sc = got[:, 0].numpy()
        print(f"[{name}-main] {B} pairs, {what}: stage+align_staged and "
              f"align_all agree; all results equal the plain version's; "
              f"{name} launches {launches}; "
              f"scores {sc.min()}..{sc.max()} (mean {sc.mean():.1f}); "
              f"{n_cells} DP cells, {n_cells / B:.0f} per pair"
              + ("" if flags is None else f"; suspect {int(flags.sum())}")
              + (f"; best short of the ends in {x_dropped(got, staged)}"
                 if al.cfg.x_drop else ""))
        print(f"[time] {card}: {name}, {what}: kernel "
              f"{kernel_ms * 1e3 / B:.4f} us/pair ({kernel_ms:.3f} ms per "
              f"launch of {B} pairs, CUDA events, mean of 10); bound "
              f"{bnd:.4f} ms by {by}; pack {pack_ms * 1e3 / B:.4f} us/pair; "
              f"align_staged {run_ms * 1e3 / B:.4f} us/pair; plain "
              f"{plain_ms * 1e3 / B:.4f} us/pair ({plain_ms:.1f} ms)"
              + big_fill(al.cfg, B))
        phase(f"{name}, {what}")
        return {"launches": launches, "max_abs_err": err, "ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by}

    # 16. the lane profile main path: run_results.py::bench_pssm's
    # workload, 8192 SCOP-style pairs at (32, 32) and (128, 128), and the
    # same at (32, 32) with x-drop 50
    scop = scop_profiles(8192, seed=1234, max_len=200)
    slen = max(max(len(q) for q, _ in scop), max(p.len() for _, p in scop))
    what = "SCOP-style seq-PSSM 30..199, gap opens -13..-9, close 0"
    paths = [profile_path(ProfileAligner(
        (S, S), batch=len(scop), seq_cap=slen + S, device=dev), scop,
        f"{what}, ({S}, {S})", "lane_align_profile") for S in (32, 128)]
    lane_p = merged(*paths)
    lane_px = profile_path(ProfileAligner(
        (32, 32), batch=len(scop), seq_cap=slen + 32, x_drop=50, device=dev),
        scop, f"{what}, x_drop 50, (32, 32)", "lane_align_profile_xdrop")

    # 17. the adaptive profile main paths: the same pairs at the default
    # (32, 256), with x-drop 50, and align_profile_exp_all on 1024 of them
    ad_p = profile_path(ProfileAligner(
        batch=len(scop), seq_cap=slen + 32, device=dev), scop,
        f"{what}, (32, 256)", "adaptive_align_profile")
    ad_px = profile_path(ProfileAligner(
        batch=len(scop), seq_cap=slen + 32, x_drop=50, device=dev), scop,
        f"{what}, x_drop 50, (32, 256)", "adaptive_align_profile_xdrop")
    exp_pairs = scop[:1024]
    fixed = ProfileAligner((256, 256), batch=1024, seq_cap=slen + 32,
                           device=dev)
    targets = [x.score for x in fixed.align_all(exp_pairs)]
    for k in range(8):
        targets[k] = 1 << 30  # never reached: these pairs run every level
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    exp_res, exp_min = align_profile_exp_all(
        exp_pairs, targets, (32, 256), batch=1024, seq_cap=slen + 32,
        device=dev)
    counts = expect_launches(lk, ak, "align_profile_exp_all",
                             "lane_align_profile", "adaptive_align_profile")
    ad_p["launches"] += counts["adaptive_align_profile"]
    lane_p["launches"] += counts["lane_align_profile"]
    settled = {}
    for m in (32, 64, 128, 256, None):
        idx = [k for k in range(len(exp_pairs)) if exp_min[k] == m]
        settled[m] = len(idx)
        if not idx:
            continue
        size = m or 256
        cfg = (lk.LaneKernelConfig(256, fixed.cfg.seq_cap, profile=True)
               if size == 256 else ak.AdaptiveKernelConfig(
                   size, 256, fixed.cfg.seq_cap, profile=True))
        pk = pack_profile([exp_pairs[k] for k in idx], cfg, dev)
        want = (lk.lane_align_plain if size == 256
                else ak.adaptive_align_plain)(*pk, cfg).cpu()
        for k, w in zip(idx, want):
            if (exp_res[k].score != int(w[0])
                    or (m is None) != (exp_res[k].score < targets[k])):
                raise AssertionError(
                    f"align_profile_exp_all pair {k} (min size {m}): "
                    f"{exp_res[k]} vs plain {w.tolist()}, target "
                    f"{targets[k]}")
    print(f"[align_profile_exp_all] {len(exp_pairs)} SCOP-style pairs at "
          "(32, 256), target the 256-256 lane score: settled per min size "
          f"{settled}; every result equals the plain version at its size; "
          "launches (lane, adaptive) ("
          f"{counts['lane_align_profile']}, "
          f"{counts['adaptive_align_profile']})")
    phase("17, align_profile_exp_all")

    # 18. the profile trace paths: the SCOP-style pairs in batches of 2048
    # on the lane (32, 32) and adaptive (32, 256) routes, global and x-drop
    def profile_trace_path(al, base, work, what, name, n_cmp=512):
        """Align every batch with trace and walk each pair's CIGAR, with
        the launch counts reset just before and read just after; hold the
        results against the non-trace twin and the plain version, every
        CIGAR against its end and its score (``check_profile_cigars``: a
        pair that misses must have a down-to-right gap hand-off, and is held
        to the plain version's CIGAR), the first ``n_cmp`` CIGARs against
        the plain version's; time each layer per batch.  Returns the
        numbers for the kernels line."""
        plain_fn = profile_plain[al.route]
        kernel_fn = profile_kernel[al.route]
        # the big route's plain trace takes a smaller word budget (its
        # buffer is zeroed), which no pair may pass
        tcfg = (with_trace_budget(al.cfg, min(al.cfg.trace_budget, 1 << 20))
                if al.route == "big" else al.cfg)
        x = al.x_drop or 0
        cfg0 = dataclasses.replace(al.cfg, trace=False)
        torch.cuda.synchronize()
        reset_launches(lk, ak)
        t = {"pack": 0.0, "kernel": 0.0, "twin": 0.0, "decode": 0.0,
             "walk": 0.0, "path": 0.0}
        res, cigars, gap_rects, nbytes = [], [], [], 0
        for k in range(0, len(work), al.batch_size):
            chunk = work[k : k + al.batch_size]
            t0 = time.perf_counter()
            staged, ms = host_ms(lambda: al._pack(chunk))
            t["pack"] += ms
            disp = al._dispatch(staged)
            got_b, ms = host_ms(lambda: al._decode(staged, disp))
            t["decode"] += ms
            ends = [(r.query_idx, r.reference_idx) for r in got_b]
            cg, ms = host_ms(lambda: al.trace().cigars_all(ends))
            t["walk"] += ms
            t["path"] += (time.perf_counter() - t0) * 1e3
            res += got_b
            cigars += cg
            trb = al.trace()
            gap_rects += [profile_gap_rects(trb, b, c, r)
                          for b, (c, r) in enumerate(zip(cg, got_b))]
            ran = np.arange(trb.desc.shape[0])[:, None] < trb.steps[None, :]
            nbytes += (4 * len(chunk) + 16 * int(ran.sum())
                       + 4 * lk.trace_words(al.cfg)
                       * int(np.where(ran, trb.desc[:, :, 3], 0).sum()))
        launches = expect_launches(lk, ak, what, name)[name]
        for k in range(0, len(work), al.batch_size):
            chunk = work[k : k + al.batch_size]
            staged = al._pack(chunk)
            t["kernel"] += cuda_ms(lambda: kernel_fn(*staged, al.cfg), 3)
            t["twin"] += cuda_ms(lambda: kernel_fn(*staged, cfg0), 3)
        if base.align_all(work, sort=False) != res:
            raise AssertionError(f"{what}: results differ from the non-trace "
                                 "instance's")
        miss, hand = check_profile_cigars(cigars, gap_rects, work, res,
                                          what, cigar_start(al.cfg))
        pk = pack_profile(work, cfg0, dev, x_drop=x)
        plain_res, plain_ms = host_ms(
            lambda: plain_fn(*pk, cfg0, count_cells=True))
        want, cells = plain_res[0].cpu(), plain_res[-1]
        got = torch.tensor([(r.score, r.query_idx, r.reference_idx)
                            for r in res], dtype=torch.int32)
        if lk.wide(al.cfg):
            err = int((got - want[:, :3]).abs().max())
        else:
            err = int((got[:, 0] - want[:, 0]).abs().max())
        if err:
            raise AssertionError(f"{what}: differs from the plain version: "
                                 f"max abs err {err}")
        # the plain version's CIGARs: the first n_cmp pairs and every pair
        # whose CIGAR does not rescore (a hand-off the walk cannot show)
        for idx in (list(range(min(n_cmp, len(work)))), miss):
            for k in range(0, len(idx), al.batch_size):
                part = idx[k : k + al.batch_size]
                sub = [work[i] for i in part]
                pk = pack_profile(sub, tcfg, dev, x_drop=x)
                got_p = plain_fn(*pk, tcfg)
                if al.route == "big":
                    if got_p[0][:, -1].any():
                        raise AssertionError(f"{what}: the plain trace "
                                             "passed its word budget")
                    tr = block_trace(got_p, None, tcfg)
                else:
                    _, words, desc, steps = got_p
                    tr = Trace(words.cpu().numpy(), desc.cpu().numpy(),
                               steps.cpu().numpy(), **trace_flags(al.cfg))
                del got_p
                ends = [(res[i].query_idx, res[i].reference_idx)
                        for i in part]
                if [str(c) for c in tr.cigars_all(ends)] != [
                        str(cigars[i]) for i in part]:
                    raise AssertionError(f"{what}: CIGARs differ from the "
                                         "plain version's")
        ops = sum(len(c.to_vec()) for c in cigars)
        bnd, by = profile_bound(pack_profile(work, cfg0, dev, x_drop=x),
                                cells, al.cfg, nbytes)
        B = len(work)
        sc = got[:, 0].numpy()
        print(f"[{name}-main] {B} pairs, {what}: batches of {al.batch_size}; "
              f"{name} launches {launches}; results equal the non-trace "
              "instance's and the plain version's; every CIGAR sums to its "
              f"end; {B - len(miss)} rescore to their score under the "
              f"block DP's profile costs; the other {len(miss)}, of the "
              f"{hand} whose CIGAR has a D run handed from a down rect's "
              "last lane to a right rect, rescore below their score and "
              "equal the plain version's CIGARs, as do the first "
              f"{min(n_cmp, B)}; "
              f"{ops} runs; scores {sc.min()}..{sc.max()} (mean "
              f"{sc.mean():.1f}); {int(cells.sum())} DP cells; "
              f"{nbytes / B:.0f} trace bytes per pair")
        print(f"[time] {card}: {name}, {what}: kernel "
              f"{t['kernel'] * 1e3 / B:.4f} us/pair ({t['kernel']:.3f} ms for "
              f"{B} pairs, CUDA events, mean of 3 per batch), the non-trace "
              f"twin on the same batches {t['twin'] * 1e3 / B:.4f} us/pair "
              f"({t['twin']:.3f} ms); bound {bnd:.4f} ms by {by}; host "
              f"clock, us/pair: pack {t['pack'] * 1e3 / B:.4f}, _decode "
              f"(copy, replay, results) {t['decode'] * 1e3 / B:.4f}, walk "
              f"(cigars_all) {t['walk'] * 1e3 / B:.4f}, path "
              f"{t['path'] * 1e3 / B:.4f}, plain {plain_ms * 1e3 / B:.4f} "
              f"({plain_ms:.1f} ms)"
              + big_fill(al.cfg, min(B, al.batch_size)))
        phase(f"{name}, {what}")
        return {"launches": launches, "max_abs_err": err, "ms": t["kernel"],
                "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by}

    trace_paths = {}
    for size, x, name in (((32, 32), None, "lane_align_profile_trace"),
                          ((32, 256), None, "adaptive_align_profile_trace"),
                          ((32, 32), 50, "lane_align_profile_xdrop_trace"),
                          ((32, 256), 50,
                           "adaptive_align_profile_xdrop_trace")):
        kw = dict(batch=2048, seq_cap=slen + 32, x_drop=x, device=dev)
        trace_paths[name] = profile_trace_path(
            ProfileAligner(size, trace=True, **kw), ProfileAligner(size, **kw),
            scop, f"{what}, {size}" + (f", x_drop {x}" if x else ""), name)

    # 19. the byte and flags instances (csrc/*_flags.cu) vs their plain
    # versions: ByteMatrix on pairs over all 256 bytes with byte 0 and the
    # golden pair, and each flag, global, x-drop (not free end gaps) and
    # trace, sequence and profile
    two = ((False, False), (False, True))
    flag_sets = (("byte", dict(byte_mode=True), two),
                 ("local start", dict(local_start=True), modes),
                 ("free start gaps", dict(free_query_start_gaps=True), modes),
                 ("free end gaps", dict(free_query_end_gaps=True), two))

    # the plain versions of phase 19 run in the CPU workers while the card
    # goes on with phases 20-42; check_flags holds them against the kernels'
    # outputs before phase 43
    flag_checks = []

    def flags_vs_plain(cfg, pairs, x, what):
        """A flags instance on the card; its plain version on the same
        packed pairs goes to a CPU worker (``plain_job``), and
        ``check_flags`` holds the two: equal outputs and, in trace mode,
        step counts, descriptors, words (the zero bits of local start too)
        and CIGARs.  Returns the kernel's output."""
        lane = isinstance(cfg, lk.LaneKernelConfig)
        if cfg.profile:
            matrix, pk = None, pack_profile(pairs, cfg, dev, x_drop=x)
        else:
            matrix = byte1 if cfg.byte_mode else scores.BLOSUM62
            pk = lk.pack_lane(pairs, matrix, cfg, Gaps(-11, -1), dev,
                              x_drop=x)
        got = (lk.lane_align if lane else ak.adaptive_align)(*pk, cfg)
        host = type(pk)(*(t.cpu() if torch.is_tensor(t) else t for t in pk))
        job = cpu.submit(plain_job, "lane" if lane else "adaptive", cfg,
                         host)
        if cfg.trace:
            # the steps the pairs ran, all that the checks read
            T = int(got[3].max())
            mine = (got[0].cpu(), got[1][:T].cpu(), got[2][:T].cpu(),
                    got[3].cpu())
        else:
            mine = got.cpu()
        flag_checks.append((job, mine, cfg, pairs, matrix, what))
        return got

    def check_flags():
        """Phase 19's kernels against their plain versions from the
        workers."""
        for job, got, cfg, pairs, matrix, what in flag_checks:
            want, _ = job.result()
            if not cfg.trace:
                check_equal(got, want, what)
                continue
            check_trace(got, want, what, lk.trace_words(cfg))
            out = want[0].numpy()
            ends = ([(int(o[1]), int(o[2])) for o in out] if lk.wide(cfg)
                    else [(len(q), r.str_len if cfg.profile else len(r))
                          for q, r in pairs])
            walk_both(got, want, ends, matrix, what, cfg)
        return len(flag_checks)

    def flag_pairs(cfg, grow, n=32, draw=rng):
        """``n`` pairs of lengths 0..200 for ``cfg``'s mode from ``draw``,
        and with ``grow`` 2 whose adaptive blocks grow to 512; free end gaps
        cut the queries short of the min size."""
        if cfg.byte_mode:
            pairs = byte_pairs(draw, n, 200)
        elif cfg.profile:
            pairs = profile_pairs(draw, n, 200) + (
                grow_profile_pairs(draw, 2) if grow else [])
        else:
            pairs = structural_pairs(draw, AA, n, 200) + (
                grow_to_512_pairs(draw, 2, 560, 300) if grow else [])
        if cfg.free_query_end_gaps:
            pairs = [(q[: cfg.min_size - 1], r) for q, r in pairs]
        return pairs

    def flag_runs(size, sets):
        """Every instance of ``sets`` at ``size`` against its plain
        version; returns (pairs checked, x-drop ends short)."""
        lo, hi = size
        checked = dropped = 0
        for label, flags, fmodes in sets:
            for prof in (False, True):
                if prof and flags.get("byte_mode"):
                    continue
                for xd, tr in fmodes:
                    if hi == 512 and not (tr or prof):
                        continue  # max_size 512 takes the big route
                    kw = dict(x_drop=xd, trace=tr, profile=prof, **flags)
                    cap = -(-(1 + 900 + hi + 16) // 128) * 128
                    alpha = 256 if flags.get("byte_mode") else 32
                    cfg = (lk.LaneKernelConfig(hi, cap, alpha, **kw)
                           if lo == hi else
                           ak.AdaptiveKernelConfig(lo, hi, cap, alpha, **kw))
                    batches = [flag_pairs(cfg, hi == 512 and lo < hi)]
                    if lo == hi == 512:
                        batches.append(flag_pairs(cfg, False, wide_n,
                                                  wide_rng))
                    for pairs in batches:
                        got = flags_vs_plain(
                            cfg, pairs, 50 if xd else 0,
                            f"{label} {size} profile={prof} x_drop={xd} "
                            f"trace={tr}, {len(pairs)} pairs")
                        if lo == hi:
                            held_warps(cfg, pairs)
                        checked += len(pairs)
                        if not xd:
                            continue
                        dropped += x_dropped(got[0] if tr else got,
                                             SimpleNamespace(
                                                 qlen=torch.tensor(
                                                     [len(q) for q, _ in
                                                      pairs]),
                                                 rlen=torch.tensor(
                                                     [r.str_len if prof
                                                      else len(r) for _, r
                                                      in pairs])))
        return checked, dropped

    checked = dropped = 0
    for S in (16, 32, 128, 512):
        c, d = flag_runs((S, S), flag_sets)
        checked, dropped = checked + c, dropped + d
    if not dropped:
        raise AssertionError("no lane flags x-drop pair ended short")
    print(f"[lane-flags-vs-plain] {checked} pairs at S in 16,32,128,512 "
          f"(at 512 32 and {wide_n} pairs): "
          "ByteMatrix(1, -1) global and trace (all 256 bytes, byte 0, the "
          "golden pair); local start and free start gaps global, x-drop "
          "50, trace and x-drop trace; free end gaps (queries shorter than "
          "S) global and trace; sequences and profiles, their plain "
          "versions held at phase 43's start (outputs, and in trace mode "
          "step counts, descriptors, words (local start's zero bits too) "
          f"and CIGARs); {dropped} x-drop best positions short of the ends")
    checked = dropped = 0
    for size in ((32, 256), (32, 512)):
        c, d = flag_runs(size, flag_sets)
        checked, dropped = checked + c, dropped + d
    if not dropped:
        raise AssertionError("no adaptive flags x-drop pair ended short")
    print(f"[adaptive-flags-vs-plain] {checked} pairs at (32, 256) and (32, "
          "512) in the same modes (at (32, 512) with trace or profiles "
          "only, with 2 pairs whose blocks grow to 512), held as the lane "
          f"ones; {dropped} x-drop best positions short of the ends")
    phase("19, byte and flags instances vs plain")

    # 20. the ByteMatrix main paths
    bpairs = rand_byte_pairs(np.random.default_rng(1234), 16384, 1000, 100)
    lane_b = main_path(
        BatchAligner(byte1, Gaps(-11, -1), size=(32, 32), batch=16384,
                     seq_cap=1024, device=dev), bpairs,
        "bytes 0..255 1000x1000 k=100, ByteMatrix(1, -1) -11/-1, (32, 32)",
        "lane_align_byte", lk.lane_align_plain, lk.lane_align)
    phase("20, lane_align_byte main path")
    ad_b = main_path(
        BatchAligner(byte1, Gaps(-11, -1), size=(32, 256), batch=len(uc),
                     seq_cap=512, device=dev), uc,
        "uc30 homologs 50-256 + indels, ByteMatrix(1, -1) -11/-1, (32, 256)",
        "adaptive_align_byte", ak.adaptive_align_plain, ak.adaptive_align)
    phase("20, adaptive_align_byte main path")
    kw = dict(size=(32, 32), batch=len(ill), seq_cap=180, device=dev)
    bal = BatchAligner(byte2, ngaps, trace=True, **kw)
    lane_bt = trace_path(bal, ill, "Illumina-like 100..150 bases, 1% edits, "
                         "ByteMatrix(2, -4) -6/-2, (32, 32)",
                         "lane_align_byte_trace",
                         BatchAligner(byte2, ngaps, **kw))
    # on ACGT reads byte equality scores as NucMatrix(2, -4) does
    bres = BatchAligner(byte2, ngaps, **kw).align_all(ill, sort=False)
    nres = BatchAligner(nuc, ngaps, **kw).align_all(ill, sort=False)
    if bres != nres:
        k = next(k for k in range(len(ill)) if bres[k] != nres[k])
        raise AssertionError(f"byte Illumina pair {k}: {bres[k]} != "
                             f"NucMatrix {nres[k]}")
    print(f"[byte-vs-nuc] {len(ill)} Illumina-like pairs: ByteMatrix(2, -4) "
          "results equal NucMatrix(2, -4)'s on the lane route")
    kw = dict(size=(32, 256), batch=2048, seq_cap=512, device=dev)
    ad_bt = trace_path(BatchAligner(byte1, Gaps(-11, -1), trace=True, **kw),
                       uc, "uc30 homologs 50-256 + indels, ByteMatrix(1, -1) "
                       "-11/-1, (32, 256)", "adaptive_align_byte_trace",
                       BatchAligner(byte1, Gaps(-11, -1), **kw))

    # 21. local start: the uc30 pairs at (32, 256), global and traced, the
    # x-drop protein pairs at (32, 32) with x 50, and uc30 with x 50
    local = dict(local_start=True)
    blosum = (scores.BLOSUM62, Gaps(-11, -1))
    ad_f = main_path(
        BatchAligner(*blosum, size=(32, 256), batch=len(uc), seq_cap=512,
                     device=dev, **local), uc,
        "uc30 homologs 50-256 + indels, BLOSUM62 -11/-1, (32, 256), local "
        "start", "adaptive_align_flags", ak.adaptive_align_plain,
        ak.adaptive_align)
    phase("21, adaptive_align_flags main path")
    kw = dict(size=(32, 256), batch=2048, seq_cap=512, device=dev, **local)
    ad_ft = trace_path(BatchAligner(*blosum, trace=True, **kw), uc,
                       "uc30 homologs 50-256 + indels, BLOSUM62 -11/-1, (32, "
                       "256), local start", "adaptive_align_flags_trace",
                       BatchAligner(*blosum, **kw))
    xprot = xdrop_protein_pairs(np.random.default_rng(7), 8192)
    kw = dict(size=(32, 32), batch=8192, seq_cap=1100, x_drop=50, device=dev,
              **local)
    what = ("protein 800..999 with len/10 substitutions, BLOSUM62 -11/-1, "
            "x_drop 50, (32, 32), local start")
    lane_fx = main_path(BatchAligner(*blosum, **kw), xprot, what,
                         "lane_align_flags_xdrop", lk.lane_align_plain,
                         lk.lane_align)
    phase("21, lane_align_flags_xdrop main path")
    lane_fxt = trace_path(BatchAligner(*blosum, trace=True, **kw), xprot,
                          what, "lane_align_flags_xdrop_trace",
                          BatchAligner(*blosum, **kw))
    kw = dict(size=(32, 256), seq_cap=512, x_drop=50, device=dev, **local)
    what = ("uc30 homologs 50-256 + indels, BLOSUM62 -11/-1, x_drop 50, "
            "(32, 256), local start")
    ad_fx = main_path(BatchAligner(*blosum, batch=len(uc), **kw), uc, what,
                       "adaptive_align_flags_xdrop", ak.adaptive_align_plain,
                       ak.adaptive_align)
    phase("21, adaptive_align_flags_xdrop main path")
    ad_fxt = trace_path(BatchAligner(*blosum, trace=True, batch=2048, **kw),
                        uc, what, "adaptive_align_flags_xdrop_trace",
                        BatchAligner(*blosum, batch=2048, **kw))

    # 22. free start gaps: the nanopore-like reads at (32, 32), traced
    kw = dict(size=(32, 32), batch=len(ont), seq_cap=1100, device=dev,
              free_query_start_gaps=True)
    lane_ft = [trace_path(
        BatchAligner(nuc, ngaps, trace=True, **kw), ont,
        "nanopore-like 800..999 bases, 10% edits, NucMatrix(2, -4) -6/-2, "
        "(32, 32), free query start gaps", "lane_align_flags_trace",
        BatchAligner(nuc, ngaps, **kw))]

    # 23. free end gaps: the Illumina-like reads (100..150 < 256) at lane
    # (256, 256), global and traced
    kw = dict(size=(256, 256), batch=len(ill), seq_cap=180, device=dev,
              free_query_end_gaps=True)
    what = ("Illumina-like 100..150 bases, 1% edits, NucMatrix(2, -4) -6/-2, "
            "(256, 256), free query end gaps")
    lane_f = main_path(BatchAligner(nuc, ngaps, **kw), ill, what,
                        "lane_align_flags", lk.lane_align_plain,
                        lk.lane_align)
    phase("23, lane_align_flags main path")
    lane_ft.append(trace_path(BatchAligner(nuc, ngaps, trace=True, **kw), ill,
                              what, "lane_align_flags_trace",
                              BatchAligner(nuc, ngaps, **kw)))
    lane_ft = merged(*lane_ft)

    # 24. profile flags: the SCOP-style pairs at lane (32, 32) with local
    # start, adaptive (32, 256) with free start gaps, lane (256, 256) with
    # free end gaps; the first two with x-drop 50 and traced (2048 pairs)
    what = "SCOP-style seq-PSSM 30..199, gap opens -13..-9, close 0"
    if max(len(q) for q, _ in scop) >= 256:
        raise AssertionError("a SCOP query is too long for free end gaps")
    lane_pf = [profile_path(ProfileAligner(
        (32, 32), batch=len(scop), seq_cap=slen + 32, local_start=True,
        device=dev), scop, f"{what}, (32, 32), local start",
        "lane_align_profile_flags")]
    lane_pf.append(profile_path(ProfileAligner(
        (256, 256), batch=len(scop), seq_cap=slen + 256,
        free_query_end_gaps=True, device=dev), scop,
        f"{what}, (256, 256), free query end gaps",
        "lane_align_profile_flags"))
    lane_pf = merged(*lane_pf)
    ad_pf = profile_path(ProfileAligner(
        batch=len(scop), seq_cap=slen + 32, free_query_start_gaps=True,
        device=dev), scop, f"{what}, (32, 256), free query start gaps",
        "adaptive_align_profile_flags")
    lane_pfx = profile_path(ProfileAligner(
        (32, 32), batch=len(scop), seq_cap=slen + 32, x_drop=50,
        local_start=True, device=dev), scop,
        f"{what}, x_drop 50, (32, 32), local start",
        "lane_align_profile_flags_xdrop")
    ad_pfx = profile_path(ProfileAligner(
        batch=len(scop), seq_cap=slen + 32, x_drop=50,
        free_query_start_gaps=True, device=dev), scop,
        f"{what}, x_drop 50, (32, 256), free query start gaps",
        "adaptive_align_profile_flags_xdrop")
    flag_traces = {}
    for size, x, flag, name in (
            ((32, 32), None, "local_start", "lane_align_profile_flags_trace"),
            ((32, 256), None, "free_query_start_gaps",
             "adaptive_align_profile_flags_trace"),
            ((32, 32), 50, "local_start",
             "lane_align_profile_flags_xdrop_trace"),
            ((32, 256), 50, "free_query_start_gaps",
             "adaptive_align_profile_flags_xdrop_trace")):
        kw = dict(batch=2048, seq_cap=slen + 32, x_drop=x, device=dev,
                  **{flag: True})
        flag_traces[name] = profile_trace_path(
            ProfileAligner(size, trace=True, **kw), ProfileAligner(size, **kw),
            scop[:2048], f"{what}, {size}" + (f", x_drop {x}" if x else "")
            + f", {flag.replace('_', ' ')}", name)

    # 38. the reference's PSSM self-oracle (examples/pssm_accuracy.rs:80-82;
    # the JAX package's examples_tpu/pssm_accuracy.py:45-52): phase 16's
    # SCOP-style pairs through one fixed (2048, 2048) block on kernel C's
    # profile instance, global and (the first 2048) x 50, then
    # pssm_accuracy.py's table: how many lane and adaptive results equal
    # the self-oracle
    max_q = max(len(q) for q, _ in scop)
    max_p = max(p.len() for _, p in scop)
    okw = dict(seq_cap=max_q + 16, prof_len=max_p + 16, device=dev)
    owhat = ("SCOP-style seq-PSSM 30..199, gap opens -13..-9, close 0, "
             "(2048, 2048)")
    kept = {}
    big_p = profile_path(ProfileAligner((2048, 2048), batch=len(scop),
                                        **okw),
                         scop, owhat, "big_align_profile", keep=kept)
    self_oracle = [r.score for r in kept["res"]]
    # without a freeze every pair runs the first rect's 2048 columns: the
    # x-drop paths take the first 2048 pairs
    big_px = profile_path(ProfileAligner((2048, 2048), batch=2048, x_drop=50,
                                         **okw),
                          scop[:2048], f"{owhat}, x_drop 50",
                          "big_align_profile_xdrop")
    table = []
    acap = max(max_q, max_p)
    for size in ((32, 32), (32, 64), (64, 64), (64, 128), (128, 128)):
        res = ProfileAligner(size, batch=len(scop), seq_cap=acap + 32,
                             device=dev).align_all(scop)
        table.append((size, sum(r.score == w
                                for r, w in zip(res, self_oracle))))
    print("[pssm-accuracy] examples_tpu/pssm_accuracy.py's table against the "
          "(2048, 2048) self-oracle, size,total,correct: " + "; ".join(
              f"{lo}-{hi},{len(scop)},{n}" for (lo, hi), n in table))
    phase("38, PSSM self-oracle (2048, 2048)")

    # 39. growth: strong-consensus profiles whose random middles make the
    # blocks grow, some with costs that vary by position, at (32, 2048)
    # global (to 1024 and 2048) and x 50, and at (512, 4096) to 4096;
    # kernel against the plain version
    def profile_vs_plain_big(pairs, size, x=None, **modes):
        """big_align against big_align_plain on profile pairs, with
        ``modes``; with trace also the step counts, word counters,
        descriptors, words and CIGARs walked from both, each CIGAR ending
        at its result and rescoring under the profile costs (or, with the
        reference's hand-off, below and equal to the plain one's); returns
        the largest block sizes reached."""
        pmax = max(p.str_len for _, p in pairs)
        cfg = ProfileAligner(
            size, seq_cap=max(max(len(q) for q, _ in pairs), pmax),
            prof_len=pmax, x_drop=x, device=dev, **modes).cfg
        pk = pack_profile(pairs, cfg, dev, x or 0)
        got = bk.big_align(*pk, cfg)
        torch.cuda.synchronize()
        *want, top = bk.big_align_plain(*pk, cfg, top_size=True)
        what = f"big profile {size} x_drop={x} {sorted(modes)}"
        if not cfg.trace:
            check_equal(got, want[0], what)
            if got[:, -1].any():
                raise AssertionError(f"{what}: a pair hit the step cap")
            return top
        check_big_trace(got, want, what)
        out = want[0].cpu()
        if out[:, -1].any():
            raise AssertionError(f"{what}: a pair hit the step cap")
        res = [api.AlignResult(int(o[0]), int(o[1]), int(o[2]))
               if lk.wide(cfg) else api.AlignResult(int(o[0]), len(q),
                                                    p.str_len)
               for o, (q, p) in zip(out, pairs)]
        ends = [(r.query_idx, r.reference_idx) for r in res]
        walk_both(got, want, ends, None, what, cfg)
        tr = block_trace(got, None, cfg)
        cigars = tr.cigars_all(ends)
        gaps = [profile_gap_rects(tr, b, c, r)
                for b, (c, r) in enumerate(zip(cigars, res))]
        check_profile_cigars(cigars, gaps, pairs, res, what, cigar_start(cfg))
        return top

    prng = np.random.default_rng(2048)
    pgrow = [p for m in (500, 800, 1100, 1400)
             for p in consensus_growth_pairs(prng, 1, 150, m)]
    # costs that vary by position, so that the down rects' C/R swap and R
    # close and the warps' carries of a row's own costs show: two growth
    # pairs and two whose queries miss a stretch of their profile
    vrng = np.random.default_rng(2049)
    pgrow += [p for m in (700, 1200)
              for p in consensus_growth_pairs(vrng, 1, 150, m, varied=True)]
    pgrow += deletion_profile_pairs(vrng)
    top = profile_vs_plain_big(pgrow, (32, 2048))
    for part in (top[:4], top[4:6]):
        if not {1024, 2048} <= set(part.tolist()):
            raise AssertionError(f"profile growth pairs reached {top}")
    profile_vs_plain_big(pgrow, (32, 2048), 50)
    pgrow4 = consensus_growth_pairs(prng, 2, 300, 2500)
    top4 = profile_vs_plain_big(pgrow4, (512, 4096))
    if 4096 not in top4.tolist():
        raise AssertionError(f"profile growth pairs reached {top4.tolist()}")
    big_shapes("profile instances (global, x-drop, trace, trace with "
               "local start, x-drop trace with local start)",
               ((128, 1024), (32, 2048), (256, 2048), (2048, 2048),
                (512, 4096)), profile=True, prof_cap=128,
               sets=[{}, {"x_drop": True}, {"trace": True},
                     {"trace": True, "local_start": True},
                     {"x_drop": True, "trace": True, "local_start": True}])
    print(f"[big-profile-growth] 4 strong-consensus profiles (flanks of 150, "
          "random middles of 500..1400), 2 more (middles of 700 and 1200) "
          "whose gap opens and closes vary by position, and 2 such profiles "
          "whose queries miss 70 and 80 positions, at (32, 2048), global "
          f"(blocks reached {top.tolist()}) and x 50, and 2 (flanks of 300, "
          f"middles of 2500) at (512, 4096) (blocks {top4.tolist()}): "
          "kernel equal to the plain version")
    phase("39, big profile growth vs plain")

    # 40. trace: the self-oracle pairs traced at (2048, 2048), global and
    # (the first 1024) x 50, through ProfileAligner in batches of 256; the
    # (32, 2048) pairs of phase 39 traced, global and x 50, against the plain
    # version
    tkw = dict(batch=256, **okw)
    big_pt = profile_trace_path(
        ProfileAligner((2048, 2048), trace=True, **tkw),
        ProfileAligner((2048, 2048), **tkw), scop, owhat,
        "big_align_profile_trace", n_cmp=256)
    big_pxt = profile_trace_path(
        ProfileAligner((2048, 2048), trace=True, x_drop=50, **tkw),
        ProfileAligner((2048, 2048), x_drop=50, **tkw), scop[:1024],
        f"{owhat}, x_drop 50", "big_align_profile_xdrop_trace", n_cmp=256)
    for x in (None, 50):
        profile_vs_plain_big(pgrow, (32, 2048), x, trace=True)
    print("[big-profile-trace-growth] the 8 profiles of phase 39 at (32, "
          "2048) traced, global and x 50: outputs, step counts, word "
          "counters, descriptors, words and CIGARs equal the plain version's; "
          "every CIGAR ends at its result and rescores")
    phase("40, big profile trace")

    # 41. the flags on the self-oracle pairs at (2048, 2048): local start
    # (and, on 2048 of them, traced, and on 1024 traced with x 50); on 2048
    # of them, which run the whole first rect, free query start gaps with x
    # 50 and free query end gaps (every query is shorter than 2048); and
    # against the plain version at (32, 2048) on the pairs of phase 39, local
    # start traced and free start gaps
    local = dict(local_start=True)
    big_pf = merged(
        profile_path(ProfileAligner((2048, 2048), batch=len(scop), **local,
                                    **okw), scop, f"{owhat}, local start",
                     "big_align_profile_flags"),
        profile_path(ProfileAligner((2048, 2048), batch=2048,
                                    free_query_end_gaps=True, **okw),
                     scop[:2048], f"{owhat}, free query end gaps",
                     "big_align_profile_flags"))
    big_pfx = profile_path(
        ProfileAligner((2048, 2048), batch=2048, x_drop=50,
                       free_query_start_gaps=True, **okw), scop[:2048],
        f"{owhat}, x_drop 50, free query start gaps",
        "big_align_profile_flags_xdrop")
    big_pft = profile_trace_path(
        ProfileAligner((2048, 2048), trace=True, **local, **tkw),
        ProfileAligner((2048, 2048), **local, **tkw), scop[:2048],
        f"{owhat}, local start", "big_align_profile_flags_trace", n_cmp=256)
    big_pfxt = profile_trace_path(
        ProfileAligner((2048, 2048), trace=True, x_drop=50, **local, **tkw),
        ProfileAligner((2048, 2048), x_drop=50, **local, **tkw), scop[:1024],
        f"{owhat}, x_drop 50, local start",
        "big_align_profile_flags_xdrop_trace", n_cmp=256)
    profile_vs_plain_big(pgrow, (32, 2048), trace=True, **local)
    profile_vs_plain_big(pgrow, (32, 2048), free_query_start_gaps=True)
    print("[big-profile-flags-growth] the 8 profiles of phase 39 at (32, "
          "2048) with traced local start and with free query start gaps: "
          "kernel equal to the plain version")
    phase("41, big profile flags")

    # 42. align_profile_exp_all on 1024 of the self-oracle pairs over a
    # (256, 2048) ladder, every level on kernel C, the self-oracle's score
    # as the target (8 unreachable, so the last level runs)
    exp_pairs = scop[:1024]
    targets = self_oracle[:1024]
    for k in range(8):
        targets[k] = 1 << 30
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    exp_res, exp_min = align_profile_exp_all(
        exp_pairs, targets, (256, 2048), batch=1024, seq_cap=acap + 16,
        device=dev)
    counts = expect_launches(lk, ak, "align_profile_exp_all past 512",
                             "big_align_profile")
    big_p["launches"] += counts["big_align_profile"]
    settled = {}
    for m in (256, 512, 1024, 2048, None):
        idx = [k for k in range(len(exp_pairs)) if exp_min[k] == m]
        settled[m] = len(idx)
        if not idx:
            continue
        sub = [exp_pairs[k] for k in idx]
        cfg = ProfileAligner((m or 2048, 2048), seq_cap=acap + 16,
                             device=dev).cfg
        want = bk.big_align_plain(*pack_profile(sub, cfg, dev), cfg).cpu()
        for k, w in zip(idx, want):
            if (exp_res[k].score != int(w[0])
                    or (m is None) != (exp_res[k].score < targets[k])):
                raise AssertionError(
                    f"align_profile_exp_all past 512, pair {k} (min size "
                    f"{m}): {exp_res[k]} vs plain {w.tolist()}, target "
                    f"{targets[k]}")
    print(f"[align_profile_exp_all-big] {len(exp_pairs)} SCOP-style pairs at "
          "(256, 2048), target the (2048, 2048) self-oracle's score: settled "
          f"per min size {settled}; every result equals the plain version "
          "at its size; big_align_profile launches "
          f"{counts['big_align_profile']}")
    phase("42, align_profile_exp_all past 512")

    # 43-48. the long-sequence API (LongBatchAligner, LongAdaptiveAligner,
    # BatchAligner's long routes) on resident codes past 16384 positions,
    # and the big kernel's 16384-row instances
    from block_aligner_tpu_torch.ops._trace import (LAUNCH_TRACE_BYTES,
                                                    trace_sub_batch)
    for hold in held:
        hold()
    phase("25, 26, 30 and 33: their plain versions from the CPU workers")
    n_flags = check_flags()
    print(f"[flags-vs-plain] phase 19's {n_flags} kernel runs equal their "
          "plain versions (CPU workers)")
    one_count = sorted(k for k, v in warps_held.items() if len(v) < 2)
    if one_count:
        raise AssertionError(f"at block 512 {one_count} ran at one warps "
                             "count only")
    print(f"[lane-warps] block 512: each of the {len(warps_held)} lane "
          "instances of phases 3, 11, 15 and 19 equal to its plain version "
          "at " + " and ".join(map(str, sorted(set().union(
              *warps_held.values())))) + " warps a pair: "
          + ", ".join(sorted(warps_held)))
    nano50 = load_nanopore_pairs("nanopore.50kbps", n_pairs=64,
                                 max_len=50000, seed=1234)
    n50 = len(nano50)
    what50 = (f"{n50} ONT-like pairs of 25..50 kbp (10% edits), "
              "NucMatrix(2, -4) -6/-2")

    def long_vs_plain(key, what):
        """A check of ``long_checks``: the aligner's kernel on its pairs
        against the plain version's output from the worker process:
        outputs, and with trace step counts, descriptors, words and
        CIGARs.  Returns its max abs err, the plain version's ms and output
        (``want``), and on the big route the largest blocks reached
        (``top``), each pair's DP cells and, with trace, the checkpoint
        saves and restores."""
        make, kw, pairs = long_checks[key]
        al = make(**kw)
        staged = al._pack(pairs)
        cfg = al._staged_cfg(staged)
        kernel = {"lane": lk.lane_align, "adaptive": ak.adaptive_align,
                  "big": bk.big_align}[al.route]
        got = kernel(*staged, cfg)
        got = tuple(t.cpu() for t in got) if cfg.trace else got.cpu()
        want, plain_ms = plain_jobs[key].result()
        top = cells = events = None
        if al.route == "big":
            *want, top = want
            if not cfg.trace:
                want, cells = want
            want = tuple(want) if cfg.trace else want
        if cfg.trace:
            if al.route == "big":
                events = check_big_trace(got, want, what)
            else:
                check_trace(got, want, what, lk.trace_words(cfg))
            ends = ([(int(o[1]), int(o[2])) for o in want[0]]
                    if lk.wide(cfg) else
                    [(len(q), r.str_len if cfg.profile else len(r))
                     for q, r in pairs])
            walk_both(got, want, ends, al.matrix, what, cfg)
            if al.route == "big":
                cells = trace_cells(block_trace(got, al.matrix, cfg),
                                    len(pairs))
            got, want = got[0], want[0]
        check_equal(got, want, what)
        if al.route != "lane" and got[:, -1].any():
            raise AssertionError(f"{what}: a pair hit the step cap")
        return SimpleNamespace(err=0, plain_ms=plain_ms, want=want, top=top,
                               cells=cells, events=events)

    def long_main(make, work, what, x=None, n_cig=16):
        """A long route's main path on ``work``: ``make(x_drop=x)``'s
        ``align_staged`` and ``align_all`` with the launch counts reset just
        before and read just after, timed (pack, kernel by CUDA events,
        decode); then ``make(x_drop=x, trace=True)``'s ``align_batch`` on
        every pair (sub-batches by the trace byte budget) with its counts:
        its results must equal the untraced ones, the first ``n_cig``
        CIGARs must span to their ends and rescore, and its descriptors
        give each pair's DP cells for both bounds.  Returns the path's
        numbers and the traced path's for the kernels line, and the
        results."""
        al = make(x_drop=x)
        torch.cuda.synchronize()
        reset_launches(lk, ak)
        staged, pack_ms = host_ms(lambda: al._pack(work))
        res, run_ms = host_ms(lambda: al.align_staged(staged))
        res_all = al.align_all(work)
        cfg = al._staged_cfg(staged)
        name = instance(al.route, cfg)
        launches = expect_launches(lk, ak, what, name)[name]
        if res_all != res:
            raise AssertionError(f"{what}: align_all disagrees with "
                                 "align_staged")
        kernel_ms = cuda_ms(lambda: al._dispatch(staged), 3)
        out = al._dispatch(staged)
        _, decode_ms = host_ms(lambda: al._decode(staged, out))
        tal = make(x_drop=x, trace=True)
        torch.cuda.synchronize()
        reset_launches(lk, ak)
        tres, tpath_ms = host_ms(lambda: tal.align_batch(work))
        tstaged = tal._pack(work)
        tcfg = tal._staged_cfg(tstaged)
        tname = instance(tal.route, tcfg)
        tlaunches = expect_launches(lk, ak, what, tname)[tname]
        if tres != res:
            raise AssertionError(f"{what}: traced results differ from the "
                                 "untraced ones")
        tr = tal.trace()
        cells = trace_cells(tr, len(work))
        cigars, walk_ms = host_ms(lambda: tr.cigars_all(
            [(r.query_idx, r.reference_idx) for r in tres[:n_cig]]))
        n_ops, _ = check_cigars(cigars, work[:n_cig], tres[:n_cig],
                                tal.matrix, tal.gaps, f"{what}, traced")
        kernel = {"lane": lk.lane_align, "adaptive": ak.adaptive_align,
                  "big": bk.big_align}[tal.route]

        def traced_ms(c):
            """The traced kernel alone on ``work`` in sub-batches of
            ``c``'s trace buffers (``trace_sub_batch``), launch by launch,
            and the count of launches."""
            n = trace_sub_batch(c)
            return sum(cuda_ms(lambda: kernel(*api._rows(
                tstaged, np.arange(k, min(k + n, len(work)))), c), 1)
                for k in range(0, len(work), n)), -(-len(work) // n)

        # the first launches as align_batch ran them (on the big route
        # with the budget of the longest walk; retried pairs not timed),
        # and on the big route with the JAX default budget
        first = tal._trace_cfg(tstaged)
        tkernel_ms, t_launches = traced_ms(first)
        jax_budget = (f"; with the JAX default budget ({tcfg.trace_budget} "
                      "words a pair): kernel {:.3f} ms in {} launches".format(
                          *traced_ms(tcfg))
                      if tal.route == "big" else "")
        B = len(work)
        n_cells = int(cells.sum())
        codes = staged.codes.numel() + 4 * (2 * B + staged.table.numel())
        bnd = max(codes / HBM_BYTES_PER_S * 1e3,
                  n_cells * ops_per_cell(cfg) / int32_per_s * 1e3)
        # each step writes its rows' words: a word for 8 cells
        words = n_cells // 8 * lk.trace_words(tcfg)
        t_ops = n_cells * ops_per_cell(tcfg) / int32_per_s * 1e3
        t_bytes = (codes + 4 * words) / HBM_BYTES_PER_S * 1e3
        numbers = {"launches": launches, "ms": kernel_ms, "bound_ms": bnd,
                   "bound_by": "operations"}
        tnumbers = {"launches": tlaunches, "ms": tkernel_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes
                    else "bytes"}
        sc = np.array([r.score for r in res])
        short = sum((r.query_idx, r.reference_idx) != (len(q), len(r_))
                    for r, (q, r_) in zip(res, work))
        print(f"[{name}-long] {B} pairs, {what}: align_staged and align_all "
              f"agree; {name} launches {launches}; code capacity "
              f"{cfg.seq_cap}, step cap {cfg.max_steps}; scores "
              f"{sc.min()}..{sc.max()} (mean {sc.mean():.1f}); "
              + (f"best short of (qlen, rlen) in {short}; " if x is not None
                 else "")
              + f"{n_cells} DP cells, {n_cells / B:.0f} per pair; traced: "
              f"align_batch in launches of up to {trace_sub_batch(first)} "
              f"pairs ({LAUNCH_TRACE_BYTES} trace bytes a launch at most"
              + (f", a first budget of {first.trace_budget} words a pair"
                 if tal.route == "big" else "") + f"), {tname} "
              f"launches {tlaunches}, results equal the untraced ones, the "
              f"first {n_cig} CIGARs span to their ends and rescore "
              f"({n_ops} ops)")
        print(f"[time] {card}: {name}, {what}: kernel "
              f"{kernel_ms * 1e3 / B:.4f} us/pair ({kernel_ms:.3f} ms per "
              f"launch of {B} pairs, CUDA events, mean of 3); bound "
              f"{bnd:.4f} ms by operations; pack {pack_ms * 1e3 / B:.4f} "
              f"us/pair; align_staged {run_ms * 1e3 / B:.4f} us/pair (decode "
              f"{decode_ms * 1e3 / B:.4f}); traced ({tname}): kernel "
              f"{tkernel_ms * 1e3 / B:.4f} us/pair ({tkernel_ms:.3f} ms in "
              f"{t_launches} launches{jax_budget}), bound "
              f"{tnumbers['bound_ms']:.4f} ms "
              f"by {tnumbers['bound_by']}, align_batch (kernel, copy, "
              f"replay) {tpath_ms * 1e3 / B:.4f} us/pair, walk "
              f"(cigars_all) {walk_ms * 1e3 / n_cig:.4f} us/pair over "
              f"{n_cig}" + big_fill(cfg, B))
        if al.route == "lane":
            lane_shape(what, cfg, B)
        return numbers, tnumbers, res

    def long_numbers(main, vs):
        """A kernels-line entry: the main path's launches, time and bound,
        the kernel-vs-plain check's error and plain time (its pairs)."""
        return {**main, "max_abs_err": vs.err, "plain_ms": vs.plain_ms}

    # 43. the lane kernel on resident codes past 16384 positions (A7's
    # windows): LongBatchAligner at block 512, nanopore_accuracy.rs's 1% band
    # for 50 kbp, against its plain version on 2 pairs of 17-20 kbp, global,
    # x 100 and traced, and on 2 profile pairs past 16384 positions
    lvs = long_vs_plain("lane", "long lane 512")
    lvs_x = long_vs_plain("lane_x", "long lane 512 x 100")
    lvs_t = long_vs_plain("lane_t", "long lane 512 traced")
    lvs_xt = long_vs_plain("lane_x_t", "long lane 512 x 100 traced")
    lvs_p = long_vs_plain("lane_p", "long lane 512 profile")
    lens = sorted(len(s) for pair in cmp_pairs for s in pair)
    print(f"[long-lane-vs-plain] LongBatchAligner(block 512) on 2 pairs of "
          f"{lens[0]}..{lens[-1]} bases (codes past 16384): global, x 100, "
          "traced and x 100 traced (step counts, descriptors, words, "
          "CIGARs) equal the plain version; profile pairs of "
          f"{[p.str_len for _, p in prof_long]} positions too; plain (one "
          f"CPU core each) {lvs.plain_ms:.1f} / {lvs_x.plain_ms:.1f} / "
          f"{lvs_t.plain_ms:.1f} / {lvs_xt.plain_ms:.1f} / "
          f"{lvs_p.plain_ms:.1f} ms")
    phase("43, long lane kernel vs plain")

    # 44. the long lane main paths: the 64 pairs at block 512, global (and
    # traced) and x 100
    ll, ll_t, ll_res = long_main(lane_long, nano50, f"{what50}, block 512")
    phase("44, long lane main path")
    ll_x, ll_xt, _ = long_main(lane_long, nano50,
                               f"{what50}, block 512, x_drop 100", x=100)
    phase("44, long lane x-drop main path")

    # 45. the big kernel on resident codes past 16384 (C's segmented
    # windows): LongAdaptiveAligner at (512, 8192) on the pairs of phase 43
    avs = long_vs_plain("ad", "long (512, 8192)")
    avs_x = long_vs_plain("ad_x", "long (512, 8192) x 100")
    avs_t = long_vs_plain("ad_t", "long (512, 8192) traced")
    avs_xt = long_vs_plain("ad_x_t", "long (512, 8192) x 100 traced")
    print("[long-adaptive-vs-plain] LongAdaptiveAligner((512, 8192)) on the "
          "2 pairs of phase 43: global, x 100, traced and x 100 traced (step "
          "counts, word counters, descriptors, words, CIGARs) equal the "
          f"plain version; plain (one CPU core each) {avs.plain_ms:.1f} / "
          f"{avs_x.plain_ms:.1f} / {avs_t.plain_ms:.1f} / "
          f"{avs_xt.plain_ms:.1f} ms")
    phase("45, long adaptive kernel vs plain")
    gvs = long_vs_plain("grow_t", "traced growth (512, 8192)")
    print("[big-trace-growth-vs-plain] the 4 traced growth pairs of phase 32 "
          f"(blocks to {sorted(gvs.top.tolist())} rows): outputs, step "
          "counts, word counters, descriptors, words and CIGARs equal the "
          f"plain version's (one CPU core, {gvs.plain_ms:.1f} ms)")
    phase("32, traced growth vs plain (its plain trace from a worker)")

    # 46. the long adaptive main paths: the 64 pairs at (512, 8192)
    la, la_t, la_res = long_main(ad_long, nano50, f"{what50}, (512, 8192)")
    phase("46, long adaptive main path")
    la_x, la_xt, _ = long_main(ad_long, nano50,
                               f"{what50}, (512, 8192), x_drop 100", x=100)
    phase("46, long adaptive x-drop main path")

    # 47. the 16384-row band: growth pairs whose blocks grow to 16384
    # (percent_len's clamp), the 16384-row instances against the plain
    # version, global, traced, x-drop, x-drop traced, traced local start
    # (whose restarts keep the blocks at 8192) and ByteMatrix
    big_shapes("the 16384-row instances (global, x-drop, trace, x-drop "
               "trace, local start's trace)", ((BAND_MIN, 16384),),
               sets=[{}, {"x_drop": True}, {"trace": True},
                     {"x_drop": True, "trace": True},
                     {"trace": True, "local_start": True}])
    band_n, band_res = {}, {}
    for key, mode in (("band", "global"), ("band_t", "trace"),
                      ("band_x", "xdrop"), ("band_x_t", "xdrop_trace"),
                      ("band_l_t", "local_trace"), ("band_b", "byte")):
        make, kw, _ = long_checks[key]
        al = make(**kw)
        torch.cuda.synchronize()
        reset_launches(lk, ak)
        res = al.align_batch(band_pairs)
        staged = al._pack(band_pairs)
        cfg = al._staged_cfg(staged)
        name = instance("big", cfg)
        launches = expect_launches(lk, ak, f"16384 band {mode}", name)[name]
        vs = long_vs_plain(key, f"16384 band {mode}")
        want = vs.want
        got = [(r.score, r.query_idx, r.reference_idx) for r in res]
        band_res[mode] = res
        if lk.wide(cfg):
            err = int(np.abs(np.array(got) - want[:, :3].numpy()).max())
        else:
            err = int(np.abs(np.array(got)[:, 0] - want[:, 0].numpy()).max())
        top = 8192 if cfg.local_start else 16384
        if err or vs.top.tolist() != [top] * len(band_pairs):
            raise AssertionError(f"16384 band {mode}: align_batch differs "
                                 f"from the plain version ({err}) or blocks "
                                 f"{vs.top.tolist()}")
        if cfg.byte_mode and res != band_res["global"]:
            raise AssertionError("16384 band: ByteMatrix(2, -4) differs from "
                                 "NucMatrix(2, -4)")
        if cfg.trace and not all(vs.events):
            raise AssertionError("16384 band trace: no checkpoint save or "
                                 "restore")
        ms = cuda_ms(lambda: bk.big_align(*staged, cfg), 3)
        bnd = int(vs.cells.sum()) * ops_per_cell(cfg) / int32_per_s * 1e3
        band_n[mode] = {"launches": launches, "max_abs_err": err, "ms": ms,
                        "plain_ms": vs.plain_ms, "bound_ms": bnd,
                        "bound_by": "operations"}
        print(f"[{name}] {len(band_pairs)} growth pairs of "
              f"{[len(q) for q, _ in band_pairs]} bases at ({BAND_MIN}, "
              "16384)" + (f", x_drop {BAND_X}" if cfg.x_drop else "")
              + (", local start" if cfg.local_start else "")
              + (", ByteMatrix(2, -4) (equal to NucMatrix(2, -4))"
                 if cfg.byte_mode else "")
              + ": align_batch equals the plain version; top_size "
              f"{vs.top.tolist()}; {int(vs.cells.sum())} DP cells; {name} "
              f"launches {launches}"
              + (f"; {vs.events[0]} saves, {vs.events[1]} restores, step "
                 "counts, word counters, descriptors, words and CIGARs equal"
                 if cfg.trace else ""))
        print(f"[time] {card}: {name}, 16384 band {mode}: kernel {ms:.3f} ms "
              f"for {len(band_pairs)} pairs (CUDA events, mean of 3); bound "
              f"{bnd:.4f} ms by operations; plain (one CPU core) "
              f"{vs.plain_ms:.1f} ms" + big_fill(cfg, len(band_pairs)))
    phase("47, the 16384-row band")

    # 48. the API: BatchAligner(seq_cap=65536) on both long routes equals the
    # long classes, and align_exp_all past 16384 code positions
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    ba = BatchAligner(nuc, ngaps, size=(512, 8192), batch=n50,
                      seq_cap=65536, device=dev)
    bl = BatchAligner(nuc, ngaps, size=(512, 512), batch=n50, seq_cap=65536,
                      device=dev)
    if not (ba.long and bl.long and ba.route == "big" and bl.route == "lane"):
        raise AssertionError("BatchAligner(seq_cap=65536) did not take the "
                             "long routes")
    if ba.align_all(nano50) != la_res or bl.align_all(nano50) != ll_res:
        raise AssertionError("BatchAligner's long routes differ from the "
                             "long classes")
    counts = expect_launches(lk, ak, "BatchAligner long routes",
                             "big_align", "lane_align")
    ll["launches"] += counts["lane_align"]
    la["launches"] += counts["big_align"]
    exp_pairs = nano50[:16]
    targets = [r.score for r in la_res[:16]]
    targets[-1] += 1 << 20  # unreachable: the last level runs
    reset_launches(lk, ak)
    exp_res, exp_min = align_exp_all(nuc, ngaps, exp_pairs, targets,
                                     (128, 8192), batch=16, seq_cap=65536,
                                     device=dev)
    counts = expect_launches(lk, ak, "align_exp_all past 16384",
                             "big_align")
    la["launches"] += counts["big_align"]
    settled = {}
    for m in sorted(set(exp_min) - {None}) + [None]:
        idx = [k for k in range(16) if exp_min[k] == m]
        settled[m] = len(idx)
        if not idx:
            continue
        want = LongAdaptiveAligner(nuc, ngaps, (m or 8192, 8192),
                                   device=dev).align_batch(
                                       [exp_pairs[k] for k in idx])
        if [exp_res[k] for k in idx] != want:
            raise AssertionError(f"align_exp_all past 16384 at min {m} "
                                 "differs from LongAdaptiveAligner")
    print(f"[long-api] BatchAligner(seq_cap=65536) at (512, 8192) and (512, "
          "512) takes the long routes and equals LongAdaptiveAligner and "
          f"LongBatchAligner on the {n50} pairs; align_exp_all over (128, "
          f"8192) at seq_cap 65536 on 16 of them (targets the (512, 8192) "
          f"scores, 1 unreachable): settled per min size {settled}, each "
          "equal to LongAdaptiveAligner at its size")
    phase("48, the long API")
    cpu.shutdown()

    print(json.dumps({"kernels": [
        {
            "name": "lane_align",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/lane_kernel.cu",
            "replaces": "block_aligner_tpu/ops/lane_kernel.py:381",
            "launches": lane_launches,
            "max_abs_err": lane_err,
            "ms": lane_ms,
            "plain_ms": lane_plain_ms,
            "bound_ms": lane_bound,
            "bound_by": lane_by,
            "library_ms": None,
        },
        {
            "name": "adaptive_align",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/adaptive_kernel.cu",
            "replaces": "block_aligner_tpu/ops/adaptive_kernel.py:213",
            "launches": ad_launches,
            "max_abs_err": ad_err,
            "ms": ad_ms,
            "plain_ms": ad_plain_ms,
            "bound_ms": ad_bound,
            "bound_by": ad_by,
            "library_ms": None,
        },
        {
            "name": "lane_align_xdrop",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/lane_kernel.cu",
            "replaces": "block_aligner_tpu/ops/lane_kernel.py:957",
            **lane_x,
            "library_ms": None,
        },
        {
            "name": "adaptive_align_xdrop",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/adaptive_kernel.cu",
            "replaces": "block_aligner_tpu/ops/adaptive_kernel.py:788",
            **ad_x,
            "library_ms": None,
        },
        {
            "name": "lane_align_trace",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/lane_kernel.cu",
            "replaces": "block_aligner_tpu/ops/lane_kernel.py:884",
            **lane_t,
            "library_ms": None,
        },
        {
            "name": "lane_align_xdrop_trace",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/lane_kernel.cu",
            "replaces": "block_aligner_tpu/ops/lane_kernel.py:884",
            **lane_xt,
            "library_ms": None,
        },
        {
            "name": "adaptive_align_trace",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/adaptive_kernel.cu",
            "replaces": "block_aligner_tpu/ops/adaptive_kernel.py:720",
            **ad_t,
            "library_ms": None,
        },
        {
            "name": "adaptive_align_xdrop_trace",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/adaptive_kernel.cu",
            "replaces": "block_aligner_tpu/ops/adaptive_kernel.py:720",
            **ad_xt,
            "library_ms": None,
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": ("block_aligner_tpu_torch/csrc/lane_profile.cu"
                       if name.startswith("lane") else
                       "block_aligner_tpu_torch/csrc/adaptive_profile.cu"),
            "replaces": ("block_aligner_tpu/ops/lane_kernel.py:769"
                         if name.startswith("lane") else
                         "block_aligner_tpu/ops/adaptive_kernel.py:610"),
            **numbers,
            "library_ms": None,
        }
        for name, numbers in (
            ("lane_align_profile", lane_p),
            ("lane_align_profile_xdrop", lane_px),
            ("adaptive_align_profile", ad_p),
            ("adaptive_align_profile_xdrop", ad_px),
            *trace_paths.items())
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/big_kernel.cu",
            "replaces": "block_aligner_tpu/ops/big_kernel.py:400",
            **numbers,
            "library_ms": None,
        }
        for name, numbers in (("big_align", big_g),
                              ("big_align_xdrop", big_x))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/big_trace.cu",
            "replaces": "block_aligner_tpu/ops/big_kernel.py:1389",
            **numbers,
            "library_ms": None,
        }
        for name, numbers in (("big_align_trace", big_t),
                              ("big_align_xdrop_trace", big_xt))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"block_aligner_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            **numbers,
            "library_ms": None,
        }
        for name, source, replaces, numbers in (
            ("big_align_byte", "big_flags", C_BYTE, big_b),
            ("big_align_byte_trace", "big_trace_flags", C_BYTE, big_bt),
            ("big_align_flags", "big_flags", C_FREE_END, big_f),
            ("big_align_flags_trace", "big_trace_flags", C_FREE_END, big_ft),
            ("big_align_flags_xdrop", "big_flags", C_FLAGS, big_fx),
            ("big_align_flags_xdrop_trace", "big_trace_flags", C_ZERO_BIT,
             big_fxt))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"block_aligner_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            **numbers,
            "library_ms": None,
        }
        for name, source, replaces, numbers in (
            ("lane_align_byte", "lane_flags", LANE_BYTE, lane_b),
            ("lane_align_byte_trace", "lane_flags", LANE_BYTE, lane_bt),
            ("adaptive_align_byte", "adaptive_flags", AD_BYTE, ad_b),
            ("adaptive_align_byte_trace", "adaptive_flags", AD_BYTE, ad_bt),
            ("lane_align_flags", "lane_flags", LANE_FREE_END, lane_f),
            ("lane_align_flags_xdrop", "lane_flags", LANE_FLAGS, lane_fx),
            ("lane_align_flags_trace", "lane_flags", LANE_FLAGS, lane_ft),
            ("lane_align_flags_xdrop_trace", "lane_flags", LANE_ZERO_BIT,
             lane_fxt),
            ("adaptive_align_flags", "adaptive_flags", AD_FLAGS, ad_f),
            ("adaptive_align_flags_xdrop", "adaptive_flags", AD_FLAGS,
             ad_fx),
            ("adaptive_align_flags_trace", "adaptive_flags", AD_ZERO_BIT,
             ad_ft),
            ("adaptive_align_flags_xdrop_trace", "adaptive_flags",
             AD_ZERO_BIT, ad_fxt),
            ("big_align_profile", "big_profile", C_PROFILE, big_p),
            ("big_align_profile_xdrop", "big_profile", C_PROFILE, big_px),
            ("big_align_profile_trace", "big_trace_profile",
             C_PROFILE_TRACE, big_pt),
            ("big_align_profile_xdrop_trace", "big_trace_profile",
             C_PROFILE_TRACE, big_pxt),
            ("big_align_profile_flags", "big_profile", C_PROFILE, big_pf),
            ("big_align_profile_flags_xdrop", "big_profile", C_PROFILE,
             big_pfx),
            ("big_align_profile_flags_trace", "big_trace_profile",
             C_PROFILE_TRACE, big_pft),
            ("big_align_profile_flags_xdrop_trace", "big_trace_profile",
             C_PROFILE_TRACE, big_pfxt),
            ("lane_align_profile_flags", "lane_profile_flags", LANE_FLAGS,
             lane_pf),
            ("lane_align_profile_flags_xdrop", "lane_profile_flags",
             LANE_FLAGS, lane_pfx),
            ("adaptive_align_profile_flags", "adaptive_profile_flags",
             AD_FLAGS, ad_pf),
            ("adaptive_align_profile_flags_xdrop", "adaptive_profile_flags",
             AD_FLAGS, ad_pfx),
            *((name, ("lane_profile_flags" if name.startswith("lane") else
                      "adaptive_profile_flags"),
               LANE_ZERO_BIT if name.startswith("lane") else AD_FLAGS,
               numbers)
              for name, numbers in flag_traces.items()))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"block_aligner_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            **long_numbers(numbers, vs),
            "library_ms": None,
        }
        for name, source, replaces, numbers, vs in (
            ("lane_align_long", "lane_kernel", A7_WINDOWS, ll, lvs),
            ("lane_align_long_xdrop", "lane_kernel", A7_WINDOWS, ll_x,
             lvs_x),
            ("lane_align_long_trace", "lane_kernel", A7_WINDOWS, ll_t,
             lvs_t),
            ("lane_align_long_xdrop_trace", "lane_kernel", A7_WINDOWS,
             ll_xt, lvs_xt),
            ("big_align_long", "big_kernel", C_WINDOWS, la, avs),
            ("big_align_long_xdrop", "big_kernel", C_WINDOWS, la_x, avs_x),
            ("big_align_long_trace", "big_trace", C_WINDOWS, la_t, avs_t),
            ("big_align_long_xdrop_trace", "big_trace", C_WINDOWS, la_xt,
             avs_xt))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"block_aligner_tpu_torch/csrc/{source}.cu",
            "replaces": C_16384,
            **band_n[key],
            "library_ms": None,
        }
        for name, source, key in (
            ("big_align_16384", "big_16384", "global"),
            ("big_align_16384_xdrop", "big_16384", "xdrop"),
            ("big_align_16384_trace", "big_trace_16384", "trace"),
            ("big_align_16384_xdrop_trace", "big_trace_16384",
             "xdrop_trace"),
            ("big_align_16384_flags_trace", "big_trace_16384",
             "local_trace"),
            ("big_align_16384_byte", "big_16384", "byte"))
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
