"""The port's scoring layer against the JAX package's: identical tables,
byte conversion and helpers; and the port imports without JAX."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import block_aligner_tpu.core.scores as jscores
import block_aligner_tpu_torch.core.scores as tscores
from block_aligner_tpu_torch import gaps_from_jax, matrix_from_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATIC = ["BLOSUM45", "BLOSUM50", "BLOSUM62", "BLOSUM80", "BLOSUM90",
          "PAM100", "PAM120", "PAM160", "PAM200", "PAM250", "NW1"]


@pytest.mark.parametrize("name", STATIC)
def test_static_tables_equal(name):
    j, t = getattr(jscores, name), getattr(tscores, name)
    assert t.kind == j.kind and t.NULL == j.NULL
    assert t.table.dtype == np.int32
    assert np.array_equal(t.table, j.table)
    assert np.array_equal(matrix_from_jax(j).table, j.table)


def test_byte_matrix_surface():
    assert (tscores.BYTES1.match_score, tscores.BYTES1.mismatch_score) == (
        jscores.BYTES1.match_score, jscores.BYTES1.mismatch_score)
    assert tscores.BYTES1.dense() is None
    for a, b in [("A", "A"), ("A", "C"), (7, 7), (0, 255)]:
        assert tscores.BYTES1.get(a, b) == jscores.BYTES1.get(a, b)
    seq = bytes(range(256))
    assert np.array_equal(tscores.BYTES1.convert(seq), jscores.BYTES1.convert(seq))


def _convert(m, s):
    try:
        return m.convert(s)
    except ValueError as err:
        return str(err)


@pytest.mark.parametrize("name", ["BLOSUM62", "NW1"])
def test_convert_equal(name):
    j, t = getattr(jscores, name), getattr(tscores, name)
    for v in range(256):  # every single byte: same code or same error
        got, want = _convert(t, bytes([v])), _convert(j, bytes([v]))
        if isinstance(want, str):
            assert got == want, v
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), v
    for s in [b"", b"ACGTN", b"acgtn", b"MKVLatgqHEW", "ACDEFGHIKLMNPQRSTVWY",
              b"AC GT", b"Z[", b"abc{"]:
        got, want = _convert(t, s), _convert(j, s)
        assert type(got) is type(want)
        if not isinstance(want, str):
            assert np.array_equal(got, want), s


def test_simple_matrices_and_setters_equal():
    for kind in ("AAMatrix", "NucMatrix"):
        j = getattr(jscores, kind).new_simple(3, -2)
        t = getattr(tscores, kind).new_simple(3, -2)
        assert np.array_equal(t.table, j.table)
        j.set("a", "C", 9)
        t.set("a", "C", 9)
        assert np.array_equal(t.table, j.table)
        assert t.get("c", "A") == j.get("c", "A") == 9
    tsv = "4 -1\n-1 5"
    assert np.array_equal(tscores.AAMatrix.from_tsv(tsv, "A R").table,
                          jscores.AAMatrix.from_tsv(tsv, "A R").table)
    with pytest.raises(ValueError):
        tscores.AAMatrix(np.zeros((4, 4)))


def test_percent_len_equal():
    for length in (0, 1, 10, 100, 999, 5000, 100000):
        for p in (0.01, 0.1, 0.5, 1.0):
            assert tscores.percent_len(length, p) == jscores.percent_len(length, p)


def test_convert_from_jax():
    g = gaps_from_jax(jscores.Gaps(open=-11, extend=-1))
    assert g == tscores.Gaps(-11, -1)
    m = matrix_from_jax(jscores.NW1)
    assert isinstance(m, tscores.NucMatrix)
    assert np.array_equal(m.table, jscores.NW1.table)
    m.table[0, 0] = 99  # a copy: the JAX table is untouched
    assert jscores.NW1.table[0, 0] != 99
    byte = matrix_from_jax(jscores.BYTES1)
    assert isinstance(byte, tscores.ByteMatrix)
    assert (byte.match_score, byte.mismatch_score) == (
        jscores.BYTES1.match_score, jscores.BYTES1.mismatch_score)
    with pytest.raises(ValueError):
        matrix_from_jax(SimpleNamespace(kind="dense"))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import block_aligner_tpu_torch as p\n"
        "from block_aligner_tpu_torch.ops import adaptive_kernel, lane_kernel\n"
        "al = p.BatchAligner(p.BLOSUM62, p.Gaps(-11, -1), (16, 16), batch=2,"
        " seq_cap=64, device='cpu')\n"
        "assert al.align_batch([(b'AAAA', b'AARA')])[0].score == 11\n"
        "ad = p.BatchAligner(p.BLOSUM62, p.Gaps(-11, -1), device='cpu')\n"
        "assert ad.route == 'adaptive'\n"
        "assert ad.align_batch([(b'AAAA', b'AARA')])[0].score == 11\n"
        "res, mins = p.align_exp_all(p.BLOSUM62, p.Gaps(-11, -1),"
        " [(b'AAAA', b'AARA')], [11], (16, 64), device='cpu')\n"
        "assert (res[0].score, mins) == (11, [16])\n"
        "from block_aligner_tpu_torch.core import cigar, traceback\n"
        "for size in ((16, 16), (16, 512)):\n"
        "    tr = p.BatchAligner(p.BLOSUM62, p.Gaps(-11, -1), size, batch=2,"
        " seq_cap=64, trace=True, device='cpu')\n"
        "    _, cg = tr.align_all_trace([(b'AAAA', b'AARA')], eq=True)\n"
        "    assert str(cg[0]) == '2=1X1=', cg\n"
        "prof = p.AAProfile.from_bytes(b'AARA', 16, 4, -1, -5, 0, -5, -1)\n"
        "pa = p.ProfileAligner((16, 64), batch=2, seq_cap=64, device='cpu')\n"
        "assert pa.align_batch([(b'AARA', prof)])[0].score == 16\n"
        "import bench, chip_smoke\n"
        "from examples_tpu.common import load_uc_pairs\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m == 'block_aligner_tpu' or"
        " m.startswith(('block_aligner_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
