"""The plain reference: GF(2^8), the frozen encode matrix, erasure decode
and SHA-256, against hand-worked cases and hashlib; and what it imports."""

import ast
import hashlib
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpubench import roofline  # noqa: E402
from gpubench.reference import rs  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "chunky_bits_tpu",
             "chunky_bits_tpu_torch"}


@pytest.mark.parametrize("a,b,product", [
    (0, 7, 0), (1, 0xAB, 0xAB), (3, 7, 9), (2, 0x80, 0x1D),
    (0x80, 0x80, 0x13), (2, 0x8E, 1)])
def test_mul_hand_worked(a, b, product):
    # 2 x 0x80 = 0x100, reduced by 0x11d to 0x1d; 0x80 x 0x80 = x^14,
    # which 0x11d reduces to x^4 + x + 1 = 0x13
    assert rs.mul(a, b) == product
    assert rs.mul(b, a) == product


def test_field_inverses_and_powers():
    for a in range(1, 256):
        assert rs.mul(a, rs.inv(a)) == 1
    assert rs.power(2, 8) == 0x1D
    assert rs.power(0, 0) == 1 and rs.power(0, 3) == 0
    assert len({rs.power(2, n) for n in range(255)}) == 255


def test_backblaze_4_2_matrix():
    """The published JavaReedSolomon 4+2 coding rows."""
    e = rs.encode_matrix(4, 2)
    assert (e[:4] == np.eye(4, dtype=np.uint8)).all()
    assert e[4:].tolist() == [[27, 28, 18, 20], [28, 27, 20, 18]]


def test_two_plus_one_by_hand():
    # V = [[1,0],[1,1],[1,2]], inv(V[:2]) = [[1,0],[1,1]], so the parity
    # row is [1 ^ 2, 2] = [3, 2]
    assert rs.encode_matrix(2, 1)[2].tolist() == [3, 2]
    shard, digests = rs.encode_part(bytes([1, 1]), 2, 1)
    assert shard == 1
    assert digests == [hashlib.sha256(bytes([v])).digest()
                       for v in (1, 1, 1)]


def test_short_part_is_zero_padded():
    part = bytes(range(7))
    rows = rs.split(part, 3)
    assert rows.shape == (3, 3)
    assert rows.reshape(-1).tolist() == list(range(7)) + [0, 0]
    shard, digests = rs.encode_part(part, 3, 2)
    mat = rs.encode_matrix(3, 2)
    parity = rs.apply(mat[3:], rows)
    assert shard == 3
    assert digests == [hashlib.sha256(r).digest()
                       for r in list(rows) + list(parity)]


@pytest.mark.parametrize("d,p", [(3, 2), (4, 2), (10, 4), (6, 3)])
def test_every_erasure_pattern_decodes(d, p):
    rng = np.random.default_rng(d * 100 + p)
    data = rng.integers(0, 256, (d, 33), dtype=np.uint8)
    mat = rs.encode_matrix(d, p)
    rows = np.concatenate([data, rs.apply(mat[d:], data)])
    patterns = list(itertools.combinations(range(d + p), p))
    for lost in patterns[:: max(1, len(patterns) // 40)]:
        present = [i for i in range(d + p) if i not in lost]
        wanted = [i for i in lost if i < d]
        if not wanted:
            continue
        dec = rs.decode_matrix(d, p, present, wanted)
        rebuilt = rs.apply(dec, rows[present[:d]])
        assert (rebuilt == data[wanted]).all(), lost


def test_matrix_equals_the_ports():
    """The frozen construction and the program's agree, which is what
    makes their parity byte-identical."""
    matrix = pytest.importorskip("chunky_bits_tpu_torch.ops.matrix")
    for d, p in [(1, 1), (3, 2), (10, 4), (16, 8), (20, 6)]:
        assert (rs.encode_matrix(d, p)
                == matrix.build_encode_matrix(d, p)).all()


def _imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            tops.add(node.module.partition(".")[0])
    return tops


def test_reference_imports_nothing_of_jax_or_the_program():
    ref = os.path.join(ROOT, "gpubench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            assert not _imported_tops(os.path.join(ref, name)) & FORBIDDEN
    code = ("import sys; import gpubench.reference.rs; "
            "print(' '.join(sorted({m.partition('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert not set(out.split()) & FORBIDDEN


def test_forbidden_names_compare_whole():
    from gpubench import run

    saved = dict(sys.modules)
    try:
        sys.modules.pop("chunky_bits_tpu", None)
        sys.modules["chunky_bits_tpu_torch_like"] = sys
        assert "chunky_bits_tpu" not in run.forbidden_modules()
        sys.modules["chunky_bits_tpu.sub"] = sys
        assert "chunky_bits_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_k1_bound_counts_bytes_once():
    # [128, 10, 1 MiB] -> 4 parity rows: 14 x 128 MiB at 3.35 TB/s
    t = roofline.gf_apply_bound_s(128, 10, 4, 1 << 20)
    assert t == pytest.approx(128 * 14 * (1 << 20) / 3.35e12)


def test_sha_bound_counts_every_compression():
    assert roofline.sha256_blocks(0) == 1
    assert roofline.sha256_blocks(55) == 1
    assert roofline.sha256_blocks(56) == 2
    assert roofline.sha256_blocks(64) == 2
    rows, s = 1792, 1 << 20
    t = roofline.sha256_rows_bound_s(rows, s)
    ops = rows * roofline.sha256_blocks(s) * roofline.SHA256_OPS_PER_BLOCK
    assert t == pytest.approx(max(ops / roofline.INT32_OPS_PER_S,
                                  rows * (s + 32) / 3.35e12))
