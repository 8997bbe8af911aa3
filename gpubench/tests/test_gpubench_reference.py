"""The frozen reference against a brute-force count in Python, and the
comparison that decides ``correct``."""

from collections import Counter

import numpy as np
import pytest

from gpubench.reference import compare
from gpubench.reference.count import dump_bytes, numpy_count
from gpubench.traffic import generate

CODE = {c: i for i, c in enumerate("ACGT")}
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def brute_force(reads, k, canonical):
    counts = Counter()
    for read in reads:
        s = bytes(read).decode().upper()
        for i in range(len(s) - k + 1):
            w = s[i : i + k]
            if set(w) - set("ACGT"):
                continue
            if canonical:
                w = min(w, "".join(COMP[c] for c in reversed(w)))
            counts[w] += 1
    W = -(-k // 32)
    out = []
    for w in sorted(counts):
        words = [0] * W
        for i, c in enumerate(w):
            words[i // 32] |= CODE[c] << (62 - 2 * (i % 32))
        out.append((words, counts[w]))
    return b"".join(b"".join(x.to_bytes(8, "little") for x in words) + c.to_bytes(4, "little") for words, c in out)


@pytest.mark.parametrize("k", [1, 5, 16, 31, 32, 33, 55, 64, 65])
@pytest.mark.parametrize("canonical", [False, True])
def test_reference_equals_a_brute_force_count(k, canonical):
    params = {"genome_length": 400, "reads": 60, "read_length": 80, "substitution_share": 0.02,
              "n_share": 0.02, "files": 1}
    reads = generate.make_reads(params, k * 2 + canonical)
    reads[3, 10:20] = np.frombuffer(b"acgtacgtac", np.uint8)  # lower case counts as its base
    words, counts = numpy_count(reads, k, canonical, block=17)
    assert dump_bytes(words, counts) == brute_force(reads, k, canonical)


@pytest.mark.parametrize("words", [1, 2], ids=["12_byte", "20_byte"])
def test_records_wrong(words):
    """Records of ``words`` key words (1: k up to 32; 2: k 33..64) and a count."""
    size = 8 * words + 4

    def rec(key, n, word=None):  # key words key, key+1, ...; ``word`` replaces the last one
        keys = [key + w for w in range(words)]
        if word is not None:
            keys[-1] = word
        return b"".join(int(x).to_bytes(8, "little") for x in keys) + int(n).to_bytes(4, "little")

    ref = rec(1, 2) + rec(5, 1) + rec(9, 3)
    assert compare.records_wrong(ref, ref, size) == 0
    assert compare.records_wrong(rec(1, 2) + rec(5, 2) + rec(9, 3), ref, size) == 2  # a count off by one
    assert compare.records_wrong(rec(1, 2) + rec(5, 1, word=8) + rec(9, 3), ref, size) == 2  # a key's last word
    assert compare.records_wrong(rec(1, 2) + rec(9, 3), ref, size) == 1  # a record missing
    assert compare.records_wrong(rec(5, 1) + rec(1, 2) + rec(9, 3), ref, size) == 1  # out of order
    assert compare.records_wrong(ref + rec(9, 3), ref, size) == 1  # a record repeated
    assert compare.records_wrong(rec(1, 2) + rec(1, 2) + rec(9, 3), ref, size) == 2  # one for another
    assert compare.records_wrong(ref[:-1], ref, size) > 0  # a torn record
    assert compare.records_wrong(b"", ref, size) == 3
    if words == 2:  # the first word alone differs
        first = (7).to_bytes(8, "little") + rec(5, 1)[8:]
        assert compare.records_wrong(rec(1, 2) + first + rec(9, 3), ref, size) == 2
