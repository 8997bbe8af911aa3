"""k-mer record ABI: packing, canonicalization, (de)serialization.

The port's own copy of kmer_counter_tpu/records.py, so that the port
imports nothing of the JAX package; tests/test_torch_copies.py holds the
two to the same results.

The on-disk record format reproduces the reference byte-for-byte
(reference: KMerSizes.h:10-28; size formula re-derived at KMerCounter.cpp:29-37,
GPUHandler.cu:235-245, KMerPrinter.cpp:19-25):

  * A k-mer key is ``ceil(k/32)`` 64-bit words.
  * Bases are 2 bits each — A=0, C=1, G=2, T=3 (GPUHandler.cu:42-78) —
    packed MSB-first: base 0 occupies bits 63..62 of word 0, base 31 bits
    1..0 of word 0, base 32 bits 63..62 of word 1, and so on.  Tail bits
    past base k-1 are zero (GPUHandler.cu:210-213).  MSB-first packing makes
    numeric uint64 word order identical to lexicographic base order.
  * A record is the key words stored little-endian, followed by a uint32
    count: ``record_size = ceil(k/32)*8 + 4`` bytes.

Device-side representation: TPUs have no fast native uint64, so every 64-bit
word is carried as two uint32 *lanes* — lane ``2w`` is the high half of word
``w`` (bases 32w..32w+15) and lane ``2w+1`` the low half (bases
32w+16..32w+31).  Unsigned lexicographic comparison over the lane sequence is
exactly the word-order (and hence base-order) comparison the reference's
comparators implement (GPUHandler.cu:247-298, KMerFileMerger.cpp:98-118).

This module is host-side (NumPy); the device twins live in
``kmer_counter_tpu_torch.ops``.
"""

from __future__ import annotations

import numpy as np

# Base encoding (reference GPUHandler.cu:42-78): A=0, C=1, G=2, T=3.
CODE_TO_BASE = "ACGT"
BASES_PER_WORD = 32
BASES_PER_LANE = 16
MAX_K = 128  # reference supports 1..4 word keys (GPUHandler.cu:300-327)

# 256-entry ASCII → code LUT; invalid bases get code 3 *and* are flagged
# invalid, mirroring bitEncode's behavior (GPUHandler.cu:79-87) — but unlike
# the reference we never let an invalid-covering window produce a count.
_BASE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(CODE_TO_BASE):
    _BASE_LUT[ord(_b)] = _i
    _BASE_LUT[ord(_b.lower())] = _i


def words_per_kmer(k: int) -> int:
    """Number of 64-bit key words: ceil(k/32) (KMerCounter.cpp:29-37)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    return -(-k // BASES_PER_WORD)


def lanes_per_kmer(k: int) -> int:
    """Number of uint32 lanes in the on-disk ABI: 2 * words_per_kmer(k)."""
    return 2 * words_per_kmer(k)


def active_lanes(k: int) -> int:
    """Number of lanes that can be non-zero: ceil(k/16).

    The ABI pads keys to whole 64-bit words (lanes_per_kmer), but lanes
    past ceil(k/16) are structurally zero, so device pipelines carry and
    sort only the active ones — for k <= 16 that halves the sort width.
    Conversion to the ABI width happens at the host boundary
    (pad_lanes_to_abi / strip_lanes_to_active).
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    return -(-k // BASES_PER_LANE)


def pad_lanes_to_abi(lanes: np.ndarray, k: int) -> np.ndarray:
    """[..., active_lanes(k)] → [..., lanes_per_kmer(k)] with zero tail."""
    lanes = np.asarray(lanes, dtype=np.uint32)
    NLa, NL = active_lanes(k), lanes_per_kmer(k)
    if lanes.shape[-1] == NL:
        return lanes
    if lanes.shape[-1] != NLa:
        raise ValueError(f"expected {NLa} or {NL} lanes, got {lanes.shape[-1]}")
    pad = np.zeros(lanes.shape[:-1] + (NL - NLa,), np.uint32)
    return np.concatenate([lanes, pad], axis=-1)


def strip_lanes_to_active(lanes: np.ndarray, k: int) -> np.ndarray:
    """[..., lanes_per_kmer(k)] → [..., active_lanes(k)] (drops zero tail)."""
    return np.asarray(lanes, dtype=np.uint32)[..., : active_lanes(k)]


def record_size_bytes(k: int) -> int:
    """On-disk record size: ceil(k/32)*8 + 4 (KMerCounter.cpp:29-37)."""
    return words_per_kmer(k) * 8 + 4


def encode_bases(ascii_bytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ASCII bytes → (2-bit codes, validity mask).

    Invalid (non-ACGT, case-insensitive) characters encode as 3 with
    ``valid == False`` (GPUHandler.cu:79-87).
    """
    raw = _BASE_LUT[np.asarray(ascii_bytes, dtype=np.uint8)]
    valid = raw != 255
    codes = np.where(valid, raw, np.uint8(3)).astype(np.uint8)
    return codes, valid


def decode_codes(codes: np.ndarray) -> str:
    """2-bit codes → ACGT string."""
    return "".join(CODE_TO_BASE[c] for c in np.asarray(codes).ravel())


def pack_codes(codes: np.ndarray, k: int | None = None) -> np.ndarray:
    """Pack per-base 2-bit codes into MSB-first uint64 key words.

    ``codes`` has shape [..., k]; the result has shape [..., words_per_kmer(k)]
    with tail bits zeroed (the left-aligned flush of GPUHandler.cu:94-109,
    without its lineLength%64==0 skip bug — see SURVEY.md §7.1).
    """
    codes = np.asarray(codes, dtype=np.uint64)
    if k is None:
        k = codes.shape[-1]
    W = words_per_kmer(k)
    padded = np.zeros(codes.shape[:-1] + (W * BASES_PER_WORD,), dtype=np.uint64)
    padded[..., :k] = codes[..., :k]
    shifts = (62 - 2 * np.arange(BASES_PER_WORD, dtype=np.uint64)).astype(np.uint64)
    grouped = padded.reshape(padded.shape[:-1] + (W, BASES_PER_WORD))
    return (grouped << shifts).sum(axis=-1, dtype=np.uint64)


def unpack_words(words: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_codes`: key words → [..., k] 2-bit codes."""
    words = np.asarray(words, dtype=np.uint64)
    W = words_per_kmer(k)
    shifts = (62 - 2 * np.arange(BASES_PER_WORD, dtype=np.uint64)).astype(np.uint64)
    codes = (words[..., :W, None] >> shifts) & np.uint64(3)
    return codes.reshape(words.shape[:-1] + (W * BASES_PER_WORD,))[..., :k].astype(
        np.uint8
    )


def words_to_lanes(words: np.ndarray) -> np.ndarray:
    """uint64 key words [..., W] → uint32 device lanes [..., 2W] (hi, lo)."""
    words = np.asarray(words, dtype=np.uint64)
    hi = (words >> np.uint64(32)).astype(np.uint32)
    lo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo], axis=-1).reshape(words.shape[:-1] + (2 * words.shape[-1],))


def lanes_to_words(lanes: np.ndarray) -> np.ndarray:
    """uint32 device lanes [..., NL] → uint64 key words [..., ceil(NL/2)].

    Device pipelines carry only the ``active_lanes(k)`` lanes, which may be
    odd; an odd lane count is zero-padded to the even ABI width here.
    """
    lanes = np.asarray(lanes, dtype=np.uint32)
    if lanes.shape[-1] % 2:
        pad = np.zeros(lanes.shape[:-1] + (1,), np.uint32)
        lanes = np.concatenate([lanes, pad], axis=-1)
    pairs = lanes.reshape(lanes.shape[:-1] + (lanes.shape[-1] // 2, 2)).astype(np.uint64)
    return (pairs[..., 0] << np.uint64(32)) | pairs[..., 1]


def revcomp_words(words: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of packed keys (new capability — the reference is
    forward-strand only, SURVEY.md §2.1 step 2)."""
    codes = unpack_words(words, k)
    rc = (np.uint8(3) - codes)[..., ::-1]
    return pack_codes(rc, k)


def canonical_words(words: np.ndarray, k: int) -> np.ndarray:
    """min(kmer, revcomp(kmer)) under lexicographic (== numeric word) order."""
    words = np.asarray(words, dtype=np.uint64)
    rc = revcomp_words(words, k)
    # Lexicographic compare over the word axis.
    take_rc = np.zeros(words.shape[:-1], dtype=bool)
    decided = np.zeros(words.shape[:-1], dtype=bool)
    for w in range(words.shape[-1]):
        lt = rc[..., w] < words[..., w]
        gt = rc[..., w] > words[..., w]
        take_rc |= lt & ~decided
        decided |= lt | gt
    return np.where(take_rc[..., None], rc, words)


def serialize_table(words: np.ndarray, counts: np.ndarray) -> bytes:
    """(keys [U, W] uint64, counts [U] uint32) → reference record bytes.

    Unlike the reference's DumpResults — which writes only 8 key bytes
    regardless of k (KMerCounter.cpp:102, a documented defect, SURVEY.md
    §7.1) — all ``W`` words are written, little-endian, followed by the
    uint32 count.
    """
    words = np.ascontiguousarray(words, dtype="<u8")
    counts = np.ascontiguousarray(counts, dtype="<u4")
    U, W = words.shape
    out = np.zeros((U, W * 8 + 4), dtype=np.uint8)
    out[:, : W * 8] = words.view(np.uint8).reshape(U, W * 8)
    out[:, W * 8 :] = counts.view(np.uint8).reshape(U, 4)
    return out.tobytes()


def parse_records(data: bytes, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Reference record bytes → (keys [U, W] uint64, counts [U] uint32)."""
    W = words_per_kmer(k)
    rec = record_size_bytes(k)
    if len(data) % rec:
        raise ValueError(f"byte length {len(data)} not a multiple of record size {rec}")
    U = len(data) // rec
    raw = np.frombuffer(data, dtype=np.uint8).reshape(U, rec)
    words = raw[:, : W * 8].copy().view("<u8").reshape(U, W)
    counts = raw[:, W * 8 :].copy().view("<u4").reshape(U)
    return words.astype(np.uint64), counts.astype(np.uint32)


def kmer_to_string(words: np.ndarray, k: int | None = None) -> str:
    """Render a key for humans.

    With ``k=None`` this matches the reference printer, which renders *all*
    32 bases of every word including the zero tail (printed as 'A's,
    KMerPrinter.cpp:68-91); pass the true k to trim to the real k-mer.
    """
    words = np.atleast_1d(np.asarray(words, dtype=np.uint64))
    n = words.shape[-1] * BASES_PER_WORD if k is None else k
    return decode_codes(unpack_words(words, n))
