"""Keccak-256 on device (JAX) — the Fiat-Shamir latency killer.

Every transcript event is keccak256(state(32) || zeros(28) || n_rounds_BE(4)
|| payload) (transcript.py; reference transcript.rs:53-62).  Running the
hash chain ON DEVICE lets a whole GKR layer's sumcheck rounds run with no
host sync: the per-round host round-trip becomes one sync per layer.
Bit-identical to utils/keccak.py.

State = two uint32[25] arrays (lane lo/hi words, lane (x,y) at index
x + 5y).  All permutation steps are gathers + elementwise shifts over the
25 lanes — static shapes, jit-friendly.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT_TABLE = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
              [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]


@functools.lru_cache(maxsize=1)
def _indices():
    """(rho rotation per lane, pi permutation, chi +1/+2 gathers,
    theta D tile) as numpy index/constant arrays."""
    rot = np.zeros(25, np.uint32)
    for x in range(5):
        for y in range(5):
            rot[x + 5 * y] = _ROT_TABLE[x][y]
    # pi: B[y + 5*((2x+3y)%5)] = A[x + 5y]  ->  perm[dst] = src
    pi_perm = np.zeros(25, np.int32)
    for x in range(5):
        for y in range(5):
            pi_perm[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    i = np.arange(25)
    x, y = i % 5, i // 5
    chi1 = ((x + 1) % 5 + 5 * y).astype(np.int32)
    chi2 = ((x + 2) % 5 + 5 * y).astype(np.int32)
    dsel = (x % 5).astype(np.int32)          # lane -> column index for D
    return rot, pi_perm, chi1, chi2, dsel


def _rotl64(lo, hi, r):
    """Per-lane 64-bit rotate-left of (lo, hi) u32 arrays by r (array)."""
    r = jnp.asarray(r, jnp.uint32)
    swap = r >= 32
    lo, hi = jnp.where(swap, hi, lo), jnp.where(swap, lo, hi)
    r = jnp.where(swap, r - 32, r)
    # r in [0, 32); handle r == 0 (shift by 32 is UB)
    rz = r == 0
    rr = jnp.where(rz, jnp.uint32(1), r)     # dummy to keep shifts defined
    nlo = (lo << rr) | (hi >> (32 - rr))
    nhi = (hi << rr) | (lo >> (32 - rr))
    return jnp.where(rz, lo, nlo), jnp.where(rz, hi, nhi)


def keccak_f(lo: jnp.ndarray, hi: jnp.ndarray):
    """Keccak-f[1600] permutation on uint32[25] lane halves.

    The 24 rounds run under lax.fori_loop: a keccak-heavy transcript
    program (e.g. the fused Fiat-Shamir round with 6 chained events) drops
    ~24x in compiled size and compile time."""
    import jax

    rot, pi_perm, chi1, chi2, dsel = _indices()
    rot = jnp.asarray(rot)
    pi_perm = jnp.asarray(pi_perm)
    chi1 = jnp.asarray(chi1)
    chi2 = jnp.asarray(chi2)
    dsel = jnp.asarray(dsel)
    rcs = jnp.asarray(
        np.array([[rc & 0xFFFFFFFF, rc >> 32] for rc in _RC],
                 dtype=np.uint32))

    def _xor5(a):
        m = a.reshape(5, 5)
        return m[0] ^ m[1] ^ m[2] ^ m[3] ^ m[4]

    def _round(i, lohi):
        lo, hi = lohi
        # theta
        clo = _xor5(lo)
        chi_ = _xor5(hi)
        r1lo, r1hi = _rotl64(jnp.roll(clo, -1), jnp.roll(chi_, -1),
                             jnp.full(5, 1, jnp.uint32))
        dlo = jnp.roll(clo, 1) ^ r1lo
        dhi = jnp.roll(chi_, 1) ^ r1hi
        lo = lo ^ dlo[dsel]
        hi = hi ^ dhi[dsel]
        # rho + pi
        rlo, rhi = _rotl64(lo, hi, rot)
        blo = rlo[pi_perm]
        bhi = rhi[pi_perm]
        # chi
        lo = blo ^ (~blo[chi1] & blo[chi2])
        hi = bhi ^ (~bhi[chi1] & bhi[chi2])
        # iota
        lo = lo.at[0].set(lo[0] ^ rcs[i, 0])
        hi = hi.at[0].set(hi[0] ^ rcs[i, 1])
        return lo, hi

    return jax.lax.fori_loop(0, 24, _round, (lo, hi))


def keccak256_words(msg_words: jnp.ndarray, msg_len_bytes: int) -> jnp.ndarray:
    """keccak256 of a single-rate-block message given as LE uint32 words
    (msg_len_bytes <= 135, a multiple of 4).  Returns the digest as LE
    uint32[8] words (i.e. digest byte k = out_word[k//4] >> (8*(k%4)))."""
    assert msg_len_bytes % 4 == 0 and msg_len_bytes <= 132
    nw = msg_len_bytes // 4
    lo = jnp.zeros(25, jnp.uint32)
    hi = jnp.zeros(25, jnp.uint32)
    # absorb: XOR message words into state (state starts zero -> set)
    padded = jnp.concatenate([
        msg_words[:nw].astype(jnp.uint32),
        jnp.zeros(34 - nw, jnp.uint32)])
    # keccak pad: 0x01 at byte msg_len, 0x80 at byte 135 (word 33 top byte)
    padded = padded.at[nw].set(padded[nw] | jnp.uint32(0x01))
    padded = padded.at[33].set(padded[33] | jnp.uint32(0x80000000))
    lo = lo.at[jnp.arange(17)].set(padded[0::2])
    hi = hi.at[jnp.arange(17)].set(padded[1::2])
    lo, hi = keccak_f(lo, hi)
    out = jnp.zeros(8, jnp.uint32)
    out = out.at[0::2].set(lo[:4])
    out = out.at[1::2].set(hi[:4])
    return out


def bswap32(w: jnp.ndarray) -> jnp.ndarray:
    """Byte-swap uint32 words (LE <-> BE views)."""
    return (((w & 0xFF) << 24) | ((w & 0xFF00) << 8)
            | ((w >> 8) & 0xFF00) | (w >> 24))


def be_words_of_state(state_le: jnp.ndarray) -> jnp.ndarray:
    """32-byte value as LE words -> the same BYTES (no reorder): identity.

    (The transcript state is an opaque 32-byte string; we keep it as the
    digest's natural LE word encoding.)"""
    return state_le


def transcript_event(state_words: jnp.ndarray, n_rounds: jnp.ndarray,
                     payload_words: jnp.ndarray) -> jnp.ndarray:
    """One transcript update: keccak256(state || 0^28 || n_rounds_BE ||
    payload).  state_words: LE uint32[8] of the 32-byte state;
    payload_words: LE uint32 words of the payload bytes (length multiple
    of 4 bytes); n_rounds: uint32 scalar.  Returns the new state words."""
    prefix = jnp.concatenate([
        state_words.astype(jnp.uint32),
        jnp.zeros(7, jnp.uint32),
        bswap32(n_rounds.astype(jnp.uint32)).reshape(1),
    ])
    msg = jnp.concatenate([prefix, payload_words.astype(jnp.uint32)])
    return keccak256_words(msg, 64 + 4 * payload_words.shape[0])


def message_payload_words(msg: bytes) -> np.ndarray:
    """Host helper: a <=32-byte label as the zero-padded 32-byte payload."""
    data = msg + b"\x00" * (32 - len(msg))
    return np.frombuffer(data, dtype="<u4").copy()
