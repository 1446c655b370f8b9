"""Device-resident Fiat-Shamir round machinery (shared by the GKR grand
products and the generic sumcheck provers).

Each sumcheck round's host round-trip (pull evals -> interpolate -> keccak
append -> challenge -> push bind scalar) is a device sync.  These helpers
keep the whole round on device: interpolation with a
precomputed inverse-Vandermonde, the 3 + framing keccak transcript events
(utils/keccak_device.py, bit-exact vs transcript.py), the challenge
reduction, and the next-claim Horner evaluation.  The host enqueues rounds
back-to-back (async dispatch) and pulls the compressed polys once per
layer/sumcheck, then replays the transcript to rebuild FElt challenges —
which doubles as a bit-exactness check of the device hash chain.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..field import FieldSpec
from ..field import device as fd


@functools.lru_cache(maxsize=None)
def vinv_mont(spec: FieldSpec, npts: int) -> tuple:
    """Inverse Vandermonde for nodes 0..npts-1 as Montgomery ints (host).

    Interpolation through these nodes is what UniPoly.from_evals computes
    via Gaussian elimination — same unique polynomial."""
    p = spec.p
    n = npts
    V = [[pow(x, j, p) for j in range(n)] for x in range(n)]
    aug = [row[:] + [int(i == r) for i in range(n)]
           for r, row in enumerate(V)]
    for c in range(n):
        piv = next(r for r in range(c, n) if aug[r][c] % p)
        aug[c], aug[piv] = aug[piv], aug[c]
        inv = pow(aug[c][c], -1, p)
        aug[c] = [v * inv % p for v in aug[c]]
        for r in range(n):
            if r != c and aug[r][c]:
                f = aug[r][c]
                aug[r] = [(v - f * w) % p for v, w in zip(aug[r], aug[c])]
    return tuple(tuple(spec.to_mont(aug[r][n + c]) for c in range(n))
                 for r in range(n))


@functools.lru_cache(maxsize=None)
def transcript_const_words():
    from ..utils.keccak_device import message_payload_words
    return (np.asarray(message_payload_words(b"UniPoly_begin")),
            np.asarray(message_payload_words(b"UniPoly_end")))


def scalar_be_words(spec: FieldSpec, mont: jnp.ndarray) -> jnp.ndarray:
    """Montgomery [L] -> the scalar's 32-byte big-endian payload as LE
    uint32[8] words (transcript.rs:97-105 byte order)."""
    from ..utils.keccak_device import bswap32
    canon = fd.from_mont_device(spec, mont)                # [L] 16-bit limbs
    le_words = canon[0::2] | (canon[1::2] << 16)           # [8] LE value words
    return bswap32(le_words[::-1])


def words_to_mont(spec: FieldSpec, words: jnp.ndarray) -> jnp.ndarray:
    """Digest LE words (32-byte string) -> Montgomery limbs of the BE
    integer mod p (transcript.rs:146-153 + ark from_bytes semantics)."""
    from ..utils.keccak_device import bswap32
    s = bswap32(words[::-1])                               # value LE words
    limbs = jnp.stack([s[i // 2] >> (16 * (i % 2)) for i in range(fd.L)]) \
        & jnp.uint32(0xFFFF)
    r2 = jnp.asarray(np.asarray(
        [int(v) for v in spec.r2_limbs], dtype=np.uint32))
    return fd.fmul(spec, limbs, r2)                        # v*R mod p, exact


def interpolate(spec: FieldSpec, evals: list) -> list:
    """Coefficients of the unique degree-(len-1) polynomial through
    (i, evals[i]); each eval a Montgomery [L] vector."""
    vinv = vinv_mont(spec, len(evals))
    coeffs = []
    for r in range(len(evals)):
        acc = None
        for c in range(len(evals)):
            term = fd.fmul(spec, jnp.asarray(
                fd.pack_ints([vinv[r][c]])[:, 0]), evals[c])
            acc = term if acc is None else fd.fadd(spec, acc, term)
        coeffs.append(acc)
    return coeffs


def horner(spec: FieldSpec, coeffs: list, x: jnp.ndarray) -> jnp.ndarray:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = fd.fadd(spec, c, fd.fmul(spec, x, acc))
    return acc


def fs_append_round(spec: FieldSpec, coeffs: list, state, nr):
    """Append a compressed round poly (all coefficients except the linear
    one) + draw the round challenge, all on device.

    Returns (compressed [L, d], rj [L] Montgomery, state', nr')."""
    from ..utils.keccak_device import transcript_event
    begin_w, end_w = transcript_const_words()
    begin_w = jnp.asarray(begin_w)
    end_w = jnp.asarray(end_w)
    empty = jnp.zeros(0, jnp.uint32)

    transmitted = [coeffs[0]] + list(coeffs[2:])
    state = transcript_event(state, nr, begin_w)
    nr = nr + 1
    for c in transmitted:
        state = transcript_event(state, nr, scalar_be_words(spec, c))
        nr = nr + 1
    state = transcript_event(state, nr, end_w)
    nr = nr + 1
    state = transcript_event(state, nr, empty)             # challenge
    nr = nr + 1
    rj = words_to_mont(spec, state)
    return jnp.stack(transmitted, axis=1), rj, state, nr


def state_to_device(transcript) -> tuple:
    """(state words, n_rounds) device values from a host Transcript."""
    return (jnp.asarray(np.frombuffer(transcript.state, dtype="<u4").copy()),
            jnp.uint32(transcript.n_rounds))


import functools as _functools


@_functools.lru_cache(maxsize=None)
def fs_round_jit(spec: FieldSpec, degree: int, use_hint: bool):
    """The STANDALONE device Fiat-Shamir round program: interpolate the
    round poly from its evals, append + draw the challenge, Horner the
    next claim.  Fixed [L, degree+1] shapes — ONE compiled program per
    (degree, hint) is shared by EVERY sumcheck-shaped protocol.  Chained
    eagerly with the (separately-jitted) evals and bind kernels, rounds
    still enqueue with no host sync, but the fused per-protocol
    mega-programs (an hour-scale fresh compile for the full-ISA primary
    round) disappear."""
    import jax

    def f(evals_dev, prev, state, nr):
        evals = [evals_dev[:, t] for t in range(degree + 1)]
        if use_hint:
            evals[1] = fd.fsub(spec, prev, evals[0])
        coeffs = interpolate(spec, evals)
        comp, rj, state, nr = fs_append_round(spec, coeffs, state, nr)
        prev = horner(spec, coeffs, rj)
        return comp, rj, prev, state, nr

    return jax.jit(f)


@_functools.lru_cache(maxsize=None)
def fs_cubic_round_jit(spec: FieldSpec):
    """Cubic (GKR) variant: evals at t = {0, 2, 3} + the previous-claim
    hint for t = 1 (grand_product.rs:363-390's evaluation points)."""
    import jax

    def f(e023, prev, state, nr):                  # e023: [L, 3]
        e0, e2, e3 = e023[:, 0], e023[:, 1], e023[:, 2]
        e1 = fd.fsub(spec, prev, e0)
        coeffs = interpolate(spec, [e0, e1, e2, e3])
        comp, rj, state, nr = fs_append_round(spec, coeffs, state, nr)
        prev = horner(spec, coeffs, rj)
        return comp, rj, prev, state, nr

    return jax.jit(f)


# ---------------------------------------------------------------------------
# device-chained protocol glue
# ---------------------------------------------------------------------------
#
# Any per-layer host interaction (challenge vectors, eq-table challenges,
# claim folds) is a host<->device sync per layer.  The helpers below keep the ENTIRE grand product device-resident: layer
# coefficients are drawn by a device keccak scan, eq tables are built from
# the device challenge array, and left/right claims are appended on device.
# The host uploads the transcript state once per GP and pulls everything
# once at the end, then replays the host transcript (bit-exactness oracle).

import jax

from ..utils.keccak_device import transcript_event


@_functools.lru_cache(maxsize=None)
def _one_limbs(spec: FieldSpec):
    return np.asarray([int(v) for v in spec.r_limbs], dtype=np.uint32)


@_functools.partial(jax.jit, static_argnums=(0, 3))
def challenge_vector_dev(spec: FieldSpec, state, nr, b_max: int, count):
    """Draw `count` (traced, <= b_max) sequential challenge scalars.

    Returns (coeffs [L, b_max] Montgomery — zero beyond count, state', nr').
    One compiled program per b_max regardless of count."""
    empty = jnp.zeros(0, jnp.uint32)

    def step(carry, i):
        st, n = carry
        new_st = transcript_event(st, n, empty)
        c = words_to_mont(spec, new_st)
        act = i < count
        st2 = jnp.where(act, new_st, st)
        n2 = jnp.where(act, n + jnp.uint32(1), n)
        c = jnp.where(act, c, jnp.uint32(0))
        return (st2, n2), c

    (state, nr), cs = jax.lax.scan(
        step, (state, nr), jnp.arange(b_max, dtype=jnp.int32))
    return jnp.moveaxis(cs, 0, 1), state, nr


@_functools.partial(jax.jit, static_argnums=0)
def challenge_scalar_dev(spec: FieldSpec, state, nr):
    """One challenge scalar on device -> (c [L], state', nr')."""
    state = transcript_event(state, nr, jnp.zeros(0, jnp.uint32))
    return words_to_mont(spec, state), state, nr + jnp.uint32(1)


@_functools.partial(jax.jit, static_argnums=0)
def append_scalars_dev(spec: FieldSpec, state, nr, scalars, count):
    """Append scalars[:, i] for i < count (traced) as sequential scalar
    transcript events.  scalars: [L, M] Montgomery."""
    M = scalars.shape[1]

    def step(carry, i):
        st, n = carry
        payload = scalar_be_words(spec, jnp.take(scalars, i, axis=1))
        new_st = transcript_event(st, n, payload)
        act = i < count
        st2 = jnp.where(act, new_st, st)
        n2 = jnp.where(act, n + jnp.uint32(1), n)
        return (st2, n2), None

    (state, nr), _ = jax.lax.scan(
        step, (state, nr), jnp.arange(M, dtype=jnp.int32))
    return state, nr


@_functools.partial(jax.jit, static_argnums=0)
def eq_masked_br(spec: FieldSpec, rs: jnp.ndarray, k) -> jnp.ndarray:
    """Masked bit-reversed eq table: rs [L, K] challenge slots (first k
    active, traced), output [L, 2^K] with out[p] = eq_br(rs[:k], p) on the
    active prefix p < 2^k, zero beyond.

    eq_br[p] = prod_{j<k} (bit_j(p) ? r_j : 1 - r_j); for j >= k the
    factor is (bit_j(p) ? 0 : 1), which zeroes everything past 2^k.
    Value-identical to poly.mle.eq_evals_device_br (mod-p products are
    order-independent); ONE compiled program per table size instead of one
    per challenge count."""
    K = rs.shape[1]
    S = 1 << K
    idx = jnp.arange(S, dtype=jnp.int32)
    one = jnp.asarray(_one_limbs(spec))[:, None]             # [L, 1]
    table = fd.ones(spec, (S,))
    for j in range(K):
        bit = ((idx >> j) & 1).astype(bool)[None, :]         # [1, S]
        rj = jnp.take(rs, j, axis=1)[:, None]                # [L, 1]
        fa = jnp.where(bit, rj, fd.fsub(spec, one, rj))      # active factor
        fi = jnp.where(bit, jnp.uint32(0), one)              # inactive
        f = jnp.where(j < k, fa, fi)
        table = fd.fmul(spec, table, jnp.broadcast_to(f, table.shape))
    return table


@_functools.partial(jax.jit, static_argnums=0)
def fold_claims_dev(spec: FieldSpec, claims, coeffs):
    """RLC joint claim: sum_b coeffs[:, b] * claims[:, b] -> [L]."""
    return fd.fsum(spec, fd.fmul(spec, claims, coeffs), axis=0)


@_functools.partial(jax.jit, static_argnums=0)
def fold_lr_dev(spec: FieldSpec, lefts, rights, r_layer):
    """claims' = lc + r_layer * (rc - lc), columnwise [L, B]."""
    rb = jnp.broadcast_to(r_layer[:, None], lefts.shape)
    return fd.fadd(spec, lefts,
                   fd.fmul(spec, rb, fd.fsub(spec, rights, lefts)))


@jax.jit
def set_col(buf: jnp.ndarray, v: jnp.ndarray, j) -> jnp.ndarray:
    """buf[:, j] = v (traced column index)."""
    return jax.lax.dynamic_update_slice(buf, v[:, None], (0, j))


@jax.jit
def rebuild_rs(rrounds: jnp.ndarray, r_layer: jnp.ndarray, k) -> jnp.ndarray:
    """Next r_grand_product slots: out[:, j] = rrounds[:, k-1-j] for j < k,
    r_layer at j == k, zero beyond.  rrounds: [L, K] round challenges in
    emission order (first k active)."""
    K = rrounds.shape[1]
    j = jnp.arange(K, dtype=jnp.int32)
    src = jnp.clip(k - 1 - j, 0, K - 1)
    rev = jnp.take(rrounds, src, axis=1)
    out = jnp.where((j < k)[None, :], rev, jnp.uint32(0))
    return jax.lax.dynamic_update_slice(out, r_layer[:, None], (0, k))


@_functools.partial(jax.jit, static_argnums=0)
def pair_finals_dev(spec: FieldSpec, l, r):
    """Bound pair layers [B, L, S] -> (lefts [L, B], rights [L, B],
    interleaved [L, 2B] = lc0, rc0, lc1, rc1, ...)."""
    lefts = jnp.moveaxis(l[..., 0], 0, 1)
    rights = jnp.moveaxis(r[..., 0], 0, 1)
    inter = jnp.stack([lefts, rights], axis=2).reshape(lefts.shape[0], -1)
    return lefts, rights, inter


@_functools.partial(jax.jit, static_argnums=0)
def toggle_finals_dev(spec: FieldSpec, flags, fps):
    """Bound toggle tensors (flags [L, m, T], fps [L, 2m, T]) -> the
    interleaved claim row [L, 4m] = flag0, fp0, flag0, fp1, flag1, fp2, …
    (left claim of fp b is flag b//2, grand_product.rs:1422-1474)."""
    f0 = flags[..., 0]                                    # [L, m]
    p0 = fps[..., 0]                                      # [L, 2m]
    lefts = jnp.repeat(f0, 2, axis=1)                     # [L, 2m]
    return jnp.stack([lefts, p0], axis=2).reshape(f0.shape[0], -1)


def replay_and_check(spec: FieldSpec, comp_ints, transcript, state_dev,
                     make_cpoly):
    """Replay `comp_ints` [rounds, d] through the HOST transcript,
    returning (compressed polys, challenges); asserts the device hash
    chain matches the host's byte-for-byte."""
    import jax
    from ..field import FElt
    compressed, challenges = [], []
    for row in comp_ints:
        cpoly = make_cpoly([FElt(int(v), spec) for v in row.tolist()])
        cpoly.append_to_transcript(transcript)
        challenges.append(transcript.challenge_scalar())
        compressed.append(cpoly)
    dev_state = np.asarray(jax.device_get(state_dev)).astype("<u4").tobytes()
    assert dev_state == transcript.state, \
        "device Fiat-Shamir chain diverged from host transcript"
    return compressed, challenges
