"""Device (JAX) BN254 field arithmetic over limb tensors.

A field array of logical shape `s` is a uint32 tensor of shape
``(NUM_LIMBS,) + s`` holding 16-bit little-endian limbs in Montgomery form
(R = 2^256).  The limb axis is FIRST, so the logical batch dimensions are
the contiguous ones.

Plain XLA path (vs the reference's arkworks 4x64 Montgomery CPU loops,
jolt-core/src/field/ark.rs):

* Schoolbook limb products are ONE outer product + ONE dense matmul against a
  constant 0/1 "anti-diagonal collector" matrix.  16-bit lo/hi product halves
  keep every column sum < 2^21 < 2^24, so f32 accumulation is exact (with
  HIGHEST precision to forbid TF32/bf16 passes).
* Montgomery reduction is single-shot (SOS): m = (T mod R) * N' mod R with
  N' = -p^{-1} mod R, then (T + m*p) / R — three schoolbooks total, no
  16-round scalar recurrence.
* Carry/borrow propagation: Kogge-Stone lookahead (elementwise, log-depth)
  or a lax.scan over the limb axis, as the backend profile says.

On the GPU, fmul / fadd / fsub (and from_mont) run the CUDA kernels of
``mont_kernel.py`` instead: same results bit for bit, and each op is one
custom call, which keeps programs small to compile (``jolt_tpu.backend``
picks by batch size).

Everything is static-shape, jit-friendly, and batched.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from .mont_kernel import field_op
from .spec import (FieldSpec, LIMB_BITS, LIMB_MASK, NUM_LIMBS, int_to_limbs,
                   limbs_to_int)

W = LIMB_BITS
L = NUM_LIMBS
MASK = jnp.uint32(LIMB_MASK)
U32 = jnp.uint32
_HIGHEST = jax.lax.Precision.HIGHEST


def _const_limbs(limbs: np.ndarray, ndim: int) -> jnp.ndarray:
    """Constant limb vector shaped [len, 1, 1, ...] for broadcasting."""
    return jnp.asarray(limbs, dtype=U32).reshape((len(limbs),) + (1,) * ndim)


@functools.lru_cache(maxsize=None)
def _collector_matrix(nl: int) -> np.ndarray:
    """f32 0/1 matrix C[(i*nl+j)*2+part, k] = 1 iff i+j+part == k.

    Collapses the lo/hi halves of all limb products into the 2*nl+1 result
    columns with a single dense matmul.
    """
    ncols = 2 * nl + 1
    mat = np.zeros((nl * nl * 2, ncols), dtype=np.float32)
    for i in range(nl):
        for j in range(nl):
            mat[(i * nl + j) * 2 + 0, i + j] = 1.0
            mat[(i * nl + j) * 2 + 1, i + j + 1] = 1.0
    return mat


def _mul_columns(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Column sums of the double-width product, carry-save uint32 < 2^21.

    a: [nl, ...], b: [nl, ...] 16-bit limbs -> [2*nl+1, ...].
    """
    nl = a.shape[0]
    batch = a.shape[1:]
    prod = a[:, None] * b[None, :]                     # [nl, nl, ...] u32
    lohi = jnp.stack([prod & MASK, prod >> W], axis=2)  # [nl, nl, 2, ...]
    flat = lohi.reshape((nl * nl * 2, -1)).astype(jnp.float32)
    mat = jnp.asarray(_collector_matrix(nl))            # [nl*nl*2, 2nl+1]
    cols = jax.lax.dot_general(mat, flat, (((0,), (0,)), ((), ())),
                               precision=_HIGHEST)      # [2nl+1, prod(batch)]
    return cols.astype(U32).reshape((2 * nl + 1,) + batch)


def _shift_up(x: jnp.ndarray, d: int, fill: int) -> jnp.ndarray:
    """[i] <- x[i-d] along the leading limb axis; positions < d get `fill`."""
    pad = jnp.full((d,) + x.shape[1:], fill, dtype=x.dtype)
    return jnp.concatenate([pad, x[:-d]], axis=0)


def _kogge_stone_carries(g: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Carry into each limb from per-limb (generate, propagate) bits.

    c_0 = 0, c_{i+1} = g_i | (p_i & c_i), solved in log2(K) parallel rounds —
    the lax.scan carry chain would serialize every field op.
    """
    K = g.shape[0]
    G, P = g, p
    d = 1
    while d < K:
        G = G | (P & _shift_up(G, d, 0))
        P = P & _shift_up(P, d, 1)
        d *= 2
    return _shift_up(G, 1, 0)  # carry INTO limb i = combined generate of 0..i-1


def _carry(t: jnp.ndarray) -> jnp.ndarray:
    """Propagate carries along the leading limb axis (redundant -> 16-bit).

    The represented integer must fit in t.shape[0] limbs.  With Kogge-Stone
    carries: two stages — (A) fold each limb's high bits into the next limb
    (one shift + add; sums stay < 2^17), then (B) resolve the remaining
    single-bit carry chain with a log-depth carry-lookahead.  Otherwise a
    lax.scan, which compiles to one tight loop on XLA:CPU.
    """
    if not backend.profile().ks_carries:
        def step(c, v):
            s = v + c
            return s >> W, s & MASK
        _, out = jax.lax.scan(step, jnp.zeros(t.shape[1:], dtype=U32), t)
        return out
    s = (t & MASK) + _shift_up(t >> W, 1, 0)       # < 2^17 - 1
    g = s >> W                                      # 0/1 generate
    p = jnp.where((s & MASK) == MASK, jnp.uint32(1), jnp.uint32(0))
    c = _kogge_stone_carries(g, p)
    return (s + c) & MASK


def _sub_borrow(a: jnp.ndarray, b: jnp.ndarray):
    """a - b limbwise; returns (16-bit diff limbs, final borrow 0/1).

    Same log-depth lookahead as _carry: d_i = a_i + 2^16 - b_i;
    a borrow is generated when d_i < 2^16, propagated when d_i == 2^16.
    """
    one = jnp.uint32(1 << W)
    if not backend.profile().ks_carries:
        def step(borrow, ab):
            ai, bi = ab
            v = ai + one - bi - borrow
            return jnp.uint32(1) - (v >> W), v & MASK
        borrow, out = jax.lax.scan(step, jnp.zeros(a.shape[1:], dtype=U32),
                                   (a, b))
        return out, borrow
    d = a + one - b                                 # in (0, 2^17)
    g = jnp.uint32(1) - (d >> W)                    # borrow generated
    p = jnp.where(d == one, jnp.uint32(1), jnp.uint32(0))
    c = _kogge_stone_carries(g, p)                  # borrow INTO limb i
    out = (d - c) & MASK
    # borrow out of the top limb: generate there, or propagate its carry-in
    top = g[-1] | (p[-1] & c[-1])
    return out, top


def _cond_sub_p(spec: FieldSpec, x: jnp.ndarray) -> jnp.ndarray:
    """x - p if x >= p else x, for x < 2p with 16-bit limbs."""
    p = jnp.broadcast_to(_const_limbs(spec.p_limbs, x.ndim - 1), x.shape)
    d, borrow = _sub_borrow(x, p)
    return jnp.where((borrow == 0)[None], d, x)


# ---------------------------------------------------------------------------
# modular add / sub / neg
# ---------------------------------------------------------------------------
#
# Public field ops called EAGERLY (host coordination code: eq tables,
# leaves prep, pulls) route through per-shape jitted wrappers: the op's
# ~10 internal jnp primitives would otherwise each dispatch (and compile)
# as their own program.  Traced calls stay INLINE so enclosing jitted
# kernels fuse them.

def _traced(*ts) -> bool:
    return any(isinstance(t, jax.core.Tracer) for t in ts)


def _fadd_impl(spec: FieldSpec, a, b):
    return _cond_sub_p(spec, _carry(a + b))


def _fsub_impl(spec: FieldSpec, a, b):
    d, borrow = _sub_borrow(a, b)
    p = jnp.broadcast_to(_const_limbs(spec.p_limbs, a.ndim - 1), a.shape)
    dp = _carry(d + p)
    return jnp.where((borrow == 1)[None], dp, d)


def fadd(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    if not _traced(a, b):
        return _fadd_jit(spec, a, b)
    if _use_kernel(jnp.broadcast_shapes(a.shape, b.shape)):
        return field_op("add", spec, a, b)
    return _fadd_impl(spec, a, b)


def fsub(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    if not _traced(a, b):
        return _fsub_jit(spec, a, b)
    if _use_kernel(jnp.broadcast_shapes(a.shape, b.shape)):
        return field_op("sub", spec, a, b)
    return _fsub_impl(spec, a, b)


def fneg(spec: FieldSpec, a: jnp.ndarray) -> jnp.ndarray:
    return fsub(spec, jnp.zeros_like(a), a)


# ---------------------------------------------------------------------------
# Montgomery multiplication
# ---------------------------------------------------------------------------

def _mont_redc(spec: FieldSpec, t16: jnp.ndarray) -> jnp.ndarray:
    """Single-shot Montgomery reduction of canonical-limb T (< p*R).

    t16: [2L+1, ...] 16-bit limbs.  Returns (T * R^{-1} mod p) canonical limbs.
    """
    batch = t16.shape[1:]
    t_lo = t16[:L]
    nprime = jnp.broadcast_to(_const_limbs(spec.nprime_limbs, len(batch)),
                              (L,) + batch)
    m = _carry(_mul_columns(t_lo, nprime)[:L])          # (T mod R)*N' mod R
    p = jnp.broadcast_to(_const_limbs(spec.p_limbs, len(batch)), (L,) + batch)
    u = _mul_columns(m, p)                               # [2L+1, ...] < 2^21
    s = _carry(u + t16)                                  # exact: (T + m*p)
    hi = s[L:2 * L]                                      # / R ; top limb is 0
    return _cond_sub_p(spec, hi)


def _use_kernel(shape) -> bool:
    """Does a field op over this broadcast shape take the CUDA kernels?"""
    lo = backend.profile().mont_kernel_min
    if not lo:
        return False
    batch = 1
    for s in shape[1:]:
        batch *= s
    return batch >= lo


def _xla_mul(spec: FieldSpec, a, b, batch_leading: bool = False):
    if batch_leading:
        return jnp.moveaxis(_xla_mul(spec, jnp.moveaxis(a, 0, 1),
                                     jnp.moveaxis(b, 0, 1)), 0, 1)
    return _mont_redc(spec, _carry(_mul_columns(a, b)))


def fmul(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Montgomery product: (a * b * R^{-1}) mod p, both operands Montgomery.

    Batches of at least the profile's ``mont_kernel_min`` elements take the
    CUDA kernel (mont_kernel.py), which keeps the whole multiply in
    registers instead of round-tripping [512, N] f32 intermediates through
    device memory.  Bit-identical results either way."""
    if not _traced(a, b):
        return _fmul_jit(spec, a, b)
    if _use_kernel(jnp.broadcast_shapes(a.shape, b.shape)):
        return field_op("mul", spec, a, b)
    return _xla_mul(spec, a, b)


_fmul_jit = jax.jit(fmul, static_argnums=0)
_fadd_jit = jax.jit(fadd, static_argnums=0)
_fsub_jit = jax.jit(fsub, static_argnums=0)


def fmul_bl(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """fmul over BATCH-LEADING operands [B, L, s] (the GP pair layout)."""
    B, _, s = jnp.broadcast_shapes(a.shape, b.shape)
    if _use_kernel((None, B * s)):
        return field_op("mul", spec, a, b, batch_leading=True)
    return _xla_mul(spec, a, b, batch_leading=True)


def fsquare(spec: FieldSpec, a: jnp.ndarray) -> jnp.ndarray:
    return fmul(spec, a, a)


_FROM_MONT_CHUNK = 1 << 16


def from_mont_device(spec: FieldSpec, a: jnp.ndarray) -> jnp.ndarray:
    """Montgomery -> canonical residue, on device (REDC of a itself).

    Huge vectors (RAM-sized 2^21 commit scalars) are REDC'd in fixed-size
    chunks: _mul_columns materializes [nl*nl*2, batch] f32 intermediates
    (~6 KB/element), which at 2^21 elements exceeds HBM in one fusion."""
    batch = 1
    for s in a.shape[1:]:
        batch *= s
    if batch > 2 * _FROM_MONT_CHUNK:
        flat = a.reshape((a.shape[0], batch))
        padded = -(-batch // _FROM_MONT_CHUNK) * _FROM_MONT_CHUNK
        if padded != batch:
            flat = jnp.pad(flat, ((0, 0), (0, padded - batch)))
        # traced chunk offset: ONE slice+REDC program serves every chunk
        # (static per-offset slices compiled one program per offset)
        parts = [_from_mont_chunk_jit(spec, flat, np.int32(off))
                 for off in range(0, padded, _FROM_MONT_CHUNK)]
        return jnp.concatenate(parts, axis=1)[:, :batch].reshape(a.shape)
    if _traced(a):
        return _from_mont_impl(spec, a)
    return _from_mont_jit(spec, a)


def _from_mont_impl(spec: FieldSpec, a):
    """REDC of T = a: the multiply kernel's a * 1 * R^-1 forms the same T,
    hence the same bits, as the plain REDC of a zero-padded a."""
    if _use_kernel(a.shape):
        one = _const_limbs(int_to_limbs(1), a.ndim - 1)
        return field_op("mul", spec, a, jnp.broadcast_to(one, a.shape))
    pad = jnp.zeros((L + 1,) + a.shape[1:], dtype=U32)
    return _mont_redc(spec, jnp.concatenate([a, pad], axis=0))


_from_mont_jit = jax.jit(_from_mont_impl, static_argnums=0)


@functools.partial(jax.jit, static_argnums=0)
def _from_mont_chunk_jit(spec: FieldSpec, flat, off):
    sl = jax.lax.dynamic_slice_in_dim(flat, off, _FROM_MONT_CHUNK, axis=1)
    return _from_mont_impl(spec, sl)


def to_mont_device(spec: FieldSpec, a: jnp.ndarray) -> jnp.ndarray:
    """Canonical residue limbs -> Montgomery form, on device (mul by R^2).

    Large tensors convert in fixed [L, 2^16] chunks through ONE compiled
    program, which bounds the plain path's [512, N] intermediates and
    serves every tensor size with one compile."""
    batch = 1
    for s in a.shape[1:]:
        batch *= s
    if not _traced(a) and batch > 2 * _FROM_MONT_CHUNK:
        flat = a.reshape((a.shape[0], batch))
        padded = -(-batch // _FROM_MONT_CHUNK) * _FROM_MONT_CHUNK
        if padded != batch:
            flat = jnp.pad(flat, ((0, 0), (0, padded - batch)))
        parts = [_to_mont_chunk_jit(spec, flat, np.int32(off))
                 for off in range(0, padded, _FROM_MONT_CHUNK)]
        return jnp.concatenate(parts, axis=1)[:, :batch].reshape(a.shape)
    r2 = jnp.broadcast_to(_const_limbs(spec.r2_limbs, a.ndim - 1), a.shape)
    return fmul(spec, a, r2)


@functools.partial(jax.jit, static_argnums=0)
def _to_mont_chunk_jit(spec: FieldSpec, flat, off):
    sl = jax.lax.dynamic_slice_in_dim(flat, off, _FROM_MONT_CHUNK, axis=1)
    r2 = jnp.broadcast_to(_const_limbs(spec.r2_limbs, 1), sl.shape)
    return fmul(spec, sl, r2)


def col(t: jnp.ndarray, i: int, axis: int = 1) -> jnp.ndarray:
    """t[:, i] via a TRACED-index gather: one XLA program per tensor shape
    instead of one per (shape, index) — the witness-assembly column
    splits otherwise compile ~90 near-identical slice programs."""
    if _traced(t):
        return jnp.take(t, i, axis=axis)
    return jnp.take(t, jnp.asarray(i, jnp.int32), axis=axis)


def fselect(cond: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise select over logical shape (cond has logical shape)."""
    return jnp.where(cond[None], a, b)


def fsum(spec: FieldSpec, a: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Modular sum along a logical axis via log-depth halving (fadd tree)."""
    if not _traced(a):
        return _fsum_jit(spec, a, axis)
    return _fsum_impl(spec, a, axis)


@functools.partial(jax.jit, static_argnums=(0, 2))
def _fsum_jit(spec: FieldSpec, a, axis: int):
    return _fsum_impl(spec, a, axis)


def _fsum_impl(spec: FieldSpec, a: jnp.ndarray, axis: int) -> jnp.ndarray:
    ax = axis + 1 if axis >= 0 else axis + a.ndim  # account for limb axis
    n = a.shape[ax]
    while n > 1:
        half = n // 2
        lo = jax.lax.slice_in_dim(a, 0, half, axis=ax)
        hi = jax.lax.slice_in_dim(a, half, 2 * half, axis=ax)
        s = fadd(spec, lo, hi)
        if n % 2:
            tail = jax.lax.slice_in_dim(a, 2 * half, n, axis=ax)
            head = fadd(spec, jax.lax.slice_in_dim(s, 0, 1, axis=ax), tail)
            s = jnp.concatenate([head, jax.lax.slice_in_dim(s, 1, half, axis=ax)],
                                axis=ax)
        a = s
        n = a.shape[ax]
    return jnp.squeeze(a, axis=ax)


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------

def pack_ints(values, shape=None) -> np.ndarray:
    """Python ints / numpy ints -> canonical limb array uint32[L, *shape]."""
    arr = np.asarray(values, dtype=object)
    if shape is None:
        shape = arr.shape
    flat = arr.ravel()
    out = np.zeros((L, flat.size), dtype=np.uint32)
    for j, v in enumerate(flat.tolist()):
        v = int(v)
        for i in range(L):
            out[i, j] = (v >> (W * i)) & LIMB_MASK
    return out.reshape((L,) + tuple(shape))


def pack_u64(values: np.ndarray) -> np.ndarray:
    """Vectorized u64 numpy array -> canonical limb array uint32[L, *shape]."""
    v = np.asarray(values, dtype=np.uint64)
    out = np.zeros((L,) + v.shape, dtype=np.uint32)
    for i in range(4):
        out[i] = ((v >> np.uint64(W * i)) & np.uint64(LIMB_MASK)).astype(np.uint32)
    return out


@functools.partial(jax.jit, static_argnums=())
def _u64_expand_jit(words: jnp.ndarray) -> jnp.ndarray:
    """[2, *shape] u32 (lo, hi words) -> [L, *shape] 16-bit canonical limbs."""
    lo, hi = words[0], words[1]
    mask = jnp.uint32(0xFFFF)
    limbs = [lo & mask, lo >> 16, hi & mask, hi >> 16]
    limbs += [jnp.zeros_like(lo)] * (L - 4)
    return jnp.stack(limbs)


def u64_to_mont_device(spec: FieldSpec, vals: np.ndarray) -> jnp.ndarray:
    """u64 host values -> Montgomery limb tensor with a COMPACT upload.

    pack_u64 + jnp.asarray uploads the 16-limb expansion (8x the data: a
    26 x 2^16 subtable stack is 436 MB).  This path ships 8 bytes/value
    and expands to limbs on device."""
    v = np.ascontiguousarray(np.asarray(vals, dtype=np.uint64))
    words = np.stack([(v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                      (v >> np.uint64(32)).astype(np.uint32)])
    return to_mont_device(spec, _u64_expand_jit(jnp.asarray(words)))


def unpack_ints(limbs: np.ndarray) -> np.ndarray:
    """Canonical limb array uint32[L, *shape] -> numpy object array of ints."""
    limbs = np.asarray(limbs)
    shape = limbs.shape[1:]
    flat = limbs.reshape(L, -1)
    out = np.empty(flat.shape[1], dtype=object)
    for j in range(flat.shape[1]):
        out[j] = limbs_to_int(flat[:, j])
    return out.reshape(shape) if shape else out


def scalar_to_device(spec: FieldSpec, x: int) -> jnp.ndarray:
    """Single host int -> Montgomery limb vector uint32[L] (host-converted)."""
    return jnp.asarray(int_to_limbs(spec.to_mont(x % spec.p)), dtype=U32)


def ints_to_device(spec: FieldSpec, values, shape=None) -> jnp.ndarray:
    """Host ints -> device Montgomery limbs (conversion mul done on device)."""
    arr = np.asarray(values, dtype=object)
    if shape is None:
        shape = arr.shape
    canonical = pack_ints([int(v) % spec.p for v in arr.ravel().tolist()],
                          shape=shape)
    return to_mont_device(spec, jnp.asarray(canonical))


def device_to_ints(spec: FieldSpec, a: jnp.ndarray) -> np.ndarray:
    """Device Montgomery limbs -> host numpy object array of canonical ints."""
    canonical = np.asarray(jax.device_get(from_mont_device(spec, a)))
    return unpack_ints(canonical)


def to_int(spec: FieldSpec, a: jnp.ndarray) -> int:
    """Device Montgomery limb vector [L] -> single canonical host int."""
    return int(np.asarray(device_to_ints(spec, a)).item())


def zeros(spec: FieldSpec, shape) -> jnp.ndarray:
    return jnp.zeros((L,) + tuple(shape), dtype=U32)


def ones(spec: FieldSpec, shape) -> jnp.ndarray:
    one = jnp.asarray(spec.r_limbs, dtype=U32)  # Montgomery 1 = R mod p
    return jnp.broadcast_to(one.reshape((L,) + (1,) * len(shape)),
                            (L,) + tuple(shape)).copy()
