"""Multilinear extensions (MLEs) as device limb tensors.

A (batch of) MLE(s) in evaluation form is a uint32 limb tensor
``[NUM_LIMBS, ..., n]`` with the hypercube on the LAST axis, n = 2^num_vars,
index bits big-endian (first/bound-first variable = most significant bit) —
the same convention as the reference's DensePolynomial
(jolt-core/src/poly/dense_mlpoly.rs:15-363) and EqPolynomial
(jolt-core/src/poly/eq_poly.rs:25-77).

The reference's four binding variants (bound_poly_var_top / _par /
_many_ones / _zero_optimized) are semantically one operation; on the device a
single dense fused bind kernel covers them all.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..field import FElt, FieldSpec, fr_spec
from ..field import device as fd


def bind_top(spec: FieldSpec, z: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Bind the top (most-significant) variable to scalar r (limb vec [L]).

    z: [L, ..., n] -> [L, ..., n/2]:  out[i] = lo[i] + r * (hi[i] - lo[i])
    (reference dense_mlpoly.rs:74-139; all variants are this formula).
    """
    n = z.shape[-1]
    lo, hi = z[..., : n // 2], z[..., n // 2:]
    rb = r.reshape((fd.L,) + (1,) * (z.ndim - 1))
    return fd.fadd(spec, lo, fd.fmul(spec, jnp.broadcast_to(rb, lo.shape),
                                     fd.fsub(spec, hi, lo)))


def bind_bot(spec: FieldSpec, z: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Bind the bottom (least-significant) variable to r.

    out[i] = z[2i] + r * (z[2i+1] - z[2i])  (dense_mlpoly.rs:206-236).
    """
    lo = z[..., 0::2]
    hi = z[..., 1::2]
    rb = r.reshape((fd.L,) + (1,) * (z.ndim - 1))
    return fd.fadd(spec, lo, fd.fmul(spec, jnp.broadcast_to(rb, lo.shape),
                                     fd.fsub(spec, hi, lo)))


@partial(jax.jit, static_argnums=0)
def _eq_evals_stacked(spec: FieldSpec, rs: jnp.ndarray) -> jnp.ndarray:
    """Doubling DP over stacked challenges rs [ell, L] -> eq table
    [L, 2^ell].  Jitted as ONE program per ell (the eager per-level op
    chain compiled ~10 programs per level)."""
    table = fd.ones(spec, (1,))
    for j in range(rs.shape[0]):
        rb = jnp.broadcast_to(rs[j][:, None], table.shape)
        hi = fd.fmul(spec, table, rb)
        lo = fd.fsub(spec, table, hi)
        # interleave: new[2i] = lo[i], new[2i+1] = hi[i]
        table = jnp.stack([lo, hi], axis=-1).reshape(fd.L, -1)
    return table


@partial(jax.jit, static_argnums=0)
def _eq_evals_stacked_br(spec: FieldSpec, rs: jnp.ndarray) -> jnp.ndarray:
    table = fd.ones(spec, (1,))
    for j in range(rs.shape[0]):
        rb = jnp.broadcast_to(rs[j][:, None], table.shape)
        hi = fd.fmul(spec, table, rb)
        lo = fd.fsub(spec, table, hi)
        table = jnp.concatenate([lo, hi], axis=-1)
    return table


def _stack_point(spec: FieldSpec, r) -> jnp.ndarray:
    """Challenge point -> stacked [k, L] Montgomery device array.

    Accepts a list of device limb vectors [L], OR host FElt/int values —
    the host form packs ALL challenges into ONE canonical array and does a
    single upload + device to-Montgomery pass (not one upload per
    scalar)."""
    first = r[0]
    if isinstance(first, jnp.ndarray) and first.dtype == jnp.uint32:
        return jnp.stack(list(r), axis=0)
    vals = [x.v if hasattr(x, "v") else int(x) % spec.p for x in r]
    packed = fd.pack_ints(vals)                        # [L, k] canonical
    return jnp.moveaxis(fd.to_mont_device(spec, jnp.asarray(packed)), 1, 0)


def eq_evals_device(spec: FieldSpec, r) -> jnp.ndarray:
    """eq(r, x) table over the 2^ell hypercube, on device.

    r: list of limb vectors [L] (Montgomery) or host FElt/ints.  Index bits
    big-endian w.r.t. r order (eq_poly.rs:34-49 doubling DP).
    """
    if not r:
        return fd.ones(spec, (1,))
    return _eq_evals_stacked(spec, _stack_point(spec, r))


def eq_evals_device_br(spec: FieldSpec, r) -> jnp.ndarray:
    """eq(r, x) table in BIT-REVERSED index order: out[p] = eq_evals[rev(p)].

    Same doubling DP as eq_evals_device but each new variable extends the
    table by concatenation (becomes the new most-significant POSITION bit)
    instead of interleaving.  Used by the grand-product prover, whose layers
    are stored bit-reversed so that every bind is a contiguous half-split
    (sums are order-independent mod p, so transcripts are unchanged).
    """
    if not r:
        return fd.ones(spec, (1,))
    return _eq_evals_stacked_br(spec, _stack_point(spec, r))


def bitrev_indices(n: int) -> np.ndarray:
    """Permutation p with p[pos] = bit-reverse(pos) over log2(n) bits."""
    k = n.bit_length() - 1
    assert 1 << k == n, "power of two required"
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for _ in range(k):
        out = (out << 1) | (idx & 1)
        idx >>= 1
    return out


def evaluate_many_host(spec: FieldSpec, polys, eq_table: jnp.ndarray):
    """Evaluate many same-length MLEs at one point (given its eq table):
    ONE stacked inner-product program + ONE pull (not one transfer per
    polynomial)."""
    from ..field.host import FElt
    stacked = jnp.stack(list(polys), axis=1)               # [L, P, n]
    prods = fd.fmul(spec, stacked, jnp.broadcast_to(
        eq_table[:, None, :], stacked.shape))
    vals = fd.fsum(spec, prods, axis=-1)                   # [L, P]
    return [FElt(int(v), spec)
            for v in fd.device_to_ints(spec, vals).tolist()]


def evaluate_device(spec: FieldSpec, z: jnp.ndarray, eq_table: jnp.ndarray) -> jnp.ndarray:
    """<Z, eq(r, .)> -> limb vector [L] (dense_mlpoly.rs:238-253)."""
    prods = fd.fmul(spec, z, jnp.broadcast_to(
        eq_table.reshape((fd.L,) + (1,) * (z.ndim - 2) + (eq_table.shape[-1],)), z.shape))
    out = prods
    while out.ndim > 1:
        out = fd.fsum(spec, out, axis=out.ndim - 2)  # logical last axis
    return out


# ---------------------------------------------------------------------------
# host-side reference MLE (verifier + tests)
# ---------------------------------------------------------------------------

def eq_evals_host(r: Sequence[FElt]) -> list[FElt]:
    spec = r[0].spec if r else fr_spec()
    table = [FElt(1, spec)]
    for rj in r:
        nxt = []
        for x in table:
            hi = x * rj
            nxt.append(x - hi)
            nxt.append(hi)
        table = nxt
    return table


def eq_evaluate_host(r: Sequence[FElt], x: Sequence[FElt]) -> FElt:
    assert len(r) == len(x)
    spec = r[0].spec if r else fr_spec()
    out = FElt(1, spec)
    for a, b in zip(r, x):
        out = out * (a * b + (FElt(1, spec) - a) * (FElt(1, spec) - b))
    return out


def evaluate_host(z: Sequence[FElt], r: Sequence[FElt]) -> FElt:
    chis = eq_evals_host(list(r))
    assert len(chis) == len(z)
    spec = r[0].spec if r else fr_spec()
    acc = FElt(0, spec)
    for zi, ci in zip(z, chis):
        acc = acc + zi * ci
    return acc


def mle_from_ints(spec: FieldSpec, values, shape=None) -> jnp.ndarray:
    return fd.ints_to_device(spec, values, shape)


def mle_to_felts(spec: FieldSpec, z: jnp.ndarray) -> np.ndarray:
    ints = fd.device_to_ints(spec, z)
    out = np.empty(ints.shape, dtype=object)
    it = np.nditer(ints, flags=["multi_index", "refs_ok"])
    for v in it:
        out[it.multi_index] = FElt(int(v.item()), spec)
    return out
