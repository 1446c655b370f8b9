"""Batched GKR grand products (Thaler'13 layered circuits).

Reference semantics: jolt-core/src/subprotocols/grand_product.rs —
interleaved [L0, R0, L1, R1, ...] layers (grand_product.rs:252-260), product
tree construction (423-446), per-layer batched cubic sumcheck with
least-significant-variable binding (297-396), claim folding with a per-layer
challenge (199-251), and verification that replays eq(r_gp, rev(r_sumcheck))
(122-182).

Device shape: a layer is a PAIR of batch-leading limb tensors
(l, r): uint32[B, NUM_LIMBS, s] holding the left/right polynomials in
BIT-REVERSED evaluation order.  Bit-reversal turns every per-round access
pattern into a contiguous half-split — the round's sibling pairs (2i, 2i+1)
sit at positions (i, i + s/2) — so the cubic-evals and bind kernels read
contiguous halves with zero de-interleaving shuffles, and the bind OUTPUTS
are directly the next round's layer pair.  Field sums are order-independent mod p, so round
polynomials, claims, and every transcript byte are identical to the
reference's interleaved order.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from functools import partial
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..field import FElt, FieldSpec, fr_spec
from ..field import device as fd
from ..poly.mle import bitrev_indices, eq_evals_device_br
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..transcript import Transcript
from .sumcheck import SumcheckInstanceProof


@dataclass
class BatchedGrandProductLayerProof:
    proof: SumcheckInstanceProof
    left_claims: list[FElt]
    right_claims: list[FElt]


@dataclass
class BatchedGrandProductProof:
    layers: list[BatchedGrandProductLayerProof]
    quark: object | None = None  # QuarkGrandProductProof in the hybrid scheme


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=0)
def _tree_level(spec: FieldSpec, layer: jnp.ndarray) -> jnp.ndarray:
    """One product-tree level over an INTERLEAVED [L, B, n] layer:
    out[i] = layer[2i] * layer[2i+1].  (Quarks construction path only —
    the GKR prover uses the bit-reversed pair representation below.)"""
    return fd.fmul(spec, layer[..., 0::2], layer[..., 1::2])


@partial(jax.jit, static_argnums=0)
def _interleaved_to_pair(spec: FieldSpec, leaves: jnp.ndarray):
    """Interleaved leaves [L, B, n] -> bit-reversed batch-leading pair
    (l, r): [B, L, n/2] each.  The left poly occupies even interleaved
    indices, i.e. the first half after bit-reversal."""
    n = leaves.shape[-1]
    br = jnp.take(leaves, jnp.asarray(bitrev_indices(n)), axis=-1)
    arr = jnp.moveaxis(br, 0, 1)                          # [B, L, n]
    return arr[..., : n // 2], arr[..., n // 2:]


@partial(jax.jit, static_argnums=0)
def _bitrev_last(spec: FieldSpec, t: jnp.ndarray) -> jnp.ndarray:
    """Bit-reverse-permute the last (hypercube) axis."""
    return jnp.take(t, jnp.asarray(bitrev_indices(t.shape[-1])), axis=-1)


@partial(jax.jit, static_argnums=0)
def _pair_tree_level(spec: FieldSpec, l: jnp.ndarray, r: jnp.ndarray):
    """Next tree level: elementwise product, split into contiguous halves.

    l, r: [B, L, s] bit-reversed.  The parent interleaved layer's
    bit-reversed array IS l*r; its left/right polys are its halves."""
    s = l.shape[-1]
    prod = fd.fmul_bl(spec, l, r)
    return prod[..., : s // 2], prod[..., s // 2:]


def _pair_tree_level_masked(spec: FieldSpec, l, r, half):
    """Masked tree level at a FIXED buffer size: inputs [B, L, Sb] with
    active pair-side s = 2*half (zeros beyond); outputs the next level
    (l', r') = halves of the product, active `half`, same buffer.  ONE
    compiled program per (B, Sb) serves every level in the size class —
    the per-shape `_pair_tree_level` chain was ~log2(n) programs per GP
    instance."""
    Sb = l.shape[-1]
    prod = fd.fmul_bl(spec, l, r)
    mask = jnp.arange(Sb, dtype=jnp.int32) < half
    l2 = jnp.where(mask, prod, jnp.uint32(0))
    r2 = jnp.where(mask, jnp.roll(prod, -half, axis=-1), jnp.uint32(0))
    return l2, r2


_pair_tree_level_m_jit = jax.jit(_pair_tree_level_masked, static_argnums=0)

# size-class ladder step for the chained tree: buffers shrink by 8x when
# the active size crosses a class boundary (<= 1.8x memory vs true sizes;
# 2 slice programs per (B, S) instead of one pad per level)
_TREE_CLASS_STEP = 8


def _build_pair_tree_classed(spec: FieldSpec, leaves: jnp.ndarray) -> list:
    """Chained-prover tree construct: every level lives in a class-sized
    masked buffer; one masked level program per (B, class)."""
    l, r = _interleaved_to_pair(spec, leaves)
    S = l.shape[-1]
    layers = [(l, r)]
    s = S
    while s > 1:
        half = s // 2
        cur = l.shape[-1]
        l, r = _pair_tree_level_m_jit(spec, l, r, np.int32(half))
        new = cur
        while new // _TREE_CLASS_STEP >= max(half, 1) \
                and new // _TREE_CLASS_STEP >= 1:
            new //= _TREE_CLASS_STEP
        if new < cur:
            l, r = l[..., :new], r[..., :new]
        layers.append((l, r))
        s = half
    return layers


def _bcast_coeffs(coeffs: jnp.ndarray, like: jnp.ndarray) -> jnp.ndarray:
    """coeffs [L, B] -> broadcast to [L, B, m]."""
    return jnp.broadcast_to(coeffs[:, :, None], like.shape)


@partial(jax.jit, static_argnums=0)
def _pair_cubic_evals(spec: FieldSpec, l: jnp.ndarray, r: jnp.ndarray,
                      eq: jnp.ndarray, coeffs: jnp.ndarray) -> jnp.ndarray:
    """Cubic round-poly evaluations at t = 0, 2, 3 -> [L, 3].

    l, r: [B, L, s] bit-reversed pairs; eq: [L, s] bit-reversed;
    coeffs: [L, B].  Computes sum_i eq_t(i) * sum_b coeff_b * left_t(b,i)
    * right_t(b,i) with the coefficient folded into `left` (one fewer mul,
    as in grand_product.rs:363-390 — order of operations preserved mod p)."""
    s = l.shape[-1]
    h = s // 2
    lf, rf = jnp.moveaxis(l, 0, 1), jnp.moveaxis(r, 0, 1)   # [L, B, s]
    l0, l1 = lf[..., :h], lf[..., h:]
    r0, r1 = rf[..., :h], rf[..., h:]
    cl0 = fd.fmul(spec, _bcast_coeffs(coeffs, l0), l0)
    cl1 = fd.fmul(spec, _bcast_coeffs(coeffs, l1), l1)
    m_l = fd.fsub(spec, cl1, cl0)
    m_r = fd.fsub(spec, r1, r0)
    le2 = fd.fadd(spec, cl1, m_l)
    le3 = fd.fadd(spec, le2, m_l)
    re2 = fd.fadd(spec, r1, m_r)
    re3 = fd.fadd(spec, re2, m_r)

    s0 = fd.fsum(spec, fd.fmul(spec, cl0, r0), axis=0)   # [L, h]
    s2 = fd.fsum(spec, fd.fmul(spec, le2, re2), axis=0)
    s3 = fd.fsum(spec, fd.fmul(spec, le3, re3), axis=0)

    eq0, eq1 = eq[..., :h], eq[..., h:]
    m_eq = fd.fsub(spec, eq1, eq0)
    eqe2 = fd.fadd(spec, eq1, m_eq)
    eqe3 = fd.fadd(spec, eqe2, m_eq)

    e0 = fd.fsum(spec, fd.fmul(spec, eq0, s0), axis=0)
    e2 = fd.fsum(spec, fd.fmul(spec, eqe2, s2), axis=0)
    e3 = fd.fsum(spec, fd.fmul(spec, eqe3, s3), axis=0)
    return jnp.stack([e0, e2, e3], axis=1)               # [L, 3]


@partial(jax.jit, static_argnums=0)
def _pair_bind(spec: FieldSpec, l: jnp.ndarray, r: jnp.ndarray,
               eq: jnp.ndarray, r_chal: jnp.ndarray):
    """Bind the bottom variable: new = lo + r*(hi - lo) on contiguous
    halves.  Outputs ARE the next round's (l, r, eq) — no re-layout."""
    s = l.shape[-1]
    h = s // 2

    def bind_lf(t):                                       # t: [L, ..., s]
        lo, hi = t[..., :h], t[..., h:]
        rb = jnp.broadcast_to(
            r_chal.reshape((fd.L,) + (1,) * (t.ndim - 1)), lo.shape)
        return fd.fadd(spec, lo, fd.fmul(spec, rb, fd.fsub(spec, hi, lo)))

    nl = jnp.moveaxis(bind_lf(jnp.moveaxis(l, 0, 1)), 0, 1)
    nr = jnp.moveaxis(bind_lf(jnp.moveaxis(r, 0, 1)), 0, 1)
    return nl, nr, bind_lf(eq)


# ---------------------------------------------------------------------------
# fixed-shape MASKED pair kernels (one compiled program per GP instance)
# ---------------------------------------------------------------------------
#
# The pair tensors stay at the GP's FULL leaf-layer size S for every layer
# and round; the active pair count h is a TRACED scalar.  Inactive lanes
# are zeros (enforced by the masked bind and layer construction), and the
# eq factors are masked before the final reductions, so round evaluations
# are bit-identical to the shrinking-shape kernels while ONE compiled
# program serves every (layer, round) — the per-halving-shape compiles
# collapse to one.

def _pair_cubic_evals_masked(spec: FieldSpec, l, r, eq, coeffs, h):
    """Masked cubic evals at t = 0, 2, 3 -> [L, 3].  l, r: [B, L, S];
    eq: [L, S]; coeffs: [L, B]; h: traced active pair count (pairs are
    (i, i+h), i < h)."""
    S = l.shape[-1]
    H = S // 2
    lf, rf = jnp.moveaxis(l, 0, 1), jnp.moveaxis(r, 0, 1)   # [L, B, S]
    l0, r0 = lf[..., :H], rf[..., :H]
    l1 = jax.lax.dynamic_slice_in_dim(lf, h, H, axis=-1)
    r1 = jax.lax.dynamic_slice_in_dim(rf, h, H, axis=-1)
    cl0 = fd.fmul(spec, _bcast_coeffs(coeffs, l0), l0)
    cl1 = fd.fmul(spec, _bcast_coeffs(coeffs, l1), l1)
    m_l = fd.fsub(spec, cl1, cl0)
    m_r = fd.fsub(spec, r1, r0)
    le2 = fd.fadd(spec, cl1, m_l)
    le3 = fd.fadd(spec, le2, m_l)
    re2 = fd.fadd(spec, r1, m_r)
    re3 = fd.fadd(spec, re2, m_r)

    s0 = fd.fsum(spec, fd.fmul(spec, cl0, r0), axis=0)   # [L, H]
    s2 = fd.fsum(spec, fd.fmul(spec, le2, re2), axis=0)
    s3 = fd.fsum(spec, fd.fmul(spec, le3, re3), axis=0)

    eq0 = eq[..., :H]
    eq1 = jax.lax.dynamic_slice_in_dim(eq, h, H, axis=-1)
    m_eq = fd.fsub(spec, eq1, eq0)
    eqe2 = fd.fadd(spec, eq1, m_eq)
    eqe3 = fd.fadd(spec, eqe2, m_eq)

    mask = jnp.arange(H, dtype=jnp.int32) < h
    zero = jnp.uint32(0)
    e0 = fd.fsum(spec, jnp.where(mask, fd.fmul(spec, eq0, s0), zero),
                 axis=0)
    e2 = fd.fsum(spec, jnp.where(mask, fd.fmul(spec, eqe2, s2), zero),
                 axis=0)
    e3 = fd.fsum(spec, jnp.where(mask, fd.fmul(spec, eqe3, s3), zero),
                 axis=0)
    return jnp.stack([e0, e2, e3], axis=1)               # [L, 3]


def _pair_bind_masked(spec: FieldSpec, l, r, eq, r_chal, h):
    """Masked bind: out[i] = lo[i] + r*(hi[i] - lo[i]) for i < h, zero
    beyond; outputs stay [.., S] with active prefix h."""
    mask = None

    def bind_lf(t):                                      # [L, ..., S]
        nonlocal mask
        H = t.shape[-1] // 2
        if mask is None:
            mask = jnp.arange(H, dtype=jnp.int32) < h
        lo = t[..., :H]
        hi = jax.lax.dynamic_slice_in_dim(t, h, H, axis=-1)
        rb = jnp.broadcast_to(
            r_chal.reshape((fd.L,) + (1,) * (t.ndim - 1)), lo.shape)
        bound = fd.fadd(spec, lo, fd.fmul(spec, rb, fd.fsub(spec, hi, lo)))
        bound = jnp.where(mask, bound, jnp.uint32(0))
        return jnp.concatenate([bound, jnp.zeros_like(bound)], axis=-1)

    nl = jnp.moveaxis(bind_lf(jnp.moveaxis(l, 0, 1)), 0, 1)
    nr = jnp.moveaxis(bind_lf(jnp.moveaxis(r, 0, 1)), 0, 1)
    return nl, nr, bind_lf(eq)


_pair_cubic_evals_m_jit = jax.jit(_pair_cubic_evals_masked,
                                  static_argnums=0)
# donate (l, r, eq): the bound outputs replace the inputs each round, so
# HBM holds ONE working copy per tensor instead of two (first call may
# copy if the caller still references the buffer — jax handles safely)
_pair_bind_m_jit = jax.jit(_pair_bind_masked, static_argnums=0,
                           donate_argnums=(1, 2, 3))


@partial(jax.jit, static_argnums=(0, 2))
def _pad_last(spec: FieldSpec, t: jnp.ndarray, S: int) -> jnp.ndarray:
    """Zero-pad the last axis up to S (jit so the pad fuses; one tiny
    program per source size)."""
    pad = S - t.shape[-1]
    if pad == 0:
        return t
    widths = [(0, 0)] * (t.ndim - 1) + [(0, pad)]
    return jnp.pad(t, widths)


# ---------------------------------------------------------------------------
# device-resident layer rounds (Fiat-Shamir chain on device)
# ---------------------------------------------------------------------------
#
# A GKR layer has log2(s) rounds and each round needs 6 transcript events.
# Running the WHOLE layer (evals -> round-poly -> keccak events ->
# challenge -> bind) on device removes the host sync from every round.
# The host then replays the transcript from the returned compressed polys
# (microseconds) to rebuild FElt challenges + state_history, and asserts
# the device hash chain matches — a per-layer bit-exactness check.

def _fs_transcript_round(spec: FieldSpec, e023, prev, state, nr):
    """Device transcript block for a cubic GKR round: interpolate from
    evals at {0,2,3} + the previous-claim hint, append the compressed
    poly + draw the challenge (fs_device helpers), Horner the next claim.
    Returns (compressed [L,3], rj, prev', state', nr')."""
    from . import fs_device as fsd
    e0, e2, e3 = e023[:, 0], e023[:, 1], e023[:, 2]
    e1 = fd.fsub(spec, prev, e0)
    coeffs = fsd.interpolate(spec, [e0, e1, e2, e3])
    comp, rj, state, nr = fsd.fs_append_round(spec, coeffs, state, nr)
    prev = fsd.horner(spec, coeffs, rj)
    return comp, rj, prev, state, nr


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------

def _pair_claims(spec: FieldSpec, top) -> list[FElt]:
    if isinstance(top, HostPairLayer):
        return [FElt(lb[0] * rb[0] % spec.p, spec)
                for lb, rb in zip(top.l, top.r)]
    l, r = top
    prods = fd.fmul(spec, jnp.moveaxis(l, 0, 1)[..., 0],
                    jnp.moveaxis(r, 0, 1)[..., 0])        # [L, B]
    return [FElt(int(v), spec)
            for v in fd.device_to_ints(spec, prods).tolist()]


# ---------------------------------------------------------------------------
# host tail: layers at or below a size threshold live as Python bigints
# ---------------------------------------------------------------------------
#
# The shape-halving GKR rounds compile one XLA program per (B, s) pair; the
# long tail of tiny shapes dominates COMPILE count (and per-round dispatch)
# while holding <1% of the field muls.  At or below the profile's
# host_tail (backend.py) layers are pulled to the host once and proved in
# Python bigint arithmetic — mathematically identical mod p, so round
# polys, challenges, and the transcript are bit-for-bit unchanged
# (cross-checked by tests/test_grand_product.py).

class HostPairLayer:
    """Bit-reversed (l, r) pair layer as host ints: l[b][i], r[b][i]."""
    __slots__ = ("l", "r")

    def __init__(self, l: list, r: list):
        self.l = l
        self.r = r

    @property
    def size(self) -> int:
        return len(self.l[0])

    @property
    def batch(self) -> int:
        return len(self.l)


def _pair_layer_to_host(spec: FieldSpec, l: jnp.ndarray,
                        r: jnp.ndarray) -> HostPairLayer:
    li = fd.device_to_ints(spec, jnp.moveaxis(l, 1, 0))   # [B, s] objects
    ri = fd.device_to_ints(spec, jnp.moveaxis(r, 1, 0))
    return HostPairLayer([[int(x) for x in row] for row in li.tolist()],
                         [[int(x) for x in row] for row in ri.tolist()])


def _host_tree_level(p: int, layer: HostPairLayer) -> HostPairLayer:
    """Mirror of _pair_tree_level on host ints."""
    h = layer.size // 2
    prods = [[a * b % p for a, b in zip(lb, rb)]
             for lb, rb in zip(layer.l, layer.r)]
    return HostPairLayer([row[:h] for row in prods],
                         [row[h:] for row in prods])


def _eq_table_br_host(p: int, r_vals: list[int]) -> list[int]:
    """Mirror of eq_evals_device_br (concatenation DP, bit-reversed)."""
    table = [1]
    for rj in r_vals:
        hi = [x * rj % p for x in table]
        table = [(x - h) % p for x, h in zip(table, hi)] + hi
    return table


def _host_cubic_evals(p: int, ll: list, rr: list, eq: list,
                      coeffs: list[int]):
    """Mirror of _pair_cubic_evals on host ints -> (e0, e2, e3)."""
    h = len(eq) // 2
    e0 = e2 = e3 = 0
    for i in range(h):
        s0 = s2 = s3 = 0
        for b, c in enumerate(coeffs):
            l0 = c * ll[b][i] % p
            l1 = c * ll[b][i + h] % p
            ml = l1 - l0
            le2 = l1 + ml
            le3 = le2 + ml
            r0 = rr[b][i]
            r1 = rr[b][i + h]
            mr = r1 - r0
            re2 = r1 + mr
            re3 = re2 + mr
            s0 += l0 * r0
            s2 += le2 * re2
            s3 += le3 * re3
        eq1 = eq[i + h]
        meq = eq1 - eq[i]
        eqe2 = eq1 + meq
        e0 += eq[i] * (s0 % p)
        e2 += eqe2 * (s2 % p)
        e3 += (eqe2 + meq) * (s3 % p)
    return e0 % p, e2 % p, e3 % p


def _host_bind(p: int, rows: list, rj: int) -> list:
    h = len(rows[0]) // 2
    return [[(row[i] + rj * (row[i + h] - row[i])) % p for i in range(h)]
            for row in rows]


def _build_pair_tree(spec: FieldSpec, leaves: jnp.ndarray,
                     host_tail: int | None = None) -> list:
    """Interleaved leaves [L, B, n] -> list of pair layers, bottom-up
    (layers[0] the largest, layers[-1] size-1).  Layers with per-side size
    <= host_tail are HostPairLayer (see module comment above)."""
    tail = backend.profile().host_tail if host_tail is None else host_tail
    if host_tail is None and backend.profile().chain:
        # chained proving keeps every layer device-resident (one pull per
        # GP) in class-sized masked buffers — no host-tail layers, no
        # per-shape level/pad programs
        return _build_pair_tree_classed(spec, leaves)
    layers = [_interleaved_to_pair(spec, leaves)]
    if tail and layers[0][0].shape[-1] <= tail:
        layers = [_pair_layer_to_host(spec, *layers[0])]
    while True:
        top = layers[-1]
        if isinstance(top, HostPairLayer):
            if top.size <= 1:
                break
            layers.append(_host_tree_level(spec.p, top))
        else:
            if top[0].shape[-1] <= 1:
                break
            nxt = _pair_tree_level(spec, *top)
            if tail and nxt[0].shape[-1] <= tail:
                nxt = _pair_layer_to_host(spec, *nxt)
            layers.append(nxt)
    return layers


class BatchedDenseGrandProduct:
    """B independent grand products over 2^k leaves, proved jointly."""

    def __init__(self, layers: list[tuple], spec: FieldSpec,
                 real_batch: int | None = None):
        self.layers = layers  # [(l, r)] pairs, layers[0] = leaves, bit-rev
        self.spec = spec
        self.round_tail = True   # False on mesh-sharded instances
        # batch size BEFORE mesh zero-padding (claims/proof entries cover
        # only the real circuits; pad rows are neutralized by zero coeffs)
        self.real_batch = real_batch if real_batch is not None \
            else layers[0][0].shape[0]

    @staticmethod
    def construct(leaves: jnp.ndarray, spec: FieldSpec | None = None,
                  mesh=None) -> "BatchedDenseGrandProduct":
        """With `mesh`, the BATCH axis of every pair layer is sharded across
        the device mesh (each chip owns a subset of the batched circuits;
        binds are local, only the tiny [L, 3] round evaluations reduce
        cross-chip).  Batches are zero-padded to the mesh size — never
        silently replicated."""
        spec = spec or fr_spec()
        real_batch = leaves.shape[1]
        # host-tail layers are incompatible with batch sharding (and the
        # mesh path exists to validate sharded execution) — disable it there
        layers = _build_pair_tree(spec, leaves,
                                  host_tail=0 if mesh is not None else None)
        if mesh is not None:
            from ..parallel.sharding import shard_gp_pair_layers
            layers = shard_gp_pair_layers(mesh, layers)
        gp = BatchedDenseGrandProduct(layers, spec, real_batch)
        gp.round_tail = mesh is None
        return gp

    def num_layers(self) -> int:
        return len(self.layers)

    def claims(self) -> list[FElt]:
        return _pair_claims(self.spec, self.layers[-1])[: self.real_batch]

    def _chain_ok(self) -> bool:
        return (backend.profile().chain and self.round_tail
                and not any(isinstance(lay, HostPairLayer)
                            for lay in self.layers)
                and self.real_batch == self.layers[0][0].shape[0])

    def prove(self, transcript: Transcript
              ) -> tuple[BatchedGrandProductProof, list[FElt]]:
        claims = self.claims()
        if self._chain_ok():
            from ..utils.profiling import span
            _B, _, _s = self.layers[0][0].shape
            _ops = sum((1 << j) * (_B * 7 + 4)
                       for j in range(len(self.layers) - 1))
            with span("BatchedDenseGP::chained", ops=_ops):
                pend, (state, _, _, _) = _chain_prove_dense(
                    self.spec, self.layers, transcript)
                comp_ints, row_ints = _chain_pull(self.spec, pend)
                layer_proofs, r_grand_product, _, _ = _chain_replay_dense(
                    self.spec, pend, comp_ints, row_ints, claims, transcript)
                _assert_chain_state(transcript, state)
            return BatchedGrandProductProof(layer_proofs), r_grand_product
        layer_proofs, r_grand_product, _ = _prove_dense_layers(
            self.spec, self.layers, claims, [], transcript,
            round_tail=self.round_tail)
        return BatchedGrandProductProof(layer_proofs), r_grand_product


def _chain_prove_dense(spec: FieldSpec, layers: list, transcript: Transcript):
    """Device-chained dense-layer rounds: enqueue EVERY layer's challenge
    vector, eq build, sumcheck rounds and claim appends on device with no
    host sync; returns (pend, ctx) for _chain_replay.

    pend: per-layer (k, [comp [L,3]] * k, inter [L, 2B]) device handles.
    ctx:  (state, nr, rs_dev [L, K+1], claims_dev [L, B]).
    """
    from . import fs_device as fsd

    n_layers = len(layers)
    B = layers[0][0].shape[0]
    K = n_layers - 1                      # max rounds = log2(leaf pair size)
    state, nr = fsd.state_to_device(transcript)
    top_l, top_r = layers[-1]
    claims_dev = fd.fmul(spec, jnp.moveaxis(top_l[..., 0], 0, 1),
                         jnp.moveaxis(top_r[..., 0], 0, 1))  # [L, B]
    rs_dev = fd.zeros(spec, (K + 1,))
    masked = backend.profile().masked_rounds
    fs_round = fsd.fs_cubic_round_jit(spec)
    pend = []
    for li in range(n_layers - 1, -1, -1):
        l, r = layers[li]
        layers[li] = None                 # release as consumed (HBM)
        k = n_layers - 1 - li             # rounds this layer
        _s = 1 << k                       # TRUE pair-side size (buffers
        #                                   are class-padded >= _s)
        coeffs, state, nr = fsd.challenge_vector_dev(
            spec, state, nr, B, np.int32(B))
        prev = fsd.fold_claims_dev(spec, claims_dev, coeffs)
        if masked:
            # per-class eq buffer: the layer's class size is its buffer
            C = l.shape[-1]
            Kc = C.bit_length() - 1
            eq = fsd.eq_masked_br(spec, rs_dev[:, :Kc], np.int32(k)) \
                if Kc > 0 else fd.ones(spec, (1,))
            evals_fn = lambda l_, r_, eq_, h_: _pair_cubic_evals_m_jit(
                spec, l_, r_, eq_, coeffs, np.int32(h_))
            bind_fn = lambda l_, r_, eq_, rj, h_: _pair_bind_m_jit(
                spec, l_, r_, eq_, rj, np.int32(h_))
        else:
            # shrinking kernels need exact-size tensors: slice the class
            # buffers to the active prefix (cheap XLA:CPU programs)
            if l.shape[-1] > _s:
                l, r = l[..., :_s], r[..., :_s]
            eq_full = fsd.eq_masked_br(spec, rs_dev[:, :K], np.int32(k)) \
                if K > 0 else fd.ones(spec, (1,))
            eq = eq_full[:, :_s] if K > 0 else eq_full
            evals_fn = lambda l_, r_, eq_, h_: _pair_cubic_evals(
                spec, l_, r_, eq_, coeffs)
            bind_fn = lambda l_, r_, eq_, rj, h_: _pair_bind(
                spec, l_, r_, eq_, rj)
        h = _s // 2
        comps = []
        rrounds = fd.zeros(spec, (K + 1,))
        for j in range(k):
            e023 = evals_fn(l, r, eq, h)
            comp, rj, prev, state, nr = fs_round(e023, prev, state, nr)
            l, r, eq = bind_fn(l, r, eq, rj, h)
            comps.append(comp)
            rrounds = fsd.set_col(rrounds, rj, np.int32(j))
            h //= 2
        lefts, rights, inter = fsd.pair_finals_dev(spec, l, r)
        state, nr = fsd.append_scalars_dev(spec, state, nr, inter,
                                           np.int32(2 * B))
        r_layer, state, nr = fsd.challenge_scalar_dev(spec, state, nr)
        claims_dev = fsd.fold_lr_dev(spec, lefts, rights, r_layer)
        rs_dev = fsd.rebuild_rs(rrounds, r_layer, np.int32(k))
        pend.append((k, comps, inter))
    return pend, (state, nr, rs_dev, claims_dev)


def _chain_pull(spec: FieldSpec, pend: list, extra_comps: list = (),
                extra_rows: list = ()):
    """One batched pull of every queued round poly + claim row.

    Returns (comp_ints iterator-indexable [T][3], row_ints [n_rows][...])."""
    all_comps = [c for (_, cs, _) in pend for c in cs] + list(extra_comps)
    rows = [it for (_, _, it) in pend] + list(extra_rows)
    comp_ints = fd.device_to_ints(
        spec, jnp.stack(all_comps, axis=1)).tolist() if all_comps else []
    # rows may differ in width (toggle claims) — group by width per stack
    row_ints = []
    for row in rows:
        row_ints.append(row)
    if row_ints:
        widths = {}
        for i, row in enumerate(row_ints):
            widths.setdefault(row.shape[-1], []).append(i)
        out = [None] * len(row_ints)
        for w, idxs in widths.items():
            stacked = fd.device_to_ints(
                spec, jnp.stack([row_ints[i] for i in idxs], axis=1))
            arr = stacked.tolist() if stacked.ndim > 1 else [stacked.tolist()]
            for i, vals in zip(idxs, arr):
                out[i] = [int(v) for v in vals]
        row_ints = out
    return comp_ints, row_ints


def _chain_replay_dense(spec: FieldSpec, pend: list, comp_ints, row_ints,
                        claims: list[FElt], transcript: Transcript):
    """Replay the dense layers through the HOST transcript, building the
    proof structure; transcript bytes are asserted against the device
    chain by the caller (state comparison)."""
    layer_proofs = []
    r_grand_product: list[FElt] = []
    idx = 0
    B = len(claims)
    for (k, _, _), inter in zip(pend, row_ints):
        transcript.challenge_vector(B)
        compressed, r_sumcheck = [], []
        for _ in range(k):
            cpoly = CompressedUniPoly(
                [FElt(int(v), spec) for v in comp_ints[idx]])
            idx += 1
            cpoly.append_to_transcript(transcript)
            r_sumcheck.append(transcript.challenge_scalar())
            compressed.append(cpoly)
        lefts = [FElt(int(inter[2 * b]), spec) for b in range(B)]
        rights = [FElt(int(inter[2 * b + 1]), spec) for b in range(B)]
        for lc, rc in zip(lefts, rights):
            transcript.append_scalar(lc)
            transcript.append_scalar(rc)
        r_layer = transcript.challenge_scalar()
        claims = [lc + r_layer * (rc - lc)
                  for lc, rc in zip(lefts, rights)]
        r_grand_product = list(reversed(r_sumcheck)) + [r_layer]
        layer_proofs.append(BatchedGrandProductLayerProof(
            SumcheckInstanceProof(compressed), lefts, rights))
    return layer_proofs, r_grand_product, claims, idx


def _assert_chain_state(transcript: Transcript, state_dev) -> None:
    dev = np.asarray(jax.device_get(state_dev)).astype("<u4").tobytes()
    assert dev == transcript.state, \
        "device Fiat-Shamir chain diverged from host transcript (GP chain)"


def _prove_dense_layers(spec: FieldSpec, layers: list[tuple],
                        claims: list[FElt], r_grand_product: list[FElt],
                        transcript: Transcript, round_tail: bool = True):
    """Prove multiplication-gate layers top-down (grand_product.rs:199-251).

    `layers` are (l, r) bit-reversed pairs, bottom-up.  Returns
    (layer_proofs, r_grand_product, claims) after folding each layer's
    left/right claims with a fresh challenge.
    """
    from ..utils.profiling import span

    layer_proofs: list[BatchedGrandProductLayerProof] = []
    n_real = len(claims)
    # canonical device-layer size: every device layer pads to the largest
    # so the masked round kernels compile exactly once per GP instance
    dev_sizes = [lay[0].shape[-1] for lay in layers
                 if not isinstance(lay, HostPairLayer)]
    s_canon = max(dev_sizes) if dev_sizes else None
    for li in range(len(layers) - 1, -1, -1):
        layer = layers[li]
        # release the tree's reference: each layer is consumed exactly once
        # (top-down), and freeing as we go halves the prover's peak HBM —
        # the leaves layer alone is ~0.5 GB at T = 2^17 (also makes the
        # bind donation below a true in-place update)
        layers[li] = None
        host_layer = isinstance(layer, HostPairLayer)
        if host_layer:
            _B, _s = layer.batch, layer.size
        else:
            l, r = layer
            _B, _, _s = l.shape
        # roofline accounting: per round at per-side size s, the cubic
        # evals cost h*(B*5+3) field muls and the bind h*(B*2+1), h = s/2
        # halving each round (grand_product.rs:335-396 mul counts)
        _ops = sum((_s >> (j + 1)) * (_B * 7 + 4)
                   for j in range(len(r_grand_product)))
        layer_span = span("BatchedDenseGP::layer", ops=_ops)
        layer_span.__enter__()
        coeffs = transcript.challenge_vector(len(claims))
        joint_claim = FElt(0, spec)
        for c, co in zip(claims, coeffs):
            joint_claim = joint_claim + c * co
        num_rounds = len(r_grand_product)

        r_sumcheck: list[FElt] = []
        compressed: list[CompressedUniPoly] = []
        if host_layer:
            # host-tail rounds: pure bigint arithmetic, zero dispatches;
            # identical round polys / transcript events mod p
            p = spec.p
            ll, rr = layer.l, layer.r
            eq_h = _eq_table_br_host(p, [x.v for x in r_grand_product])
            coeff_ints = [c.v for c in coeffs]
            previous_claim = joint_claim
            backend.note_offload(num_rounds)
            for _ in range(num_rounds):
                e0i, e2i, e3i = _host_cubic_evals(p, ll, rr, eq_h,
                                                  coeff_ints)
                e0, e2, e3 = (FElt(v, spec) for v in (e0i, e2i, e3i))
                round_poly = UniPoly.from_evals(
                    [e0, previous_claim - e0, e2, e3])
                cpoly = round_poly.compress()
                cpoly.append_to_transcript(transcript)
                r_j = transcript.challenge_scalar()
                r_sumcheck.append(r_j)
                ll = _host_bind(p, ll, r_j.v)
                rr = _host_bind(p, rr, r_j.v)
                eq_h = _host_bind(p, [eq_h], r_j.v)[0]
                previous_claim = round_poly.evaluate(r_j)
                compressed.append(cpoly)
            left_claims = [FElt(row[0], spec) for row in ll][:n_real]
            right_claims = [FElt(row[0], spec) for row in rr][:n_real]
            for lc, rc in zip(left_claims, right_claims):
                transcript.append_scalar(lc)
                transcript.append_scalar(rc)
            r_grand_product = list(reversed(r_sumcheck))
            r_layer = transcript.challenge_scalar()
            claims = [lc + r_layer * (rc - lc)
                      for lc, rc in zip(left_claims, right_claims)]
            r_grand_product.append(r_layer)
            layer_proofs.append(BatchedGrandProductLayerProof(
                SumcheckInstanceProof(compressed), left_claims,
                right_claims))
            layer_span.__exit__(None, None, None)
            continue

        # mesh zero-padding: pad rows get coefficient 0, so every round
        # evaluation is identical to the unpadded prover's (ONE packed
        # upload)
        coeffs_dev = fd.ints_to_device(
            spec, [c.v for c in coeffs] + [0] * (l.shape[0] - n_real))

        eq = eq_evals_device_br(spec, r_grand_product)

        # device rounds only while the per-side size is above the host-tail
        # threshold; the halving tail rounds run as host bigints (same as
        # the toggle layer) — identical transcript, and the per-(B, s) XLA
        # programs for every tiny shape disappear
        tail = 0 if not round_tail else backend.profile().host_tail
        dev_rounds = 0
        while dev_rounds < num_rounds and (_s >> dev_rounds) > tail:
            dev_rounds += 1

        # Canonical fixed shapes (masked rounds): pad this layer's tensors up to the
        # GP's largest device-layer size; the masked round kernels take
        # the active pair count h as a TRACED scalar, so ONE compiled
        # program serves every (layer, round) of this GP instance.
        # Otherwise the per-shape SHRINKING kernels run — transcripts
        # identical.
        masked = backend.profile().masked_rounds
        if masked and s_canon is not None:
            if _s < s_canon:
                l = _pad_last(spec, l, s_canon)
                r = _pad_last(spec, r, s_canon)
            if eq.shape[-1] < s_canon:
                eq = _pad_last(spec, eq, s_canon)
        h = _s // 2
        if masked:
            evals_fn = lambda l_, r_, eq_, h_: _pair_cubic_evals_m_jit(
                spec, l_, r_, eq_, coeffs_dev, np.int32(h_))
            bind_fn = lambda l_, r_, eq_, rj, h_: _pair_bind_m_jit(
                spec, l_, r_, eq_, rj, np.int32(h_))
        else:
            evals_fn = lambda l_, r_, eq_, h_: _pair_cubic_evals(
                spec, l_, r_, eq_, coeffs_dev)
            bind_fn = lambda l_, r_, eq_, rj, h_: _pair_bind(
                spec, l_, r_, eq_, rj)

        previous_claim = joint_claim
        if dev_rounds > 0 and backend.profile().device_fs:
            # device Fiat-Shamir: rounds chain through device arrays with
            # no host sync; a host replay of the transcript at the end
            # also validates the device keccak chain bit-for-bit
            from . import fs_device as fsd
            state_dev, nr_dev = fsd.state_to_device(transcript)
            prev_dev = fd.scalar_to_device(spec, joint_claim.v)
            fs_round = fsd.fs_cubic_round_jit(spec)
            comps = []
            for _ in range(dev_rounds):
                e023 = evals_fn(l, r, eq, h)
                comp, rj, prev_dev, state_dev, nr_dev = fs_round(
                    e023, prev_dev, state_dev, nr_dev)
                l, r, eq = bind_fn(l, r, eq, rj, h)
                comps.append(comp)
                h //= 2
            comp_ints = fd.device_to_ints(
                spec, jnp.stack(comps, axis=1))            # [rounds, 3]
            compressed, r_sumcheck = fsd.replay_and_check(
                spec, comp_ints, transcript, state_dev, CompressedUniPoly)
            for cpoly, r_j in zip(compressed, r_sumcheck):
                previous_claim = cpoly.eval_from_hint(previous_claim, r_j)
        else:
            for _ in range(dev_rounds):
                e023 = evals_fn(l, r, eq, h)
                ints = fd.device_to_ints(spec, e023).tolist()
                e0, e2, e3 = (FElt(int(v), spec) for v in ints)
                round_poly = UniPoly.from_evals(
                    [e0, previous_claim - e0, e2, e3])
                cpoly = round_poly.compress()
                cpoly.append_to_transcript(transcript)
                r_j = transcript.challenge_scalar()
                r_sumcheck.append(r_j)
                l, r, eq = bind_fn(l, r, eq,
                                   fd.scalar_to_device(spec, r_j.v), h)
                previous_claim = round_poly.evaluate(r_j)
                compressed.append(cpoly)
                h //= 2

        if dev_rounds < num_rounds:
            # host tail: pull the bound layer once (active prefix only —
            # the padded region is dead zeros), finish in bigints
            p = spec.p
            s_active = _s >> dev_rounds
            la = l[..., :s_active]
            ra = r[..., :s_active]
            ll = [[int(x) for x in row] for row in
                  fd.device_to_ints(spec, jnp.moveaxis(la, 1, 0)).tolist()]
            rr = [[int(x) for x in row] for row in
                  fd.device_to_ints(spec, jnp.moveaxis(ra, 1, 0)).tolist()]
            eq_h = [int(x) for x in
                    fd.device_to_ints(spec, eq[..., :s_active]).tolist()]
            coeff_ints = [c.v for c in coeffs] + [0] * (len(ll) - n_real)
            backend.note_offload(num_rounds - dev_rounds)
            for _ in range(num_rounds - dev_rounds):
                e0i, e2i, e3i = _host_cubic_evals(p, ll, rr, eq_h,
                                                  coeff_ints)
                e0, e2, e3 = (FElt(v, spec) for v in (e0i, e2i, e3i))
                round_poly = UniPoly.from_evals(
                    [e0, previous_claim - e0, e2, e3])
                cpoly = round_poly.compress()
                cpoly.append_to_transcript(transcript)
                r_j = transcript.challenge_scalar()
                r_sumcheck.append(r_j)
                ll = _host_bind(p, ll, r_j.v)
                rr = _host_bind(p, rr, r_j.v)
                eq_h = _host_bind(p, [eq_h], r_j.v)[0]
                previous_claim = round_poly.evaluate(r_j)
                compressed.append(cpoly)
            left_claims = [FElt(row[0], spec) for row in ll][:n_real]
            right_claims = [FElt(row[0], spec) for row in rr][:n_real]
        else:
            finals_l = fd.device_to_ints(spec, jnp.moveaxis(l, 0, 1)[..., 0])
            finals_r = fd.device_to_ints(spec, jnp.moveaxis(r, 0, 1)[..., 0])
            left_claims = [FElt(int(v), spec)
                           for v in finals_l.tolist()][:n_real]
            right_claims = [FElt(int(v), spec)
                            for v in finals_r.tolist()][:n_real]

        for lc, rc in zip(left_claims, right_claims):
            transcript.append_scalar(lc)
            transcript.append_scalar(rc)

        r_grand_product = list(reversed(r_sumcheck))
        r_layer = transcript.challenge_scalar()
        claims = [lc + r_layer * (rc - lc)
                  for lc, rc in zip(left_claims, right_claims)]
        r_grand_product.append(r_layer)

        layer_proofs.append(BatchedGrandProductLayerProof(
            SumcheckInstanceProof(compressed), left_claims, right_claims))
        layer_span.__exit__(None, None, None)
    return layer_proofs, r_grand_product, claims


# ---------------------------------------------------------------------------
# toggled grand product (Lasso read/write multisets, grand_product.rs:1049-1546)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=0)
def _toggle_values(spec: FieldSpec, flags: jnp.ndarray, fingerprints: jnp.ndarray
                   ) -> jnp.ndarray:
    """Toggle-gate outputs: flag * fp + 1 - flag; flags [L,m,T] broadcast to
    the read/write pairs of fingerprints [L,2m,T]."""
    f2 = jnp.repeat(flags, 2, axis=1)
    one = fd.ones(spec, f2.shape[1:])
    return fd.fadd(spec, fd.fmul(spec, f2, fingerprints), fd.fsub(spec, one, f2))


@partial(jax.jit, static_argnums=0)
def _toggle_cubic_evals(spec: FieldSpec, flags: jnp.ndarray,
                        fingerprints: jnp.ndarray, eq: jnp.ndarray,
                        coeffs: jnp.ndarray) -> jnp.ndarray:
    """Toggle-layer round evals at t = 0, 2, 3 (grand_product.rs:1216-1360).

    sum_b coeff_b * sum_i eq_t(i) * (flag_t(b,i) * fp_t(b,i) + 1 - flag_t(b,i));
    flags/fps/eq are BIT-REVERSED along the hypercube axis, so the sibling
    pairs (2i, 2i+1) are the contiguous halves; flags are per-memory (b//2).
    """
    f2 = jnp.repeat(flags, 2, axis=1)              # [L, 2m, T]
    h = f2.shape[-1] // 2
    one = fd.ones(spec, (f2.shape[1], h))

    def halves(t):
        return t[..., :h], t[..., h:]

    f0, f1 = halves(f2)
    p0, p1 = halves(fingerprints)
    e0, e1 = halves(eq)
    m_f = fd.fsub(spec, f1, f0)
    m_p = fd.fsub(spec, p1, p0)
    m_e = fd.fsub(spec, e1, e0)
    out = []
    ft, pt, et = f0, p0, e0
    for t in (0, 2, 3):
        if t == 2:
            ft = fd.fadd(spec, f1, m_f)
            pt = fd.fadd(spec, p1, m_p)
            et = fd.fadd(spec, e1, m_e)
        elif t == 3:
            ft = fd.fadd(spec, ft, m_f)
            pt = fd.fadd(spec, pt, m_p)
            et = fd.fadd(spec, et, m_e)
        gate = fd.fadd(spec, fd.fmul(spec, ft, pt), fd.fsub(spec, one, ft))
        weighted = fd.fmul(spec, _bcast_coeffs(coeffs, gate), gate)
        per_i = fd.fsum(spec, weighted, axis=0)            # [L, h]
        out.append(fd.fsum(spec, fd.fmul(spec, et, per_i), axis=-1))
    return jnp.stack(out, axis=1)


@partial(jax.jit, static_argnums=0)
def _toggle_bind(spec: FieldSpec, flags: jnp.ndarray, fingerprints: jnp.ndarray,
                 eq: jnp.ndarray, r: jnp.ndarray):
    """Bottom-bind flags/fingerprints/eq: contiguous halves (bit-rev)."""
    def bb(t):
        h = t.shape[-1] // 2
        lo, hi = t[..., :h], t[..., h:]
        rb = jnp.broadcast_to(r.reshape((fd.L,) + (1,) * (t.ndim - 1)), lo.shape)
        return fd.fadd(spec, lo, fd.fmul(spec, rb, fd.fsub(spec, hi, lo)))

    return bb(flags), bb(fingerprints), bb(eq)


def _toggle_cubic_evals_masked(spec: FieldSpec, flags, fingerprints, eq,
                               coeffs, h):
    """Masked toggle-layer round evals: tensors stay at full [.., T],
    active pairs (i, i+h), i < h (traced).  Only the eq factor needs the
    mask — inactive lanes' gates are killed by eq == 0 there."""
    f2 = jnp.repeat(flags, 2, axis=1)              # [L, 2m, T]
    H = f2.shape[-1] // 2
    one = fd.ones(spec, (f2.shape[1], H))

    def halves(t):
        return t[..., :H], jax.lax.dynamic_slice_in_dim(t, h, H, axis=-1)

    f0, f1 = halves(f2)
    p0, p1 = halves(fingerprints)
    e0, e1 = halves(eq)
    mask = jnp.arange(H, dtype=jnp.int32) < h
    m_f = fd.fsub(spec, f1, f0)
    m_p = fd.fsub(spec, p1, p0)
    m_e = fd.fsub(spec, e1, e0)
    out = []
    ft, pt, et = f0, p0, e0
    for t in (0, 2, 3):
        if t == 2:
            ft = fd.fadd(spec, f1, m_f)
            pt = fd.fadd(spec, p1, m_p)
            et = fd.fadd(spec, e1, m_e)
        elif t == 3:
            ft = fd.fadd(spec, ft, m_f)
            pt = fd.fadd(spec, pt, m_p)
            et = fd.fadd(spec, et, m_e)
        gate = fd.fadd(spec, fd.fmul(spec, ft, pt), fd.fsub(spec, one, ft))
        weighted = fd.fmul(spec, _bcast_coeffs(coeffs, gate), gate)
        per_i = fd.fsum(spec, weighted, axis=0)            # [L, H]
        masked_e = jnp.where(mask, et, jnp.uint32(0))
        out.append(fd.fsum(spec, fd.fmul(spec, masked_e, per_i), axis=-1))
    return jnp.stack(out, axis=1)


def _toggle_bind_masked(spec: FieldSpec, flags, fingerprints, eq, r, h):
    mask = None

    def bb(t):
        nonlocal mask
        H = t.shape[-1] // 2
        if mask is None:
            mask = jnp.arange(H, dtype=jnp.int32) < h
        lo = t[..., :H]
        hi = jax.lax.dynamic_slice_in_dim(t, h, H, axis=-1)
        rb = jnp.broadcast_to(r.reshape((fd.L,) + (1,) * (t.ndim - 1)),
                              lo.shape)
        bound = fd.fadd(spec, lo, fd.fmul(spec, rb, fd.fsub(spec, hi, lo)))
        bound = jnp.where(mask, bound, jnp.uint32(0))
        return jnp.concatenate([bound, jnp.zeros_like(bound)], axis=-1)

    return bb(flags), bb(fingerprints), bb(eq)


_toggle_cubic_evals_m_jit = jax.jit(_toggle_cubic_evals_masked,
                                    static_argnums=0)
_toggle_bind_m_jit = jax.jit(_toggle_bind_masked, static_argnums=0)


@partial(jax.jit, static_argnums=0)
def _toggle_values_bits(spec: FieldSpec, bits: jnp.ndarray,
                        fingerprints: jnp.ndarray) -> jnp.ndarray:
    """Toggle-gate outputs from BIT-PACKED flags [m, T]: flag values are
    0/1, so flag*fp + 1 - flag == where(bit, fp, 1)."""
    b2 = jnp.repeat(bits, 2, axis=0)                 # [2m, T]
    one = fd.ones(spec, fingerprints.shape[1:])
    return jnp.where(b2[None], fingerprints, one)


@partial(jax.jit, static_argnums=0)
def _expand_flag_bits(spec: FieldSpec, bits: jnp.ndarray) -> jnp.ndarray:
    """[m, T] bool -> Montgomery 0/1 limb tensor [L, m, T]."""
    one = fd.ones(spec, bits.shape)
    return jnp.where(bits[None], one, jnp.uint32(0))


def _host_toggle_cubic_evals(p: int, flags: list, fps: list, eq: list,
                             coeffs: list[int]):
    """Mirror of _toggle_cubic_evals on host ints: flags[m][s], fps[2m][s],
    eq[s] -> (e0, e2, e3).  Batch entry b uses flag row b // 2."""
    h = len(eq) // 2
    e0 = e2 = e3 = 0
    for i in range(h):
        s0 = s2 = s3 = 0
        for b, c in enumerate(coeffs):
            f0 = flags[b // 2][i]
            f1 = flags[b // 2][i + h]
            mf = f1 - f0
            p0 = fps[b][i]
            p1 = fps[b][i + h]
            mp = p1 - p0
            g0 = f0 * p0 + 1 - f0
            fe2 = f1 + mf
            pe2 = p1 + mp
            g2 = fe2 * pe2 + 1 - fe2
            fe3 = fe2 + mf
            pe3 = pe2 + mp
            g3 = fe3 * pe3 + 1 - fe3
            s0 += c * (g0 % p)
            s2 += c * (g2 % p)
            s3 += c * (g3 % p)
        eq1 = eq[i + h]
        meq = eq1 - eq[i]
        eqe2 = eq1 + meq
        e0 += eq[i] * (s0 % p)
        e2 += eqe2 * (s2 % p)
        e3 += (eqe2 + meq) * (s3 % p)
    return e0 % p, e2 % p, e3 % p


class ToggledBatchedGrandProduct:
    """Flag-gated grand product: bottom layer computes flag*fp + 1 - flag.

    The reference uses sparse flag-index lists (grand_product.rs:1049-1421);
    here flags are DENSE 0/1 Montgomery tensors — masked dense compute with
    identical transcript bytes.
    """

    def __init__(self, flags: jnp.ndarray, fingerprints: jnp.ndarray,
                 spec: FieldSpec | None = None, mesh=None):
        """`flags` is either a Montgomery [L, m, T] tensor OR a bit-packed
        [m, T] u8/bool array.  Bits are ~36x smaller in HBM (the flags of
        a T=2^17 trace cost 254 MB as limb tensors); the Montgomery
        expansion for the toggle rounds is deferred to prove() — after the
        dense layers are proved and released, past the construction-time
        HBM peak."""
        self.spec = spec or fr_spec()
        self.mesh = mesh
        if flags.ndim == 2:                     # bit-packed
            bits = jnp.asarray(flags).astype(bool)
            self._flag_bits = _bitrev_last(self.spec, bits)
            self.flags = None                   # expanded lazily in prove
            values = _toggle_values_bits(self.spec, bits, fingerprints)
        else:
            self._flag_bits = None
            self.flags = _bitrev_last(self.spec, flags)          # [L, m, T]
            values = _toggle_values(self.spec, flags, fingerprints)
        self.fingerprints = _bitrev_last(self.spec, fingerprints)  # [L, 2m, T]
        self.real_batch = values.shape[1]
        self.layers = _build_pair_tree(self.spec, values,
                                       host_tail=0 if mesh is not None
                                       else None)
        if mesh is not None:
            # dense layers shard on the BATCH axis; the toggle-round tensors
            # shard on the HYPERCUBE axis T (the toggle rounds' work scales
            # with T, not the 2m batch — SURVEY §2.8)
            from ..parallel.sharding import (maybe_shard_hypercube,
                                             shard_gp_pair_layers)
            self.layers = shard_gp_pair_layers(mesh, self.layers)
            if self.flags is not None:
                self.flags = maybe_shard_hypercube(mesh, self.flags)
            else:
                self._flag_bits = maybe_shard_hypercube(mesh,
                                                        self._flag_bits)
            self.fingerprints = maybe_shard_hypercube(mesh, self.fingerprints)

    @staticmethod
    def construct(leaves, spec: FieldSpec | None = None, mesh=None):
        flags, fingerprints = leaves
        return ToggledBatchedGrandProduct(flags, fingerprints, spec,
                                          mesh=mesh)

    def claims(self) -> list[FElt]:
        return _pair_claims(self.spec, self.layers[-1])[: self.real_batch]

    def _chain_ok(self) -> bool:
        return (backend.profile().chain and self.mesh is None
                and not any(isinstance(lay, HostPairLayer)
                            for lay in self.layers))

    def _prove_chained(self, transcript: Transcript, claims: list[FElt]
                       ) -> tuple[BatchedGrandProductProof, list[FElt]]:
        """Device-chained prove: dense layers + toggle rounds enqueue with
        no host sync; ONE pull + host transcript replay at the end."""
        from . import fs_device as fsd
        from ..utils.profiling import span

        spec = self.spec
        m = self.real_batch
        T = self.fingerprints.shape[-1]
        k_toggle = T.bit_length() - 1
        _ops = (sum((1 << j) * (m * 7 + 4) for j in range(k_toggle - 1))
                + 2 * T * (m * 8 + 4))
        with span("ToggledGP::chained", ops=_ops):
            pend, (state, nr, rs_dev, claims_dev) = _chain_prove_dense(
                spec, self.layers, transcript)
            # toggle rounds (grand_product.rs:1422-1474): log T rounds,
            # claims appended per (flag, fingerprint) pair, NO r_layer
            coeffs_dev, state, nr = fsd.challenge_vector_dev(
                spec, state, nr, m, np.int32(m))
            prev = fsd.fold_claims_dev(spec, claims_dev, coeffs_dev)
            eq = fsd.eq_masked_br(spec, rs_dev, np.int32(k_toggle))
            if self.flags is None:
                self.flags = _expand_flag_bits(spec, self._flag_bits)
            flags, fps = self.flags, self.fingerprints
            masked = backend.profile().masked_rounds
            if masked:
                evals_fn = lambda f_, p_, e_, h_: _toggle_cubic_evals_m_jit(
                    spec, f_, p_, e_, coeffs_dev, np.int32(h_))
                bind_fn = lambda f_, p_, e_, rj, h_: _toggle_bind_m_jit(
                    spec, f_, p_, e_, rj, np.int32(h_))
            else:
                evals_fn = lambda f_, p_, e_, h_: _toggle_cubic_evals(
                    spec, f_, p_, e_, coeffs_dev)
                bind_fn = lambda f_, p_, e_, rj, h_: _toggle_bind(
                    spec, f_, p_, e_, rj)
            fs_round = fsd.fs_cubic_round_jit(spec)
            h = T // 2
            toggle_comps = []
            for _ in range(k_toggle):
                e023 = evals_fn(flags, fps, eq, h)
                comp, rj, prev, state, nr = fs_round(e023, prev, state, nr)
                flags, fps, eq = bind_fn(flags, fps, eq, rj, h)
                toggle_comps.append(comp)
                h //= 2
            inter = fsd.toggle_finals_dev(spec, flags, fps)
            state, nr = fsd.append_scalars_dev(spec, state, nr, inter,
                                               np.int32(2 * m))

            comp_ints, row_ints = _chain_pull(
                spec, pend, extra_comps=toggle_comps, extra_rows=[inter])
            layer_proofs, _, _, idx = _chain_replay_dense(
                spec, pend, comp_ints, row_ints[:-1], claims, transcript)
            # toggle replay
            transcript.challenge_vector(m)
            compressed, r_sumcheck = [], []
            for _ in range(k_toggle):
                cpoly = CompressedUniPoly(
                    [FElt(int(v), spec) for v in comp_ints[idx]])
                idx += 1
                cpoly.append_to_transcript(transcript)
                r_sumcheck.append(transcript.challenge_scalar())
                compressed.append(cpoly)
            inter_row = row_ints[-1]
            left_claims = [FElt(int(inter_row[2 * b]), spec)
                           for b in range(m)]
            right_claims = [FElt(int(inter_row[2 * b + 1]), spec)
                            for b in range(m)]
            for lc, rc in zip(left_claims, right_claims):
                transcript.append_scalar(lc)
                transcript.append_scalar(rc)
            _assert_chain_state(transcript, state)
            r_grand_product = list(reversed(r_sumcheck))
            layer_proofs.append(BatchedGrandProductLayerProof(
                SumcheckInstanceProof(compressed), left_claims,
                right_claims))
        return BatchedGrandProductProof(layer_proofs), r_grand_product

    def prove(self, transcript: Transcript
              ) -> tuple[BatchedGrandProductProof, list[FElt]]:
        spec = self.spec
        claims = self.claims()
        if self._chain_ok():
            return self._prove_chained(transcript, claims)
        layer_proofs, r_grand_product, claims = _prove_dense_layers(
            spec, self.layers, claims, [], transcript,
            round_tail=self.mesh is None)

        # toggle layer (grand_product.rs:1422-1474): log T rounds, no r_layer
        coeffs = transcript.challenge_vector(len(claims))
        joint_claim = FElt(0, spec)
        for c, co in zip(claims, coeffs):
            joint_claim = joint_claim + c * co
        coeffs_dev = fd.ints_to_device(spec, [c.v for c in coeffs])
        eq = eq_evals_device_br(spec, r_grand_product)

        if self.flags is None:   # bit-packed: expand past the HBM peak
            self.flags = _expand_flag_bits(spec, self._flag_bits)
        flags, fps = self.flags, self.fingerprints
        r_sumcheck: list[FElt] = []
        compressed: list[CompressedUniPoly] = []
        num_rounds = len(r_grand_product)
        # device rounds while the hypercube axis is above the host-tail
        # threshold; the tiny tail rounds run as host bigints (identical
        # transcript, no per-shape XLA programs — see module comment)
        size = flags.shape[-1]
        tail = 0 if self.mesh is not None else backend.profile().host_tail
        dev_rounds = 0
        while dev_rounds < num_rounds and (size >> dev_rounds) > tail:
            dev_rounds += 1
        previous_claim = joint_claim
        h = size // 2
        if backend.profile().masked_rounds:
            evals_fn = lambda f_, p_, e_, h_: _toggle_cubic_evals_m_jit(
                spec, f_, p_, e_, coeffs_dev, np.int32(h_))
            bind_fn = lambda f_, p_, e_, rj, h_: _toggle_bind_m_jit(
                spec, f_, p_, e_, rj, np.int32(h_))
        else:
            evals_fn = lambda f_, p_, e_, h_: _toggle_cubic_evals(
                spec, f_, p_, e_, coeffs_dev)
            bind_fn = lambda f_, p_, e_, rj, h_: _toggle_bind(
                spec, f_, p_, e_, rj)
        if dev_rounds > 0 and backend.profile().device_fs:
            from . import fs_device as fsd
            state_dev, nr_dev = fsd.state_to_device(transcript)
            prev_dev = fd.scalar_to_device(spec, joint_claim.v)
            fs_round = fsd.fs_cubic_round_jit(spec)
            comps = []
            for _ in range(dev_rounds):
                e023 = evals_fn(flags, fps, eq, h)
                comp, rj, prev_dev, state_dev, nr_dev = fs_round(
                    e023, prev_dev, state_dev, nr_dev)
                flags, fps, eq = bind_fn(flags, fps, eq, rj, h)
                comps.append(comp)
                h //= 2
            comp_ints = fd.device_to_ints(spec, jnp.stack(comps, axis=1))
            compressed, r_sumcheck = fsd.replay_and_check(
                spec, comp_ints, transcript, state_dev, CompressedUniPoly)
            for cpoly, r_j in zip(compressed, r_sumcheck):
                previous_claim = cpoly.eval_from_hint(previous_claim, r_j)
        else:
            for _ in range(dev_rounds):
                e023 = evals_fn(flags, fps, eq, h)
                ints = fd.device_to_ints(spec, e023).tolist()
                e0, e2, e3 = (FElt(int(v), spec) for v in ints)
                round_poly = UniPoly.from_evals(
                    [e0, previous_claim - e0, e2, e3])
                cpoly = round_poly.compress()
                cpoly.append_to_transcript(transcript)
                r_j = transcript.challenge_scalar()
                r_sumcheck.append(r_j)
                flags, fps, eq = bind_fn(flags, fps, eq,
                                         fd.scalar_to_device(spec, r_j.v), h)
                previous_claim = round_poly.evaluate(r_j)
                compressed.append(cpoly)
                h //= 2

        if dev_rounds < num_rounds:
            # host tail: pull the active prefix once, finish in bigints
            p = spec.p
            s_active = size >> dev_rounds
            flags_h = [[int(x) for x in row] for row in fd.device_to_ints(
                spec, flags[..., :s_active]).tolist()]
            fps_h = [[int(x) for x in row] for row in fd.device_to_ints(
                spec, fps[..., :s_active]).tolist()]
            eq_h = [int(x) for x in fd.device_to_ints(
                spec, eq[..., :s_active]).tolist()]
            coeff_ints = [c.v for c in coeffs]
            backend.note_offload(num_rounds - dev_rounds)
            for _ in range(num_rounds - dev_rounds):
                e0i, e2i, e3i = _host_toggle_cubic_evals(
                    p, flags_h, fps_h, eq_h, coeff_ints)
                e0, e2, e3 = (FElt(v, spec) for v in (e0i, e2i, e3i))
                round_poly = UniPoly.from_evals(
                    [e0, previous_claim - e0, e2, e3])
                cpoly = round_poly.compress()
                cpoly.append_to_transcript(transcript)
                r_j = transcript.challenge_scalar()
                r_sumcheck.append(r_j)
                flags_h = _host_bind(p, flags_h, r_j.v)
                fps_h = _host_bind(p, fps_h, r_j.v)
                eq_h = _host_bind(p, [eq_h], r_j.v)[0]
                previous_claim = round_poly.evaluate(r_j)
                compressed.append(cpoly)
            flag_vals = [row[0] for row in flags_h]
            fp_vals = [row[0] for row in fps_h]
        else:
            flag_vals = fd.device_to_ints(spec, flags[..., 0]).tolist()
            fp_vals = fd.device_to_ints(spec, fps[..., 0]).tolist()
        left_claims = [FElt(int(flag_vals[b // 2]), spec)
                       for b in range(len(fp_vals))]
        right_claims = [FElt(int(v), spec) for v in fp_vals]
        for lc, rc in zip(left_claims, right_claims):
            transcript.append_scalar(lc)
            transcript.append_scalar(rc)

        r_grand_product = list(reversed(r_sumcheck))
        layer_proofs.append(BatchedGrandProductLayerProof(
            SumcheckInstanceProof(compressed), left_claims, right_claims))
        return BatchedGrandProductProof(layer_proofs), r_grand_product


def toggled_verify_sumcheck_claim(layer_proof, coeffs, sumcheck_claim, eq_eval,
                                  claims, r_grand_product, transcript,
                                  layer_index: int, num_layers: int):
    """Toggled GP claim check (grand_product.rs:1486-1546)."""
    spec = sumcheck_claim.spec
    one = FElt(1, spec)
    if layer_index != num_layers - 1:
        return default_verify_sumcheck_claim(
            layer_proof, coeffs, sumcheck_claim, eq_eval, claims,
            r_grand_product, transcript, layer_index, num_layers)
    expected = FElt(0, spec)
    for co, fl, fp in zip(coeffs, layer_proof.left_claims,
                          layer_proof.right_claims):
        expected = expected + co * eq_eval * (fl * fp + one - fl)
    assert expected == sumcheck_claim, "toggle layer claim mismatch"
    new_claims = [fl * fp + one - fl
                  for fl, fp in zip(layer_proof.left_claims,
                                    layer_proof.right_claims)]
    return new_claims, r_grand_product


# ---------------------------------------------------------------------------
# verifier (host)
# ---------------------------------------------------------------------------

def default_verify_sumcheck_claim(layer_proof: BatchedGrandProductLayerProof,
                                  coeffs: list[FElt], sumcheck_claim: FElt,
                                  eq_eval: FElt, claims: list[FElt],
                                  r_grand_product: list[FElt],
                                  transcript: Transcript,
                                  layer_index: int = 0, num_layers: int = 0
                                  ) -> tuple[list[FElt], list[FElt]]:
    """Multiplication-gate layer claim check (grand_product.rs:89-122)."""
    spec = sumcheck_claim.spec
    expected = FElt(0, spec)
    for co, lc, rc in zip(coeffs, layer_proof.left_claims,
                          layer_proof.right_claims):
        expected = expected + co * lc * rc * eq_eval
    assert expected == sumcheck_claim, "grand product layer claim mismatch"

    r_layer = transcript.challenge_scalar()
    new_claims = [lc + r_layer * (rc - lc)
                  for lc, rc in zip(layer_proof.left_claims,
                                    layer_proof.right_claims)]
    return new_claims, r_grand_product + [r_layer]


def verify_grand_product(proof: BatchedGrandProductProof,
                         claims: Sequence[FElt],
                         transcript: Transcript,
                         r_start: Sequence[FElt] = (),
                         verify_sumcheck_claim: Callable = default_verify_sumcheck_claim,
                         ) -> tuple[list[FElt], list[FElt]]:
    """Layer-by-layer verification (grand_product.rs:122-182).

    Returns (final claims = leaf-MLE evaluations, r_grand_product).
    """
    claims_to_verify = list(claims)
    r_grand_product = list(r_start)
    fixed_at_start = len(r_start)
    spec = claims_to_verify[0].spec
    one = FElt(1, spec)

    for layer_index, layer_proof in enumerate(proof.layers):
        coeffs = transcript.challenge_vector(len(claims_to_verify))
        joint_claim = FElt(0, spec)
        for c, co in zip(claims_to_verify, coeffs):
            joint_claim = joint_claim + c * co

        sumcheck_claim, r_sumcheck = layer_proof.proof.verify(
            joint_claim, layer_index + fixed_at_start, 3, transcript)
        assert len(claims_to_verify) == len(layer_proof.left_claims)

        for lc, rc in zip(layer_proof.left_claims, layer_proof.right_claims):
            transcript.append_scalar(lc)
            transcript.append_scalar(rc)

        assert len(r_grand_product) == len(r_sumcheck)
        eq_eval = one
        for r_gp, r_sc in zip(r_grand_product, reversed(r_sumcheck)):
            eq_eval = eq_eval * (r_gp * r_sc + (one - r_gp) * (one - r_sc))

        r_grand_product = list(reversed(r_sumcheck))
        claims_to_verify, r_grand_product = verify_sumcheck_claim(
            layer_proof, coeffs, sumcheck_claim, eq_eval, claims_to_verify,
            r_grand_product, transcript, layer_index, len(proof.layers))

    return claims_to_verify, r_grand_product
