"""Batched opening reduction (reference: poly/opening_proof.rs:1-665).

Many openings (polynomial, point, claim) accumulate over the course of a
proof; one batching sumcheck reduces them to a single PCS opening:

  prover append:   rho-powers RLC of same-point polynomials (device kernel)
  reduce_and_prove: quadratic sumcheck over sum_i coeff_i * P_i(x) * eq_i(x)
                    (smaller polynomials enter late, scaled by 2^remaining),
                    then gamma-powers joint polynomial opened once with the PCS
  verifier mirror:  homomorphic commitment combination + claim checks
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp

from .. import backend
from ..field import FElt, FieldSpec, fr_spec
from ..field import device as fd
from ..poly.mle import bind_top, eq_evals_device, eq_evaluate_host
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..subprotocols.sumcheck import SumcheckInstanceProof
from ..transcript import Transcript


@partial(jax.jit, static_argnums=0)
def _rlc(spec: FieldSpec, polys: tuple[jnp.ndarray, ...],
         coeffs: jnp.ndarray) -> jnp.ndarray:
    """sum_i coeffs[i] * polys[i]; coeffs [L, B]; same-length polys."""
    out = None
    for i, p in enumerate(polys):
        term = fd.fmul(spec, jnp.broadcast_to(coeffs[:, i][:, None], p.shape), p)
        out = term if out is None else fd.fadd(spec, out, term)
    return out


def rlc_polys(spec: FieldSpec, polys: Sequence[jnp.ndarray],
              coeffs: Sequence[FElt], pad_to: int | None = None) -> jnp.ndarray:
    """Host wrapper: RLC of device polys (zero-padding shorter ones at the tail)."""
    n = pad_to or max(p.shape[-1] for p in polys)
    padded = []
    for p in polys:
        if p.shape[-1] < n:
            p = jnp.concatenate(
                [p, jnp.zeros(p.shape[:-1] + (n - p.shape[-1],), dtype=p.dtype)],
                axis=-1)
        padded.append(p)
    coeffs_dev = fd.ints_to_device(spec, [c.v for c in coeffs])
    return _rlc(spec, tuple(padded), coeffs_dev)


@partial(jax.jit, static_argnums=0)
def _reduction_round_fs(spec: FieldSpec, k: int, polys, eqs, coeffs_k,
                        inact, prev, state, nr):
    """One batch-reduction sumcheck round with the device transcript:
    quadratic evals of the k active (poly, eq) pairs + the host-constant
    contribution of not-yet-active claims, then append/challenge/bind."""
    from ..subprotocols import fs_device as fsd
    ev0, ev2 = inact, inact
    for p, q, c in zip(polys, eqs, coeffs_k):
        pair = _quadratic_evals(spec, p, q)
        ev0 = fd.fadd(spec, ev0, fd.fmul(spec, c, pair[:, 0]))
        ev2 = fd.fadd(spec, ev2, fd.fmul(spec, c, pair[:, 1]))
    e1 = fd.fsub(spec, prev, ev0)
    coeffs3 = fsd.interpolate(spec, [ev0, e1, ev2])
    comp, rj, state, nr = fsd.fs_append_round(spec, coeffs3, state, nr)
    prev = fsd.horner(spec, coeffs3, rj)
    polys = tuple(bind_top(spec, p, rj) for p in polys)
    eqs = tuple(bind_top(spec, q, rj) for q in eqs)
    return comp, polys, eqs, prev, state, nr


import functools as _functools


@_functools.lru_cache(maxsize=None)
def _reduction_round_fs_jit(spec: FieldSpec, k: int):
    return jax.jit(partial(_reduction_round_fs, spec, k))


def _pad_to(t: jnp.ndarray, n: int) -> jnp.ndarray:
    """Zero-pad the last axis to n."""
    if t.shape[-1] == n:
        return t
    return jnp.concatenate(
        [t, jnp.zeros(t.shape[:-1] + (n - t.shape[-1],), dtype=t.dtype)],
        axis=-1)


def _reduction_round_fs_masked(spec: FieldSpec, stack_p, stack_e, coeffs,
                               amask, inact, prev, state, nr, h):
    """Stacked masked batch-reduction round (fixed shapes, traced h).

    stack_p/stack_e: [L, P, N]; coeffs: [L, P]; amask: [P] bool (polys
    active this round); inact: [L] host-constant contribution of inactive
    claims.  Active polys share active length 2h; inactive rows pass
    through the bind untouched.  One compiled program per (P, N)."""
    from ..subprotocols import fs_device as fsd
    H = stack_p.shape[-1] // 2
    mask = jnp.arange(H, dtype=jnp.int32) < h
    zero = jnp.uint32(0)

    p_lo, e_lo = stack_p[..., :H], stack_e[..., :H]
    p_hi = jax.lax.dynamic_slice_in_dim(stack_p, h, H, axis=-1)
    e_hi = jax.lax.dynamic_slice_in_dim(stack_e, h, H, axis=-1)
    s0 = fd.fsum(spec, jnp.where(mask, fd.fmul(spec, p_lo, e_lo), zero),
                 axis=-1)                                   # [L, P]
    p2 = fd.fadd(spec, p_hi, fd.fsub(spec, p_hi, p_lo))
    e2 = fd.fadd(spec, e_hi, fd.fsub(spec, e_hi, e_lo))
    s2 = fd.fsum(spec, jnp.where(mask, fd.fmul(spec, p2, e2), zero),
                 axis=-1)
    cs0 = jnp.where(amask, fd.fmul(spec, coeffs, s0), zero)
    cs2 = jnp.where(amask, fd.fmul(spec, coeffs, s2), zero)
    ev0 = fd.fadd(spec, inact, fd.fsum(spec, cs0, axis=-1))
    ev2 = fd.fadd(spec, inact, fd.fsum(spec, cs2, axis=-1))

    e1 = fd.fsub(spec, prev, ev0)
    coeffs3 = fsd.interpolate(spec, [ev0, e1, ev2])
    comp, rj, state, nr = fsd.fs_append_round(spec, coeffs3, state, nr)
    prev = fsd.horner(spec, coeffs3, rj)

    rb = jnp.broadcast_to(rj.reshape((fd.L, 1, 1)), p_lo.shape)
    bp = fd.fadd(spec, p_lo, fd.fmul(spec, rb, fd.fsub(spec, p_hi, p_lo)))
    be = fd.fadd(spec, e_lo, fd.fmul(spec, rb, fd.fsub(spec, e_hi, e_lo)))
    # active rows: bound prefix (< h) + zeros; inactive rows: untouched
    arow = amask[None, :, None]
    new_p = jnp.where(arow, jnp.where(mask, bp, zero), p_lo)
    new_e = jnp.where(arow, jnp.where(mask, be, zero), e_lo)
    top_p = jnp.where(amask[None, :, None], zero, stack_p[..., H:])
    top_e = jnp.where(amask[None, :, None], zero, stack_e[..., H:])
    stack_p = jnp.concatenate([new_p, top_p], axis=-1)
    stack_e = jnp.concatenate([new_e, top_e], axis=-1)
    return comp, stack_p, stack_e, prev, state, nr


@_functools.lru_cache(maxsize=None)
def _reduction_round_fs_m_jit(spec: FieldSpec):
    return jax.jit(partial(_reduction_round_fs_masked, spec))


def _quadratic_evals(spec: FieldSpec, poly: jnp.ndarray, eq: jnp.ndarray
                     ) -> jnp.ndarray:
    """(eval_0, eval_2) of sum_x P(t,x)*eq(t,x) -> [L, 2]."""
    n = poly.shape[-1]
    p_lo, p_hi = poly[..., : n // 2], poly[..., n // 2:]
    e_lo, e_hi = eq[..., : n // 2], eq[..., n // 2:]
    ev0 = fd.fsum(spec, fd.fmul(spec, p_lo, e_lo), axis=-1)
    p2 = fd.fadd(spec, p_hi, fd.fsub(spec, p_hi, p_lo))
    e2 = fd.fadd(spec, e_hi, fd.fsub(spec, e_hi, e_lo))
    ev2 = fd.fsum(spec, fd.fmul(spec, p2, e2), axis=-1)
    return jnp.stack([ev0, ev2], axis=1)


@dataclass
class ProverOpening:
    polynomial: jnp.ndarray      # [L, n] device RLC polynomial
    eq_poly: jnp.ndarray         # [L, n] eq(x, opening_point)
    opening_point: list[FElt]
    claim: FElt
    batch: list[jnp.ndarray]     # individual polynomials (test oracle)


@dataclass
class ReducedOpeningProof:
    sumcheck_proof: SumcheckInstanceProof
    sumcheck_claims: list[FElt]
    joint_opening_proof: object


class ProverOpeningAccumulator:
    def __init__(self, spec: FieldSpec | None = None):
        self.spec = spec or fr_spec()
        self.openings: list[ProverOpening] = []

    def __len__(self):
        return len(self.openings)

    def append(self, polynomials: Sequence[jnp.ndarray], eq_poly: jnp.ndarray,
               opening_point: Sequence[FElt], claims: Sequence[FElt],
               transcript: Transcript) -> None:
        """RLC-batch same-point openings with rho powers (opening_proof.rs:142-213)."""
        assert len(polynomials) == len(claims)
        spec = self.spec
        rho_powers = transcript.challenge_scalar_powers(len(polynomials))
        batched_claim = FElt(0, spec)
        for rp, c in zip(rho_powers, claims):
            batched_claim = batched_claim + rp * c
        batched_poly = rlc_polys(spec, polynomials, rho_powers)
        self.openings.append(ProverOpening(
            batched_poly, eq_poly, list(opening_point), batched_claim,
            list(polynomials)))

    def prove_batch_opening_reduction(self, coeffs: list[FElt],
                                      transcript: Transcript):
        spec = self.spec
        max_num_vars = max(len(o.opening_point) for o in self.openings)
        zero = FElt(0, spec)

        e = zero
        for co, o in zip(coeffs, self.openings):
            scaled = o.claim
            diff = max_num_vars - len(o.opening_point)
            if diff:
                scaled = FElt(1 << diff, spec) * scaled
            e = e + scaled * co

        if backend.profile().device_fs:
            return self._prove_reduction_device_fs(coeffs, e, max_num_vars,
                                                   transcript)

        r: list[FElt] = []
        compressed: list[CompressedUniPoly] = []
        bound: list[jnp.ndarray | None] = [None] * len(self.openings)
        bound_eq: list[jnp.ndarray] = [o.eq_poly for o in self.openings]

        for rnd in range(max_num_vars):
            remaining = max_num_vars - rnd
            ev0 = zero
            ev2 = zero
            for i, o in enumerate(self.openings):
                if remaining <= len(o.opening_point):
                    poly = bound[i] if bound[i] is not None else o.polynomial
                    pair = fd.device_to_ints(
                        spec, _quadratic_evals(spec, poly, bound_eq[i])).tolist()
                    ev0 = ev0 + coeffs[i] * FElt(int(pair[0]), spec)
                    ev2 = ev2 + coeffs[i] * FElt(int(pair[1]), spec)
                else:
                    rem_vars = remaining - len(o.opening_point) - 1
                    scaled = FElt(1 << rem_vars, spec) * o.claim * coeffs[i]
                    ev0 = ev0 + scaled
                    ev2 = ev2 + scaled
            round_poly = UniPoly.from_evals([ev0, e - ev0, ev2])
            cpoly = round_poly.compress()
            cpoly.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar()
            r.append(r_j)
            r_dev = fd.scalar_to_device(spec, r_j.v)
            for i, o in enumerate(self.openings):
                if remaining <= len(o.opening_point):
                    src = bound[i] if bound[i] is not None else o.polynomial
                    bound[i] = bind_top(spec, src, r_dev)
                    bound_eq[i] = bind_top(spec, bound_eq[i], r_dev)
            e = round_poly.evaluate(r_j)
            compressed.append(cpoly)

        claims = [FElt(fd.to_int(spec, b[..., 0]), spec)
                  for b in bound]
        return SumcheckInstanceProof(compressed), r, claims

    def _prove_reduction_device_fs(self, coeffs: list[FElt], e: FElt,
                                   max_num_vars: int,
                                   transcript: Transcript):
        """Batch-reduction sumcheck with the Fiat-Shamir chain on device
        (subprotocols/fs_device.py): rounds enqueue without host syncs;
        per-round not-yet-active claim contributions are host constants
        folded in as device scalars.  Byte-identical transcript."""
        spec = self.spec
        from ..subprotocols import fs_device as fsd
        from ..subprotocols.grand_product import _host_bind
        # device rounds while the active polynomials are above the
        # host-tail threshold; the remaining rounds run as host bigints
        # (identical transcript bytes, no per-shape XLA programs for the
        # long tail of tiny shapes)
        prof = backend.profile()
        tail = 0 if (getattr(self, "_mesh", None) is not None
                     or prof.masked_rounds) else prof.host_tail
        dev_rounds = max_num_vars
        if tail:
            dev_rounds = 0
            while dev_rounds < max_num_vars and \
                    (1 << (max_num_vars - dev_rounds)) > tail:
                dev_rounds += 1
        import numpy as np
        compressed: list[CompressedUniPoly] = []
        r: list[FElt] = []
        previous_claim = e
        # ONE stacked [L, P, N] tensor for the polys (and one for the eqs):
        # the masked round kernel below is compiled once per (P, N) — every
        # round reuses it with a traced active length h and per-poly
        # active mask, instead of one XLA program per (round, active-set)
        # shape combination
        N = 1 << max_num_vars
        stack_p = jnp.stack([_pad_to(o.polynomial, N)
                             for o in self.openings], axis=1)
        stack_e = jnp.stack([_pad_to(o.eq_poly, N)
                             for o in self.openings], axis=1)
        coeffs_mat = fd.ints_to_device(spec, [c.v for c in coeffs])  # [L, P]
        if dev_rounds > 0:
            state_dev, nr_dev = fsd.state_to_device(transcript)
            prev_dev = fd.scalar_to_device(spec, e.v)
            # per-round inactive-claim constants + active masks are
            # challenge-independent: ONE packed upload for all rounds
            amasks, inacts = [], []
            for rnd in range(dev_rounds):
                remaining = max_num_vars - rnd
                am = np.array([remaining <= len(o.opening_point)
                               for o in self.openings])
                inact = FElt(0, spec)
                for i, o in enumerate(self.openings):
                    if not am[i]:
                        rem_vars = remaining - len(o.opening_point) - 1
                        inact = inact + FElt(1 << rem_vars, spec) * o.claim \
                            * coeffs[i]
                amasks.append(am)
                inacts.append(inact.v)
            inacts_dev = fd.ints_to_device(spec, inacts)      # [L, R]
            amasks_dev = jnp.asarray(np.stack(amasks))        # [R, P]
            comps = []
            for rnd in range(dev_rounds):
                remaining = max_num_vars - rnd
                comp, stack_p, stack_e, prev_dev, state_dev, nr_dev = \
                    _reduction_round_fs_m_jit(spec)(
                        stack_p, stack_e, coeffs_mat,
                        jnp.take(amasks_dev, jnp.asarray(rnd, jnp.int32),
                                 axis=0),
                        fd.col(inacts_dev, rnd),
                        prev_dev, state_dev, nr_dev,
                        np.int32(1 << (remaining - 1)))
                comps.append(comp)
            comp_ints = fd.device_to_ints(spec, jnp.stack(comps, axis=1))
            compressed, r = fsd.replay_and_check(spec, comp_ints, transcript,
                                                 state_dev, CompressedUniPoly)
            for cpoly, r_j in zip(compressed, r):
                previous_claim = cpoly.eval_from_hint(previous_claim, r_j)
        if dev_rounds < max_num_vars:
            p = spec.p
            backend.note_offload(max_num_vars - dev_rounds)
            # one pull of the whole stack; per-poly active lengths on host
            remaining0 = max_num_vars - dev_rounds
            stack_ints = fd.device_to_ints(spec, stack_p)
            eq_ints = fd.device_to_ints(spec, stack_e)
            pb, pe = [], []
            for i, o in enumerate(self.openings):
                li = min(1 << len(o.opening_point), 1 << remaining0)
                pb.append([int(x) for x in stack_ints[i][:li].tolist()])
                pe.append([int(x) for x in eq_ints[i][:li].tolist()])
            for rnd in range(dev_rounds, max_num_vars):
                remaining = max_num_vars - rnd
                ev0 = ev2 = 0
                for i, o in enumerate(self.openings):
                    if remaining <= len(o.opening_point):
                        pl, ql = pb[i], pe[i]
                        h = len(pl) // 2
                        s0 = s2 = 0
                        for t in range(h):
                            plo, phi = pl[t], pl[t + h]
                            qlo, qhi = ql[t], ql[t + h]
                            s0 += plo * qlo
                            s2 += (2 * phi - plo) * (2 * qhi - qlo)
                        ev0 += coeffs[i].v * (s0 % p)
                        ev2 += coeffs[i].v * (s2 % p)
                    else:
                        rem_vars = remaining - len(o.opening_point) - 1
                        scaled = ((1 << rem_vars) * o.claim.v % p) \
                            * coeffs[i].v
                        ev0 += scaled
                        ev2 += scaled
                e0 = FElt(ev0 % p, spec)
                round_poly = UniPoly.from_evals(
                    [e0, previous_claim - e0, FElt(ev2 % p, spec)])
                cpoly = round_poly.compress()
                cpoly.append_to_transcript(transcript)
                r_j = transcript.challenge_scalar()
                r.append(r_j)
                for i, o in enumerate(self.openings):
                    if remaining <= len(o.opening_point):
                        pb[i] = _host_bind(p, [pb[i]], r_j.v)[0]
                        pe[i] = _host_bind(p, [pe[i]], r_j.v)[0]
                previous_claim = round_poly.evaluate(r_j)
                compressed.append(cpoly)
            claims = [FElt(pb[i][0], spec) for i in range(len(pb))]
            return SumcheckInstanceProof(compressed), r, claims
        finals = fd.device_to_ints(spec, stack_p[..., 0])   # [P]
        claims = [FElt(int(v), spec) for v in finals.tolist()]
        return SumcheckInstanceProof(compressed), r, claims

    def reduce_and_prove(self, pcs, transcript: Transcript,
                         mesh=None) -> ReducedOpeningProof:
        spec = self.spec
        if mesh is not None:
            # shard every accumulated polynomial (and its eq) on the
            # hypercube axis; the reduction sumcheck's binds are chip-local
            # (opening_proof.rs:216-335's par_iter over polys+x, SURVEY §2.8)
            from ..parallel.sharding import maybe_shard_hypercube
            self._mesh = mesh
            for o in self.openings:
                o.polynomial = maybe_shard_hypercube(mesh, o.polynomial)
                o.eq_poly = maybe_shard_hypercube(mesh, o.eq_poly)
        rho_powers = transcript.challenge_scalar_powers(len(self.openings))
        sumcheck_proof, r_sumcheck, sumcheck_claims = \
            self.prove_batch_opening_reduction(rho_powers, transcript)
        transcript.append_scalars(sumcheck_claims)

        gamma_powers = transcript.challenge_scalar_powers(len(self.openings))
        max_len = max(o.polynomial.shape[-1] for o in self.openings)
        joint_poly = rlc_polys(spec, [o.polynomial for o in self.openings],
                               gamma_powers, pad_to=max_len)
        joint_opening_proof = pcs.prove(joint_poly, r_sumcheck, transcript)
        return ReducedOpeningProof(sumcheck_proof, sumcheck_claims,
                                   joint_opening_proof)


@dataclass
class VerifierOpening:
    commitment: object
    opening_point: list[FElt]
    claim: FElt


class VerifierOpeningAccumulator:
    def __init__(self, pcs, spec: FieldSpec | None = None):
        self.spec = spec or fr_spec()
        self.pcs = pcs
        self.openings: list[VerifierOpening] = []
        self.prover_openings: list[ProverOpening] | None = None

    def __len__(self):
        return len(self.openings)

    def compare_to(self, prover_acc: ProverOpeningAccumulator):
        """Oracle: cross-check appended points/claims against the prover's
        accumulator (opening_proof.rs:458-470, test-only in the reference)."""
        self.prover_openings = prover_acc.openings

    def append(self, commitments: Sequence, opening_point: Sequence[FElt],
               claims: Sequence[FElt], transcript: Transcript) -> None:
        assert len(commitments) == len(claims)
        spec = self.spec
        rho_powers = transcript.challenge_scalar_powers(len(commitments))
        batched_claim = FElt(0, spec)
        for rp, c in zip(rho_powers, claims):
            batched_claim = batched_claim + rp * c
        joint_commitment = self.pcs.combine_commitments(commitments, rho_powers)
        if self.prover_openings is not None:
            po = self.prover_openings[len(self.openings)]
            assert [x.v for x in po.opening_point] == [x.v for x in opening_point], \
                "opening point mismatch"
            assert po.claim == batched_claim, "batched claim mismatch"
        self.openings.append(VerifierOpening(joint_commitment,
                                             list(opening_point), batched_claim))

    def verify_batch_opening_reduction(self, coeffs, num_rounds,
                                       sumcheck_proof, transcript):
        spec = self.spec
        combined = FElt(0, spec)
        for co, o in zip(coeffs, self.openings):
            scaled = o.claim
            diff = num_rounds - len(o.opening_point)
            if diff:
                scaled = FElt(1 << diff, spec) * scaled
            combined = combined + scaled * co
        return sumcheck_proof.verify(combined, num_rounds, 2, transcript)

    def reduce_and_verify(self, pcs, reduced_proof: ReducedOpeningProof,
                          transcript: Transcript) -> None:
        spec = self.spec
        one = FElt(1, spec)
        num_rounds = max(len(o.opening_point) for o in self.openings)
        rho_powers = transcript.challenge_scalar_powers(len(self.openings))
        sumcheck_claim, r_sumcheck = self.verify_batch_opening_reduction(
            rho_powers, num_rounds, reduced_proof.sumcheck_proof, transcript)

        expected = FElt(0, spec)
        for o, co, claim in zip(self.openings, rho_powers,
                                reduced_proof.sumcheck_claims):
            r_hi = r_sumcheck[num_rounds - len(o.opening_point):]
            eq_eval = eq_evaluate_host(r_hi, o.opening_point)
            expected = expected + eq_eval * claim * co
        assert sumcheck_claim == expected, "batch opening reduction claim mismatch"

        transcript.append_scalars(reduced_proof.sumcheck_claims)
        gamma_powers = transcript.challenge_scalar_powers(len(self.openings))

        joint_commitment = pcs.combine_commitments(
            [o.commitment for o in self.openings], gamma_powers)
        joint_claim = FElt(0, spec)
        for o, co, claim in zip(self.openings, gamma_powers,
                                reduced_proof.sumcheck_claims):
            r_lo = r_sumcheck[: num_rounds - len(o.opening_point)]
            lagrange = one
            for rv in r_lo:
                lagrange = lagrange * (one - rv)
            joint_claim = joint_claim + co * claim * lagrange

        pcs.verify(reduced_proof.joint_opening_proof, transcript,
                   r_sumcheck, joint_claim, joint_commitment)
