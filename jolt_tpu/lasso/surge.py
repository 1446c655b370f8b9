"""Surge: standalone Lasso lookup argument for a single instruction type.

Reference: lasso/surge.rs.  Proves that N lookups into a decomposable table
(C chunks x M-entry subtables) were performed correctly:
  1. commit dim / read_cts / final_cts / E polynomials
  2. primary sumcheck:  claim = sum_x eq(r, x) * g(E_0(x), ..., E_{m-1}(x))
  3. offline memory checking of the E reads against the subtables

Witness generation is fully vectorized: counter polynomials via
argsort cumcount (no per-op loops), subtable gathers as numpy indexing, and
fingerprint leaves as one fused device kernel over [limbs, 2m, n].
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..commitment.base import BatchType
from ..field import FElt, FieldSpec, fr_spec
from ..field import device as fd
from ..field.generic import DevF
from ..poly import mle
from ..poly.opening_proof import (ProverOpeningAccumulator,
                                  VerifierOpeningAccumulator)
from ..subprotocols.sumcheck import SumcheckInstanceProof, prove_arbitrary
from ..transcript import Transcript
from ..utils.math import log2_strict, next_power_of_two
from .memory_checking import MemoryCheckingProof, MemoryCheckingProver


def cumcount(addresses: np.ndarray, M: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized per-address access counters.

    Returns (read_cts [N], final_cts [M]): read_cts[i] = #previous accesses
    to addresses[i]; final_cts[a] = total accesses to a.  Replaces the
    reference's sequential counter scan (surge.rs:556-582) with an
    argsort-based cumcount.
    """
    a = np.asarray(addresses, dtype=np.int64)
    order = np.argsort(a, kind="stable")
    sorted_a = a[order]
    idx = np.arange(len(a), dtype=np.int64)
    # first position of each group in the sorted array
    is_start = np.ones(len(a), dtype=bool)
    is_start[1:] = sorted_a[1:] != sorted_a[:-1]
    group_start = np.maximum.accumulate(np.where(is_start, idx, 0))
    rank_in_group = idx - group_start
    read_cts = np.empty(len(a), dtype=np.uint64)
    read_cts[order] = rank_in_group.astype(np.uint64)
    final_cts = np.bincount(a, minlength=M).astype(np.uint64)
    return read_cts, final_cts


class SurgePreprocessing:
    """Materialized subtables (surge.rs:528-547)."""

    def __init__(self, instruction_cls, C: int, M: int,
                 spec: FieldSpec | None = None):
        self.spec = spec or fr_spec()
        self.instruction_cls = instruction_cls
        self.C = C
        self.M = M
        instr = instruction_cls()
        self.subtable_list = [s for s, _ in instr.subtables(C, M)]
        self.num_subtables = len(self.subtable_list)
        self.num_memories = C * self.num_subtables
        # u64 entries for witness gathers + device Montgomery tables
        self.subtable_entries = np.stack(
            [s.materialize_entries(M) for s in self.subtable_list])  # [S, M]
        self.subtable_dev = fd.u64_to_mont_device(
            self.spec, self.subtable_entries)  # [L, S, M]

    def memory_to_subtable_index(self, i: int) -> int:
        return i // self.C

    def memory_to_dimension_index(self, i: int) -> int:
        return i % self.C


@dataclass
class SurgePolynomials:
    dim: jnp.ndarray        # [L, C, n]
    read_cts: jnp.ndarray   # [L, C, n]
    final_cts: jnp.ndarray  # [L, C, M]
    E_polys: jnp.ndarray    # [L, m, n]

    def read_write_values(self) -> list[jnp.ndarray]:
        """Canonical ordering: dim ‖ read_cts ‖ E (surge.rs:73-80)."""
        return ([fd.col(self.dim, i) for i in range(self.dim.shape[1])]
                + [fd.col(self.read_cts, i) for i in range(self.read_cts.shape[1])]
                + [fd.col(self.E_polys, i) for i in range(self.E_polys.shape[1])])

    def init_final_values(self) -> list[jnp.ndarray]:
        return [fd.col(self.final_cts, i) for i in range(self.final_cts.shape[1])]


@dataclass
class SurgePrimarySumcheck:
    sumcheck_proof: SumcheckInstanceProof
    num_rounds: int
    claimed_evaluation: FElt
    E_poly_openings: list[FElt]


@dataclass
class SurgeProof:
    commitments: list
    final_commitments: list
    primary_sumcheck: SurgePrimarySumcheck
    memory_checking: MemoryCheckingProof
    C: int
    M: int


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def _b3(x: jnp.ndarray, like: jnp.ndarray) -> jnp.ndarray:
    """Broadcast a scalar limb vector [L] to `like`'s shape."""
    return jnp.broadcast_to(x.reshape((fd.L,) + (1,) * (like.ndim - 1)), like.shape)


@partial(jax.jit, static_argnums=(0, 1))
def _surge_rw_leaves(spec: FieldSpec, mem_to_dim: tuple[int, ...],
                     dim: jnp.ndarray, read_cts: jnp.ndarray,
                     E: jnp.ndarray, gamma: jnp.ndarray, tau: jnp.ndarray
                     ) -> jnp.ndarray:
    """Interleaved read/write fingerprint leaves [L, 2m, n] (surge.rs:125-144)."""
    g2 = fd.fmul(spec, gamma, gamma)
    sel = jnp.asarray(mem_to_dim)
    dim_g = dim[:, sel]          # [L, m, n]
    cts_g = read_cts[:, sel]
    read_fp = fd.fadd(
        spec,
        fd.fadd(spec, fd.fmul(spec, cts_g, _b3(g2, cts_g)),
                fd.fmul(spec, E, _b3(gamma, E))),
        fd.fsub(spec, dim_g, _b3(tau, dim_g)))
    write_fp = fd.fadd(spec, read_fp, _b3(g2, read_fp))
    return jnp.stack([read_fp, write_fp], axis=2).reshape(
        (fd.L, 2 * read_fp.shape[1], read_fp.shape[2]))


@partial(jax.jit, static_argnums=(0, 1, 2))
def _surge_if_leaves(spec: FieldSpec, mem_to_dim: tuple[int, ...],
                     mem_to_sub: tuple[int, ...],
                     subtables: jnp.ndarray, final_cts: jnp.ndarray,
                     identity: jnp.ndarray, gamma: jnp.ndarray,
                     tau: jnp.ndarray) -> jnp.ndarray:
    """Interleaved init/final fingerprint leaves [L, 2m, M] (surge.rs:146-176)."""
    g2 = fd.fmul(spec, gamma, gamma)
    tbl = subtables[:, jnp.asarray(mem_to_sub)]     # [L, m, M]
    cts = final_cts[:, jnp.asarray(mem_to_dim)]     # [L, m, M]
    ident = jnp.broadcast_to(identity[:, None, :], tbl.shape)
    init_fp = fd.fadd(spec, fd.fmul(spec, tbl, _b3(gamma, tbl)),
                      fd.fsub(spec, ident, _b3(tau, tbl)))
    final_fp = fd.fadd(spec, init_fp, fd.fmul(spec, cts, _b3(g2, cts)))
    return jnp.stack([init_fp, final_fp], axis=2).reshape(
        (fd.L, 2 * init_fp.shape[1], init_fp.shape[2]))


_COMB_CACHE: dict = {}


def combine_with_eq(instruction_cls, C: int, M: int):
    """Stable device combine function: g(E...) * eq, cached for jit reuse."""
    key = (instruction_cls, C, M)
    if key not in _COMB_CACHE:
        instr = instruction_cls()

        def comb(spec, params):
            evals = [DevF(p, spec) for p in params[:-1]]
            g = instr.combine_lookups(evals, C, M)
            return fd.fmul(spec, g.limbs, params[-1])

        _COMB_CACHE[key] = comb
    return _COMB_CACHE[key]


@partial(jax.jit, static_argnums=(0, 1))
def _primary_claim(spec: FieldSpec, comb, polys: tuple[jnp.ndarray, ...]
                   ) -> jnp.ndarray:
    return fd.fsum(spec, comb(spec, polys), axis=-1)


# ---------------------------------------------------------------------------
# memory checking instance
# ---------------------------------------------------------------------------

class SurgeMemoryChecking(MemoryCheckingProver):
    def __init__(self, preprocessing: SurgePreprocessing):
        self.pre = preprocessing
        self.spec = preprocessing.spec

    def protocol_name(self) -> bytes:
        return b"SurgeMemCheck"

    def compute_leaves(self, polynomials: SurgePolynomials, gamma: FElt,
                       tau: FElt):
        pre = self.pre
        spec = self.spec
        mem_to_dim = tuple(pre.memory_to_dimension_index(i)
                           for i in range(pre.num_memories))
        mem_to_sub = tuple(pre.memory_to_subtable_index(i)
                           for i in range(pre.num_memories))
        g = fd.scalar_to_device(spec, gamma.v)
        t = fd.scalar_to_device(spec, tau.v)
        identity = fd.u64_to_mont_device(spec,
                                         np.arange(pre.M, dtype=np.uint64))
        rw = _surge_rw_leaves(spec, mem_to_dim, polynomials.dim,
                              polynomials.read_cts, polynomials.E_polys, g, t)
        inf = _surge_if_leaves(spec, mem_to_dim, mem_to_sub,
                               pre.subtable_dev, polynomials.final_cts,
                               identity, g, t)
        return rw, inf


# ---------------------------------------------------------------------------
# prover / verifier
# ---------------------------------------------------------------------------

def generate_witness(pre: SurgePreprocessing, x: np.ndarray, y: np.ndarray
                     ) -> tuple[SurgePolynomials, np.ndarray]:
    """Vectorized witness generation (surge.rs:543-624)."""
    C, M = pre.C, pre.M
    log_M = log2_strict(M)
    num_ops = len(x)
    n = next_power_of_two(num_ops)

    indices = pre.instruction_cls.to_indices_vec(x, y, C, log_M)  # [C, num_ops]
    # pad with address-0 fake ops (they still bump counters, surge.rs:569-581)
    if n > num_ops:
        pad = np.zeros((C, n - num_ops), dtype=np.uint64)
        indices = np.concatenate([indices, pad], axis=1)

    read_cts = np.zeros((C, n), dtype=np.uint64)
    final_cts = np.zeros((C, M), dtype=np.uint64)
    for c in range(C):
        read_cts[c], final_cts[c] = cumcount(indices[c], M)

    E_host = np.zeros((pre.num_memories, n), dtype=np.uint64)
    for mem in range(pre.num_memories):
        d = pre.memory_to_dimension_index(mem)
        s = pre.memory_to_subtable_index(mem)
        E_host[mem] = pre.subtable_entries[s][indices[d].astype(np.int64)]

    spec = pre.spec
    polys = SurgePolynomials(
        dim=fd.u64_to_mont_device(spec, indices),
        read_cts=fd.u64_to_mont_device(spec, read_cts),
        final_cts=fd.u64_to_mont_device(spec, final_cts),
        E_polys=fd.u64_to_mont_device(spec, E_host),
    )
    return polys, indices


def surge_prove(pre: SurgePreprocessing, pcs, x: np.ndarray, y: np.ndarray,
                mesh=None
                ) -> tuple[SurgeProof, Transcript, ProverOpeningAccumulator]:
    """Prove N lookups (surge.rs:378-480).  Returns (proof, transcript, acc)
    — transcript/accumulator returned as the debug oracle (ProverDebugInfo).

    With `mesh`, the primary sumcheck's E/eq MLEs are sharded on the
    HYPERCUBE axis across the device mesh (the reference's rayon axis,
    SURVEY §2.8 — here GSPMD partitions the round kernels and all-reduces
    the [L, degree+1] evals); transcript-identical to the unsharded path."""
    spec = pre.spec
    C, M = pre.C, pre.M
    transcript = Transcript(b"Surge transcript")
    opening_accumulator = ProverOpeningAccumulator(spec)
    transcript.append_protocol_name(b"Surge")

    polys, _ = generate_witness(pre, x, y)
    n = polys.dim.shape[-1]
    num_rounds = log2_strict(n)

    rw_polys = polys.read_write_values()
    commitments = pcs.batch_commit(rw_polys, BatchType.SURGE_READ_WRITE)
    final_commitments = pcs.batch_commit(polys.init_final_values(),
                                         BatchType.SURGE_INIT_FINAL)

    # primary sumcheck
    r_primary = transcript.challenge_vector(num_rounds)
    eq = mle.eq_evals_device(spec, r_primary)
    instr = pre.instruction_cls()
    comb = combine_with_eq(pre.instruction_cls, C, M)
    e_list = tuple(polys.E_polys[:, i] for i in range(pre.num_memories))
    claim_dev = _primary_claim(spec, comb, e_list + (eq,))
    sumcheck_claim = FElt(fd.to_int(spec, claim_dev), spec)
    transcript.append_scalar(sumcheck_claim)

    degree = instr.g_poly_degree(C) + 1
    sc_polys = e_list + (eq,)
    if mesh is not None:
        from ..parallel.sharding import shard_sumcheck_polys
        sc_polys = shard_sumcheck_polys(mesh, sc_polys)
    proof_primary, r_z, final_evals = prove_arbitrary(
        num_rounds, sc_polys, comb, degree, transcript, spec)
    e_openings = final_evals[:-1]
    # Fork parity: E-poly opening accumulation disabled (surge.rs:440-447).

    primary = SurgePrimarySumcheck(proof_primary, num_rounds, sumcheck_claim,
                                   e_openings)

    mc = SurgeMemoryChecking(pre)
    mc_proof = mc.prove_memory_checking(polys, opening_accumulator, transcript)

    proof = SurgeProof(commitments, final_commitments, primary, mc_proof, C, M)
    return proof, transcript, opening_accumulator


def surge_verify(pre: SurgePreprocessing, pcs, proof: SurgeProof,
                 debug_transcript: Transcript | None = None) -> None:
    """Verify (surge.rs:485-541)."""
    spec = pre.spec
    transcript = Transcript(b"Surge transcript")
    if debug_transcript is not None:
        transcript.compare_to(debug_transcript)
    transcript.append_protocol_name(b"Surge")
    instr = pre.instruction_cls()

    r_primary = transcript.challenge_vector(proof.primary_sumcheck.num_rounds)
    transcript.append_scalar(proof.primary_sumcheck.claimed_evaluation)
    degree = instr.g_poly_degree(pre.C) + 1
    claim_last, r_z = proof.primary_sumcheck.sumcheck_proof.verify(
        proof.primary_sumcheck.claimed_evaluation,
        proof.primary_sumcheck.num_rounds, degree, transcript)

    eq_eval = mle.eq_evaluate_host(r_primary, r_z)
    combined = instr.combine_lookups(proof.primary_sumcheck.E_poly_openings,
                                     pre.C, pre.M)
    assert eq_eval * combined == claim_last, "Surge primary sumcheck failed"

    mc = SurgeMemoryChecking(pre)
    vacc = VerifierOpeningAccumulator(pcs, spec)
    mc.verify_memory_checking(proof.memory_checking, proof.commitments,
                              vacc, transcript)
