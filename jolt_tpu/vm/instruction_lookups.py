"""Instruction lookups: Lasso for the zkVM "execute" stage.

Reference: jolt-core/src/jolt/vm/instruction_lookups.rs.

  * Preprocessing derives the memory layout from the union of each
    instruction's per-chunk subtable usage (instruction_lookups.rs:493-547).
  * Witness generation is vectorized per instruction class: operand chunking,
    lookup outputs, per-memory access counters (masked argsort cumcounts),
    and subtable gathers — no per-op Python loops.
  * Primary sumcheck: sum_x eq(r,x) * [sum_i flag_i(x) * g_i(E(x)) - out(x)],
    degree = max g degree + 2 (instruction_lookups.rs:843-1065).  Each round
    is ONE fused device kernel over the stacked flag/E tensors.
  * Memory checking: ToggledBatchedGrandProduct for read/write (flags gate
    the fingerprints), dense GP for init/final with the I F..F interleaving
    per subtable (instruction_lookups.rs:155-365).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..field import FElt, FieldSpec, fr_spec
from ..field import device as fd
from ..field.generic import DevF
from ..lasso.memory_checking import MultisetHashes, MemoryCheckingProof
from ..lasso.surge import cumcount
from ..poly import mle
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..subprotocols.grand_product import (BatchedDenseGrandProduct,
                                          ToggledBatchedGrandProduct,
                                          toggled_verify_sumcheck_claim,
                                          verify_grand_product)
from ..subprotocols.sumcheck import SumcheckInstanceProof
from ..transcript import Transcript
from ..utils.math import log2_strict

PRIMARY_PROTOCOL = b"Jolt instruction lookups"
MEMCHECK_PROTOCOL = b"Instruction lookups check"


class InstructionLookupsPreprocessing:
    """Memory layout + materialized subtables (instruction_lookups.rs:482-561)."""

    def __init__(self, instruction_classes, subtable_order, C: int, M: int,
                 spec: FieldSpec | None = None):
        self.spec = spec or fr_spec()
        self.instruction_classes = list(instruction_classes)
        self.C, self.M = C, M
        self.num_instructions = len(self.instruction_classes)

        # canonical subtable enum order (rv32i_vm.rs subtable_enum!)
        self.subtables = list(subtable_order)
        sub_enum = {s.key(): i for i, s in enumerate(self.subtables)}
        self.num_subtables = len(self.subtables)

        # union of chunk indices per subtable
        subtable_chunks = [set() for _ in self.subtables]
        for cls in self.instruction_classes:
            for sub, indices in cls().subtables(C, M):
                subtable_chunks[sub_enum[sub.key()]].update(indices)

        self.subtable_to_memory_indices = []
        self.memory_to_subtable_index = []
        self.memory_to_dimension_index = []
        mem = 0
        for s_idx, chunks in enumerate(subtable_chunks):
            dims = sorted(chunks)
            self.subtable_to_memory_indices.append(
                list(range(mem, mem + len(dims))))
            self.memory_to_subtable_index.extend([s_idx] * len(dims))
            self.memory_to_dimension_index.extend(dims)
            mem += len(dims)
        self.num_memories = mem

        self.instruction_to_memory_indices = []
        for cls in self.instruction_classes:
            mems = []
            for sub, indices in cls().subtables(C, M):
                for m_idx in self.subtable_to_memory_indices[sub_enum[sub.key()]]:
                    if self.memory_to_dimension_index[m_idx] in indices:
                        mems.append(m_idx)
            self.instruction_to_memory_indices.append(mems)

        self.subtable_entries = np.stack(
            [s.materialize_entries(M) for s in self.subtables])  # [S, M]
        self.subtable_dev = fd.u64_to_mont_device(self.spec,
                                                   self.subtable_entries)

        self.max_g_degree = max(cls().g_poly_degree(C)
                                for cls in self.instruction_classes)
        self.sumcheck_degree = self.max_g_degree + 2

    def meta_key(self):
        """Hashable static metadata for jit caching of the primary kernel."""
        return (tuple(self.instruction_classes),
                tuple(tuple(m) for m in self.instruction_to_memory_indices),
                self.C, self.M)


@dataclass
class InstructionLookupPolynomials:
    dim: jnp.ndarray                 # [L, C, T]
    read_cts: jnp.ndarray            # [L, m, T]
    final_cts: jnp.ndarray           # [L, m, M]
    E_polys: jnp.ndarray             # [L, m, T]
    instruction_flags: jnp.ndarray   # [L, NI, T]
    lookup_outputs: jnp.ndarray      # [L, T]
    instruction_flag_bits: np.ndarray  # [NI, T] u8 (host)
    memory_flag_bits: np.ndarray       # [m, T] u8 (host)
    memory_flags_dev: jnp.ndarray      # [m, T] bool (bit-packed; the
    #   toggled GP expands to Montgomery lazily — 36x less HBM)

    def read_write_values(self) -> list[jnp.ndarray]:
        """Canonical ordering: dim ‖ read_cts ‖ E ‖ flags ‖ outputs."""
        out = [fd.col(self.dim, i) for i in range(self.dim.shape[1])]
        out += [fd.col(self.read_cts, i) for i in range(self.read_cts.shape[1])]
        out += [fd.col(self.E_polys, i) for i in range(self.E_polys.shape[1])]
        out += [fd.col(self.instruction_flags, i)
                for i in range(self.instruction_flags.shape[1])]
        out.append(self.lookup_outputs)
        return out

    def init_final_values(self) -> list[jnp.ndarray]:
        return [fd.col(self.final_cts, i) for i in range(self.final_cts.shape[1])]


def generate_witness(pre: InstructionLookupsPreprocessing,
                     instr_idx: np.ndarray, x: np.ndarray, y: np.ndarray
                     ) -> InstructionLookupPolynomials:
    """Vectorized witness generation (instruction_lookups.rs:728-825).

    instr_idx[j]: index into pre.instruction_classes, or -1 for steps with no
    instruction lookup (padding no-ops).  Arrays must already be padded to a
    power-of-two length.
    """
    spec = pre.spec
    C, M = pre.C, pre.M
    log_M = log2_strict(M)
    T = len(instr_idx)
    NI = pre.num_instructions
    m = pre.num_memories

    dim_all = np.zeros((C, T), dtype=np.uint64)
    outputs = np.zeros(T, dtype=np.uint64)
    flag_bits = np.zeros((NI, T), dtype=np.uint8)
    for k, cls in enumerate(pre.instruction_classes):
        mask = instr_idx == k
        if not mask.any():
            continue
        flag_bits[k][mask] = 1
        dim_all[:, mask] = cls.to_indices_vec(x[mask], y[mask], C, log_M)
        outputs[mask] = cls.lookup_entry_vec(x[mask], y[mask])

    mem_flag_bits = np.zeros((m, T), dtype=np.uint8)
    for k in range(NI):
        for mi in pre.instruction_to_memory_indices[k]:
            mem_flag_bits[mi] |= flag_bits[k]

    read_cts = np.zeros((m, T), dtype=np.uint64)
    final_cts = np.zeros((m, M), dtype=np.uint64)
    E_host = np.zeros((m, T), dtype=np.uint64)
    for mi in range(m):
        active = mem_flag_bits[mi] == 1
        d = pre.memory_to_dimension_index[mi]
        s = pre.memory_to_subtable_index[mi]
        addrs = dim_all[d][active].astype(np.int64)
        if addrs.size:
            rc, fc = cumcount(addrs, M)
            read_cts[mi][active] = rc
            final_cts[mi] = fc
            E_host[mi][active] = pre.subtable_entries[s][addrs]

    to_dev = lambda arr: fd.u64_to_mont_device(spec, arr)
    return InstructionLookupPolynomials(
        dim=to_dev(dim_all),
        read_cts=to_dev(read_cts),
        final_cts=to_dev(final_cts),
        E_polys=to_dev(E_host),
        instruction_flags=to_dev(flag_bits.astype(np.uint64)),
        lookup_outputs=to_dev(outputs),
        instruction_flag_bits=flag_bits,
        memory_flag_bits=mem_flag_bits,
        memory_flags_dev=jnp.asarray(mem_flag_bits.astype(bool)),
    )


# ---------------------------------------------------------------------------
# primary sumcheck kernel
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=0)
def _primary_bind(spec: FieldSpec, eq, outputs, flags, E, r):
    return (mle.bind_top(spec, eq, r), mle.bind_top(spec, outputs, r),
            mle.bind_top(spec, flags, r), mle.bind_top(spec, E, r))


def _primary_bind_masked(spec: FieldSpec, eq, outputs, flags, E, r, h):
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

    return bb(eq), bb(outputs), bb(flags), bb(E)


_primary_bind_m_jit = jax.jit(_primary_bind_masked, static_argnums=0)


# -- decomposed primary evals ------------------------------------------------
#
# One monolithic evals program unrolls the full instruction-combine graph
# (degree+1) times: for the 29-instruction RV32I zoo that single XLA
# program took tens of minutes to compile.  The round
# is instead driven as ~30 SMALL programs — a split, one g-term program
# per instruction CLASS (reused by every evaluation point and round), an
# extrapolation step, and a masked finisher — chained eagerly on device
# (still no host sync on the FS path; dispatches pipeline).

@functools.lru_cache(maxsize=None)
def _primary_split_jit(spec: FieldSpec):
    @jax.jit
    def f(eq, out, fl, e, h):
        outs = []
        for t in (eq, out, fl, e):
            H = t.shape[-1] // 2
            lo = t[..., :H]
            hi = jax.lax.dynamic_slice_in_dim(t, h, H, axis=-1)
            outs += [lo, hi, fd.fsub(spec, hi, lo)]
        return tuple(outs)                # (lo, hi, d) x (eq, out, f, e)
    return f


@functools.lru_cache(maxsize=None)
def _primary_ext_jit(spec: FieldSpec):
    @jax.jit
    def f(eq_t, out_t, f_t, e_t, d_eq, d_out, d_f, d_e):
        return (fd.fadd(spec, eq_t, d_eq), fd.fadd(spec, out_t, d_out),
                fd.fadd(spec, f_t, d_f), fd.fadd(spec, e_t, d_e))
    return f


@functools.lru_cache(maxsize=None)
def _g_term_jit(spec: FieldSpec, cls, mems: tuple, k: int, C: int, M: int):
    @jax.jit
    def f(e_t, f_t):                      # [L, m, H], [L, NI, H]
        vals = [DevF(e_t[:, mi], spec) for mi in mems]
        g = cls().combine_lookups(vals, C, M)
        return fd.fmul(spec, f_t[:, k], g.limbs)
    return f


@functools.lru_cache(maxsize=None)
def _point_finish_jit(spec: FieldSpec):
    @jax.jit
    def f(eq_t, out_t, inner, h):
        H = eq_t.shape[-1]
        mask = jnp.arange(H, dtype=jnp.int32) < h
        total = fd.fmul(spec, jnp.where(mask, eq_t, jnp.uint32(0)),
                        fd.fsub(spec, inner, out_t))
        return fd.fsum(spec, total, axis=-1)
    return f


def _primary_round_evals_decomposed(spec: FieldSpec, meta, degree: int,
                                    eq, out, fl, e, h) -> jnp.ndarray:
    """Round evals [L, degree+1] via the small-program pipeline.  Works for
    both the masked fixed-shape arrays (h < physical half) and the
    shrinking arrays (h == physical half: the dynamic slice and mask
    degenerate to the static split)."""
    instr_classes, instr_mems, C, M = meta
    hs = np.int32(h)
    (eq0, eq1, d_eq, out0, out1, d_out,
     f0, f1, d_f, e0, e1, d_e) = _primary_split_jit(spec)(eq, out, fl, e, hs)
    finish = _point_finish_jit(spec)
    ext = _primary_ext_jit(spec)
    evals = []
    eq_t, out_t, f_t, e_t = eq0, out0, f0, e0
    for t in range(degree + 1):
        if t == 1:
            eq_t, out_t, f_t, e_t = eq1, out1, f1, e1
        elif t >= 2:
            eq_t, out_t, f_t, e_t = ext(eq_t, out_t, f_t, e_t,
                                        d_eq, d_out, d_f, d_e)
        inner = None
        for k, cls in enumerate(instr_classes):
            term = _g_term_jit(spec, cls, tuple(instr_mems[k]), k, C, M)(
                e_t, f_t)
            inner = term if inner is None else fd.fadd(spec, inner, term)
        evals.append(finish(eq_t, out_t, inner, hs))
    return jnp.stack(evals, axis=1)


# ---------------------------------------------------------------------------
# leaves kernels (memory checking)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(0, 1))
def _il_rw_leaves(spec: FieldSpec, mem_to_dim, dim, read_cts, E, gamma, tau):
    """Interleaved read/write fingerprints [L, 2m, T]
    (instruction_lookups.rs:183-218); read_cts indexed per MEMORY."""
    g2 = fd.fmul(spec, gamma, gamma)
    sel = jnp.asarray(mem_to_dim)
    dim_g = dim[:, sel]

    def b3(s, like):
        return jnp.broadcast_to(s.reshape((fd.L,) + (1,) * (like.ndim - 1)),
                                like.shape)

    read_fp = fd.fadd(
        spec,
        fd.fadd(spec, fd.fmul(spec, read_cts, b3(g2, read_cts)),
                fd.fmul(spec, E, b3(gamma, E))),
        fd.fsub(spec, dim_g, b3(tau, dim_g)))
    write_fp = fd.fadd(spec, read_fp, b3(g2, read_fp))
    return jnp.stack([read_fp, write_fp], axis=2).reshape(
        (fd.L, 2 * read_fp.shape[1], read_fp.shape[2]))


@partial(jax.jit, static_argnums=(0, 1, 2))
def _il_if_leaves(spec: FieldSpec, sub_to_mems, mem_count, subtables,
                  final_cts, identity, gamma, tau):
    """Init/final leaves ordered I F..F per subtable -> [L, S+m, M]
    (instruction_lookups.rs:220-260)."""
    g2 = fd.fmul(spec, gamma, gamma)

    def b3(s, like):
        return jnp.broadcast_to(s.reshape((fd.L,) + (1,) * (like.ndim - 1)),
                                like.shape)

    ident = jnp.broadcast_to(identity[:, None, :], subtables.shape)
    init = fd.fadd(spec, fd.fmul(spec, subtables, b3(gamma, subtables)),
                   fd.fsub(spec, ident, b3(tau, subtables)))  # [L, S, M]
    init_g = init[:, jnp.asarray([s for s, mems in enumerate(sub_to_mems)
                                  for _ in mems])]            # [L, m, M]
    finals = fd.fadd(spec, init_g,
                     fd.fmul(spec, final_cts, b3(g2, final_cts)))
    # interleave I F..F per subtable
    order = []
    pos = 0
    layers = []
    for s, mems in enumerate(sub_to_mems):
        layers.append(init[:, s:s + 1])
        layers.append(finals[:, pos:pos + len(mems)])
        pos += len(mems)
    return jnp.concatenate(layers, axis=1)


# ---------------------------------------------------------------------------
# proof structures + prover / verifier
# ---------------------------------------------------------------------------

@dataclass
class PrimarySumcheckOpenings:
    E_poly_openings: list[FElt]
    flag_openings: list[FElt]
    lookup_outputs_opening: FElt


@dataclass
class PrimarySumcheck:
    sumcheck_proof: SumcheckInstanceProof
    num_rounds: int
    openings: PrimarySumcheckOpenings


@dataclass
class InstructionLookupsProof:
    primary_sumcheck: PrimarySumcheck
    memory_checking: MemoryCheckingProof


def _combine_lookups_host(pre: InstructionLookupsPreprocessing,
                          vals: list[FElt], flags: list[FElt]) -> FElt:
    """sum_i flag_i * g_i(E[mems_i]) (instruction_lookups.rs:1081-1104)."""
    total = FElt(0, pre.spec)
    for k, cls in enumerate(pre.instruction_classes):
        operands = [vals[mi] for mi in pre.instruction_to_memory_indices[k]]
        total = total + flags[k] * cls().combine_lookups(operands, pre.C, pre.M)
    return total


def prove_instruction_lookups(pre: InstructionLookupsPreprocessing,
                              polys: InstructionLookupPolynomials,
                              opening_accumulator, transcript: Transcript,
                              mesh=None) -> InstructionLookupsProof:
    spec = pre.spec
    transcript.append_protocol_name(PRIMARY_PROTOCOL)

    T = polys.dim.shape[-1]
    num_rounds = log2_strict(T)
    r_eq = transcript.challenge_vector(num_rounds)
    eq = mle.eq_evals_device(spec, r_eq)

    degree = pre.sumcheck_degree
    meta = pre.meta_key()
    eq_b, out_b = eq, polys.lookup_outputs
    f_b, e_b = polys.instruction_flags, polys.E_polys
    if mesh is not None:
        # hypercube-axis sharding (SURVEY §2.8): each chip owns a slice of
        # the T axis; round evaluations reduce cross-chip via XLA-inserted
        # collectives, binds stay local (matches the reference's rayon
        # par_iter over x, instruction_lookups.rs primary sumcheck)
        from ..parallel.sharding import maybe_shard_hypercube
        eq_b, out_b, f_b, e_b = (maybe_shard_hypercube(mesh, t)
                                 for t in (eq_b, out_b, f_b, e_b))
    r_primary: list[FElt] = []
    compressed: list[CompressedUniPoly] = []
    prof = backend.profile()
    h = T // 2
    if num_rounds > 0 and prof.device_fs:
        # device Fiat-Shamir: primary-sumcheck rounds enqueue without
        # a host sync; one pull + host transcript replay at the end
        from ..subprotocols import fs_device as fsd
        import numpy as np
        state_dev, nr_dev = fsd.state_to_device(transcript)
        # decomposed device-FS: masked evals -> shared FS round program ->
        # masked bind, chained through device arrays (no host sync).  The
        # FUSED per-protocol program was an hour-scale fresh compile for
        # the full 29-instruction combine graph + keccak.
        fs_round = fsd.fs_round_jit(spec, degree, False)
        prev_dev = fd.zeros(spec, ())
        comps = []
        for _ in range(num_rounds):
            evals_dev = _primary_round_evals_decomposed(
                spec, meta, degree, eq_b, out_b, f_b, e_b, h)
            comp, rj, prev_dev, state_dev, nr_dev = fs_round(
                evals_dev, prev_dev, state_dev, nr_dev)
            eq_b, out_b, f_b, e_b = _primary_bind_m_jit(
                spec, eq_b, out_b, f_b, e_b, rj, np.int32(h))
            comps.append(comp)
            h //= 2
        comp_ints = fd.device_to_ints(spec, jnp.stack(comps, axis=1))
        compressed, r_primary = fsd.replay_and_check(
            spec, comp_ints, transcript, state_dev, CompressedUniPoly)
        dev_fs_done = num_rounds
    else:
        dev_fs_done = 0
    if dev_fs_done < num_rounds:
        import numpy as np
        # decomposed evals serve BOTH modes (shrinking arrays degenerate
        # the dynamic slice/mask to the static split); only the bind
        # differs (masked keeps full physical size, shrinking halves —
        # full-size rounds cost ~log2(T)/2 x more 1-core FLOPs on CPU)
        ev_fn = lambda eq_, out_, f_, e_, h_: _primary_round_evals_decomposed(
            spec, meta, degree, eq_, out_, f_, e_, h_)
        if prof.masked_rounds:
            bind_fn = lambda *ts: _primary_bind_m_jit(
                spec, *ts[:-1], np.int32(ts[-1]))
        else:
            bind_fn = lambda eq_, out_, f_, e_, rv_, h_: _primary_bind(
                spec, eq_, out_, f_, e_, rv_)
        for j in range(num_rounds - dev_fs_done):
            evals_dev = ev_fn(eq_b, out_b, f_b, e_b, h)
            evals = [FElt(int(v), spec)
                     for v in fd.device_to_ints(spec, evals_dev).tolist()]
            round_poly = UniPoly.from_evals(evals)
            cpoly = round_poly.compress()
            cpoly.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar()
            r_primary.append(r_j)
            rv = fd.scalar_to_device(spec, r_j.v)
            eq_b, out_b, f_b, e_b = bind_fn(eq_b, out_b, f_b, e_b, rv, h)
            compressed.append(cpoly)
            h //= 2

    flag_evals = [FElt(int(v), spec) for v in
                  fd.device_to_ints(spec, f_b[..., 0]).tolist()]
    E_evals = [FElt(int(v), spec) for v in
               fd.device_to_ints(spec, e_b[..., 0]).tolist()]
    outputs_eval = FElt(fd.to_int(spec, out_b[..., 0]), spec)

    openings = PrimarySumcheckOpenings(E_evals, flag_evals, outputs_eval)
    # opening accumulation for E ‖ flags ‖ outputs (ACTIVE in the fork)
    primary_polys = ([fd.col(polys.E_polys, i) for i in range(pre.num_memories)]
                     + [fd.col(polys.instruction_flags, i)
                        for i in range(pre.num_instructions)]
                     + [polys.lookup_outputs])
    primary_openings = E_evals + flag_evals + [outputs_eval]
    eq_r_primary = mle.eq_evals_device(spec, r_primary)
    opening_accumulator.append(primary_polys, eq_r_primary, r_primary,
                               primary_openings, transcript)

    primary = PrimarySumcheck(SumcheckInstanceProof(compressed), num_rounds,
                              openings)
    mc_proof = _prove_memory_checking(pre, polys, transcript, mesh=mesh)
    return InstructionLookupsProof(primary, mc_proof)


def _prove_memory_checking(pre, polys, transcript: Transcript, mesh=None
                           ) -> MemoryCheckingProof:
    spec = pre.spec
    gamma = transcript.challenge_scalar()
    tau = transcript.challenge_scalar()
    transcript.append_protocol_name(MEMCHECK_PROTOCOL)

    g = fd.scalar_to_device(spec, gamma.v)
    t = fd.scalar_to_device(spec, tau.v)
    rw_leaves = _il_rw_leaves(spec, tuple(pre.memory_to_dimension_index),
                              polys.dim, polys.read_cts, polys.E_polys, g, t)
    identity = fd.u64_to_mont_device(spec, np.arange(pre.M, dtype=np.uint64))
    if_leaves = _il_if_leaves(
        spec, tuple(tuple(v) for v in pre.subtable_to_memory_indices),
        pre.num_memories, pre.subtable_dev, polys.final_cts, identity, g, t)

    rw_circuit = ToggledBatchedGrandProduct(polys.memory_flags_dev, rw_leaves,
                                            spec, mesh=mesh)
    rw_hashes = rw_circuit.claims()
    if_circuit = BatchedDenseGrandProduct.construct(if_leaves, spec,
                                                    mesh=mesh)
    del rw_leaves, if_leaves   # the pair trees hold their own copies
    if_hashes = if_circuit.claims()

    hashes = _uninterleave_hashes(pre, rw_hashes, if_hashes)
    _check_multiset_equality(pre, hashes)
    hashes.append_to_transcript(transcript)

    rw_proof, _ = rw_circuit.prove(transcript)
    if_proof, _ = if_circuit.prove(transcript)
    return MemoryCheckingProof(hashes, rw_proof, if_proof)


def _uninterleave_hashes(pre, rw: list[FElt], inf: list[FElt]) -> MultisetHashes:
    reads = rw[0::2]
    writes = rw[1::2]
    init_hashes, final_hashes = [], []
    it = iter(inf)
    for s in range(pre.num_subtables):
        init_hashes.append(next(it))
        for _ in pre.subtable_to_memory_indices[s]:
            final_hashes.append(next(it))
    return MultisetHashes(reads, writes, init_hashes, final_hashes)


def _interleave_hashes(pre, h: MultisetHashes):
    rw = [x for pair in zip(h.read_hashes, h.write_hashes) for x in pair]
    inf = []
    for s in range(pre.num_subtables):
        inf.append(h.init_hashes[s])
        for mi in pre.subtable_to_memory_indices[s]:
            inf.append(h.final_hashes[mi])
    return rw, inf


def _check_multiset_equality(pre, h: MultisetHashes):
    for i in range(pre.num_memories):
        init = h.init_hashes[pre.memory_to_subtable_index[i]]
        assert init * h.write_hashes[i] == h.final_hashes[i] * h.read_hashes[i], \
            f"multiset hashes don't match (memory {i})"


def verify_instruction_lookups(pre: InstructionLookupsPreprocessing,
                               proof: InstructionLookupsProof,
                               commitments, opening_accumulator,
                               transcript: Transcript) -> None:
    spec = pre.spec
    transcript.append_protocol_name(PRIMARY_PROTOCOL)
    num_rounds = proof.primary_sumcheck.num_rounds
    r_eq = transcript.challenge_vector(num_rounds)

    claim_last, r_primary = proof.primary_sumcheck.sumcheck_proof.verify(
        FElt(0, spec), num_rounds, pre.sumcheck_degree, transcript)

    eq_eval = mle.eq_evaluate_host(r_eq, r_primary)
    op = proof.primary_sumcheck.openings
    combined = _combine_lookups_host(pre, op.E_poly_openings, op.flag_openings)
    assert eq_eval * (combined - op.lookup_outputs_opening) == claim_last, \
        "instruction lookups primary sumcheck failed"

    if commitments is not None:
        cs = (list(commitments["E"]) + list(commitments["flags"])
              + [commitments["outputs"]])
        opening_accumulator.append(
            cs, r_primary,
            op.E_poly_openings + op.flag_openings + [op.lookup_outputs_opening],
            transcript)

    # memory checking
    gamma = transcript.challenge_scalar()
    tau = transcript.challenge_scalar()
    transcript.append_protocol_name(MEMCHECK_PROTOCOL)
    h = proof.memory_checking.multiset_hashes
    _check_multiset_equality(pre, h)
    h.append_to_transcript(transcript)
    rw_hashes, if_hashes = _interleave_hashes(pre, h)

    verify_grand_product(proof.memory_checking.read_write_grand_product,
                         rw_hashes, transcript,
                         verify_sumcheck_claim=toggled_verify_sumcheck_claim)
    verify_grand_product(proof.memory_checking.init_final_grand_product,
                         if_hashes, transcript)
    # Fork parity: opening appends + fingerprint checks disabled
    # (memory_checking.rs:546-586).
    del gamma, tau
