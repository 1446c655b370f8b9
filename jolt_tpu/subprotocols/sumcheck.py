"""The sumcheck protocol: batched device prover + host verifier.

Prover semantics mirror the reference's `SumcheckInstanceProof::prove_arbitrary`
(jolt-core/src/subprotocols/sumcheck.rs:81-177): each round evaluates the
combined polynomial at t = 0..degree over the half-hypercube (top-variable
split, extrapolation by repeated addition of hi-lo), interpolates the round
polynomial, appends its compressed form to the transcript, then binds all
polynomials to the challenge.

Device shape: every per-round pass is a single jitted dense kernel over
limb tensors; specialized provers (grand products, Spartan, instruction
lookups) build on the same round structure with fused combine functions.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..field import FElt, FieldSpec, fr_spec
from ..field import device as fd
from ..poly.mle import bind_top
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..transcript import Transcript


class SumcheckError(Exception):
    pass


@dataclass
class SumcheckInstanceProof:
    compressed_polys: list[CompressedUniPoly]

    def verify(self, claim: FElt, num_rounds: int, degree_bound: int,
               transcript: Transcript) -> tuple[FElt, list[FElt]]:
        """Host verification (sumcheck.rs:495-552). Returns (final claim, r)."""
        if len(self.compressed_polys) != num_rounds:
            raise SumcheckError(
                f"expected {num_rounds} round polys, got {len(self.compressed_polys)}")
        e = claim
        r: list[FElt] = []
        for poly in self.compressed_polys:
            if poly.degree() != degree_bound:
                raise SumcheckError(
                    f"round poly degree {poly.degree()} != bound {degree_bound}")
            poly.append_to_transcript(transcript)
            r_i = transcript.challenge_scalar()
            r.append(r_i)
            e = poly.eval_from_hint(e, r_i)
        return e, r


@partial(jax.jit, static_argnums=(0, 1, 2))
def _round_evals(spec: FieldSpec, comb_func, degree: int,
                 polys: tuple[jnp.ndarray, ...]) -> jnp.ndarray:
    """Evaluations of sum_x comb(polys(t, x)) at t = 0..degree -> [L, degree+1]."""
    n = polys[0].shape[-1]
    half = n // 2
    lows = tuple(p[..., :half] for p in polys)
    highs = tuple(p[..., half:] for p in polys)

    def total(params):
        return fd.fsum(spec, comb_func(spec, params), axis=-1)

    evals = [total(lows), total(highs)]
    cur = highs
    for _ in range(2, degree + 1):
        cur = tuple(fd.fadd(spec, c, fd.fsub(spec, h, l))
                    for c, h, l in zip(cur, highs, lows))
        evals.append(total(cur))
    return jnp.stack(evals, axis=1)


@partial(jax.jit, static_argnums=0)
def _bind_all(spec: FieldSpec, polys: tuple[jnp.ndarray, ...],
              r: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    return tuple(bind_top(spec, p, r) for p in polys)


def _final_evals_batched(spec: FieldSpec, polys) -> list[FElt]:
    """Pull every poly's bound value p[..., 0] in ONE stacked fetch
    (one transfer instead of one per polynomial)."""
    if not polys:
        return []
    stacked = jnp.stack([p[..., 0] for p in polys], axis=1)   # [L, P]
    return [FElt(int(v), spec)
            for v in fd.device_to_ints(spec, stacked).tolist()]


def _device_scalars_to_felts(spec: FieldSpec, arr: jnp.ndarray) -> list[FElt]:
    ints = fd.device_to_ints(spec, arr)
    return [FElt(int(v), spec) for v in ints.tolist()]


def prove_arbitrary(num_rounds: int,
                    polys: Sequence[jnp.ndarray],
                    comb_func: Callable,
                    degree: int,
                    transcript: Transcript,
                    spec: FieldSpec | None = None,
                    ) -> tuple[SumcheckInstanceProof, list[FElt], list[FElt]]:
    """Generic sumcheck prover over device MLE limb tensors.

    comb_func(spec, params) -> limb tensor, where params is a tuple of
    [L, half]-shaped limb tensors (one per polynomial).  Pass a stable
    (module-level) function so the jitted round kernel caches across calls.

    Returns (proof, challenge point r, final per-poly evaluations).
    """
    spec = spec or fr_spec()
    polys = tuple(polys)
    # roofline accounting (approximate — comb_func cost assumed to be the
    # (npolys-1)-mul product form): per round at half-size h, (degree+1)
    # comb evaluations of h*(npolys-1) muls plus the npolys*h bind muls
    from ..utils.profiling import span
    _np = len(polys)
    _n = int(polys[0].shape[-1]) if polys else 0
    _ops = sum((_n >> (j + 1)) * ((degree + 1) * (_np - 1) + _np)
               for j in range(num_rounds))
    with span("Sumcheck::prove_arbitrary", ops=_ops):
        if num_rounds > 0 and backend.profile().device_fs:
            compressed, r, polys = _prove_rounds_device(
                num_rounds, polys, comb_func, degree, transcript, spec,
                bot=False, claim=None)
            final_evals = _final_evals_batched(spec, polys)
            return SumcheckInstanceProof(compressed), r, final_evals
        r: list[FElt] = []
        compressed: list[CompressedUniPoly] = []
        h = polys[0].shape[-1] // 2
        ev_fn, bind_fn = _round_fns(bot=False)
        for _ in range(num_rounds):
            evals_dev = ev_fn(spec, comb_func, degree, polys, h)
            evals = _device_scalars_to_felts(spec, evals_dev)
            round_poly = UniPoly.from_evals(evals)
            cpoly = round_poly.compress()
            cpoly.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar()
            r.append(r_j)
            rv = fd.scalar_to_device(spec, r_j.v)
            polys = bind_fn(spec, polys, rv, h)
            compressed.append(cpoly)
            h //= 2
        final_evals = [
            FElt(fd.to_int(spec, p[..., 0]), spec) for p in polys
        ]
        return SumcheckInstanceProof(compressed), r, final_evals


@partial(jax.jit, static_argnums=(0, 1, 2))
def _round_evals_bot(spec: FieldSpec, comb_func, degree: int,
                     polys: tuple[jnp.ndarray, ...]) -> jnp.ndarray:
    """Bottom-variable variant: pairs (2i, 2i+1) (sumcheck.rs:185-317)."""
    lows = tuple(p[..., 0::2] for p in polys)
    highs = tuple(p[..., 1::2] for p in polys)

    def total(params):
        return fd.fsum(spec, comb_func(spec, params), axis=-1)

    evals = [total(lows), total(highs)]
    cur = highs
    for _ in range(2, degree + 1):
        cur = tuple(fd.fadd(spec, c, fd.fsub(spec, h, l))
                    for c, h, l in zip(cur, highs, lows))
        evals.append(total(cur))
    return jnp.stack(evals, axis=1)


@partial(jax.jit, static_argnums=0)
def _bind_all_bot(spec: FieldSpec, polys: tuple[jnp.ndarray, ...],
                  r: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    from ..poly.mle import bind_bot
    return tuple(bind_bot(spec, p, r) for p in polys)


def prove_arbitrary_bot(num_rounds: int, polys, comb_func, degree: int,
                        transcript: Transcript, spec: FieldSpec | None = None,
                        claim: FElt | None = None):
    """Bottom-binding sumcheck (used by Spartan's outer sumcheck; the final
    evaluation point must be REVERSED by the caller, spartan.rs:146).

    If `claim` is given, round evals at t=1 are derived as claim - e0 (the
    reference's hint trick); values are identical for honest provers.
    """
    spec = spec or fr_spec()
    polys = tuple(polys)
    if num_rounds > 0 and backend.profile().device_fs:
        compressed, r, polys = _prove_rounds_device(
            num_rounds, polys, comb_func, degree, transcript, spec,
            bot=True, claim=claim)
        final_evals = _final_evals_batched(spec, polys)
        return SumcheckInstanceProof(compressed), r, final_evals
    r: list[FElt] = []
    compressed: list[CompressedUniPoly] = []
    previous_claim = claim
    h = polys[0].shape[-1] // 2
    ev_fn, bind_fn = _round_fns(bot=True)
    for _ in range(num_rounds):
        evals_dev = ev_fn(spec, comb_func, degree, polys, h)
        evals = _device_scalars_to_felts(spec, evals_dev)
        if previous_claim is not None:
            evals[1] = previous_claim - evals[0]
        round_poly = UniPoly.from_evals(evals)
        cpoly = round_poly.compress()
        cpoly.append_to_transcript(transcript)
        r_j = transcript.challenge_scalar()
        r.append(r_j)
        rv = fd.scalar_to_device(spec, r_j.v)
        polys = bind_fn(spec, polys, rv, h)
        if previous_claim is not None:
            previous_claim = round_poly.evaluate(r_j)
        compressed.append(cpoly)
        h //= 2
    final_evals = [FElt(fd.to_int(spec, p[..., 0]), spec) for p in polys]
    return SumcheckInstanceProof(compressed), r, final_evals


# -- fixed-shape MASKED round kernels ----------------------------------------
#
# A sumcheck's polynomials halve every round; compiling one XLA program per
# halving shape made a full-VM prove compile ~2000 programs.  The masked
# kernels below keep
# every tensor at its FULL initial size N with a TRACED active length h:
# one compiled program serves every round of the sumcheck.  Dead lanes are
# zeros (maintained by the masked bind), and the combine output is masked
# before the reduction, so round evaluations are bit-identical to the
# shrinking-shape path.  Work per round is O(N) instead of O(h).

def _round_evals_masked(spec: FieldSpec, comb_func, degree: int,
                        polys, h) -> jnp.ndarray:
    """Top-variable masked round evals: active pairs are (i, i+h), i < h,
    inside [.., N] tensors.  h: traced int32."""
    N = polys[0].shape[-1]
    H = N // 2
    lows = tuple(p[..., :H] for p in polys)
    highs = tuple(jax.lax.dynamic_slice_in_dim(p, h, H, axis=-1)
                  for p in polys)
    mask = jnp.arange(H, dtype=jnp.int32) < h

    def total(params):
        return fd.fsum(spec, jnp.where(mask, comb_func(spec, params),
                                       jnp.uint32(0)), axis=-1)

    evals = [total(lows), total(highs)]
    cur = highs
    for _ in range(2, degree + 1):
        cur = tuple(fd.fadd(spec, c, fd.fsub(spec, hi, lo))
                    for c, hi, lo in zip(cur, highs, lows))
        evals.append(total(cur))
    return jnp.stack(evals, axis=1)


def _bind_all_masked(spec: FieldSpec, polys, r: jnp.ndarray, h):
    """Masked top-bind: out[i] = lo[i] + r*(hi[i] - lo[i]) for i < h,
    zero beyond — output stays [.., N] with active prefix h."""
    out = []
    mask = None
    for p in polys:
        N = p.shape[-1]
        H = N // 2
        if mask is None:
            mask = jnp.arange(H, dtype=jnp.int32) < h
        lo = p[..., :H]
        hi = jax.lax.dynamic_slice_in_dim(p, h, H, axis=-1)
        rb = jnp.broadcast_to(
            r.reshape((fd.L,) + (1,) * (p.ndim - 2) + (1,)), lo.shape)
        bound = fd.fadd(spec, lo, fd.fmul(spec, rb, fd.fsub(spec, hi, lo)))
        bound = jnp.where(mask, bound, jnp.uint32(0))
        out.append(jnp.concatenate([bound, jnp.zeros_like(bound)], axis=-1))
    return tuple(out)


def _round_evals_bot_masked(spec: FieldSpec, comb_func, degree: int,
                            polys, h) -> jnp.ndarray:
    """Bottom-variable masked round evals: active pairs (2i, 2i+1), i < h —
    strided slices of the fixed array, no dynamic offsets needed."""
    N = polys[0].shape[-1]
    H = N // 2
    lows = tuple(p[..., 0::2] for p in polys)
    highs = tuple(p[..., 1::2] for p in polys)
    mask = jnp.arange(H, dtype=jnp.int32) < h

    def total(params):
        return fd.fsum(spec, jnp.where(mask, comb_func(spec, params),
                                       jnp.uint32(0)), axis=-1)

    evals = [total(lows), total(highs)]
    cur = highs
    for _ in range(2, degree + 1):
        cur = tuple(fd.fadd(spec, c, fd.fsub(spec, hi, lo))
                    for c, hi, lo in zip(cur, highs, lows))
        evals.append(total(cur))
    return jnp.stack(evals, axis=1)


def _bind_all_bot_masked(spec: FieldSpec, polys, r: jnp.ndarray, h):
    out = []
    mask = None
    for p in polys:
        H = p.shape[-1] // 2
        if mask is None:
            mask = jnp.arange(H, dtype=jnp.int32) < h
        lo, hi = p[..., 0::2], p[..., 1::2]
        rb = jnp.broadcast_to(
            r.reshape((fd.L,) + (1,) * (p.ndim - 2) + (1,)), lo.shape)
        bound = fd.fadd(spec, lo, fd.fmul(spec, rb, fd.fsub(spec, hi, lo)))
        bound = jnp.where(mask, bound, jnp.uint32(0))
        out.append(jnp.concatenate([bound, jnp.zeros_like(bound)], axis=-1))
    return tuple(out)


_round_evals_m_jit = jax.jit(_round_evals_masked, static_argnums=(0, 1, 2))
_bind_all_m_jit = jax.jit(_bind_all_masked, static_argnums=0)
_round_evals_bot_m_jit = jax.jit(_round_evals_bot_masked,
                                 static_argnums=(0, 1, 2))
_bind_all_bot_m_jit = jax.jit(_bind_all_bot_masked, static_argnums=0)


def _round_fns(bot: bool):
    """(evals_fn, bind_fn) with a unified (…, h) signature: the masked
    fixed-shape kernels or the per-shape shrinking kernels, as the profile's
    masked_rounds says (transcript-identical)."""
    if backend.profile().masked_rounds:
        if bot:
            return (lambda spec, comb, deg, polys, h:
                    _round_evals_bot_m_jit(spec, comb, deg, polys,
                                           np.int32(h)),
                    lambda spec, polys, rv, h:
                    _bind_all_bot_m_jit(spec, polys, rv, np.int32(h)))
        return (lambda spec, comb, deg, polys, h:
                _round_evals_m_jit(spec, comb, deg, polys, np.int32(h)),
                lambda spec, polys, rv, h:
                _bind_all_m_jit(spec, polys, rv, np.int32(h)))
    if bot:
        return (lambda spec, comb, deg, polys, h:
                _round_evals_bot(spec, comb, deg, polys),
                lambda spec, polys, rv, h: _bind_all_bot(spec, polys, rv))
    return (lambda spec, comb, deg, polys, h:
            _round_evals(spec, comb, deg, polys),
            lambda spec, polys, rv, h: _bind_all(spec, polys, rv))


def _prove_rounds_device(num_rounds, polys, comb_func, degree, transcript,
                         spec, bot: bool, claim):
    """Shared device-FS driver: enqueue rounds without a host sync, pull
    compressed polys once, replay the host transcript."""
    from . import fs_device as fsd
    use_hint = claim is not None
    h = polys[0].shape[-1] // 2
    if num_rounds > 0:
        state_dev, nr_dev = fsd.state_to_device(transcript)
        prev_dev = fd.scalar_to_device(spec, claim.v) if use_hint \
            else fd.zeros(spec, ())
        # decomposed device-FS: evals -> shared FS round program -> bind
        # (no host sync; no fused per-comb mega-program)
        fs_round = fsd.fs_round_jit(spec, degree, use_hint)
        ev_fn, bind_fn = _round_fns(bot)
        comps = []
        for _ in range(num_rounds):
            evals_dev = ev_fn(spec, comb_func, degree, polys, h)
            comp, rj, prev_dev, state_dev, nr_dev = fs_round(
                evals_dev, prev_dev, state_dev, nr_dev)
            polys = bind_fn(spec, polys, rj, h)
            comps.append(comp)
            h //= 2
        comp_ints = fd.device_to_ints(spec, jnp.stack(comps, axis=1))
        compressed, r = fsd.replay_and_check(spec, comp_ints, transcript,
                                             state_dev, CompressedUniPoly)
    return compressed, r, polys


# -- common combine functions (stable objects for jit caching) ---------------

def comb_product(spec: FieldSpec, params):
    out = params[0]
    for p in params[1:]:
        out = fd.fmul(spec, out, p)
    return out
