"""HyperKZG multilinear PCS (reference: poly/commitment/hyperkzg.rs).

Gemini-style multilinear-to-univariate transformation over the EVALUATION
vector (no FFTs): ell-1 bottom-variable foldings produce halving polynomials
P_i, each committed with univariate KZG; all are batch-opened at {r, -r, r^2}
with q-powers RLC and a single multi-pairing check.

Device work: foldings are dense bind kernels, commitments are Pippenger
MSMs, quotients use the suffix-sum formulation (kzg.py).  Verification is
host-side (one small MSM + one pairing product).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import jax.numpy as jnp

from ..curve.bn254 import G1Affine, g1_msm_host
from ..curve.pairing import pairing_product_is_one
from ..field import FElt, FieldSpec, fr_spec
from ..field import device as fd
from ..poly.mle import bind_bot
from ..poly.opening_proof import rlc_polys
from ..transcript import Transcript
from .base import BatchType, CommitShape
from .kzg import (KZGProverKey, KZGVerifierKey, kzg_commit,
                  kzg_commit_batch, kzg_commit_grand_product,
                  kzg_open_no_rem, poly_eval_device, srs_setup)

FR = fr_spec()


@dataclass
class HyperKZGCommitment:
    point: G1Affine

    def append_to_transcript(self, transcript: Transcript) -> None:
        transcript.append_point(None if self.point.is_infinity else self.point)

    def __eq__(self, other):
        return self.point == other.point


@dataclass
class HyperKZGProof:
    com: list[G1Affine]          # commitments to P_1 .. P_{ell-1}
    w: list[G1Affine]            # KZG witnesses at r, -r, r^2
    v: list[list[FElt]]          # v[j][i] = P_i(u_j), 3 x ell


class HyperKZG:
    def __init__(self, pk: KZGProverKey, vk: KZGVerifierKey,
                 spec: FieldSpec | None = None):
        self.pk = pk
        self.vk = vk
        self.spec = spec or FR

    @staticmethod
    def protocol_name() -> bytes:
        return b"HyperKZG"

    @classmethod
    def setup(cls, shapes: Sequence[CommitShape] | int, seed: int = 0x6A6F6C74
              ) -> "HyperKZG":
        if isinstance(shapes, int):
            max_len = shapes
        else:
            max_len = max(s.input_length for s in shapes)
        pk, vk = srs_setup(max_len, seed)
        return cls(pk, vk)

    @classmethod
    def from_srs(cls, g1_points, g2, beta_g2) -> "HyperKZG":
        """Instantiate from imported SRS points (ceremony / persisted file;
        see utils/ark_serialize.load_srs and kzg.srs_from_points)."""
        from .kzg import srs_from_points
        pk, vk = srs_from_points(g1_points, g2, beta_g2)
        return cls(pk, vk)

    def save_srs(self, path: str) -> None:
        """Persist the SRS in ark-compatible bytes (rv32i_vm.rs:193-235
        preprocessing persistence analog)."""
        from ..utils.ark_serialize import save_srs
        from .kzg import srs_g1_host
        save_srs(path, srs_g1_host(self.pk), self.vk.g2, self.vk.beta_g2)

    @classmethod
    def load_srs(cls, path: str) -> "HyperKZG":
        from ..utils.ark_serialize import load_srs
        g1, g2, beta_g2 = load_srs(path)
        return cls.from_srs(g1, g2, beta_g2)

    # -- commitments ---------------------------------------------------------
    def commit(self, poly: jnp.ndarray) -> HyperKZGCommitment:
        return HyperKZGCommitment(kzg_commit(self.pk, poly))

    def batch_commit(self, polys: Sequence[jnp.ndarray],
                     batch_type: BatchType = BatchType.BIG, mesh=None
                     ) -> list[HyperKZGCommitment]:
        """GrandProduct batches take the mostly-ones shortcut [FORK]
        (hyperkzg.rs:554-566 -> kzg.rs:223-256); same commitment bytes.
        With `mesh`, the MSM point axis is sharded across the chips
        (each owns an SRS slice; per-bit-plane partial sums reduce
        cross-chip — the pjit analog of msm/mod.rs:87-109's rayon)."""
        if batch_type == BatchType.GRAND_PRODUCT:
            return [HyperKZGCommitment(kzg_commit_grand_product(self.pk, p))
                    for p in polys]
        return [HyperKZGCommitment(p)
                for p in kzg_commit_batch(self.pk, list(polys), mesh=mesh)]

    def combine_commitments(self, commitments: Sequence[HyperKZGCommitment],
                            coeffs: Sequence[FElt]) -> HyperKZGCommitment:
        pts = [c.point for c in commitments]
        return HyperKZGCommitment(g1_msm_host(pts, [c.v for c in coeffs]))

    # -- opening --------------------------------------------------------------
    def prove(self, poly: jnp.ndarray, opening_point: Sequence[FElt],
              transcript: Transcript) -> HyperKZGProof:
        """Open (hyperkzg.rs:311-362)."""
        spec = self.spec
        point = list(opening_point)
        ell = len(point)
        assert poly.shape[-1] == 1 << ell

        # Folds below FOLD_BUCKET are kept zero-padded AT the bucket size:
        # bind_bot of a zero-padded vector is the bound vector zero-padded
        # (pairs of zeros bind to zero), and zero coefficients change
        # neither KZG commitments nor evaluations — so every fold round
        # reuses ONE (bind, pad) pair of compiled programs instead of one
        # program (and compile) per halving shape.
        FOLD_BUCKET = 4096
        cur = poly
        polys = [poly]
        # ONE packed upload for every fold challenge (not one per scalar)
        if ell > 1:
            r_folds = fd.ints_to_device(
                spec, [point[ell - i - 1].v for i in range(ell - 1)])
        for i in range(ell - 1):
            cur = bind_bot(spec, cur, fd.col(r_folds, i))
            if cur.shape[-1] < min(FOLD_BUCKET, poly.shape[-1]):
                cur = jnp.pad(cur, ((0, 0), (0, cur.shape[-1])))
            polys.append(cur)

        com = kzg_commit_batch(self.pk, polys[1:])
        transcript.append_points(com)
        r = transcript.challenge_scalar()
        u = [r, FElt(-r.v, spec), r * r]

        w, v = self._kzg_open_batch(polys, u, transcript)
        return HyperKZGProof(com, w, v)

    def _kzg_open_batch(self, polys, u, transcript: Transcript):
        """(hyperkzg.rs:158-199)."""
        spec = self.spec
        k = len(polys)
        # all 3k evaluations with ONE eval-point upload + ONE value pull
        # (poly_eval_device costs an upload + a pull per call; an open has
        # 3*(ell+1) of them)
        from ..commitment.kzg import FR, _powers_device
        u_dev = fd.ints_to_device(spec, [x.v for x in u])     # [L, 3]
        by_shape: dict[int, list[int]] = {}
        for i, f in enumerate(polys):
            by_shape.setdefault(f.shape[-1], []).append(i)
        pend = []
        for n, idxs in by_shape.items():
            stacked = jnp.stack([polys[i] for i in idxs], axis=1)
            for j in range(len(u)):
                upow = _powers_device(FR, fd.col(u_dev, j), n)
                s = fd.fsum(spec, fd.fmul(spec, stacked, upow[:, None, :]),
                            axis=-1)                          # [L, P]
                pend.append((j, idxs, s))
        allv = fd.device_to_ints(
            spec, jnp.concatenate([s for (_, _, s) in pend], axis=-1)
        ).tolist()
        vals: dict[tuple[int, int], FElt] = {}
        pos = 0
        for j, idxs, _ in pend:
            for i in idxs:
                vals[(j, i)] = FElt(int(allv[pos]), spec)
                pos += 1
        v = [[vals[(j, i)] for i in range(k)] for j in range(len(u))]
        transcript.append_scalars([x for row in v for x in row])
        q_powers = transcript.challenge_scalar_powers(k)
        B = rlc_polys(spec, polys, q_powers, pad_to=polys[0].shape[-1])
        w = [kzg_open_no_rem(self.pk, B, uj) for uj in u]
        transcript.append_points(w)
        transcript.challenge_scalar()  # d_0, used only by the verifier
        return w, v

    # -- verification ----------------------------------------------------------
    def verify(self, proof: HyperKZGProof, transcript: Transcript,
               opening_point: Sequence[FElt], opening: FElt,
               commitment: HyperKZGCommitment) -> None:
        """(hyperkzg.rs:365-470 + kzg_verify_batch 201-281)."""
        spec = self.spec
        point = list(opening_point)
        ell = len(point)
        y = opening
        one = FElt(1, spec)
        two = FElt(2, spec)

        transcript.append_points(proof.com)
        r = transcript.challenge_scalar()
        assert not r.is_zero() and not commitment.point.is_infinity
        com = [commitment.point] + list(proof.com)
        u = [r, FElt(-r.v, spec), r * r]

        v = proof.v
        assert len(v) == 3 and all(len(row) == ell for row in v)
        ypos, yneg = v[0], v[1]
        Y = list(v[2]) + [y]
        for i in range(ell):
            x = point[ell - i - 1]
            lhs = two * r * Y[i + 1]
            rhs = (r * (one - x) * (ypos[i] + yneg[i])
                   + x * (ypos[i] - yneg[i]))
            assert lhs == rhs, f"HyperKZG fold consistency failed at {i}"

        assert self._kzg_verify_batch(com, proof.w, u, v, transcript), \
            "HyperKZG batch KZG check failed"

    def _kzg_verify_batch(self, C: list[G1Affine], W: list[G1Affine],
                          u: list[FElt], v: list[list[FElt]],
                          transcript: Transcript) -> bool:
        spec = self.spec
        k = len(C)
        transcript.append_scalars([x for row in v for x in row])
        q_powers = transcript.challenge_scalar_powers(k)
        transcript.append_points(W)
        d0 = transcript.challenge_scalar()
        d1 = d0 * d0

        q_mult = FElt(1, spec) + d0 + d1
        B_u = []
        for row in v:
            acc = FElt(0, spec)
            for a, b in zip(row, q_powers):
                acc = acc + a * b
            B_u.append(acc)

        bases = C + [W[0], W[1], W[2], self.vk.g1]
        scalars = ([(q * q_mult).v for q in q_powers]
                   + [u[0].v, (u[1] * d0).v, (u[2] * d1).v,
                      (-(B_u[0] + d0 * B_u[1] + d1 * B_u[2])).v])
        L = g1_msm_host(bases, scalars)
        R = (W[0].to_jacobian().add(W[1].to_jacobian().mul(d0.v))
             .add(W[2].to_jacobian().mul(d1.v))).to_affine()
        return pairing_product_is_one([(L, self.vk.g2),
                                       (R.neg(), self.vk.beta_g2)])
