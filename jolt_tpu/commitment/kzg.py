"""Univariate KZG over BN254 (reference: poly/commitment/kzg.rs).

* SRS generation is DEVICE-side: powers of tau are host scalars, but the
  G1 points g*tau^i are produced by a fixed-base windowed table gather +
  log-depth point tree-sum on device (the reference computes them with a
  CPU fixed-base MSM, kzg.rs:22-84).  SRS points are kept in Jacobian form
  (the general device point-add needs no affine normalization).
* commit = device Pippenger MSM over the SRS prefix.
* open(B, u): the quotient q = (B - B(u)) / (X - u) is computed WITHOUT a
  sequential synthetic-division scan: q[j] = u^{-(j+1)} * suffix_j+1(b_i u^i),
  i.e. two power tables + a log-depth suffix sum — dense device ops.
* verify: host pairing check e(C - v*g - u*W, g2) * e(W, beta_g2)^-1 == 1.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..curve import device as cd
from ..curve.bn254 import G1Affine, G1Jacobian, G2Affine
from ..curve.pairing import pairing_product_is_one
from ..field import FElt, FieldSpec, fr_spec
from ..field import device as fd

FR = fr_spec()


# ---------------------------------------------------------------------------
# SRS
# ---------------------------------------------------------------------------

@dataclass
class KZGProverKey:
    g1_jac: tuple  # (X, Y, Z) device limb tensors [L, N] — g * tau^i
    n: int
    _g_products: list | None = None  # lazily: sum(g1[:2^k]) per k (kzg.rs:66-77)

    def g_products(self) -> list:
        """All-ones-vector commitments per power-of-two length [FORK]
        (kzg.rs:66-77) — lazily computed with a log-depth device pass."""
        if self._g_products is None:
            self._g_products = _compute_g_products(self.g1_jac, self.n)
        return self._g_products


@dataclass
class KZGVerifierKey:
    g1: G1Affine
    g2: G2Affine
    beta_g2: G2Affine  # g2 * tau


def _fixed_base_table(base: G1Affine, c: int = 8, windows: int = 32):
    """Host table T[w][d] = base * (d << (c*w)); [windows, 2^c] affine."""
    table = []
    cur_base = base.to_jacobian()
    for _ in range(windows):
        row = [G1Jacobian.identity()]
        for d in range(1, 1 << c):
            row.append(row[-1].add(cur_base))
        table.append([p.to_affine() for p in row])
        for _ in range(c):
            cur_base = cur_base.double()
    return table


@partial(jax.jit, static_argnums=())
def _srs_points(tx, ty, tinf, digits):
    """Gather fixed-base table entries and sum the 32 windows.

    tx/ty: [L, W, 2^c] table coords; tinf: [W, 2^c]; digits: [W, N].
    Returns Jacobian (X, Y, Z) of shape [L, N].  The windows fold in
    sequence under lax.scan: one jac_add body to compile (an unrolled
    tree compiles W - 1 of them) for the same W - 1 adds."""
    gx = jnp.take_along_axis(tx, digits[None, :, :], axis=2)   # [L, W, N]
    gy = jnp.take_along_axis(ty, digits[None, :, :], axis=2)
    ginf = jnp.take_along_axis(tinf, digits, axis=1)           # [W, N]
    one = fd.ones(cd.FQ, ginf.shape)
    gz = jnp.where(ginf[None], jnp.zeros_like(one), one)
    win = tuple(jnp.moveaxis(t, 1, 0) for t in (gx, gy, gz))   # [W, L, N]
    acc, _ = jax.lax.scan(lambda p, q: (cd.jac_add(p, q), None),
                          tuple(t[0] for t in win),
                          tuple(t[1:] for t in win))
    return acc


def _srs_cache_path(n: int, seed: int) -> str | None:
    """Disk cache for generated SRS point tensors (large SRS only): the
    seed is deterministic, so the G1 powers are pure functions of
    (n, seed) — repeated bench/CLI runs skip the device generation pass.
    Disable with JOLT_TPU_SRS_CACHE=0."""
    import os
    if n < (1 << 12) or os.environ.get("JOLT_TPU_SRS_CACHE", "1") in ("0", ""):
        return None
    from ..utils.caches import srs_cache_dir
    return os.path.join(srs_cache_dir(), f"srs_{n}_{seed:x}.npz")


def srs_setup(max_degree: int, seed: int = 0x6A6F6C74) -> tuple[KZGProverKey, KZGVerifierKey]:
    """Generate a (test/dev) SRS from a deterministic seed.

    Production deployments load a ceremony SRS instead; the reference
    similarly generates from an RNG in tests (kzg.rs:22-84).
    """
    rng = random.Random(seed)
    tau = rng.randrange(1, FR.p)
    n = max_degree

    cache = _srs_cache_path(n, seed)
    if cache is not None:
        import os
        if os.path.exists(cache):
            try:
                z = np.load(cache)
                X, Y, Z = (jnp.asarray(z[k]) for k in ("X", "Y", "Z"))
                g2 = G2Affine.generator()
                vk = KZGVerifierKey(G1Affine.generator(), g2, g2.mul(tau))
                return KZGProverKey((X, Y, Z), n), vk
            except Exception:
                pass  # corrupt/partial cache file: regenerate below

    # powers of tau: host computes only the first chunk (<= 2^16 bigint
    # muls); every further chunk is the previous one scaled by tau^C on
    # device — ONE compiled [L, C] fmul reused across all chunks.  This
    # replaces the 2^21-iteration host bigint loop + per-element
    # pack_ints that dominated SRS wall time.
    C = min(n, 1 << 16)
    powers = np.empty(C, dtype=object)
    acc = 1
    for i in range(C):
        powers[i] = acc
        acc = acc * tau % FR.p
    chunk = fd.to_mont_device(FR, jnp.asarray(fd.pack_ints(powers)))
    chunks = [chunk]
    if n > C:
        step_c = fd.scalar_to_device(FR, pow(tau, C, FR.p))[:, None]
        for _ in range(n // C - 1):
            chunk = fd.fmul(FR, chunk, step_c)
            chunks.append(chunk)
    P = jnp.concatenate(chunks, axis=-1) if len(chunks) > 1 else chunk
    powers_limbs = fd.from_mont_device(FR, P[:, :n])  # canonical [L, N]

    table = _fixed_base_table(G1Affine.generator())
    tx = fd.ints_to_device(cd.FQ, [[p.x for p in row] for row in table])
    ty = fd.ints_to_device(cd.FQ, [[p.y for p in row] for row in table])
    tinf = jnp.asarray(np.array([[p.is_infinity for p in row] for row in table]))

    digits = jnp.stack([
        ((powers_limbs[w // 2] >> jnp.uint32(8 * (w % 2)))
         & jnp.uint32(0xFF)).astype(jnp.int32)
        for w in range(32)])
    # Chunk over N: the gather materializes [L, 32, N] coordinate tensors
    # (plus the tree-sum intermediates), which at N = 2^21 (RAM-sized SRS)
    # is tens of GB — beyond HBM.  Fixed-size chunks keep peak memory
    # bounded AND reuse one compiled program for every chunk.
    chunk = 1 << 16
    if n <= chunk:
        X, Y, Z = _srs_points(tx, ty, tinf, digits)
    else:
        parts = []
        for off in range(0, n, chunk):
            d = digits[:, off:off + chunk]
            if d.shape[1] < chunk:  # pad tail to the compiled shape
                d = jnp.pad(d, ((0, 0), (0, chunk - d.shape[1])))
            parts.append(_srs_points(tx, ty, tinf, d))
        X, Y, Z = (jnp.concatenate(t, axis=1)[:, :n]
                   for t in zip(*parts))

    g2 = G2Affine.generator()
    vk = KZGVerifierKey(G1Affine.generator(), g2, g2.mul(tau))
    if cache is not None:
        try:  # atomic publish: a killed writer must not poison readers
            import os
            tmp = cache + f".tmp{os.getpid()}.npz"
            np.savez(tmp, X=np.asarray(X), Y=np.asarray(Y), Z=np.asarray(Z))
            os.replace(tmp, cache)
        except Exception:
            pass
    return KZGProverKey((X, Y, Z), n), vk


def srs_from_points(g1_points: list[G1Affine], g2: G2Affine,
                    beta_g2: G2Affine) -> tuple[KZGProverKey, KZGVerifierKey]:
    """Build prover/verifier keys from an imported SRS (e.g. a ceremony
    SRS loaded via utils/ark_serialize.load_srs — kzg.rs:22-84 loads ark
    bytes the same way)."""
    X, Y, inf = cd.points_to_device(g1_points)
    one = fd.ones(cd.FQ, (len(g1_points),))
    Z = jnp.where(jnp.asarray(inf)[None], jnp.zeros_like(one), one)
    return (KZGProverKey((X, Y, Z), len(g1_points)),
            KZGVerifierKey(g1_points[0], g2, beta_g2))


def srs_g1_host(pk: KZGProverKey) -> list[G1Affine]:
    """Pull the SRS G1 powers back to host affine points (persistence)."""
    return [p.to_affine() for p in cd.jacobian_to_host(*pk.g1_jac)]


# ---------------------------------------------------------------------------
# commit / open / verify
# ---------------------------------------------------------------------------

def kzg_commit(pk: KZGProverKey, coeffs_mont: jnp.ndarray) -> G1Affine:
    """Commit to coefficient vector (bitplane device MSM over the SRS)."""
    return cd.msm_bitplane(pk.g1_jac, coeffs_mont, FR)


def kzg_commit_batch(pk: KZGProverKey, polys: list,
                     mesh=None) -> list[G1Affine]:
    """Batch commit: all polynomials' scalar bit-planes share one kernel
    stream over the same SRS bases (the ~90-column witness commit,
    vm/mod.rs:393, is the reference prover's #1 cost)."""
    return cd.batch_msm_bitplane(pk.g1_jac, list(polys), FR, mesh=mesh)


@partial(jax.jit, static_argnums=())
def _point_tree_level(P):
    return cd.jac_add(tuple(t[..., 0::2] for t in P),
                      tuple(t[..., 1::2] for t in P))


def _compute_g_products(g1_jac, n: int) -> list:
    """[sum(g1[:2^k]) for k in 0..log2(n)] via one pairwise-reduction sweep:
    after j halvings, element 0 is the prefix sum of the first 2^j points."""
    k_max = n.bit_length() - 1
    P = tuple(t[..., :1 << k_max] for t in g1_jac)
    first = lambda Q: cd.jacobian_to_host(*(t[..., 0:1] for t in Q))[0]
    products = [first(P)]
    for _ in range(k_max):
        P = _point_tree_level(P)
        products.append(first(P))
    return products


def kzg_commit_grand_product(pk: KZGProverKey, coeffs_mont: jnp.ndarray
                             ) -> G1Affine:
    """CommitMode::GrandProduct [FORK] (kzg.rs:137-144, 223-256): ~93% of
    grand-product leaf coefficients are 1, so commit g_products[k] plus the
    MSM of the (coeff - 1) residual.  Identical commitment bytes; on CPU it
    skips most bucket adds, on the device it zeroes most MSM digits."""
    n = coeffs_mont.shape[-1]
    if n & (n - 1):
        return kzg_commit(pk, coeffs_mont)
    ones = fd.ones(FR, (n,))
    residual = fd.fsub(FR, coeffs_mont, ones)
    X, Y, Z = pk.g1_jac
    pts = (X[..., :n], Y[..., :n], Z[..., :n])
    msm_part = _msm_jac(pts, residual)
    total = pk.g_products()[n.bit_length() - 1].add(msm_part.to_jacobian())
    return total.to_affine()


def _msm_jac(points_jac, scalars_mont: jnp.ndarray) -> G1Affine:
    """MSM accepting Jacobian device points (bitplane, size-adaptive)."""
    n = scalars_mont.shape[-1]
    pts = tuple(t[..., :n] for t in points_jac)
    return cd.msm_bitplane(pts, scalars_mont, FR)


@partial(jax.jit, static_argnums=(2,))
def _msm_windows_jac(points_jac, scalar_limbs, n_windows=None):
    px, py, pz = points_jac
    inf_mask = jnp.all(pz == 0, axis=0)
    return cd._msm_windows_impl(px, py, pz, inf_mask, scalar_limbs, n_windows)


def msm_jacobian(points_jac, scalars_mont: jnp.ndarray) -> G1Affine:
    return _msm_jac(points_jac, scalars_mont)


@partial(jax.jit, static_argnums=(0, 2))
def _powers_device(spec: FieldSpec, u: jnp.ndarray, n: int) -> jnp.ndarray:
    """[1, u, u^2, ..., u^{n-1}] by log-doubling; u: [L] Montgomery."""
    table = fd.ones(spec, (1,))
    cur = u[:, None]
    while table.shape[-1] < n:
        k = table.shape[-1]
        ext = fd.fmul(spec, table, jnp.broadcast_to(cur, table.shape))
        table = jnp.concatenate([table, ext], axis=-1)
        cur = fd.fmul(spec, cur, cur)
    return table[..., :n]


@partial(jax.jit, static_argnums=0)
def _quotient_coeffs(spec: FieldSpec, b: jnp.ndarray, upow: jnp.ndarray,
                     uinv_pow: jnp.ndarray) -> jnp.ndarray:
    """q[j] = u^{-(j+1)} * sum_{i >= j+1} b_i u^i, j = 0..n-2."""
    n = b.shape[-1]
    terms = fd.fmul(spec, b, upow)                     # b_i u^i
    # suffix sums via Hillis-Steele
    s = terms
    d = 1
    while d < n:
        shifted = jnp.concatenate(
            [s[..., d:], jnp.zeros_like(s[..., :d])], axis=-1)
        s = fd.fadd(spec, s, shifted)
        d *= 2
    suffix = s[..., 1:]                                 # S[j+1], j = 0..n-2
    return fd.fmul(spec, suffix, uinv_pow[..., 1:n])    # u^{-(j+1)}


def kzg_open_no_rem(pk: KZGProverKey, coeffs_mont: jnp.ndarray,
                    u: FElt) -> G1Affine:
    """Commitment to (B(X) - B(u)) / (X - u) (kzg.rs:258-275)."""
    n = coeffs_mont.shape[-1]
    u_dev = fd.scalar_to_device(FR, u.v)
    uinv_dev = fd.scalar_to_device(FR, pow(u.v, -1, FR.p))
    upow = _powers_device(FR, u_dev, n)
    uinv_pow = _powers_device(FR, uinv_dev, n)
    q = _quotient_coeffs(FR, coeffs_mont, upow, uinv_pow)
    return kzg_commit(pk, q)


def kzg_verify(vk: KZGVerifierKey, commitment: G1Affine, u: FElt, v: FElt,
               w: G1Affine) -> bool:
    """Pairing check e(C - v*g + u*W, g2) == e(W, beta_g2) (kzg.rs:277-296)."""
    lhs = (commitment.to_jacobian()
           .add(vk.g1.to_jacobian().mul((-v.v) % FR.p))
           .add(w.to_jacobian().mul(u.v))).to_affine()
    return pairing_product_is_one([(lhs, vk.g2), (w.neg(), vk.beta_g2)])


def poly_eval_device(coeffs_mont: jnp.ndarray, u: FElt) -> FElt:
    """Univariate evaluation sum b_i u^i via a power-table dot product."""
    n = coeffs_mont.shape[-1]
    upow = _powers_device(FR, fd.scalar_to_device(FR, u.v), n)
    return FElt(fd.to_int(FR, fd.fsum(FR, fd.fmul(FR, coeffs_mont, upow),
                                      axis=-1)), FR)
