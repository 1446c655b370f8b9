"""Device (JAX) BN254 G1 arithmetic + Pippenger MSM.

Points are Jacobian coordinate triples of Fq limb tensors (infinity ⇔ Z = 0).
All branch cases (infinity, doubling, inverses) are handled with dense masked
selects — no data-dependent control flow.

MSM (replaces the reference's size-adaptive CPU Pippenger, msm/mod.rs:11-482)
is a sort-based windowed bucket method designed for a dense vector machine:
  1. extract c-bit digits for all windows at once -> [W, N]
  2. per window, sort point indices by digit and gather points
  3. segmented Hillis-Steele scan (log N dense masked point-add passes)
     reduces each bucket's run; segment tails are scattered into a dense
     [W, 2^c] bucket table
  4. suffix-scan + tree-sum over buckets gives each window's total
     (sum_d d*B_d = sum_{d>=1} suffix_d)
  5. the W window totals are combined on host (Horner, ~W*c point ops)
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..field import device as fd
from ..field.spec import FieldSpec, fq_spec, fr_spec, LIMB_BITS
from .bn254 import G1Affine, G1Jacobian, Q as Q_INT

FQ = fq_spec()
FR = fr_spec()


def _sq(x):
    return fd.fmul(FQ, x, x)


def _mul(x, y):
    return fd.fmul(FQ, x, y)


def _add(x, y):
    return fd.fadd(FQ, x, y)


def _sub(x, y):
    return fd.fsub(FQ, x, y)


def _dbl_f(x):
    return fd.fadd(FQ, x, x)


def _iszero(x):
    return jnp.all(x == 0, axis=0)


def jac_double(X, Y, Z):
    """a=0 Jacobian doubling (dbl-2009-l); infinity-safe (Z3 = 2YZ = 0)."""
    A = _sq(X)
    B = _sq(Y)
    C = _sq(B)
    xb = _add(X, B)
    D = _dbl_f(_sub(_sub(_sq(xb), A), C))
    E = _add(_add(A, A), A)
    F = _sq(E)
    X3 = _sub(F, _dbl_f(D))
    Y3 = _sub(_mul(E, _sub(D, X3)), _dbl_f(_dbl_f(_dbl_f(C))))
    Z3 = _dbl_f(_mul(Y, Z))
    return X3, Y3, Z3


def jac_add(p1, p2):
    """Full Jacobian addition with masked special cases."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    z1z1 = _sq(Z1)
    z2z2 = _sq(Z2)
    u1 = _mul(X1, z2z2)
    u2 = _mul(X2, z1z1)
    s1 = _mul(_mul(Y1, Z2), z2z2)
    s2 = _mul(_mul(Y2, Z1), z1z1)
    h = _sub(u2, u1)
    rr = _sub(s2, s1)
    h2 = _sq(h)
    h3 = _mul(h, h2)
    v = _mul(u1, h2)
    X3 = _sub(_sub(_sq(rr), h3), _dbl_f(v))
    Y3 = _sub(_mul(rr, _sub(v, X3)), _mul(s1, h3))
    Z3 = _mul(_mul(Z1, Z2), h)

    dX, dY, dZ = jac_double(X1, Y1, Z1)

    p1_inf = _iszero(Z1)
    p2_inf = _iszero(Z2)
    h_zero = _iszero(h) & ~p1_inf & ~p2_inf
    r_zero = _iszero(rr)
    is_dbl = h_zero & r_zero
    is_opp = h_zero & ~r_zero

    X3 = fd.fselect(is_dbl, dX, X3)
    Y3 = fd.fselect(is_dbl, dY, Y3)
    Z3 = fd.fselect(is_dbl, dZ, Z3)
    Z3 = fd.fselect(is_opp, jnp.zeros_like(Z3), Z3)
    # infinity propagation
    X3 = fd.fselect(p2_inf, X1, fd.fselect(p1_inf, X2, X3))
    Y3 = fd.fselect(p2_inf, Y1, fd.fselect(p1_inf, Y2, Y3))
    Z3 = fd.fselect(p2_inf, Z1, fd.fselect(p1_inf, Z2, Z3))
    return X3, Y3, Z3


def proj_cadd(p1, p2):
    """COMPLETE projective addition (a=0, b3=9; Renes–Costello–Batina 2016
    Alg. 7): 12 muls, no branches — identity (0:1:0), doubling and inverse
    inputs all come out right.  The MSM accumulate path uses this instead
    of the branched Jacobian add (~20 muls + select cascades)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    b3 = lambda t: _add(_dbl_f(_dbl_f(_dbl_f(t))), t)      # 9t
    t0 = _mul(X1, X2)
    t1 = _mul(Y1, Y2)
    t2 = _mul(Z1, Z2)
    t3 = _sub(_mul(_add(X1, Y1), _add(X2, Y2)), _add(t0, t1))
    t4 = _sub(_mul(_add(Y1, Z1), _add(Y2, Z2)), _add(t1, t2))
    X3 = _mul(_add(X1, Z1), _add(X2, Z2))
    Y3 = _sub(X3, _add(t0, t2))
    t0 = _add(_dbl_f(t0), t0)
    t2 = b3(t2)
    Z3 = _add(t1, t2)
    t1 = _sub(t1, t2)
    Y3 = b3(Y3)
    X3 = _sub(_mul(t3, t1), _mul(t4, Y3))
    Y3 = _add(_mul(Y3, t0), _mul(t1, Z3))
    Z3 = _add(_mul(Z3, t4), _mul(t0, t3))
    return X3, Y3, Z3


def proj_to_host_jac(X, Y, Z) -> list[G1Jacobian]:
    """Projective (X:Y:Z) -> host Jacobians (X·Z, Y·Z², Z) — no inversions."""
    xi = fd.device_to_ints(FQ, X).ravel()
    yi = fd.device_to_ints(FQ, Y).ravel()
    zi = fd.device_to_ints(FQ, Z).ravel()
    out = []
    for a, b, c in zip(xi, yi, zi):
        a, b, c = int(a), int(b), int(c)
        if c == 0:
            out.append(G1Jacobian.identity())
        else:
            out.append(G1Jacobian(a * c % Q_INT, b * c * c % Q_INT, c))
    return out


# ---------------------------------------------------------------------------
# host <-> device points
# ---------------------------------------------------------------------------

def points_to_device(points: list[G1Affine]):
    """Affine host points -> (x [L,N], y [L,N], inf_mask [N]) Montgomery."""
    xs = [p.x for p in points]
    ys = [p.y for p in points]
    inf = np.array([p.is_infinity for p in points])
    x = fd.ints_to_device(FQ, xs)
    y = fd.ints_to_device(FQ, ys)
    return x, y, jnp.asarray(inf)


def jacobian_to_host(X, Y, Z) -> list[G1Jacobian]:
    xi = fd.device_to_ints(FQ, X).ravel()
    yi = fd.device_to_ints(FQ, Y).ravel()
    zi = fd.device_to_ints(FQ, Z).ravel()
    return [G1Jacobian(int(a), int(b), int(c)) for a, b, c in zip(xi, yi, zi)]


# ---------------------------------------------------------------------------
# MSM
# ---------------------------------------------------------------------------

MSM_WINDOW_BITS = 8


def scalar_max_windows(canonical_limbs: jnp.ndarray,
                       window_bits: int = MSM_WINDOW_BITS) -> int:
    """Number of c-bit windows needed for the largest scalar (size-adaptive
    dispatch, msm/mod.rs:11-54: Jolt witness scalars are mostly tiny —
    flags, counters, u64 values — so most MSMs need 1-8 windows, not 32).
    One tiny device reduction + host sync; commitment bytes unchanged."""
    axes = tuple(range(1, canonical_limbs.ndim))
    limb_max = np.asarray(jax.device_get(jnp.max(canonical_limbs, axis=axes)))
    msb = 0
    for i, v in enumerate(limb_max.tolist()):
        if v:
            msb = LIMB_BITS * i + int(v).bit_length()
    return max(1, -(-msb // window_bits))


@partial(jax.jit, static_argnums=(4,))
def _msm_windows(px, py, inf_mask, scalar_limbs, n_windows=None):
    """Affine-input wrapper: all window totals -> Jacobian points [L, W]."""
    one = fd.ones(FQ, (px.shape[-1],))
    pz = jnp.where(inf_mask[None], jnp.zeros_like(one), one)
    return _msm_windows_impl(px, py, pz, inf_mask, scalar_limbs, n_windows)


def _msm_windows_impl(px, py, pz, inf_mask, scalar_limbs, n_windows=None,
                      window_bits: int = MSM_WINDOW_BITS):
    """Window totals of the MSM -> Jacobian points [L, W].

    px/py/pz: [L, N] Fq Montgomery Jacobian coords; inf_mask: [N] bool;
    scalar_limbs: [L, N] CANONICAL 16-bit Fr limbs; n_windows: how many
    low-order c-bit windows are (possibly) nonzero — every pass below
    scales linearly with it.  window_bits must divide LIMB_BITS; smaller
    values shrink the (unrolled) bucket scan graphs — the multichip dryrun
    uses 4 to keep XLA:CPU compile time down.
    """
    c = window_bits
    per_limb = LIMB_BITS // c
    W = n_windows or fd.L * per_limb
    N = px.shape[-1]

    # digits [W, N]
    digits = jnp.stack([(scalar_limbs[w // per_limb] >> (c * (w % per_limb)))
                        & jnp.uint32((1 << c) - 1) for w in range(W)])

    order = jnp.argsort(digits, axis=1)                    # [W, N]
    sd = jnp.take_along_axis(digits, order, axis=1)        # sorted digits
    gx = px[:, order]                                      # [L, W, N]
    gy = py[:, order]
    gz0 = pz[:, order]
    ginf = inf_mask[order]                                 # [W, N]
    active = (sd != 0) & ~ginf
    gz = jnp.where(active[None], gz0, jnp.zeros_like(gz0))

    # segmented inclusive scan by sorted digit (Hillis-Steele)
    P = (gx, gy, gz)
    d = 1
    while d < N:
        key_shift = jnp.concatenate(
            [jnp.full((W, d), 1 << c, dtype=sd.dtype), sd[:, :-d]], axis=1)
        same = key_shift == sd                              # [W, N]
        shift_pt = tuple(
            jnp.concatenate([jnp.zeros_like(t[..., :d]), t[..., :-d]], axis=-1)
            for t in P)
        # make shifted-in points infinity where segment differs
        sx, sy, sz = shift_pt
        sz = fd.fselect(same, sz, jnp.zeros_like(sz))
        added = jac_add(P, (sx, sy, sz))
        P = added
        d *= 2

    # scatter segment tails into dense buckets [L, W, 2^c]
    idx = jnp.arange(N)
    is_last = jnp.concatenate(
        [sd[:, 1:] != sd[:, :-1], jnp.ones((W, 1), dtype=bool)], axis=1)
    key = jnp.where(is_last, sd, 0).astype(jnp.int32)      # junk -> bucket 0
    w_ids = jnp.broadcast_to(jnp.arange(W)[:, None], (W, N))
    buckets = []
    for t in P:
        b = jnp.zeros((fd.L, W, 1 << c), dtype=t.dtype)
        buckets.append(b.at[:, w_ids, key].set(t))
    bx, by, bz = buckets
    # ensure non-tail scatters didn't corrupt: bucket 0 is never used below.

    # suffix sums over the bucket axis
    S = (bx, by, bz)
    d = 1
    while d < (1 << c):
        shift_pt = tuple(
            jnp.concatenate([t[..., d:], jnp.zeros_like(t[..., :d])], axis=-1)
            for t in S)
        S = jac_add(S, shift_pt)
        d *= 2
    # S[d] = sum_{e>=d} B_e ; window total = sum_{d>=1} S[d]
    Sx, Sy, Sz = (t[..., 1:] for t in S)
    T = (Sx, Sy, Sz)
    n = (1 << c) - 1
    while n > 1:
        half = n // 2
        lo = tuple(t[..., :half] for t in T)
        hi = tuple(t[..., half:2 * half] for t in T)
        s = jac_add(lo, hi)
        if n % 2:
            tail = tuple(t[..., 2 * half:] for t in T)
            first = jac_add(tuple(t[..., :1] for t in s), tail)
            s = tuple(jnp.concatenate([f, t[..., 1:]], axis=-1)
                      for f, t in zip(first, s))
        T = s
        n = T[0].shape[-1]
    return tuple(t[..., 0] for t in T)  # [L, W] each


# ---------------------------------------------------------------------------
# bitplane MSM — the production commit path
# ---------------------------------------------------------------------------
#
# Pippenger's bucket step does not vectorize (scatter-adds of group
# elements); the sort-based variant above pays N log N point-adds per
# window plus argsort/gather/scatter.  The bitplane ("binary Pippenger")
# formulation is MUCH better matched to a dense vector machine:
#
#     sum_i s_i * P_i  =  sum_b 2^b * (sum_{i : bit b of s_i} P_i)
#
# Each bit-plane's masked sum is a log-depth tree of dense Jacobian adds —
# no data movement at all — and total add count is bits(max scalar) * N,
# vs the sorted method's windows * N log N (16x fewer adds for 0/1 flag
# polynomials, ~2x for 254-bit RLC scalars).  Jolt's witness scalars are
# mostly tiny (flags, counters, u32 values — msm/mod.rs:11-54 exploits the
# same structure on CPU), so the adaptive bit count does the heavy lifting.
# Bit-planes of MANY polynomials over the SAME bases (the ~90-column batch
# commit, vm/mod.rs:393) stack into one kernel as extra channels.

MSM_CHANNEL_CHUNK = 64  # bit-plane channels per dispatch (bounds live memory)


def _msm_host_tail() -> int:
    """Tree level below which the masked sum finishes on host: each
    halving level is its own kernel SHAPE inside the tree program
    (log2(N) shapes), so stopping the device tree at 128 nearly halves
    the program's compile while the host finishes
    with ~K*tail bigint point-adds (milliseconds).  JOLT_MSM_HOST_TAIL=1
    disables (pure device tree)."""
    import os
    v = os.environ.get("JOLT_MSM_HOST_TAIL")
    return int(v) if v is not None else 128


def _masked_tree_sum(px, py, pz, masks, stop: int = 1):
    """sum_{i: masks[k, i]} P_i per channel k, reduced to `stop` partials
    per channel -> Jacobian [L, K, stop] (stop=1: fully reduced [L, K]).

    px/py/pz: [L, N] Jacobian (Z=0 ⇔ infinity); masks: [K, N] bool.
    log2(N/stop) levels of dense jac_adds; the mask is applied to Z on
    the way in (Z=0 points are identities for jac_add)."""
    K, N = masks.shape
    X = jnp.broadcast_to(px[:, None, :], (px.shape[0], K, N))
    Y = jnp.broadcast_to(py[:, None, :], (py.shape[0], K, N))
    Z = jnp.where(masks[None], jnp.broadcast_to(pz[:, None, :], X.shape), 0)
    P = (X, Y, Z)
    n = N
    while n > stop:
        half = n // 2
        lo = tuple(t[..., :half] for t in P)
        hi = tuple(t[..., half:2 * half] for t in P)
        s = jac_add(lo, hi)
        if n % 2:
            first = jac_add(tuple(t[..., :1] for t in s),
                            tuple(t[..., -1:] for t in P))
            s = tuple(jnp.concatenate([f, t[..., 1:]], axis=-1)
                      for f, t in zip(first, s))
        P = s
        n = P[0].shape[-1]
    if stop == 1:
        return tuple(t[..., 0] for t in P)  # [L, K]
    return P                                # [L, K, stop]


_masked_tree_sum_jit = jax.jit(_masked_tree_sum, static_argnums=4)
_jac_add_jit = jax.jit(lambda a, b: jac_add(a, b))

MSM_SEGMENT = 1 << 16  # points per tree-sum dispatch (bounds the [L, K, N]
#                        broadcast: at N = 2^21, K = 64 it would be ~25 GB)


# canonical scan-fold geometry: every dispatch processes MSM_FOLD_SEG
# points as MSM_FOLD_SEG/MSM_FOLD_TAIL sequential jac_adds of a fixed
# [L, K, MSM_FOLD_TAIL] accumulator inside ONE lax.scan — a single small
# program serves every chunk of every commit, instead of one unrolled
# log-depth tree program (and its compile) per (K, n)
import os as _os

MSM_FOLD_SEG = int(_os.environ.get("JOLT_MSM_FOLD_SEG", 8192))
MSM_FOLD_TAIL = int(_os.environ.get("JOLT_MSM_FOLD_TAIL", 64))


@jax.jit
def _msm_fold_seg(px, py, pz, masks, acc, off):
    """Fold points [off, off+SEG) of every channel into acc (PROJECTIVE
    accumulator, complete adds — 12 muls/add, no branch selects).

    px/py/pz: [L, N] Jacobian Z∈{0,R} (affine SRS; Z=0 ⇔ infinity);
    masks: [K, N] bool; acc: projective ([L, K, TAIL],)*3; off: traced
    int32.  Masked-out or infinity points enter as the projective
    identity (0:1:0)."""
    K = masks.shape[0]
    Lq = px.shape[0]
    T = MSM_FOLD_TAIL
    S = MSM_FOLD_SEG // T
    one = jnp.asarray([int(v) for v in FQ.r_limbs], jnp.uint32)
    sl = tuple(jax.lax.dynamic_slice_in_dim(t, off, MSM_FOLD_SEG, axis=-1)
               for t in (px, py, pz))
    m = jax.lax.dynamic_slice_in_dim(masks, off, MSM_FOLD_SEG, axis=-1)
    steps = tuple(jnp.moveaxis(t.reshape(Lq, S, T), 1, 0) for t in sl)
    msteps = jnp.moveaxis(m.reshape(K, S, T), 1, 0)        # [S, K, T]

    def body(carry, inp):
        sx, sy, sz, mk = inp                               # [L, T], [K, T]
        live = mk[None] & jnp.any(sz != 0, axis=0)[None, None, :]
        X = jnp.where(live, jnp.broadcast_to(sx[:, None, :], (Lq, K, T)),
                      jnp.uint32(0))
        Y = jnp.where(live, jnp.broadcast_to(sy[:, None, :], (Lq, K, T)),
                      jnp.broadcast_to(one[:, None, None], (Lq, K, T)))
        Z = jnp.where(live, jnp.broadcast_to(sz[:, None, :], (Lq, K, T)),
                      jnp.uint32(0))
        return proj_cadd(carry, (X, Y, Z)), None

    acc, _ = jax.lax.scan(body, acc, steps + (msteps,))
    return acc


@jax.jit
def _proj_from_jac(px, pz):
    """Jacobian (X, Y, Z) -> projective (X*Z : Y : Z^3); Y unchanged."""
    return _mul(px, pz), _mul(pz, _sq(pz))


_proj_from_jac_jit = _proj_from_jac


@jax.jit
def _proj_tail_fold(acc):
    """Tree-reduce the projective accumulator [L, K, T] -> [L, K]."""
    X, Y, Z = acc
    while X.shape[-1] > 1:
        h = X.shape[-1] // 2
        lo = (X[..., :h], Y[..., :h], Z[..., :h])
        hi = (X[..., h:], Y[..., h:], Z[..., h:])
        X, Y, Z = proj_cadd(lo, hi)
    return X[..., 0], Y[..., 0], Z[..., 0]


def _masked_tree_sum_hosttail(px, py, pz, masks, defer_pull: bool = False):
    """Masked sum per channel -> HOST Jacobians [K] (or, with
    `defer_pull`, the un-pulled device projective triple [L, K] so the
    caller can batch many chunks into one transfer).

    N >= MSM_FOLD_SEG (guaranteed by the bucketing in batch_msm_bitplane):
    the canonical scan-fold reduces each channel to MSM_FOLD_TAIL partials;
    a device tree fold finishes.  Small N falls back to the unrolled tree
    (tiny compiles)."""
    K, N = masks.shape
    if N < MSM_FOLD_SEG or N % MSM_FOLD_SEG:
        tail = max(1, min(_msm_host_tail(), N))
        sx, sy, sz = _masked_tree_sum_jit(px, py, pz, masks, tail)
        parts = jacobian_to_host(sx, sy, sz)
        acc = [G1Jacobian.identity() for _ in range(K)]
        for k in range(K):
            a = acc[k]
            for p in parts[k * tail: (k + 1) * tail]:
                a = a.add(p)
            acc[k] = a
        return acc
    T = MSM_FOLD_TAIL
    # jacobian SRS -> projective once: (X, Y, Z)_jac == (X*Z : Y : Z^3)_proj
    # (2 muls/point, one pass; the complete-add fold then runs at 12
    # muls/add with no branch selects)
    px, pz = _proj_from_jac_jit(px, pz)
    zero = jnp.zeros((px.shape[0], K, T), jnp.uint32)
    one = jnp.asarray([int(v) for v in FQ.r_limbs], jnp.uint32)
    ones = jnp.broadcast_to(one[:, None, None], zero.shape)
    acc = (zero, ones, zero)             # (0:1:0): the projective identity
    for off in range(0, N, MSM_FOLD_SEG):
        acc = _msm_fold_seg(px, py, pz, masks, acc, np.int32(off))
    sx, sy, sz = _proj_tail_fold(acc)    # device tree: [L, K, T] -> [L, K]
    if defer_pull:
        return (sx, sy, sz)
    return proj_to_host_jac(sx, sy, sz)


def scalar_max_bits(canonical_limbs: jnp.ndarray) -> int:
    """Bit length of the largest scalar (one tiny reduction + host sync)."""
    axes = tuple(range(1, canonical_limbs.ndim))
    limb_max = np.asarray(jax.device_get(jnp.max(canonical_limbs, axis=axes)))
    msb = 0
    for i, v in enumerate(limb_max.tolist()):
        if v:
            msb = LIMB_BITS * i + int(v).bit_length()
    return max(1, msb)


def _horner_bits(sums: list[G1Jacobian]) -> G1Jacobian:
    """sum_b 2^b * sums[b] via MSB-first Horner (host, ~bits point ops)."""
    acc = G1Jacobian.identity()
    for s in reversed(sums):
        acc = acc.double()
        acc = acc.add(s)
    return acc


@jax.jit
def _poly_limb_maxes(canon):
    return jnp.max(canon, axis=-1)


def _stack_canonical(stacked_mont):
    """[L, J, n] Montgomery -> canonical limbs + per-poly limb maxes.

    Deliberately NOT one jit: from_mont_device REDCs huge tensors in
    fixed [L, 2^16] chunks that all reuse ONE compiled program — wrapping
    this in jax.jit inlined the chunk loop into a single giant XLA
    program (one huge compile).  Eagerly, the chunk program compiles
    once and the ~30 dispatches pipeline."""
    canon = fd.from_mont_device(FR, stacked_mont)
    return canon, _poly_limb_maxes(canon)


@jax.jit
def _bitplane_masks(canon, limb_idx, poly_idx, shifts, valid):
    """[K, n] bit masks for one channel chunk, built ON DEVICE: channel k
    is bit `shifts[k]` of limb `limb_idx[k]` of poly `poly_idx[k]`;
    channels with valid[k] == False come out all-False (chunk padding)."""
    sel = canon[limb_idx, poly_idx, :]                     # [K, n]
    bits = (sel >> shifts[:, None]) & jnp.uint32(1)
    return bits.astype(bool) & valid[:, None]


def batch_msm_bitplane(points_jac, scalars_mont: list, spec_fr: FieldSpec,
                       mesh=None) -> list[G1Affine]:
    """MSMs of many scalar vectors over one base set (batch commit).

    points_jac: (X [L, N], Y [L, N], Z [L, N]) Montgomery Jacobian
    (Z = 0 ⇔ infinity — the form the SRS is stored in);
    scalars_mont: list of [Lr, n_j] Montgomery Fr tensors (n_j <= N).

    Fully device-batched: equal-length polys stack into one [L, J, n]
    tensor, canonicalization + per-poly bit widths come from ONE compiled
    pass (+ one tiny host pull), and each MSM_CHANNEL_CHUNK-sized group of
    bit-planes is one jitted mask-build + masked-tree dispatch.  The
    expensive tree program is keyed only by (K, n) — J never enters its
    shape.  Per-poly results are Horner-combined on host (~sum(bits)
    Jacobian ops, microseconds each)."""
    import os as _osm
    import time as _tm
    _dbg = _osm.environ.get("JOLT_MSM_DEBUG", "") not in ("", "0")
    _t = _tm.perf_counter
    _tl = _t()

    def _mark(label):
        nonlocal _tl
        if _dbg:
            now = _t()
            print(f"[msm] {label}: {now - _tl:.2f}s", flush=True)
            _tl = now

    px, py, pz_full = points_jac
    n_pts = px.shape[-1]

    # group polys by BUCKETED length: scalar vectors are zero-padded up to
    # a power of two (>= 4096) so the expensive masked-tree program is
    # compiled/loaded for only a handful of (K, n) shapes per process
    # instead of one per poly length (zero scalars set no bit-plane masks
    # and no channels, so commitments are unchanged)
    def _bucket(n: int) -> int:
        b = 1 << max(MSM_FOLD_SEG.bit_length() - 1, (n - 1).bit_length())
        return min(b, n_pts) if n_pts >= n else n

    by_len: dict[int, list[int]] = {}
    for j, s in enumerate(scalars_mont):
        by_len.setdefault(_bucket(s.shape[-1]), []).append(j)

    def _shard_pts(ts):
        """Point-axis mesh sharding (SURVEY §2.8: each chip owns an SRS
        slice; XLA reduces the per-channel partials cross-chip)."""
        if mesh is None:
            return ts
        from jax.sharding import NamedSharding, PartitionSpec as P
        ax = mesh.axis_names[0]
        return tuple(
            jax.device_put(t, NamedSharding(
                mesh, P(*([None] * (t.ndim - 1) + [ax]))))
            if t.shape[-1] % mesh.devices.size == 0 else t for t in ts)

    results: dict[int, G1Affine] = {}
    for n, idxs in by_len.items():
        pxn, pyn, pzn = _shard_pts((px[..., :n], py[..., :n],
                                    pz_full[..., :n]))
        stacked = jnp.stack(
            [scalars_mont[j] if scalars_mont[j].shape[-1] == n
             else jnp.pad(scalars_mont[j],
                          ((0, 0), (0, n - scalars_mont[j].shape[-1])))
             for j in idxs], axis=1)
        canon, maxes = _stack_canonical(stacked)           # [L, J, n], [L, J]
        limb_max = np.asarray(jax.device_get(maxes))       # ONE tiny pull
        _mark(f"n={n} J={len(idxs)} stack+canon")
        # per-poly bit widths -> flat (poly slot, bit) channel list
        channels: list[tuple[int, int]] = []
        for slot, j in enumerate(idxs):
            msb = 0
            for i, v in enumerate(limb_max[:, slot].tolist()):
                if v:
                    msb = LIMB_BITS * i + int(v).bit_length()
            channels += [(slot, b) for b in range(max(1, msb))]
        sums: dict[int, list[G1Jacobian]] = {j: [] for j in idxs}
        K = MSM_CHANNEL_CHUNK
        pending = []          # (group, device (X, Y, Z) [L, K]) per chunk
        for lo in range(0, len(channels), K):
            group = channels[lo: lo + K]
            pad = K - len(group)
            poly_idx = np.array([s for s, _ in group] + [0] * pad, np.int32)
            bits = np.array([b for _, b in group] + [0] * pad, np.int32)
            valid = np.array([True] * len(group) + [False] * pad)
            masks = _bitplane_masks(canon, bits // LIMB_BITS, poly_idx,
                                    (bits % LIMB_BITS).astype(np.uint32),
                                    valid)
            masks = _shard_pts((masks,))[0]
            res = _masked_tree_sum_hosttail(pxn, pyn, pzn, masks,
                                            defer_pull=True)
            _mark(f"chunk {lo // K} tree+fold enqueue")
            pending.append((group, res))
        # ONE pull for every chunk's [L, K] channel sums (one transfer
        # instead of one per chunk)
        dev_chunks = [res for _, res in pending
                      if not isinstance(res, list)]
        if dev_chunks:
            stacked = tuple(jnp.concatenate([r[i] for r in dev_chunks],
                                            axis=-1) for i in range(3))
            flat_pts = proj_to_host_jac(*stacked)
            _mark(f"n={n} batched pull")
        di = 0
        for group, res in pending:
            if isinstance(res, list):
                pts = res
            else:
                pts = flat_pts[di * K: (di + 1) * K]
                di += 1
            for (slot, _b), p in zip(group, pts):
                sums[idxs[slot]].append(p)
        for j in idxs:
            results[j] = _horner_bits(sums[j]).to_affine()
        _mark(f"n={n} horner+affine")
    return [results[j] for j in range(len(scalars_mont))]


def msm_bitplane(points_jac, scalars_mont: jnp.ndarray,
                 spec_fr: FieldSpec) -> G1Affine:
    """Single-vector bitplane MSM (Jacobian bases)."""
    return batch_msm_bitplane(points_jac, [scalars_mont], spec_fr)[0]


def msm(points_dev, scalars_mont: jnp.ndarray,
        spec_fr: FieldSpec) -> G1Affine:
    """Full MSM: device windows + host Horner combine.

    points_dev: output of points_to_device; scalars_mont: [L, N] Fr Montgomery.
    """
    px, py, inf_mask = points_dev
    n = scalars_mont.shape[-1]
    assert px.shape[-1] >= n, "SRS too short"
    canonical = fd.from_mont_device(spec_fr, scalars_mont)
    wx, wy, wz = _msm_windows(px[..., :n], py[..., :n], inf_mask[:n],
                              canonical, scalar_max_windows(canonical))
    windows = jacobian_to_host(wx, wy, wz)
    acc = G1Jacobian.identity()
    for wpt in reversed(windows):
        for _ in range(MSM_WINDOW_BITS):
            acc = acc.double()
        acc = acc.add(wpt)
    return acc.to_affine()
