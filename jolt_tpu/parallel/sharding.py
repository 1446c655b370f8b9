"""Multi-chip sharding of the prover hot loops.

The reference is single-process rayon (SURVEY §2.8).  Two scaling axes:

* **Grand products / sumchecks**: the BATCH axis.  A Jolt memory-checking
  grand product batches ~50-100 independent circuits; each chip owns a
  subset, so binds are purely local and only the tiny [L, 3] round-poly
  partial sums cross chips (all-gathered and modularly folded — NOT psum'd,
  because modular addition of limb tensors is not plain u32 addition).
  The bit-reversed pair layout (subprotocols/grand_product.py) is
  shard-oblivious along the batch axis.
* **MSM**: the point/scalar axis — per-shard sort/bucket windows, tiny
  cross-shard Jacobian tree-fold.

The transcript work stays on host, replicated.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..field import FieldSpec, fr_spec
from ..field import device as fd
from ..subprotocols.grand_product import _pair_cubic_evals, _pair_bind


def make_mesh(n_devices: int | None = None, axis: str = "hc") -> Mesh:
    devices = np.array(jax.devices()[: n_devices or len(jax.devices())])
    return Mesh(devices, (axis,))


def shard_hypercube(mesh: Mesh, arr: jnp.ndarray, axis: str = "hc") -> jnp.ndarray:
    """Place a [L, ..., n] limb tensor with the hypercube axis sharded."""
    spec = P(*([None] * (arr.ndim - 1) + [axis]))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def shard_batch(mesh: Mesh, arr: jnp.ndarray, axis: str = "hc") -> jnp.ndarray:
    """Place a batch-leading [B, L, s] pair tensor with B sharded."""
    spec = P(*([axis] + [None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def sharded_gp_round(mesh: Mesh, spec: FieldSpec, l: jnp.ndarray,
                     r: jnp.ndarray, eq: jnp.ndarray, coeffs: jnp.ndarray,
                     r_chal: jnp.ndarray, axis: str = "hc"):
    """One full sharded GKR round over bit-reversed pair layers.

    l, r: [B, L, s] sharded on the batch axis; eq: [L, s] replicated;
    coeffs: [L, B] sharded on B; r_chal: [L] replicated (the round
    challenge — in the real protocol it depends on the evals via the
    transcript; the dryrun feeds a dummy to exercise the dataflow in one
    step).  Returns (evals [L, 3] replicated, bound l/r sharded, bound eq
    replicated).
    """
    def step(l_s, r_s, eq_s, coeffs_s, rc):
        local = _pair_cubic_evals(spec, l_s, r_s, eq_s, coeffs_s)  # [L, 3]
        gathered = jax.lax.all_gather(local, axis)                 # [D, L, 3]
        evals = fd.fsum(spec, jnp.moveaxis(gathered, 0, -1), axis=-1)
        nl, nr, neq = _pair_bind(spec, l_s, r_s, eq_s, rc)
        return evals, nl, nr, neq

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(None, None),
                  P(None, axis), P(None)),
        out_specs=(P(None, None), P(axis, None, None), P(axis, None, None),
                   P(None, None)),
        check_vma=False)
    return jax.jit(fn)(l, r, eq, coeffs, r_chal)


# ---------------------------------------------------------------------------
# jit-propagated sharding: shard the leaves once, let XLA insert collectives
# ---------------------------------------------------------------------------

def pad_batch_to(arr: jnp.ndarray, n_dev: int) -> jnp.ndarray:
    """Pad the leading batch axis up to a multiple of n_dev with zero rows.

    0 is a valid field element, so the pad rows flow through bind/product
    kernels unchanged; provers neutralize them by padding the batching
    COEFFICIENTS with zeros, which zeroes the pad rows' contribution to
    every round evaluation (transcript-neutral)."""
    B = arr.shape[0]
    Bp = -(-B // n_dev) * n_dev
    if Bp == B:
        return arr
    pad = jnp.zeros((Bp - B,) + arr.shape[1:], dtype=arr.dtype)
    return jnp.concatenate([arr, pad], axis=0)


def maybe_shard_pair(mesh: Mesh, pair: tuple, axis: str = "hc") -> tuple:
    """Shard a (l, r) pair layer on the batch axis, zero-padding the batch
    to the mesh size so sharding NEVER silently degrades to replication
    (round-1 fallback replicated whenever B % n_devices != 0 — which real
    Jolt batches usually are)."""
    n_dev = mesh.devices.size
    l, r = pair
    if l.shape[0] % n_dev:
        l, r = pad_batch_to(l, n_dev), pad_batch_to(r, n_dev)
    return shard_batch(mesh, l, axis), shard_batch(mesh, r, axis)


def shard_gp_pair_layers(mesh: Mesh, layers: list[tuple],
                         axis: str = "hc") -> list[tuple]:
    """Place a dense GP's pair layers batch-sharded (batch zero-padded to
    the mesh size).  All downstream round kernels are ordinary jits — XLA
    partitions the local work and inserts the cross-chip reductions for
    the [L, 3] round evaluations."""
    return [maybe_shard_pair(mesh, pair, axis) for pair in layers]


# ---------------------------------------------------------------------------
# sharded MSM: local sort-based windows per shard, tree-fold across shards
# ---------------------------------------------------------------------------

def sharded_msm_windows(mesh: Mesh, points_jac, scalar_limbs: jnp.ndarray,
                        axis: str = "hc", n_windows: int | None = None,
                        window_bits: int | None = None):
    """MSM window totals over a sharded point/scalar set.

    The single-device kernel sorts points by digit (curve/device.py) — a
    global sort would force an all-gather, so each shard sorts and
    bucket-sums ITS slice locally, then the [L, W] per-shard window totals
    (tiny) are all-gathered and tree-folded with full Jacobian adds.
    points_jac: (X, Y, Z) [Lq, N] sharded on N; scalar_limbs: [Lr, N]
    CANONICAL 16-bit limbs, sharded.  n_windows must be a GLOBAL bound
    (same on every shard).  Returns (X, Y, Z) [Lq, W] replicated.
    """
    from ..curve import device as cd
    wb = window_bits or cd.MSM_WINDOW_BITS

    def step(px, py, pz, sl):
        inf = jnp.all(pz == 0, axis=0)
        w = cd._msm_windows_impl(px, py, pz, inf, sl, n_windows, wb)  # [L, W]
        g = tuple(jnp.moveaxis(jax.lax.all_gather(t, axis), 0, -1)
                  for t in w)                               # [L, W, D]
        while g[0].shape[-1] > 1:
            half = g[0].shape[-1] // 2
            lo = tuple(t[..., :half] for t in g)
            hi = tuple(t[..., half:2 * half] for t in g)
            s = cd.jac_add(lo, hi)
            if g[0].shape[-1] % 2:
                tail = tuple(t[..., -1:] for t in g)
                first = cd.jac_add(tuple(t[..., :1] for t in s), tail)
                s = tuple(jnp.concatenate([f, t[..., 1:]], axis=-1)
                          for f, t in zip(first, s))
            g = s
        return tuple(t[..., 0] for t in g)

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(None, axis), P(None, axis)),
        out_specs=(P(None, None), P(None, None), P(None, None)),
        check_vma=False)
    return jax.jit(fn)(*points_jac, scalar_limbs)


def sharded_msm(mesh: Mesh, points_jac, scalars_mont: jnp.ndarray,
                spec_fr: FieldSpec | None = None, axis: str = "hc",
                window_bits: int | None = None):
    """Full sharded MSM -> host G1Affine (windows on device, Horner on host)."""
    from ..curve import device as cd
    spec_fr = spec_fr or fr_spec()
    wb = window_bits or cd.MSM_WINDOW_BITS
    canonical = fd.from_mont_device(spec_fr, scalars_mont)
    n_windows = cd.scalar_max_windows(canonical, wb)
    pts = tuple(shard_hypercube(mesh, t, axis) for t in points_jac)
    scl = shard_hypercube(mesh, canonical, axis)
    wx, wy, wz = sharded_msm_windows(mesh, pts, scl, axis, n_windows, wb)
    windows = cd.jacobian_to_host(wx, wy, wz)
    from ..curve.bn254 import G1Jacobian
    acc = G1Jacobian.identity()
    for wpt in reversed(windows):
        for _ in range(wb):
            acc = acc.double()
        acc = acc.add(wpt)
    return acc.to_affine()


# ---------------------------------------------------------------------------
# sharded bitplane MSM: the production commit path (curve/device.py
# batch_msm_bitplane) across chips
# ---------------------------------------------------------------------------

def sharded_msm_bitplane(mesh: Mesh, points_jac, scalars_mont: jnp.ndarray,
                         spec_fr: FieldSpec | None = None, axis: str = "hc"):
    """Bitplane MSM with the POINT axis sharded.

    Each shard masked-tree-sums its point slice per scalar bit-plane
    (log-depth dense Jacobian adds, zero data movement), then the tiny
    [L, nbits] per-shard partials are all-gathered and tree-folded with
    jac_add; the Horner double-and-add over bit-planes runs on host.
    Unlike the window MSM, the per-shard graph is O(log n) point-ops deep —
    this is what the multichip dryrun and the multi-chip commit path use.
    """
    from ..curve import device as cd

    spec_fr = spec_fr or fr_spec()
    canon = fd.from_mont_device(spec_fr, scalars_mont)
    nbits = cd.scalar_max_bits(canon)
    from ..field.spec import LIMB_BITS

    def step(px, py, pz, sl):
        masks = jnp.stack(
            [(sl[b // LIMB_BITS] >> jnp.uint32(b % LIMB_BITS))
             & jnp.uint32(1) for b in range(nbits)]).astype(bool)
        s = cd._masked_tree_sum(px, py, pz, masks)         # ([L, nbits],)*3
        g = tuple(jnp.moveaxis(jax.lax.all_gather(t, axis), 0, -1)
                  for t in s)                              # [L, nbits, D]
        while g[0].shape[-1] > 1:
            half = g[0].shape[-1] // 2
            g = cd.jac_add(tuple(t[..., :half] for t in g),
                           tuple(t[..., half:] for t in g))
        return tuple(t[..., 0] for t in g)

    pts = tuple(shard_hypercube(mesh, t, axis) for t in points_jac)
    scl = shard_hypercube(mesh, canon, axis)
    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(None, axis),
                  P(None, axis)),
        out_specs=(P(None, None), P(None, None), P(None, None)),
        check_vma=False)
    sx, sy, sz = jax.jit(fn)(*pts, scl)
    sums = cd.jacobian_to_host(sx, sy, sz)
    return cd._horner_bits(sums).to_affine()


# ---------------------------------------------------------------------------
# hypercube-axis sharding: the 2^k MLE dimension (SURVEY §5, §7.9)
# ---------------------------------------------------------------------------

def maybe_shard_hypercube(mesh: Mesh | None, arr: jnp.ndarray,
                          axis: str = "hc") -> jnp.ndarray:
    """Shard ONE MLE limb tensor [L, ..., n] on its hypercube (last) axis,
    replicating (loudly) when n doesn't divide across the mesh; identity
    when mesh is None.  The single-tensor face of shard_sumcheck_polys —
    used by the mesh-wired full-VM prover (vm/jolt.py prove(mesh=...)),
    matching the rayon parallelism of the reference's sumcheck loops
    (e.g. sumcheck.rs par_iter sites) with XLA-propagated collectives."""
    if mesh is None:
        return arr
    return shard_sumcheck_polys(mesh, [arr], axis)[0]


def shard_sumcheck_polys(mesh: Mesh, polys, axis: str = "hc"):
    """Place generic-sumcheck MLE limb tensors [L, ..., n] with the
    HYPERCUBE axis n sharded across the mesh.

    Downstream round kernels (subprotocols/sumcheck._round_evals /
    _bind_all) are ordinary jits: GSPMD partitions the shard-local
    evaluate+bind work and inserts the modular-sum all-reduce for the tiny
    [L, degree+1] round evaluations.  Top-binding halves n each round; the
    halves remain aligned to the shard grid until n < n_dev, after which
    XLA's propagation degrades to (correct) replication — by then the
    tensors are tiny.  Tensors too small to split (n < 2 * n_dev) are
    replicated outright, LOUDLY."""
    import sys
    n_dev = mesh.devices.size
    out = []
    for p in polys:
        if p.shape[-1] % n_dev == 0 and p.shape[-1] >= 2 * n_dev:
            out.append(shard_hypercube(mesh, p, axis))
        else:
            print(f"[sharding] hypercube axis {p.shape[-1]} not divisible "
                  f"by mesh size {n_dev}; replicating", file=sys.stderr)
            out.append(jax.device_put(
                p, NamedSharding(mesh, P(*([None] * p.ndim)))))
    return tuple(out)
