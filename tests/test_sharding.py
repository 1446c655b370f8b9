"""Multi-device sharding paths on a flat 4-device mesh (4 virtual CPU
devices in the test suite, the card count of the multi-GPU configuration).

Covers what the driver dryrun does not: the sort/bucket window MSM
variant, the bitplane MSM against the host oracle, and transcript
equality of the padded batch-sharded GP prover vs the unsharded one
(SURVEY §2.8 invented backend; the pad rows must be invisible)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jolt_tpu.curve import device as cd
from jolt_tpu.curve.bn254 import G1Affine, g1_msm_host
from jolt_tpu.field import device as fd, fr_spec
from jolt_tpu.parallel.sharding import sharded_msm, sharded_msm_bitplane

SPEC = fr_spec()

def _points(n):
    pts, g = [], G1Affine.generator().to_jacobian()
    acc = g
    for _ in range(n):
        pts.append(acc.to_affine())
        acc = acc.add(g).double()
    return pts


def _jac(pts):
    px, py, inf = cd.points_to_device(pts)
    one = fd.ones(cd.FQ, (len(pts),))
    pz = jnp.where(jnp.asarray(inf)[None], jnp.zeros_like(one), one)
    return px, py, pz


def test_sharded_msm_window_vs_host(mesh4):
    mesh = mesh4
    n = 16
    pts = _points(n)
    ints = np.random.default_rng(1).integers(1, 1 << 48, size=n,
                                             dtype=np.uint64)
    scalars = fd.to_mont_device(SPEC, jnp.asarray(fd.pack_u64(ints)))
    got = sharded_msm(mesh, _jac(pts), scalars, SPEC, window_bits=4)
    want = g1_msm_host(pts, [int(v) for v in ints])
    assert (got.x, got.y, got.is_infinity) == \
        (want.x, want.y, want.is_infinity)


def test_sharded_msm_bitplane_vs_host(mesh4):
    mesh = mesh4
    n = 16
    pts = _points(n)
    ints = np.random.default_rng(2).integers(0, 1 << 32, size=n,
                                             dtype=np.uint64)
    ints[0] = 0
    scalars = fd.to_mont_device(SPEC, jnp.asarray(fd.pack_u64(ints)))
    got = sharded_msm_bitplane(mesh, _jac(pts), scalars, SPEC)
    want = g1_msm_host(pts, [int(v) for v in ints])
    assert (got.x, got.y, got.is_infinity) == \
        (want.x, want.y, want.is_infinity)


def test_sharded_gp_padded_batch_transcript_equal(mesh4):
    """B = 11 (not a multiple of 4): the mesh prover zero-pads to 12 and
    must emit a byte-identical transcript to the unsharded prover."""
    from jolt_tpu.subprotocols.grand_product import (
        BatchedDenseGrandProduct, verify_grand_product)
    from jolt_tpu.transcript import Transcript

    rng = np.random.default_rng(5)
    leaves = fd.to_mont_device(SPEC, jnp.asarray(fd.pack_u64(
        rng.integers(1, 1 << 32, size=(11, 8), dtype=np.uint64))))
    mesh = mesh4

    gp_plain = BatchedDenseGrandProduct.construct(leaves, SPEC)
    claims_plain = gp_plain.claims()      # prove() releases the layers
    t_plain = Transcript(b"pad")
    proof_plain, _ = gp_plain.prove(t_plain)

    gp_mesh = BatchedDenseGrandProduct.construct(leaves, SPEC, mesh=mesh)
    assert gp_mesh.layers[0][0].shape[0] == 12      # padded
    assert gp_mesh.real_batch == 11
    claims = gp_mesh.claims()
    assert claims == claims_plain
    t_mesh = Transcript(b"pad")
    proof_mesh, _ = gp_mesh.prove(t_mesh)
    assert t_mesh.state_history == t_plain.state_history, \
        "padded mesh prover diverged from the unsharded transcript"
    verify_grand_product(proof_mesh, claims, Transcript(b"pad"))


def test_hypercube_sharded_sumcheck_transcript_equal(mesh4):
    """Generic sumcheck with the 2^k HYPERCUBE axis sharded over the mesh
    (SURVEY §5: the scaling axis for large T).  GSPMD partitions the round
    kernels; the transcript must be byte-identical to the unsharded
    prover's."""
    from jolt_tpu.parallel.sharding import shard_sumcheck_polys
    from jolt_tpu.subprotocols.sumcheck import comb_product, prove_arbitrary
    from jolt_tpu.transcript import Transcript

    rng = np.random.default_rng(11)
    n = 128
    polys = tuple(
        fd.to_mont_device(SPEC, jnp.asarray(fd.pack_u64(
            rng.integers(1, 1 << 32, size=n, dtype=np.uint64))))
        for _ in range(3))

    t_plain = Transcript(b"hc")
    proof_plain, r_plain, fe_plain = prove_arbitrary(
        7, polys, comb_product, 3, t_plain, SPEC)

    mesh = mesh4
    sharded = shard_sumcheck_polys(mesh, polys)
    t_mesh = Transcript(b"hc")
    proof_mesh, r_mesh, fe_mesh = prove_arbitrary(
        7, sharded, comb_product, 3, t_mesh, SPEC)

    assert t_mesh.state_history == t_plain.state_history, \
        "hypercube-sharded sumcheck diverged from the unsharded transcript"
    assert [x.v for x in fe_mesh] == [x.v for x in fe_plain]


def test_sharded_surge_prove_transcript_equal(mesh4):
    """Surge with the primary sumcheck hypercube-sharded over the mesh:
    byte-identical transcript, and the proof verifies."""
    from jolt_tpu.commitment import MockCommitmentScheme
    from jolt_tpu.instructions import XorInstruction
    from jolt_tpu.lasso import SurgePreprocessing, surge_prove, surge_verify

    import random
    rng = random.Random(31)
    pre = SurgePreprocessing(XorInstruction, 2, 1 << 4, SPEC)
    pcs = MockCommitmentScheme(SPEC)
    x = np.array([rng.randrange(16) for _ in range(16)], dtype=np.uint64)
    y = np.array([rng.randrange(16) for _ in range(16)], dtype=np.uint64)

    proof_plain, t_plain, _ = surge_prove(pre, pcs, x, y)
    mesh = mesh4
    proof_mesh, t_mesh, _ = surge_prove(pre, pcs, x, y, mesh=mesh)
    assert t_mesh.state_history == t_plain.state_history, \
        "mesh Surge prover diverged from the unsharded transcript"
    surge_verify(pre, pcs, proof_mesh, debug_transcript=t_mesh)
