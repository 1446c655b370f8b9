"""Dense batched GKR grand product prove/verify roundtrip.

Mirrors the reference's dense GP roundtrip tests
(grand_product.rs:1547-1754): prover and verifier transcripts must agree,
claims must equal the true products, and the final verifier claims must equal
the leaf MLE evaluations at r_grand_product.
"""
import random

from jolt_tpu.field import FElt, fr, fr_spec
from jolt_tpu.field import device as fd
from jolt_tpu.poly import mle
from jolt_tpu.subprotocols.grand_product import (
    BatchedDenseGrandProduct, verify_grand_product)
from jolt_tpu.transcript import Transcript

RNG = random.Random(42)


def test_dense_grand_product_roundtrip():
    spec = fr_spec()
    B, n = 3, 8
    leaves_ints = [[RNG.randrange(spec.p) for _ in range(n)] for _ in range(B)]
    leaves = fd.ints_to_device(spec, leaves_ints)

    gp = BatchedDenseGrandProduct.construct(leaves, spec)
    claims = gp.claims()
    for b in range(B):
        prod = 1
        for v in leaves_ints[b]:
            prod = prod * v % spec.p
        assert claims[b] == fr(prod)

    pt = Transcript(b"gp")
    proof, r_prover = gp.prove(pt)

    vt = Transcript(b"gp")
    vt.compare_to(pt)
    final_claims, r_verify = verify_grand_product(proof, claims, vt)
    assert [x.v for x in r_verify] == [x.v for x in r_prover]

    # final claims are the leaf MLE evaluations at r_grand_product
    for b in range(B):
        leaf_felts = [fr(v) for v in leaves_ints[b]]
        assert final_claims[b] == mle.evaluate_host(leaf_felts, r_verify), b


def test_grand_product_rejects_tampering():
    spec = fr_spec()
    leaves = fd.ints_to_device(
        spec, [[RNG.randrange(spec.p) for _ in range(4)]])
    gp = BatchedDenseGrandProduct.construct(leaves, spec)
    claims = gp.claims()
    proof, _ = gp.prove(Transcript(b"gp"))

    # tamper with a left claim
    proof.layers[0].left_claims[0] = proof.layers[0].left_claims[0] + fr(1)
    try:
        verify_grand_product(proof, claims, Transcript(b"gp"))
        raise SystemExit("tampered proof should not verify")
    except AssertionError:
        pass


def test_device_fiat_shamir_layer_parity(monkeypatch):
    """Device-resident Fiat-Shamir chain (one dispatch per layer) produces
    the exact same proof + transcript as the host path."""
    monkeypatch.setenv("JOLT_TPU_DEVICE_FS", "1")
    spec = fr_spec()
    B, n = 2, 8
    leaves_ints = [[RNG.randrange(spec.p) for _ in range(n)]
                   for _ in range(B)]
    leaves = fd.ints_to_device(spec, leaves_ints)
    gp = BatchedDenseGrandProduct.construct(leaves, spec)
    claims = gp.claims()
    t_dev = Transcript(b"gp")
    proof_dev, r_dev = gp.prove(t_dev)

    monkeypatch.setenv("JOLT_TPU_DEVICE_FS", "0")
    gp2 = BatchedDenseGrandProduct.construct(leaves, spec)
    t_host = Transcript(b"gp")
    proof_host, r_host = gp2.prove(t_host)

    assert t_dev.state_history == t_host.state_history
    assert [x.v for x in r_dev] == [x.v for x in r_host]
    for ld, lh in zip(proof_dev.layers, proof_host.layers):
        for pd, ph in zip(ld.proof.compressed_polys,
                          lh.proof.compressed_polys):
            assert [c.v for c in pd.coeffs_except_linear_term] == \
                [c.v for c in ph.coeffs_except_linear_term]
    verify_grand_product(proof_dev, claims, Transcript(b"gp"))


def test_masked_device_rounds_transcript_parity(monkeypatch):
    """host_tail=0 forces every layer through the masked fixed-shape
    DEVICE round kernels (padded to the GP's canonical size, traced h);
    transcript must match the host-tail prover byte-for-byte.  Regression:
    a missing h-halving in the non-FS masked loop shipped past the default
    suite because host tails ate every small layer."""
    spec = fr_spec()
    B, n = 3, 32
    leaves_ints = [[RNG.randrange(spec.p) for _ in range(n)]
                   for _ in range(B)]
    leaves = fd.ints_to_device(spec, leaves_ints)

    monkeypatch.setenv("JOLT_TPU_DEVICE_FS", "0")
    monkeypatch.setenv("JOLT_TPU_HOST_TAIL", "0")
    monkeypatch.setenv("JOLT_TPU_MASKED", "1")
    gp = BatchedDenseGrandProduct.construct(leaves, spec)
    claims = gp.claims()
    t_dev = Transcript(b"gpm")
    proof_dev, _ = gp.prove(t_dev)
    verify_grand_product(proof_dev, claims, Transcript(b"gpm"))

    monkeypatch.delenv("JOLT_TPU_HOST_TAIL")
    monkeypatch.delenv("JOLT_TPU_MASKED")
    gp2 = BatchedDenseGrandProduct.construct(leaves, spec)
    t_host = Transcript(b"gpm")
    gp2.prove(t_host)
    assert t_dev.state_history == t_host.state_history, \
        "masked device rounds diverge from the host-tail prover"


def test_masked_device_fs_rounds_transcript_parity(monkeypatch):
    """Same as above with the device Fiat-Shamir chain enabled (the
    production GPU path: fs_cubic_round_jit + masked evals/bind)."""
    spec = fr_spec()
    B, n = 2, 16
    leaves_ints = [[RNG.randrange(spec.p) for _ in range(n)]
                   for _ in range(B)]
    leaves = fd.ints_to_device(spec, leaves_ints)

    monkeypatch.setenv("JOLT_TPU_DEVICE_FS", "1")
    monkeypatch.setenv("JOLT_TPU_HOST_TAIL", "0")
    monkeypatch.setenv("JOLT_TPU_MASKED", "1")
    gp = BatchedDenseGrandProduct.construct(leaves, spec)
    claims = gp.claims()
    t_dev = Transcript(b"gpf")
    proof_dev, _ = gp.prove(t_dev)
    verify_grand_product(proof_dev, claims, Transcript(b"gpf"))

    monkeypatch.setenv("JOLT_TPU_DEVICE_FS", "0")
    monkeypatch.delenv("JOLT_TPU_HOST_TAIL")
    monkeypatch.delenv("JOLT_TPU_MASKED")
    gp2 = BatchedDenseGrandProduct.construct(leaves, spec)
    t_host = Transcript(b"gpf")
    gp2.prove(t_host)
    assert t_dev.state_history == t_host.state_history
