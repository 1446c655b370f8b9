"""jolt_tpu — a zkVM prover/verifier framework on JAX (NVIDIA GPU).

A from-scratch JAX/XLA re-design of the capabilities of the Jolt zkVM
(reference: zhaowenlan1779/jolt, Rust): a RISC-V RV32IM zero-knowledge virtual
machine built from Lasso instruction lookups, offline memory checking, uniform
Spartan R1CS, batched GKR grand products, and HyperKZG polynomial commitments
over BN254 — all driven by a Keccak256 Fiat-Shamir transcript.

Architecture (NOT a port):
  * BN254 field elements are limb-decomposed uint32 tensors (16 x 16-bit
    limbs, limbs-first layout); Montgomery multiplication is a fused
    static-shape kernel on the GPU (field/mont_kernel.py).
  * All sumcheck / grand-product / MSM inner loops are dense batched tensor
    programs under jit; polynomial "zoos" are stacked into single tensors.
  * The verifier is pure host Python over arbitrary-precision ints — an
    independent implementation that cross-checks the device prover.
  * Multi-device scaling shards the 2^n hypercube (or the GP batch axis)
    over a jax.sharding.Mesh; backend.py holds the per-platform policy.
"""

__version__ = "0.1.0"
