"""Field specifications for BN254.

The reference implements `JoltField` over arkworks' BN254 scalar field
(jolt-core/src/field/mod.rs:15-51, field/ark.rs:1-58).  Here a field is a
`FieldSpec` carrying the modulus and the Montgomery constants used by the
device limb kernels (device.py) and the host big-int implementation (host.py).

Device representation: 16 little-endian limbs of 16 bits each, stored in
uint32 (headroom for redundant/carry-save accumulation), Montgomery form with
R = 2^256 — the same R as arkworks' 4x64-bit representation, so Montgomery
residues match the reference bit-for-bit.
"""
from __future__ import annotations

import functools

import numpy as np

LIMB_BITS = 16
NUM_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * NUM_LIMBS  # 256


def int_to_limbs(x: int, n: int = NUM_LIMBS) -> np.ndarray:
    """Little-endian 16-bit limb decomposition as uint32[n]."""
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)],
                    dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    out = 0
    for i, l in enumerate(np.asarray(limbs).tolist()):
        out += int(l) << (LIMB_BITS * i)
    return out


class FieldSpec:
    """A prime field with precomputed Montgomery constants (R = 2^256)."""

    def __init__(self, name: str, modulus: int):
        assert modulus % 2 == 1 and modulus < (1 << R_BITS)
        self.name = name
        self.p = modulus
        self.num_bits = modulus.bit_length()
        # -p^{-1} mod 2^16 (per-limb Montgomery factor)
        self.n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.r = (1 << R_BITS) % modulus          # R mod p (Montgomery 1)
        self.r2 = (self.r * self.r) % modulus     # for to-Montgomery conversion
        self.r_inv = pow(1 << R_BITS, -1, modulus)
        # -p^{-1} mod 2^256 (single-shot Montgomery reduction factor)
        self.nprime = (-pow(modulus, -1, 1 << R_BITS)) % (1 << R_BITS)
        self.p_limbs = int_to_limbs(modulus)
        self.r_limbs = int_to_limbs(self.r)
        self.r2_limbs = int_to_limbs(self.r2)
        self.nprime_limbs = int_to_limbs(self.nprime)

    # -- host-side scalar helpers ------------------------------------------
    def to_mont(self, x: int) -> int:
        return (x * self.r) % self.p

    def from_mont(self, x: int) -> int:
        return (x * self.r_inv) % self.p

    def inv(self, x: int) -> int:
        return pow(x, -1, self.p)

    def __repr__(self):
        return f"FieldSpec({self.name})"

    def __hash__(self):
        return hash((self.name, self.p))

    def __eq__(self, other):
        return isinstance(other, FieldSpec) and self.p == other.p


# BN254 scalar field Fr (the proof-system field; reference field/ark.rs)
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# BN254 base field Fq (G1/G2 coordinates; used by the MSM/curve kernels)
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583


@functools.cache
def fr_spec() -> FieldSpec:
    return FieldSpec("bn254_fr", FR_MODULUS)


@functools.cache
def fq_spec() -> FieldSpec:
    return FieldSpec("bn254_fq", FQ_MODULUS)
