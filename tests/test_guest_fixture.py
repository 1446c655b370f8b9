"""Frozen guest-ELF regression fixture.

The reference feeds cargo-built guest ELFs through its tracer
(jolt-core/src/host/mod.rs:100-214); this environment has no Rust
toolchain and /root/reference ships no prebuilt guest binaries (checked:
examples/*/guest contain only sources).  The achievable substitute: a
repo-assembled sha2-chain ELF is FROZEN as a fixture — decode + trace it
every round and pin the ELF bytes, trace length, and program output, so
assembler/ELF-writer/tracer drift is caught immediately.
"""
import hashlib
import os

import pytest

from jolt_tpu.tracer.elf import decode_elf
from jolt_tpu.tracer.elf_write import write_elf
from jolt_tpu.vm.guests import sha2_chain_expected, sha2_chain_program
from jolt_tpu.vm.host import trace_program
from jolt_tpu.vm.rv32i_vm import rv32i_vm

FIXDIR = os.path.join(os.path.dirname(__file__), "..", "fixtures", "guests")
ELF_PATH = os.path.join(FIXDIR, "sha2_chain_1.elf")
INPUTS = b"\x05" * 32


def test_guest_elf_fixture_frozen():
    """The assembled sha2-chain(1) guest ELF is byte-frozen."""
    os.makedirs(FIXDIR, exist_ok=True)
    program = sha2_chain_program(1)
    tmp = ELF_PATH + ".new"
    write_elf(tmp, program)
    with open(tmp, "rb") as f:
        blob = f.read()
    os.remove(tmp)
    if not os.path.exists(ELF_PATH):
        with open(ELF_PATH, "wb") as f:
            f.write(blob)
        pytest.skip("fixture generated; rerun to compare")
    with open(ELF_PATH, "rb") as f:
        want = f.read()
    assert hashlib.sha256(blob).hexdigest() == \
        hashlib.sha256(want).hexdigest(), \
        "assembled guest ELF bytes drifted from the frozen fixture"


def test_guest_elf_fixture_traces():
    """Decode the FROZEN ELF (not the in-memory program) and run it
    through the full tracer pipeline; trace length and outputs pinned."""
    if not os.path.exists(ELF_PATH):
        pytest.skip("fixture not generated yet")
    instructions, memory_init, entry = decode_elf(ELF_PATH)
    assert entry == instructions[0].address
    vm = rv32i_vm()
    steps, device, bytecode_rows = trace_program(instructions, vm,
                                                 inputs=INPUTS)
    assert bytes(device.outputs)[:32] == sha2_chain_expected(INPUTS, 1)
    assert len(steps) == 5161, \
        f"sha2-chain(1) trace length drifted: {len(steps)}"
    assert len(bytecode_rows) == len(instructions) or bytecode_rows
