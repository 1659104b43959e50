"""The port's copy of the plonk host layer against zkvm_tpu's.

The copied modules (errors, constraint system, composer, compress,
transcript, widgets, proof, verifier, the Poseidon gadget, encryption,
`opening_gadget`) are held value for value and byte for byte against the
reference: the committed fixture bundles load through the port's `Prover`
and `Verifier` and re-serialize to the same bytes, circuits compress to the
reference's bytes, transcripts give the same challenges, and the kzg10
byte functions round-trip against the reference's.  The two packages'
classes differ, so values cross as ints and bytes.
"""

import sys
from pathlib import Path

import pytest
import torch

from zkvm_tpu.curves.jubjub import JubjubExtended as RJubjubExtended
from zkvm_tpu.curves.jubjub import dhke as rdhke
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.fields import JubjubFr as RJubjubFr
from zkvm_tpu.hashes import encryption as rencryption
from zkvm_tpu.plonk import Composer as RComposer
from zkvm_tpu.plonk import errors as rerrors
from zkvm_tpu.plonk import kzg10 as rkzg
from zkvm_tpu.plonk.transcript import Transcript as RTranscript
from zkvm_tpu.rng import StdRng as RStdRng
from zkvm_tpu_torch.curves.jubjub import JubjubExtended, dhke
from zkvm_tpu_torch.fields import Fr, JubjubFr
from zkvm_tpu_torch.hashes import encryption
from zkvm_tpu_torch.plonk import (Circuit, Composer, Constraint, Proof,
                                  Prover, Verifier, errors, kzg10)
from zkvm_tpu_torch.plonk.compress import CompressedCircuit
from zkvm_tpu_torch.plonk.transcript import Transcript
from zkvm_tpu_torch.rng import StdRng
from zkvm_tpu_torch.utils import dryrun

sys.path.insert(0, str(Path(__file__).parent))
from test_fixtures import FixedCircuit as RFixedCircuit  # noqa: E402
from test_plonk_e2e import RangeLogicCircuit as RRangeLogic  # noqa: E402

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"


class FixedCircuit(Circuit):
    """`tests/test_fixtures.py`'s FixedCircuit on the port's classes."""

    def circuit(self, c):
        a = c.append_witness(Fr(3))
        b = c.append_witness(Fr(5))
        o = c.gate_add(Constraint().left(1).right(1).a(a).b(b))
        c.assert_equal_constant(o, Fr(8), None)
        x = c.gate_mul(Constraint().mult(1).a(a).b(b))
        c.assert_equal_constant(x, Fr(15), None)
        c.component_boolean(c.append_witness(Fr(1)))


class RangeLogicCircuit(Circuit):
    """`tests/test_plonk_e2e.py`'s RangeLogicCircuit on the port's classes
    (range, logic, boolean and select gadgets)."""

    def __init__(self, x=0x3FF):
        self.x = Fr(x)

    def circuit(self, composer):
        x = composer.append_witness(self.x)
        composer.component_range(x, 16)  # 32-bit range
        y = composer.append_witness(Fr(0xAB))
        composer.append_logic_and(x, y, 16)
        composer.append_logic_xor(x, y, 16)
        bit = composer.append_witness(Fr.one())
        composer.component_boolean(bit)
        composer.component_select(bit, x, y)


def test_fixture_bundles_load_and_reserialize():
    pb = (FIXTURES / "prover_bundle_v1.bin").read_bytes()
    vb = (FIXTURES / "verifier_bundle_v1.bin").read_bytes()
    prover = Prover.try_from_bytes(pb, "cpu")
    verifier = Verifier.try_from_bytes(vb)
    assert prover.to_bytes() == pb
    assert verifier.to_bytes() == vb
    assert prover.device == torch.device("cpu")
    assert prover.commit_key.device == torch.device("cpu")
    assert prover.label == b"fixture" and verifier.label == b"fixture"


@pytest.mark.parametrize("circuit", ["fixed", "range_logic", "dryrun"])
def test_circuits_compress_to_the_reference_bytes(circuit):
    """The composer, its gadgets and `opening_gadget` (with the Poseidon
    hash gadget) build the reference's constraints, witnesses and public
    inputs: the compressed circuits are byte-identical."""
    if circuit == "fixed":
        port, ref = FixedCircuit(), RFixedCircuit()
        expect = (FIXTURES / "compressed_circuit_v1.bin").read_bytes()
        assert port.compress() == expect
    elif circuit == "range_logic":
        port, ref = RangeLogicCircuit(), RRangeLogic()
    else:
        from zkvm_tpu.utils import dryrun as rdryrun

        port, ref = dryrun.dryrun_circuit(), rdryrun.dryrun_circuit()
    blob = port.compress()
    assert blob == ref.compress()
    back = CompressedCircuit.from_bytes(blob)
    assert isinstance(back, Composer)
    fresh = Composer.initialized()
    port.circuit(fresh)
    assert len(back.constraints) == len(fresh.constraints)
    rcomp = RComposer.initialized()
    ref.circuit(rcomp)
    assert ([w.value for w in fresh.witnesses]
            == [w.value for w in rcomp.witnesses])
    assert ([v.value for v in fresh.public_input_values()]
            == [v.value for v in rcomp.public_input_values()])
    assert fresh.public_input_indexes() == rcomp.public_input_indexes()


def test_transcript_gives_the_reference_challenges():
    port, ref = Transcript(b"test protocol"), RTranscript(b"test protocol")
    # merlin 3.0.0's own known answer
    for t in (port, ref):
        t.append_message(b"some label", b"some data")
    assert port.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")
    ref.challenge_bytes(b"challenge", 32)
    vk = Verifier.try_from_bytes(
        (FIXTURES / "verifier_bundle_v1.bin").read_bytes()).verifier_key
    from zkvm_tpu.plonk.verifier import Verifier as RVerifier

    rvk = RVerifier.try_from_bytes(
        (FIXTURES / "verifier_bundle_v1.bin").read_bytes()).verifier_key
    port.circuit_domain_sep(37)
    ref.circuit_domain_sep(37)
    vk.seed_transcript(port)
    rvk.seed_transcript(ref)
    for i in range(20):
        v = (i * 0x9E3779B97F4A7C15 << 64 | i) % Fr.MODULUS
        port.append_scalar(b"pi", Fr(v))
        ref.append_scalar(b"pi", RFr(v))
        a, b = port.challenge_scalar(b"beta"), ref.challenge_scalar(b"beta")
        assert a.value == b.value
    assert port.clone().challenge_bytes(b"x", 64) == \
        ref.clone().challenge_bytes(b"x", 64)


def test_errors_have_the_reference_classes():
    def classes(mod):
        return {name: cls for name, cls in vars(mod).items()
                if isinstance(cls, type) and issubclass(cls, Exception)}

    port, ref = classes(errors), classes(rerrors)
    assert sorted(port) == sorted(ref) and len(port) == 24
    for name, cls in ref.items():
        assert [b.__name__ for b in port[name].__mro__] == \
            [b.__name__ for b in cls.__mro__]
    assert str(errors.InvalidCircuitSize(3, 4)) == \
        str(rerrors.InvalidCircuitSize(3, 4))
    assert issubclass(kzg10.KZGError, errors.PlonkError)
    assert issubclass(kzg10.KZGError, ValueError)


def test_kzg10_bytes_round_trip_against_the_reference():
    ref = rkzg.PublicParameters.setup(5, RStdRng(3))
    port = kzg10.PublicParameters.setup(5, StdRng(3), "cpu")
    assert port.to_var_bytes() == ref.to_var_bytes()
    assert port.to_raw_var_bytes() == ref.to_raw_var_bytes()
    assert port.commit_key.to_var_bytes() == ref.commit_key.to_var_bytes()
    back = kzg10.PublicParameters.from_slice(ref.to_var_bytes(), "cpu")
    assert back.to_var_bytes() == ref.to_var_bytes()
    assert back.commit_key.device == torch.device("cpu")
    raw = kzg10.PublicParameters.from_slice_unchecked(ref.to_raw_var_bytes(),
                                                      "cpu")
    assert raw.to_raw_var_bytes() == ref.to_raw_var_bytes()
    ck = kzg10.CommitKey.from_slice(ref.commit_key.to_var_bytes(), "cpu")
    assert ck == port.commit_key
    with pytest.raises(kzg10.KZGError):
        kzg10.CommitKey.from_slice(b"\0" * 47, "cpu")
    with pytest.raises(errors.NotEnoughBytes):
        kzg10.PublicParameters.from_slice(b"\0" * 10, "cpu")


def test_proof_bytes_round_trip_on_the_dryrun_fixture():
    proof_bytes, pis = dryrun.load_fixture()
    proof = Proof.from_bytes(proof_bytes)
    assert proof.to_bytes() == proof_bytes and len(proof_bytes) == Proof.SIZE
    assert len(pis) == 1


def test_encryption_matches_the_reference():
    secret = dhke(JubjubFr(4321), JubjubExtended.generator())
    rsecret = rdhke(RJubjubFr(4321), RJubjubExtended.generator())
    message = [Fr(10), Fr(20), Fr(30)]
    cipher = encryption.encrypt(message, secret, Fr(31337))
    rcipher = rencryption.encrypt([RFr(10), RFr(20), RFr(30)], rsecret,
                                  RFr(31337))
    assert [c.value for c in cipher] == [c.value for c in rcipher]
    assert encryption.decrypt(cipher, secret, Fr(31337)) == message
    composer = Composer.initialized()
    point = composer.append_point(secret)
    nonce = composer.append_witness(Fr(31337))
    wits = [composer.append_witness(m) for m in message]
    out = encryption.encrypt_gadget(composer, wits, point, nonce)
    assert [composer[w] for w in out] == cipher
    with pytest.raises(encryption.DecryptionError):
        encryption.decrypt([cipher[0] + Fr.one()] + cipher[1:], secret,
                           Fr(31337))

