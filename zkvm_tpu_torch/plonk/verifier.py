"""Verifier: transcript replay + pairing check (plonk/src/compiler/verifier.rs)."""

from __future__ import annotations

from ..fields import Fr
from .composer import Composer
from .errors import (InconsistentPublicInputsLen, NotEnoughBytes,
                     PlonkError)
from .kzg10 import OpeningKey
from .proof import Proof
from .widgets import VerifierKey


class Verifier:
    """Holds VerifierKey/OpeningKey/PI indexes/base transcript
    (verifier.rs:16-218)."""

    def __init__(self, label: bytes, verifier_key: VerifierKey,
                 opening_key: OpeningKey, public_input_indexes: list[int],
                 size: int, constraints: int):
        from .prover import base_transcript

        self.label = bytes(label)
        self.verifier_key = verifier_key
        self.opening_key = opening_key
        self.public_input_indexes = list(public_input_indexes)
        self.size = size
        self.constraints = constraints
        self.transcript = base_transcript(self.label, verifier_key,
                                          constraints)

    # -- serialization (verifier.rs:49-183) ----------------------------------------
    def to_bytes(self) -> bytes:
        verifier_key = self.verifier_key.to_bytes()
        opening_key = self.opening_key.to_bytes()
        out = (len(self.label).to_bytes(8, "big")
               + len(verifier_key).to_bytes(8, "big")
               + len(opening_key).to_bytes(8, "big")
               + len(self.public_input_indexes).to_bytes(8, "big")
               + self.size.to_bytes(8, "big")
               + self.constraints.to_bytes(8, "big"))
        out += self.label + verifier_key + opening_key
        for i in self.public_input_indexes:
            out += int(i).to_bytes(8, "big")
        return out

    @classmethod
    def try_from_bytes(cls, buf: bytes) -> "Verifier":
        if len(buf) < 48:
            raise NotEnoughBytes()
        label_len = int.from_bytes(buf[0:8], "big")
        vk_len = int.from_bytes(buf[8:16], "big")
        ok_len = int.from_bytes(buf[16:24], "big")
        pi_len = int.from_bytes(buf[24:32], "big")
        size = int.from_bytes(buf[32:40], "big")
        constraints = int.from_bytes(buf[40:48], "big")
        pos = 48
        label = buf[pos: pos + label_len]
        pos += label_len
        verifier_key = VerifierKey.from_bytes(buf[pos: pos + vk_len])
        pos += vk_len
        opening_key = OpeningKey.from_bytes(buf[pos: pos + ok_len])
        pos += ok_len
        indexes = [int.from_bytes(buf[pos + 8 * i: pos + 8 * (i + 1)], "big")
                   for i in range(pi_len)]
        return cls(label, verifier_key, opening_key, indexes, size,
                   constraints)

    def verify(self, proof: Proof, public_inputs: list[Fr]) -> None:
        if len(public_inputs) != len(self.public_input_indexes):
            raise InconsistentPublicInputsLen(
                len(self.public_input_indexes), len(public_inputs))
        transcript = self.transcript.clone()
        for pi in public_inputs:
            transcript.append_scalar(b"pi", pi)
        dense = Composer.dense_public_inputs(
            self.public_input_indexes, public_inputs, self.size)
        proof.verify(self.verifier_key, transcript, self.opening_key, dense)
