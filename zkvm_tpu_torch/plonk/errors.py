"""Typed error hierarchy, one class per reference variant
(plonk/src/error.rs `Error` enum, all 23 variants; messages mirror the
reference's Display impl)."""

from __future__ import annotations


class PlonkError(Exception):
    """Base class (the reference's `Error` enum itself)."""


class InvalidEvalDomainSize(PlonkError):
    def __init__(self, log_size_of_group: int, adacity: int):
        super().__init__(
            f"Log-size of the EvaluationDomain group > TWO_ADACITY "
            f"Size: {log_size_of_group} > TWO_ADACITY = {adacity}")
        self.log_size_of_group = log_size_of_group
        self.adacity = adacity


class ProofVerificationError(PlonkError):
    def __init__(self, msg: str = "proof verification failed"):
        super().__init__(msg)


class CircuitInputsNotFound(PlonkError):
    def __init__(self):
        super().__init__("circuit inputs not found")


class UninitializedPIGenerator(PlonkError):
    def __init__(self):
        super().__init__("PI generator uninitialized")


class InvalidPublicInputBytes(PlonkError):
    def __init__(self):
        super().__init__("invalid public input bytes")


class CircuitAlreadyPreprocessed(PlonkError):
    def __init__(self):
        super().__init__("circuit has already been preprocessed")


class InvalidCircuitSize(PlonkError):
    def __init__(self, description_size: int, circuit_size: int):
        super().__init__(
            "circuit description has a different amount of gates than the "
            f"circuit for the proof creation: description size = "
            f"{description_size}, circuit size = {circuit_size}")
        self.got = description_size
        self.expected = circuit_size


class MismatchedPolyLen(PlonkError):
    def __init__(self):
        super().__init__("the length of the wires is not the same")


class DegreeIsZero(PlonkError):
    def __init__(self):
        super().__init__(
            "cannot create PublicParameters with max degree 0")


class TruncatedDegreeTooLarge(PlonkError):
    def __init__(self):
        super().__init__("cannot trim more than the maximum degree")


class TruncatedDegreeIsZero(PlonkError):
    def __init__(self):
        super().__init__(
            "cannot trim PublicParameters to a maximum size of zero")


class PolynomialDegreeTooLarge(PlonkError):
    def __init__(self):
        super().__init__(
            "proving key is not large enough to commit to said polynomial")


class PolynomialDegreeIsZero(PlonkError):
    def __init__(self):
        super().__init__("cannot commit to polynomial of zero degree")


class PairingCheckFailure(PlonkError):
    def __init__(self):
        super().__init__("pairing check failed")


class BytesError(PlonkError):
    """Wraps a lower-layer serialization error (coset-bytes Error)."""

    def __init__(self, err):
        super().__init__(str(err))
        self.inner = err


class NotEnoughBytes(PlonkError):
    def __init__(self):
        super().__init__("not enough bytes left to read")


class PointMalformed(PlonkError):
    def __init__(self):
        super().__init__("BLS point bytes malformed")


class BlsScalarMalformed(PlonkError):
    def __init__(self):
        super().__init__("BLS scalar bytes malformed")


class JubJubScalarMalformed(PlonkError):
    def __init__(self):
        super().__init__("JubJub scalar bytes malformed")


class UnsupportedWNAF2k(PlonkError):
    def __init__(self):
        super().__init__(
            "WNAF2k cannot hold values not contained in `[-1..1]`")


class PublicInputNotFound(PlonkError):
    def __init__(self, index: int):
        super().__init__(
            f"The public input of index {index} is defined in the circuit "
            "description, but wasn't declared in the prove instance")
        self.index = index


class InconsistentPublicInputsLen(PlonkError):
    def __init__(self, expected: int, provided: int):
        super().__init__(
            f"The provided public inputs set of length {provided} doesn't "
            f"match the processed verifier: {expected}")
        self.expected = expected
        self.provided = provided


class InvalidCompressedCircuit(PlonkError):
    def __init__(self, msg: str = "invalid compressed circuit"):
        super().__init__(msg)
