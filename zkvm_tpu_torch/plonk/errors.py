"""The error classes that `kzg10` and `ops.ntt` raise, with the reference's
messages.

Copies of the matching classes in `zkvm_tpu/plonk/errors.py` (which cannot
be imported without JAX: `zkvm_tpu.plonk` imports the device prover).
"""

from __future__ import annotations


class PlonkError(Exception):
    """Base class (the reference's `Error` enum itself)."""


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


class InvalidEvalDomainSize(PlonkError):
    def __init__(self, log_size_of_group: int, adacity: int):
        super().__init__(
            f"Log-size of the EvaluationDomain group > TWO_ADACITY "
            f"Size: {log_size_of_group} > TWO_ADACITY = {adacity}")
        self.log_size_of_group = log_size_of_group
        self.adacity = adacity


class PairingCheckFailure(PlonkError):
    def __init__(self):
        super().__init__("pairing check failed")
