"""PLONK proof system (TurboPLONK variant with 4 wires + lookup-free widgets).

The port of `zkvm_tpu.plonk`: the same names, the same bytes.  Composer with
the full gadget library, KZG10 commitments, widget prover/verifier keys,
quotient/linearization pipeline, merlin-compatible transcript, and
proof/key serialization are host code copied from the reference; the
compiler's preprocessing and every prover round run on the commit key's
device (`zkvm_tpu_torch.ops`).
"""

from .composer import Circuit, Composer
from .compiler import Compiler
from .constraint_system import Constraint, Witness, WitnessPoint
from .errors import PlonkError, ProofVerificationError
from .evaluations import Evaluations
from .kzg10 import Commitment, CommitKey, OpeningKey, PublicParameters
from .polynomial import Polynomial
from .proof import Proof
from .prover import Prover
from .transcript import Transcript
from .verifier import Verifier

__all__ = [
    "Circuit", "Commitment", "CommitKey", "Compiler", "Composer",
    "Constraint", "Evaluations", "OpeningKey", "PlonkError", "Polynomial",
    "Proof", "ProofVerificationError", "Prover", "PublicParameters",
    "Transcript", "Verifier", "Witness", "WitnessPoint",
]
