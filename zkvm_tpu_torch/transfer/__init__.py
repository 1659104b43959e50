"""Dusk's Phoenix transfer: the notes' arithmetic on the host and the
transfer circuit (`TxCircuit`) that the prover proves.

* `schnorr`  JubJub Schnorr signatures, single and double, on the host and
             as gadgets (jubjub-schnorr);
* `notes`    value commitments, note hashes, nullifiers and the ElGamal
             encryption of a point, on the host and as gadgets;
* `circuit`  `TxCircuit(inputs, height)`: phoenix-circuits' `TxCircuit`.
"""

from .circuit import InputNote, OutputNote, TxCircuit
from .schnorr import (Signature, SignatureDouble, sign, sign_double, verify,
                      verify_double, verify_signature_gadget,
                      verify_signature_double_gadget)

__all__ = ["InputNote", "OutputNote", "Signature", "SignatureDouble",
           "TxCircuit", "sign", "sign_double", "verify", "verify_double",
           "verify_signature_gadget", "verify_signature_double_gadget"]
