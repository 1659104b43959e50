"""Host-side (Python-int) finite field arithmetic.

These classes are the *semantic reference* for the whole framework: exact,
arbitrary-precision, and byte-compatible with the reference Rust crates.  The
device (JAX/Pallas) kernels in ``zkvm_tpu.ops`` are tested against them.
"""

from .field import PrimeField
from .fr import Fr
from .fp import Fp
from .fp2 import Fp2
from .fp6 import Fp6
from .fp12 import Fp12
from .jubjub_fr import JubjubFr

__all__ = ["PrimeField", "Fr", "Fp", "Fp2", "Fp6", "Fp12",
           "JubjubFr"]
