from .g1 import G1Affine, G1Projective
from .g2 import G2Affine, G2Projective
from .jubjub import JubjubAffine, JubjubExtended
from .pairing import pairing, multi_miller_loop, final_exponentiation, G2Prepared, Gt

__all__ = [
    "G1Affine", "G1Projective", "G2Affine", "G2Projective",
    "JubjubAffine", "JubjubExtended",
    "pairing", "multi_miller_loop", "final_exponentiation", "G2Prepared", "Gt",
]
