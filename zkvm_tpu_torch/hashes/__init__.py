from .poseidon import Domain, Hash
from .hades import ScalarPermutation, hades_permute, WIDTH
from .safe import Sponge, Call

__all__ = ["Domain", "Hash", "ScalarPermutation", "hades_permute", "WIDTH", "Sponge", "Call"]
