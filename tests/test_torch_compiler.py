"""The port's compiler gives the committed fixture bundles byte for byte.

`Compiler.compile_with_circuit` at setup 2^6, `StdRng(1234)`, label
b"fixture" reproduces `tests/fixtures/prover_bundle_v1.bin` and
`verifier_bundle_v1.bin` (the reference's own bytes, `tests/
test_fixtures.py`), and so does `compile_with_compressed` of
`compressed_circuit_v1.bin`: the batched iFFT of the 15 columns, the
multi-set commit of the live ones and the batched coset FFT onto 8n all
run on the commit key's device (here the CPU).  The keys a compile
returns carry its device tensors as the prover's caches, equal to the ones
a prover from the bundle lifts itself.
"""

import sys
from pathlib import Path

import pytest
import torch

from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.plonk import Compiler, Prover, PublicParameters
from zkvm_tpu_torch.plonk import quotient
from zkvm_tpu_torch.rng import StdRng

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_plonk_host import FixedCircuit  # noqa: E402

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def pp():
    return PublicParameters.setup(1 << 6, StdRng(1234), "cpu")


@pytest.mark.parametrize("entry", ["circuit", "compressed"])
def test_compiler_gives_the_fixture_bundles(pp, entry):
    if entry == "circuit":
        prover, verifier = Compiler.compile_with_circuit(pp, b"fixture",
                                                         FixedCircuit())
    else:
        prover, verifier = Compiler.compile_with_compressed(
            pp, b"fixture",
            (FIXTURES / "compressed_circuit_v1.bin").read_bytes())
    pb = (FIXTURES / "prover_bundle_v1.bin").read_bytes()
    assert prover.to_bytes() == pb
    assert verifier.to_bytes() == (FIXTURES /
                                   "verifier_bundle_v1.bin").read_bytes()
    assert prover.device == torch.device("cpu")
    if entry == "circuit":
        # the compiler's device tensors equal what a loaded prover lifts
        made = quotient._device_cache(prover.prover_key, "cpu")
        lifted = quotient._device_cache(
            Prover.try_from_bytes(pb, "cpu").prover_key, "cpu")
        for name, _ in lifted[0].items():
            assert torch.equal(made[0][name], lifted[0][name])
        assert torch.equal(made[1], lifted[1])
        assert torch.equal(made[2], lifted[2])
        # X over the coset 7 H of the 8n domain
        assert lf.FR.from_mont_array(made[2])[:2] == [
            7, 7 * prover.prover_key.v_h_coset_8n.domain.group_gen
            % lf.FR.modulus]
