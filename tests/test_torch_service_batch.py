"""The whole batch service, zkvm_tpu's against the port's, byte for byte.

One circuit cache (the height-1 opening circuit at capacity 10, compiled by
zkvm_tpu under `StdRng(42)`) and one input of three good leaves and one bad
leaf.  zkvm_tpu's batch and the port's (device "cpu": the plain versions of
the kernels) must write the same proof and public-input files; a second
run of the port loads the same cache and writes the same bytes again; the
port's CLI `verify` accepts every proof and refuses one whose public-input
file has a changed byte.  Tolerance 0: bytes are compared.
"""

import pytest
import torch

import zkvm_tpu.service.batch as rbatch
import zkvm_tpu.service.formats as rformats
import zkvm_tpu_torch.service.batch as pbatch
import zkvm_tpu_torch.service.cli as pcli
from zkvm_tpu.fields import Fr
from zkvm_tpu.merkle import Item, PoseidonTree
from zkvm_tpu.plonk import Compiler, PublicParameters
from zkvm_tpu.rng import StdRng
from zkvm_tpu_torch.utils import metrics

torch.set_num_threads(1)

HEIGHT, CAPACITY = 1, 10


def _files(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.slow
def test_port_batch_writes_the_reference_s_files(tmp_path, caplog):
    pp = PublicParameters.setup(1 << CAPACITY, StdRng(42))
    prover, verifier = Compiler.compile_with_circuit(
        pp, b"opening-circuit", rbatch.OpeningCircuit.default_for_height(
            HEIGHT))
    cache, vfile = tmp_path / "circuit_prove.bin", tmp_path / "verifier.bin"
    cache.write_bytes(rformats.prover_cache_to_bytes(CAPACITY,
                                                     prover.to_bytes()))
    vfile.write_bytes(verifier.to_bytes())

    tree = PoseidonTree(HEIGHT)
    leaves = [Fr(1000 + i) for i in range(3)]
    for i, leaf in enumerate(leaves):
        tree.insert(i, Item(leaf, None))
    infos = [rformats.LeafInfo(i, leaf.to_bytes(),
                               tree.opening(i).to_var_bytes())
             for i, leaf in enumerate(leaves)]
    # a leaf that is not the opened one: skipped, not fatal
    infos.insert(1, rformats.LeafInfo(0, Fr(4242).to_bytes(),
                                      tree.opening(0).to_var_bytes()))
    merkle = tmp_path / "merkle_some.bin"
    merkle.write_bytes(rformats.MultipleLeavesData(
        tree.root().hash.to_bytes(), infos).to_rkyv_bytes())

    def config(module, out, **kw):
        return module.BatchProofConfig(
            merkle_input_file=str(merkle), circuit_cache_file=str(cache),
            verifier_file=str(vfile), output_dir=str(tmp_path / out),
            capacity=CAPACITY, tree_height=HEIGHT, **kw)

    assert rbatch.process_batch_proofs_with_config(config(rbatch, "ref")) == 3
    want = _files(tmp_path / "ref")
    assert sorted(want) == [f"plonk_{kind}_{i}.bin" for kind in
                            ("proof", "publicinputs") for i in (1, 3, 4)]
    for run in ("port1", "port2"):
        caplog.clear()
        metrics.GLOBAL.reset()
        with caplog.at_level("INFO", logger="zkvm_tpu_torch.service"):
            assert pbatch.process_batch_proofs_with_config(
                config(pbatch, run, device="cpu")) == 3
        assert any(r.getMessage().startswith("loaded cached prover")
                   for r in caplog.records)
        # the first proven leaf's prove apart from the rest
        assert metrics.GLOBAL.counts["service/first_prove"] == 1
        assert metrics.GLOBAL.counts["service/prove"] == 2
        assert _files(tmp_path / run) == want
    assert cache.read_bytes()[:8] == CAPACITY.to_bytes(8, "little")

    out = tmp_path / "port2"
    for i in (1, 3, 4):
        assert pcli.main(["verify", "--proof",
                          str(out / f"plonk_proof_{i}.bin"),
                          "--public-inputs",
                          str(out / f"plonk_publicinputs_{i}.bin"),
                          "--verifier", str(vfile)]) == 0
    changed = bytearray(want["plonk_publicinputs_1.bin"])
    changed[0] ^= 1
    (tmp_path / "changed.bin").write_bytes(bytes(changed))
    assert pcli.main(["verify", "--proof", str(out / "plonk_proof_1.bin"),
                      "--public-inputs", str(tmp_path / "changed.bin"),
                      "--verifier", str(vfile)]) == 1
