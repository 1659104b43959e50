"""The port's batch service against zkvm_tpu's: file formats, make-input,
configuration and CLI, the circuit cache and the skip logic.

Bytes are compared throughout (tolerance 0).  Seeded inputs go through both
packages' `formats`, and each package must parse the other's bytes.  The
skip logic runs on a circuit cache that zkvm_tpu's compiler writes once per
module (height 1, capacity 10, `StdRng(42)`): an input whose leaves are all
bad, one of each kind, proves nothing and writes no file.  A `"cuda"`
request on a machine without a card raises; nothing falls back to the
CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import zkvm_tpu.service.batch as rbatch
import zkvm_tpu.service.cli as rcli
import zkvm_tpu.service.formats as rformats
import zkvm_tpu_torch.service.batch as pbatch
import zkvm_tpu_torch.service.cli as pcli
import zkvm_tpu_torch.service.formats as pformats
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.merkle import Item as RItem
from zkvm_tpu.merkle import PoseidonTree as RPoseidonTree
from zkvm_tpu.plonk import Compiler as RCompiler
from zkvm_tpu.plonk import PublicParameters as RPublicParameters
from zkvm_tpu.rng import StdRng as RStdRng
from zkvm_tpu_torch.curves.g1 import G1Affine
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.merkle import Item, PoseidonTree
from zkvm_tpu_torch.plonk import Compiler, PublicParameters
from zkvm_tpu_torch.plonk.errors import TruncatedDegreeTooLarge
from zkvm_tpu_torch.plonk.kzg10 import CommitKey

torch.set_num_threads(1)

FORMATS = [rformats, pformats]


def _blob(rng, n: int) -> bytes:
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _leaves_data(module, seed: int, proof_lengths):
    rng = np.random.default_rng(seed)
    infos = [module.LeafInfo(position=int(rng.integers(0, 1 << 62)),
                             leaf_hash=_blob(rng, 32),
                             proof_bytes=_blob(rng, n))
             for n in proof_lengths]
    return module.MultipleLeavesData(_blob(rng, 32), infos)


@pytest.mark.parametrize("proof_lengths", [(), (0,), (1,), (7, 0, 33),
                                           (1, 2, 3, 4, 5, 6, 7, 8, 9),
                                           (1237, 31)])
def test_multiple_leaves_bytes_equal_and_parse_across(proof_lengths):
    seed = len(proof_lengths) * 1000 + sum(proof_lengths)
    blobs = [_leaves_data(m, seed, proof_lengths).to_rkyv_bytes()
             for m in FORMATS]
    assert blobs[0] == blobs[1]
    for writer, reader in ((0, 1), (1, 0)):
        back = FORMATS[reader].MultipleLeavesData.from_rkyv_bytes(
            blobs[writer])
        want = _leaves_data(FORMATS[writer], seed, proof_lengths)
        assert back.root_hash == want.root_hash
        assert [(i.position, i.leaf_hash, i.proof_bytes)
                for i in back.leaves_info] == [
            (i.position, i.leaf_hash, i.proof_bytes)
            for i in want.leaves_info]


@pytest.mark.parametrize("length", [0, 1, 3, 4, 5, 143, 1001])
def test_zkproof_and_cache_bytes_equal_and_parse_across(length):
    payload = _blob(np.random.default_rng(length), length)
    proofs = [m.ZKProofData(payload).to_rkyv_bytes() for m in FORMATS]
    caches = [m.prover_cache_to_bytes(length + 10, payload) for m in FORMATS]
    assert proofs[0] == proofs[1] and caches[0] == caches[1]
    for m in FORMATS:
        assert m.ZKProofData.from_rkyv_bytes(proofs[0]).data == payload
        assert m.prover_cache_from_bytes(caches[0]) == (length + 10, payload)


@pytest.mark.parametrize("height, leaves", [(3, 4), (17, 8)])
def test_make_input_files_equal(tmp_path, height, leaves):
    outs = []
    for name, cli in (("ref", rcli), ("port", pcli)):
        out = tmp_path / f"{name}.bin"
        assert cli.main(["make-input", "--leaves", str(leaves), "--height",
                         str(height), "--out", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    data = pformats.MultipleLeavesData.from_rkyv_bytes(outs[1])
    assert [i.position for i in data.leaves_info] == list(range(leaves))


def test_config_defaults_are_the_reference_s_plus_the_device():
    ref = dataclasses.asdict(rbatch.BatchProofConfig())
    port = dataclasses.asdict(pbatch.BatchProofConfig())
    assert port.pop("device") == "cuda"
    assert port == ref
    assert (pbatch.DEFAULT_TREE_HEIGHT, pbatch.DEFAULT_CAPACITY) == (
        rbatch.DEFAULT_TREE_HEIGHT, rbatch.DEFAULT_CAPACITY) == (17, 13)


def _pp(capacity: int) -> PublicParameters:
    """Public parameters of `setup(1 << capacity)`'s degree; the points are
    not powers of tau: only the size rule of `trim` is under test."""
    n_points = (1 << capacity) + PublicParameters.ADDED_BLINDING_DEGREE + 1
    return PublicParameters(CommitKey([G1Affine.generator()] * n_points,
                                      "cpu"), None)


def test_default_capacity_cannot_hold_the_default_height():
    """The reference's defaults (height 17, capacity 13) fail at compile:
    the height-17 circuit has 17,158 gates and needs a domain of 2^15; a
    capacity of 15 holds it.  The card compiles it at capacity 15."""
    circuit = pbatch.OpeningCircuit.default_for_height(17)
    assert circuit.size() == 17158
    with pytest.raises(TruncatedDegreeTooLarge):
        Compiler.compile_with_circuit(_pp(pbatch.DEFAULT_CAPACITY),
                                      b"opening-circuit", circuit)
    ck, _ = _pp(15).trim(1 << 15)
    blinding = PublicParameters.ADDED_BLINDING_DEGREE
    assert ck.max_degree() == (1 << 15) + blinding


def test_opening_circuit_size_is_witness_independent():
    c1 = pbatch.OpeningCircuit.default_for_height(2)
    tree = PoseidonTree(2)
    for i in range(5):
        tree.insert(i, Item(Fr(i + 50), None))
    c2 = pbatch.OpeningCircuit(tree.opening(3), Item(Fr(53), None))
    assert c1.size() == c2.size() > 0
    assert c1.size() == rbatch.OpeningCircuit.default_for_height(2).size()


@pytest.mark.parametrize("command", ["batch", "prove"])
def test_cli_device_flag(command):
    parser = pcli.build_parser()
    assert parser.parse_args([command]).device == "cuda"
    args = parser.parse_args([command, "--device", "cpu", "--capacity", "15",
                              "--height", "17"])
    assert (args.device, args.capacity, args.height) == ("cpu", 15, 17)


# -- the service on a cache that zkvm_tpu wrote ------------------------------

@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """zkvm_tpu's compile of the height-1 opening circuit at capacity 10
    under StdRng(42), written as the service's cache and verifier files."""
    d = tmp_path_factory.mktemp("cache")
    pp = RPublicParameters.setup(1 << 10, RStdRng(42))
    prover, verifier = RCompiler.compile_with_circuit(
        pp, b"opening-circuit", rbatch.OpeningCircuit.default_for_height(1))
    (d / "circuit_prove.bin").write_bytes(
        rformats.prover_cache_to_bytes(10, prover.to_bytes()))
    (d / "verifier.bin").write_bytes(verifier.to_bytes())
    return d


def _write_input(path, bad: bool) -> None:
    """Leaves of a height-1 tree.  `bad`: four, each bad in one of the four
    ways the service skips, in its order: a non-canonical leaf hash, an
    opening that does not parse, an opening of another tree (its root
    differs), a leaf that is not the opened one.  Else one good leaf."""
    tree, other = RPoseidonTree(1), RPoseidonTree(1)
    for i in range(3):
        tree.insert(i, RItem(RFr(1000 + i), None))
        other.insert(i, RItem(RFr(2000 + i), None))
    good = tree.opening(1).to_var_bytes()
    infos = [
        rformats.LeafInfo(0, b"\xff" * 32, good),
        rformats.LeafInfo(1, RFr(1001).to_bytes(), good[:-5]),
        rformats.LeafInfo(1, RFr(2001).to_bytes(),
                          other.opening(1).to_var_bytes()),
        rformats.LeafInfo(1, RFr(4242).to_bytes(), good),
    ] if bad else [rformats.LeafInfo(1, RFr(1001).to_bytes(), good)]
    path.write_bytes(rformats.MultipleLeavesData(
        tree.root().hash.to_bytes(), infos).to_rkyv_bytes())


def _config(cache, tmp_path, bad: bool, **kw) -> pbatch.BatchProofConfig:
    _write_input(tmp_path / "merkle_some.bin", bad)
    return pbatch.BatchProofConfig(
        merkle_input_file=str(tmp_path / "merkle_some.bin"),
        circuit_cache_file=str(cache / "circuit_prove.bin"),
        verifier_file=str(cache / "verifier.bin"),
        output_dir=str(tmp_path / "out"), capacity=10, tree_height=1, **kw)


def test_every_bad_leaf_is_skipped(cache, tmp_path, caplog):
    config = _config(cache, tmp_path, bad=True, device="cpu")
    with caplog.at_level("WARNING", logger="zkvm_tpu_torch.service"):
        assert pbatch.process_batch_proofs_with_config(config) == 0
    assert list((tmp_path / "out").iterdir()) == []
    messages = [r.getMessage() for r in caplog.records]
    assert len(messages) == 4
    assert messages[0] == "leaf 0: bad leaf hash, skipping"
    assert messages[1].startswith("leaf 1: bad opening (bad length")
    assert messages[2:] == ["leaf 2: root mismatch, skipping",
                            "leaf 3: not in tree, skipping"]


def test_cache_crosses_both_ways(cache, tmp_path):
    """zkvm_tpu's cache loads into the port's service; the port writes it
    back in its own format, and zkvm_tpu's service loads that into the
    same prover and verifier bytes."""
    config = _config(cache, tmp_path, bad=True, device="cpu")
    prover, verifier = pbatch.load_or_compile_opening_circuit(config)
    cap, want = rformats.prover_cache_from_bytes(
        (cache / "circuit_prove.bin").read_bytes())
    assert cap == 10 and prover.to_bytes() == want
    (tmp_path / "circuit_prove.bin").write_bytes(
        pformats.prover_cache_to_bytes(10, prover.to_bytes()))
    (tmp_path / "verifier.bin").write_bytes(verifier.to_bytes())
    rprover, rverifier = rbatch.load_or_compile_opening_circuit(
        rbatch.BatchProofConfig(
            circuit_cache_file=str(tmp_path / "circuit_prove.bin"),
            verifier_file=str(tmp_path / "verifier.bin"), capacity=10,
            tree_height=1))
    assert rprover.to_bytes() == want
    assert rverifier.to_bytes() == (cache / "verifier.bin").read_bytes()


@pytest.mark.parametrize("entry", ["config", "cli"])
def test_cuda_without_a_card_raises(cache, tmp_path, entry):
    """A good leaf under the default device, "cuda": the service loads the
    cache and raises at the prove; it writes no file and proves nothing on
    the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = _config(cache, tmp_path, bad=False)
    assert config.device == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        if entry == "config":
            pbatch.process_batch_proofs_with_config(config)
        else:
            pcli.main(["batch", "--input", config.merkle_input_file,
                       "--circuit-cache", config.circuit_cache_file,
                       "--verifier-file", config.verifier_file,
                       "--out", config.output_dir, "--capacity", "10",
                       "--height", "1"])
    assert list((tmp_path / "out").iterdir()) == []
