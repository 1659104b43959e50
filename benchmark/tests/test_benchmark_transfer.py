"""The transfer cell's loop (`harness/transfers.py`) on the CPU at the
smallest transfer (1 input, a height-1 tree: 28,192 gates, a 2^15 domain;
a few minutes here): its proofs judged by the plain reference, an altered
one rejected; and the reader `jubjub_gadget_ms` on made-up windows."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import core
from benchmark.harness.core import Window, load_reader
from benchmark.harness.transfers import Loop
from benchmark.reference import phoenix as ref_phoenix

CONFIG = dict(core.load_json(core.BENCH_DIR / "configs/transfer4x2-h17.json"),
              inputs=1, tree={"arity": 4, "height": 1}, srs_log2=15)
TRAFFIC = dict(core.load_json(core.BENCH_DIR / "traffic/transfers.json"),
               proofs=2, warmup=0)


def quick_setup(max_degree, rng, device):
    """`PublicParameters.setup` with the same draws (so the reference's
    trapdoor), its powers of g taken one by one by the native library."""
    from zkvm_tpu_torch.curves.g1 import G1Affine
    from zkvm_tpu_torch.curves.g2 import G2Affine
    from zkvm_tpu_torch.fields import Fp, Fr
    from zkvm_tpu_torch.native import native_msm
    from zkvm_tpu_torch.plonk import CommitKey, OpeningKey, PublicParameters
    from zkvm_tpu_torch.plonk.kzg10 import powers_of

    x = Fr.random(rng)
    g = (G1Affine.generator() * Fr.random(rng)).to_affine()
    powers = []
    for s in powers_of(x, max_degree + PublicParameters.ADDED_BLINDING_DEGREE):
        px, py, _ = native_msm([g], [s])
        powers.append(G1Affine(Fp(px), Fp(py)))
    h = (G2Affine.generator() * Fr.random(rng)).to_affine()
    return PublicParameters(CommitKey(powers, device),
                            OpeningKey(g, h, (h * x).to_affine()))


def test_the_loop_proves_transfers_the_reference_accepts(fast_commits,
                                                        monkeypatch):
    from zkvm_tpu_torch.plonk import PublicParameters
    from zkvm_tpu_torch.plonk.proof import Proof

    monkeypatch.setattr(PublicParameters, "setup", staticmethod(quick_setup))
    loop = Loop(CONFIG, TRAFFIC, 2_500_000_001, "cpu")
    loop.setup({})
    assert loop.pool == 2
    assert (loop.prover.size, loop.prover.constraints) == (1 << 15, 28_192)
    records = [loop.item()]
    real = Proof.to_bytes

    def to_bytes(self):
        raw = bytearray(real(self))
        raw[-32] ^= 1  # z_eval's lowest bit
        return bytes(raw)
    monkeypatch.setattr(Proof, "to_bytes", to_bytes)
    records.append(loop.item())
    assert [r["error"] for r in records] == [None, None]
    loop.release()
    checks = loop.check(records)
    assert checks == {"proofs_rejected": (1, 0), "proofs_missing": (0, 0),
                      "proofs_repeated": (0, 0)}
    t = loop.transfers[0]
    assert len(ref_phoenix.public_inputs(t)) == len(loop.layout().public) == 25


RECORDS = [{"wall": 4.0, "prove": 3.5, "error": None}] * 2
SPANS = {
    "prove/witness_synthesis": (5.0, 2),
    "prove/witness_synthesis/prove/jubjub_fixed_base": (0.5, 52),
    "prove/witness_synthesis/prove/jubjub_fixed_base/prove/gc": (0.1, 9),
    "prove/witness_synthesis/prove/jubjub_variable_base": (1.3, 28),
    "prove/witness_synthesis/prove/poseidon_gadget": (3.0, 180),
    "prove/jubjub_fixed_base": (0.2, 26),  # outside the prover: counted
}


def test_the_jubjub_reader_sums_both_spans_per_proof():
    w = Window(RECORDS, 51.0, SPANS, None)
    assert load_reader("jubjub_gadget_ms")(w) == pytest.approx(1000.0)


def test_the_jubjub_reader_reads_none_without_its_spans():
    read = load_reader("jubjub_gadget_ms")
    assert read(Window(RECORDS, 51.0, {"prove/witness_synthesis": (5.0, 2)},
                       None)) is None
    assert read(Window([], 51.0, SPANS, None)) is None
    assert read(Window(RECORDS, 51.0,
                       {"prove/jubjub_fixed_base_x": (1.0, 1)}, None)) is None


def test_the_cell_is_declared_as_the_config_says():
    bench = core.load_json(core.BENCH_DIR.parent / "BENCHMARK.json")
    cell, config, traffic = core.find_cell(bench, "transfer4x2-h17.transfers")
    assert cell["chips"] == 1 and traffic["loop"] == "transfers"
    assert core.loop_class(traffic) is Loop
    lay = ref_phoenix.transfer_layout(config["inputs"],
                                      config["tree"]["height"])
    assert len(lay.gates) == config["gates"]
    assert len(lay.public) == config["public_inputs"]
    assert (len(lay.gates) + 6 - 1).bit_length() == config["domain_log2"]
    assert json.dumps(config["reduced"]) == "[]"
