"""zkvm_tpu_torch runs without JAX and without zkvm_tpu, and hides no
device fallback.

The port imports nothing of `jax` and nothing of `zkvm_tpu` (it keeps its
own copy of the host layer); a subprocess with both blocked runs a tiny
setup and commit, a tree build of height 1 and the gate-1 prove of the
fixture circuit from the committed prover bundle, and must print the
reference's commitment bytes, root bytes and proof bytes.
"""

import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import pytest
import torch

from zkvm_tpu.fields import Fr
from zkvm_tpu.merkle import PoseidonTree as RPoseidonTree
from zkvm_tpu.plonk import kzg10 as rkzg
from zkvm_tpu.plonk.polynomial import Polynomial
from zkvm_tpu.plonk.prover import Prover as RProver
from zkvm_tpu.rng import StdRng
from zkvm_tpu_torch.fields import Fr as PFr
from zkvm_tpu_torch.merkle import PoseidonTree
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.ops.limb_field import FR
from zkvm_tpu_torch.plonk import kzg10
from zkvm_tpu_torch.rng import StdRng as PStdRng

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    p for p in (ROOT / "zkvm_tpu_torch").rglob("*.py")
    if "build" not in p.relative_to(ROOT).parts) + [ROOT / "chip_smoke.py"]

_SLICE = """
import sys
sys.modules["jax"] = None
sys.modules["zkvm_tpu"] = None
import torch
torch.set_num_threads(1)
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.rng import StdRng
from zkvm_tpu_torch.plonk.kzg10 import PublicParameters
pp = PublicParameters.setup(4, StdRng(3), "cpu")
c = pp.commit_key.commit([Fr(i + 1) for i in range(5)])
from zkvm_tpu_torch.merkle import Item, PoseidonTree
leaves = [Fr(7 * i + 3) for i in range(4)]
tree = PoseidonTree.from_leaves(1, leaves, "cpu")
assert tree.opening(2).verify(Item(leaves[2]))
from zkvm_tpu_torch.plonk import Constraint, Prover
from zkvm_tpu_torch.plonk.composer import Circuit


class FixedCircuit(Circuit):
    def circuit(self, c):
        a = c.append_witness(Fr(3))
        b = c.append_witness(Fr(5))
        o = c.gate_add(Constraint().left(1).right(1).a(a).b(b))
        c.assert_equal_constant(o, Fr(8), None)
        x = c.gate_mul(Constraint().mult(1).a(a).b(b))
        c.assert_equal_constant(x, Fr(15), None)
        c.component_boolean(c.append_witness(Fr(1)))


with open("tests/fixtures/prover_bundle_v1.bin", "rb") as f:
    prover = Prover.try_from_bytes(f.read(), "cpu")
proof, _ = prover.prove(StdRng(5), FixedCircuit())
assert not any(m.split(".")[0] in ("jax", "zkvm_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print(c.to_bytes().hex())
print(tree.root().to_bytes().hex())
print(proof.to_bytes().hex())
"""


def test_slice_runs_with_jax_blocked():
    """`jax` and `zkvm_tpu` are both blocked in the subprocess."""
    out = subprocess.run([sys.executable, "-c", _SLICE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ref = rkzg.PublicParameters.setup(4, StdRng(3)).commit_key.commit(
        Polynomial([Fr(i + 1) for i in range(5)]))
    root = RPoseidonTree.from_leaves(
        1, [Fr(7 * i + 3) for i in range(4)]).root()
    from test_fixtures import FixedCircuit

    pb = (ROOT / "tests" / "fixtures" / "prover_bundle_v1.bin").read_bytes()
    proof, _ = RProver.try_from_bytes(pb).prove(StdRng(5), FixedCircuit())
    assert out.stdout.split() == [ref.to_bytes().hex(),
                                  root.to_bytes().hex(),
                                  proof.to_bytes().hex()]


_SERVICE = """
import sys
sys.modules["jax"] = None
sys.modules["zkvm_tpu"] = None
import os
from zkvm_tpu_torch.service import cli
from zkvm_tpu_torch.service.formats import (MultipleLeavesData, ZKProofData,
                                            prover_cache_from_bytes,
                                            prover_cache_to_bytes)
from zkvm_tpu_torch.plonk import debugger
from zkvm_tpu_torch.utils import benches
out = sys.argv[1]
assert cli.main(["make-input", "--leaves", "3", "--height", "2",
                 "--out", out]) == 0
blob = open(out, "rb").read()
assert MultipleLeavesData.from_rkyv_bytes(blob).to_rkyv_bytes() == blob
assert ZKProofData.from_rkyv_bytes(ZKProofData(blob).to_rkyv_bytes()).data == blob
assert prover_cache_from_bytes(prover_cache_to_bytes(15, blob)) == (15, blob)
assert not any(m.split(".")[0] in ("jax", "zkvm_tpu") for m in sys.modules
               if sys.modules[m] is not None)
"""


def test_service_runs_with_jax_blocked(tmp_path):
    """The port's make-input, formats, debugger and benches import with
    `jax` and `zkvm_tpu` both blocked, and make-input writes the
    reference's bytes."""
    import zkvm_tpu.service.cli as rcli

    out = tmp_path / "port.bin"
    run = subprocess.run([sys.executable, "-c", _SERVICE, str(out)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr
    assert rcli.main(["make-input", "--leaves", "3", "--height", "2",
                      "--out", str(tmp_path / "ref.bin")]) == 0
    assert out.read_bytes() == (tmp_path / "ref.bin").read_bytes()


_MESH = """
import sys
sys.modules["jax"] = None
sys.modules["zkvm_tpu"] = None
import torch
torch.set_num_threads(1)
from zkvm_tpu_torch.ops.collective import Mesh, sharded_scan_mul
from zkvm_tpu_torch.ops.limb_field import FR
from zkvm_tpu_torch.plonk import dpoly
x = FR.to_mont_array([3 * i + 1 for i in range(16)], "cpu")
got = sharded_scan_mul(x, Mesh(["cpu", "cpu"]))
assert torch.equal(got, dpoly.prefix_products(x))
assert not any(m.split(".")[0] in ("jax", "zkvm_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print(FR.from_mont_array(got[:, -1:])[0])
"""


def test_mesh_scan_runs_with_jax_blocked():
    """A 2-shard `sharded_scan_mul` with `jax` and `zkvm_tpu` blocked; its
    last element is the product of the 16 values."""
    out = subprocess.run([sys.executable, "-c", _MESH], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = 1
    for i in range(16):
        want = want * (3 * i + 1) % Fr.MODULUS
    assert out.stdout.split() == [str(want)]


def test_the_grep_covers_the_mesh_modules():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"zkvm_tpu_torch/ops/collective.py",
            "zkvm_tpu_torch/ops/ntt_sharded.py",
            "zkvm_tpu_torch/utils/dryrun.py", "chip_smoke.py"} <= names


_ENTRY = """
import sys
sys.modules["jax"] = None
sys.modules["zkvm_tpu"] = None
import torch
torch.set_num_threads(1)
from zkvm_tpu_torch import bench
from zkvm_tpu_torch.curves.g1 import G1Affine
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops.msm import msm_device
from zkvm_tpu_torch.tools import (bench_msm_cwidth, bench_msm_r3,
                                  bench_ntt_r3, bench_padd,
                                  gen_dryrun_fixture, gen_native_frob,
                                  gen_poseidon_constants)
from zkvm_tpu_torch.utils import trace_to
from zkvm_tpu_torch.utils.dryrun import load_fixture, write_fixture
write_fixture(*load_fixture(), sys.argv[1])
g = G1Affine.generator()
assert msm_device([g, g, g], [Fr(2), Fr(3)], "cpu") == g.to_projective() * 5
assert not any(m.split(".")[0] in ("jax", "zkvm_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("\\n".join(gen_native_frob.lines()))
"""


def test_entry_and_tools_run_with_jax_blocked(tmp_path):
    """The benchmark entry, `trace_to`, `msm_device`, `write_fixture` and
    every tool of this round import with `jax` and `zkvm_tpu` both
    blocked; the fixture written equals the committed one and the
    Frobenius lines equal the reference tool's."""
    out = tmp_path / "fixture.bin"
    run = subprocess.run([sys.executable, "-c", _ENTRY, str(out)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    fixture = ROOT / "tests" / "fixtures" / "dryrun_proof_v1.bin"
    assert out.read_bytes() == fixture.read_bytes()
    ref = subprocess.run([sys.executable, "tools/gen_native_frob.py"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    assert run.stdout == ref.stdout


def test_the_grep_covers_the_entry_and_the_tools():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {f"zkvm_tpu_torch/{name}.py" for name in (
        "bench", "tools/bench_msm_cwidth", "tools/bench_msm_r3",
        "tools/bench_ntt_r3", "tools/bench_padd", "tools/gen_dryrun_fixture",
        "tools/gen_native_frob", "tools/gen_poseidon_constants")} <= names


def test_the_kernel_sources_are_the_built_ones():
    """Every CUDA source of the port is one the library is built from (and
    includes no header but the port's own and the toolkit's)."""
    csrc = ROOT / "zkvm_tpu_torch" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted(
        kernels._SOURCES)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == sorted(
        kernels._HEADERS)
    for path in csrc.iterdir():
        for inc in re.findall(r'^#include [<"]([^>"]+)[>"]', path.read_text(),
                              re.M):
            assert inc in kernels._HEADERS or inc in ("cstdint",
                                                      "cuda_runtime.h"), (
                path.name, inc)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_source_imports_no_jax(path):
    text = path.read_text()
    # the word boundary lets `zkvm_tpu_torch` itself through
    assert not re.search(r"^\s*(import|from)\s+(jax|zkvm_tpu)\b", text, re.M)


def test_cuda_request_without_cuda_raises():
    """Asking for the card where there is none fails; nothing runs on the
    CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        kzg10.PublicParameters.setup(2, PStdRng(1), "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        PoseidonTree.from_leaves(1, [PFr(i) for i in range(4)], "cuda")
    from zkvm_tpu_torch.ops.collective import Mesh

    with pytest.raises((RuntimeError, AssertionError)):
        Mesh(["cuda", "cuda"])
    from test_torch_plonk_host import FixedCircuit
    from zkvm_tpu_torch.plonk import Prover

    pb = (ROOT / "tests" / "fixtures" / "prover_bundle_v1.bin").read_bytes()
    prover = Prover.try_from_bytes(pb, "cuda")
    assert prover.device == torch.device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        prover.prove(PStdRng(5), FixedCircuit())


def test_kernel_wrappers_refuse_other_devices_and_layouts():
    meta = torch.zeros((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.mont_mul(FR, meta, meta)
    cpu = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.mont_mul(FR, cpu.to(torch.int64), cpu.to(torch.int64))
    # every second lane is read in place; leading axes that do not collapse
    # into one are not, and the power chain takes contiguous operands only
    strided = torch.zeros((8, 8), dtype=torch.int32)[:, ::2]
    assert kernels.mont_mul(FR, strided, strided).shape == (8, 4)
    wide = torch.zeros((3, 4, 8, 6), dtype=torch.int32)[:, :3]
    with pytest.raises(ValueError, match="cannot be read in place"):
        kernels.mont_mul(FR, wide, wide)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.mont_pow(FR, strided, 3)
