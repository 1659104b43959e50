"""zkvm_tpu_torch runs without JAX and without zkvm_tpu, and hides no
device fallback.

The port imports nothing of `jax` and nothing of `zkvm_tpu` (it keeps its
own copy of the host layer); a subprocess with both blocked runs a tiny
setup and commit and a tree build of height 1, and must print the
reference's commitment bytes and root bytes.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zkvm_tpu.fields import Fr
from zkvm_tpu.merkle import PoseidonTree as RPoseidonTree
from zkvm_tpu.plonk import kzg10 as rkzg
from zkvm_tpu.plonk.polynomial import Polynomial
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
assert not any(m.split(".")[0] in ("jax", "zkvm_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print(c.to_bytes().hex())
print(tree.root().to_bytes().hex())
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
    assert out.stdout.split() == [ref.to_bytes().hex(),
                                  root.to_bytes().hex()]


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
