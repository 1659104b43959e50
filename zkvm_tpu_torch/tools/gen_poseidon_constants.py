"""Generate `zkvm_tpu_torch/hashes/poseidon_constants.py` from the Hades
asset blobs.

The port's copy of `tools/gen_poseidon_constants.py`.  The Dusk Hades round
constants (68 rounds x width 5) and the 5 x 5 MDS matrix are published
protocol parameters, required verbatim for interoperability: the reference
loads them from `assets/arc.bin` and `assets/mds.bin` of its coset-poseidon
crate as canonical little-endian 4 x u64 values (coset-poseidon/src/hades/
round_constants.rs:11-35, mds_matrix.rs:8-31).  Give the directory that
holds those two files; nothing is fetched.

    python3 -m zkvm_tpu_torch.tools.gen_poseidon_constants ASSETS_DIR \\
        [--out PATH]
"""

from __future__ import annotations

import argparse
from pathlib import Path

ROUNDS, WIDTH = 68, 5
TARGET = Path(__file__).resolve().parent.parent / "hashes" / \
    "poseidon_constants.py"


def read_scalars(path: Path) -> list[int]:
    data = path.read_bytes()
    if len(data) % 32:
        raise ValueError(f"{path}: {len(data)} bytes is not a whole number "
                         f"of 32-byte scalars")
    return [int.from_bytes(data[i: i + 32], "little")
            for i in range(0, len(data), 32)]


def render(arc: list[int], mds: list[int]) -> str:
    """The module's text from the round constants and the matrix."""
    out = ['"""Dusk Hades protocol parameters (width 5, 8 full + 60 partial '
           'rounds).\n\n',
           "Generated by zkvm_tpu_torch/tools/gen_poseidon_constants.py "
           "from the\n",
           "published asset blobs; values are canonical integers mod the "
           "BLS12-381\n",
           "scalar field.\n",
           '"""\n\n',
           "# 68 rounds x 5 state elements of ARC (additive round "
           "constants)\n",
           "ROUND_CONSTANTS = [\n"]
    for r in range(ROUNDS):
        out.append("    [" + ", ".join(f"0x{arc[r * WIDTH + c]:064x}"
                                       for c in range(WIDTH)) + "],\n")
    out.append("]\n\n# 5x5 MDS mixing matrix\nMDS_MATRIX = [\n")
    for i in range(WIDTH):
        out.append("    [" + ", ".join(f"0x{mds[i * WIDTH + j]:064x}"
                                       for j in range(WIDTH)) + "],\n")
    out.append("]\n")
    return "".join(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m zkvm_tpu_torch.tools.gen_poseidon_constants")
    parser.add_argument("assets", help="directory holding arc.bin, mds.bin")
    parser.add_argument("--out", default=str(TARGET))
    args = parser.parse_args(argv)
    assets = Path(args.assets)
    arc = read_scalars(assets / "arc.bin")
    mds = read_scalars(assets / "mds.bin")
    if len(arc) < ROUNDS * WIDTH or len(mds) != WIDTH * WIDTH:
        raise ValueError(f"{len(arc)} round constants (want >= "
                         f"{ROUNDS * WIDTH}), {len(mds)} MDS entries (want "
                         f"{WIDTH * WIDTH})")
    Path(args.out).write_text(render(arc, mds))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
