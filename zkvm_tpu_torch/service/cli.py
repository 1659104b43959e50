"""CLI for the batch Merkle-membership proving service.

Equivalent of the reference binaries `merkle_proof` / `batch_merkle_proof`
(merkle-plonk/Cargo.toml:37-44), plus a `make-input` helper that builds a
tree from leaf values and emits the rkyv-format input file the Rust pipeline
would normally produce.  `batch` and `prove` run on `--device` (default
`cuda`); `make-input` and `verify` are host work.

  python -m zkvm_tpu_torch.service.cli make-input --leaves 32 --height 17 \\
      --out merkle_some.bin
  python -m zkvm_tpu_torch.service.cli batch --input merkle_some.bin \\
      --out ./proofs --capacity 15 --height 17 --device cuda
  python -m zkvm_tpu_torch.service.cli verify --proof plonk_proof_1.bin \\
      --public-inputs plonk_publicinputs_1.bin --verifier verifier.bin
"""

from __future__ import annotations

import argparse
import logging
import sys
import tempfile

from ..fields import Fr
from ..merkle import Item
from ..merkle.poseidon_tree import PoseidonTree
from ..plonk import Proof, Verifier
from .batch import BatchProofConfig, process_batch_proofs_with_config
from .formats import LeafInfo, MultipleLeavesData, ZKProofData


def _add_batch_args(p: argparse.ArgumentParser):
    d = BatchProofConfig()
    p.add_argument("--input", default=d.merkle_input_file,
                   help="rkyv MultipleLeavesData input file")
    p.add_argument("--circuit-cache", default=d.circuit_cache_file)
    p.add_argument("--verifier-file", default=d.verifier_file)
    p.add_argument("--out", default=d.output_dir, help="output directory")
    p.add_argument("--proof-prefix", default=d.proof_file_prefix)
    p.add_argument("--pi-prefix", default=d.public_inputs_file_prefix)
    p.add_argument("--capacity", type=int, default=d.capacity,
                   help="log2 SRS capacity")
    p.add_argument("--height", type=int, default=d.tree_height,
                   help="merkle tree height")
    p.add_argument("--device", default=d.device,
                   help="torch device that compiles and proves")


def cmd_batch(args) -> int:
    config = BatchProofConfig(
        merkle_input_file=args.input,
        circuit_cache_file=args.circuit_cache,
        verifier_file=args.verifier_file,
        output_dir=args.out,
        proof_file_prefix=args.proof_prefix,
        public_inputs_file_prefix=args.pi_prefix,
        capacity=args.capacity,
        tree_height=args.height,
        device=args.device)
    proven = process_batch_proofs_with_config(config)
    print(f"proved {proven} leaves")
    return 0 if proven else 1


def cmd_make_input(args) -> int:
    height = args.height
    tree = PoseidonTree(height)
    leaves = [Fr(1000 + i) for i in range(args.leaves)]
    for i, leaf in enumerate(leaves):
        tree.insert(i, Item(leaf, None))
    infos = []
    for i, leaf in enumerate(leaves):
        opening = tree.opening(i)
        infos.append(LeafInfo(position=i, leaf_hash=leaf.to_bytes(),
                              proof_bytes=opening.to_var_bytes()))
    data = MultipleLeavesData(root_hash=tree.root().hash.to_bytes(),
                              leaves_info=infos)
    with open(args.out, "wb") as f:
        f.write(data.to_rkyv_bytes())
    print(f"wrote {args.leaves} leaves (height {height}) to {args.out}")
    return 0


def cmd_prove(args) -> int:
    """Single-leaf proof (the reference's `merkle_proof` binary,
    merkle-plonk/src/main.rs): proves the FIRST leaf of the input file."""
    config = BatchProofConfig(
        merkle_input_file=args.input,
        circuit_cache_file=args.circuit_cache,
        verifier_file=args.verifier_file,
        output_dir=args.out,
        capacity=args.capacity,
        tree_height=args.height,
        device=args.device)
    with open(config.merkle_input_file, "rb") as f:
        data = MultipleLeavesData.from_rkyv_bytes(f.read())
    data.leaves_info = data.leaves_info[:1]
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as tmp:
        tmp.write(data.to_rkyv_bytes())
        config.merkle_input_file = tmp.name
    proven = process_batch_proofs_with_config(config)
    print("proof generated" if proven else "no valid leaf")
    return 0 if proven else 1


def cmd_verify(args) -> int:
    with open(args.verifier, "rb") as f:
        verifier = Verifier.try_from_bytes(f.read())
    with open(args.proof, "rb") as f:
        proof_blob = ZKProofData.from_rkyv_bytes(f.read()).data
    with open(args.public_inputs, "rb") as f:
        pi_blob = ZKProofData.from_rkyv_bytes(f.read()).data
    proof = Proof.from_bytes(proof_blob)
    if proof is None:
        print("invalid proof encoding")
        return 1
    pis = [Fr.from_bytes(pi_blob[i: i + 32])
           for i in range(0, len(pi_blob), 32)]
    try:
        verifier.verify(proof, pis)
    except Exception as err:
        print(f"verification FAILED: {err}")
        return 1
    print("verification OK")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="zkvm-tpu-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p_batch = sub.add_parser("batch",
                             help="batch-prove merkle memberships")
    _add_batch_args(p_batch)
    p_batch.set_defaults(fn=cmd_batch)

    p_make = sub.add_parser("make-input",
                            help="generate a test input file")
    p_make.add_argument("--leaves", type=int, default=4)
    p_make.add_argument("--height", type=int, default=3)
    p_make.add_argument("--out", default="merkle_some.bin")
    p_make.set_defaults(fn=cmd_make_input)

    p_prove = sub.add_parser("prove",
                             help="prove a single leaf (merkle_proof parity)")
    _add_batch_args(p_prove)
    p_prove.set_defaults(fn=cmd_prove)

    p_verify = sub.add_parser("verify", help="verify a stored proof")
    p_verify.add_argument("--proof", required=True)
    p_verify.add_argument("--public-inputs", required=True)
    p_verify.add_argument("--verifier", required=True)
    p_verify.set_defaults(fn=cmd_verify)
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
