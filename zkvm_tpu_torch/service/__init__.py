"""Application/service layer (merkle-plonk crate equivalent)."""

from .batch import (BatchProofConfig, OpeningCircuit,
                    load_or_compile_opening_circuit, process_batch_proofs,
                    process_batch_proofs_with_config)
from .formats import LeafInfo, MultipleLeavesData, ZKProofData

__all__ = ["BatchProofConfig", "LeafInfo", "MultipleLeavesData",
           "OpeningCircuit", "ZKProofData",
           "load_or_compile_opening_circuit", "process_batch_proofs",
           "process_batch_proofs_with_config"]
