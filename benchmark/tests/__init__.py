"""CPU tests of the benchmark (the contract, the readers, the reference, the faults)."""
