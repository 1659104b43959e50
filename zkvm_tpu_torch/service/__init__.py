"""Application/service layer (merkle-plonk crate equivalent): so far the
circuits that the service proves."""

from .batch import MultiOpeningCircuit, OpeningCircuit

__all__ = ["MultiOpeningCircuit", "OpeningCircuit"]
