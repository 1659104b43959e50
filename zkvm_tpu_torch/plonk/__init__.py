"""PLONK layer of the port: so far the KZG10 commitment scheme."""
