"""The benchmark's plain reference: integer arithmetic in plain Python.

It imports nothing of the program.  It works out again, from the run's
seed, what the program derives at set-up (the SRS trapdoor, the circuit's
gates and copy constraints, the verifier key) and judges the program's
outputs against it:

* `srs`       the KZG setup's secret (tau) and base point, from the seed;
* `circuit`   the Merkle-opening circuit's gates, built without witness
              values, and its verifier key evaluated at tau;
* `plonk`     a PLONK verifier that checks a proof's final pairing
              equation with tau in place of the pairing;
* `merkle`    the frozen input generator: a sparse Poseidon tree, its
              openings and the service's rkyv input bytes;
* `commit`    a polynomial's KZG commitment as [p(tau)] g.
"""
