"""The benchmark's harness: the run (`core`), the closed loops that drive
the program (`proofs`, `commits`), the traced window (`trace`) and the
roofline arithmetic (`roofline`)."""
