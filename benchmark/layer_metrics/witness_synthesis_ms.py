"""witness_synthesis_ms: the program's span `prove/witness_synthesis` (the
composer re-synthesising the circuit's witness on the host), per proof of
the measured window."""


def read(w):
    s = w.span_mean_s("prove/witness_synthesis")
    return None if s is None else 1e3 * s
