"""prove_unspanned_ms: per proof finished in the measured window, its
`Prover.prove` call on the harness's clock less the program's top-level
prover spans (keys `prove/<x>`, no further `/`), in ms: the prover's host
time that no span of the program covers.  A collection outside every span
(`prove/gc` alone) is left out of the sum, since the service's steps
around the prover, which are not the prover's time, see collections too.
Named by rule beside `proof_device_ms`; the time it finds moves
`proof_rate`."""


def read(w):
    done = [r for r in w.records if r["error"] is None]
    top = [s for k, (s, _) in w.spans.items()
           if k.startswith("prove/") and k.count("/") == 1
           and k != "prove/gc"]
    if not done or not top:
        return None
    return 1e3 * (sum(r["prove"] for r in done) - sum(top)) / len(done)
