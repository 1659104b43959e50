"""service_overhead_ms: per proof, the service's steps around the prover
(opening parse and native check, `Verifier.verify`, the rkyv bytes and the
file write): each item's wall time less its `Prover.prove` call, on the
harness's clock, mean over the measured window."""


def read(w):
    done = [r for r in w.records if r["error"] is None]
    if not done:
        return None
    return 1e3 * sum(r["wall"] - r["prove"] for r in done) / len(done)
