"""poseidon_gadget_ms: the in-circuit Poseidon permutations of witness
synthesis (span `prove/poseidon_gadget`, one a tree level), summed over
every nesting, per proof of the measured window, in ms; the composer's own
share of synthesis is `witness_synthesis_ms` less this.  Named by rule
beside `proof_device_ms`; the time is the host's and moves `proof_rate`."""

SPAN = "prove/poseidon_gadget"


def read(w):
    s = [t for k, (t, _) in w.spans.items()
         if k == SPAN or k.endswith("/" + SPAN)]
    if not s or not w.records:
        return None
    return 1e3 * sum(s) / len(w.records)
