"""jubjub_gadget_ms: the circuit's JubJub scalar multiplications in
witness synthesis (spans `prove/jubjub_fixed_base` and
`prove/jubjub_variable_base`, one a multiplication), summed over every
nesting, per proof of the measured window, in ms.  Named by rule beside
`proof_device_ms`; the time is the host's and moves `proof_rate`."""

SPANS = ("prove/jubjub_fixed_base", "prove/jubjub_variable_base")


def read(w):
    s = [t for k, (t, _) in w.spans.items()
         if any(k == n or k.endswith("/" + n) for n in SPANS)]
    if not s or not w.records:
        return None
    return 1e3 * sum(s) / len(w.records)
