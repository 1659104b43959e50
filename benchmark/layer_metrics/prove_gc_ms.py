"""prove_gc_ms: the program's garbage-collection pauses (span `prove/gc`,
opened by its `gc.callbacks` hook in whatever span a pause interrupts)
summed over every nesting, per proof of the measured window, in ms.  Named
by rule beside `proof_device_ms`; the pauses are host time and move
`proof_rate`."""

SPAN = "prove/gc"


def read(w):
    s = [t for k, (t, _) in w.spans.items()
         if k == SPAN or k.endswith("/" + SPAN)]
    if not s or not w.records:
        return None
    return 1e3 * sum(s) / len(w.records)
