"""rounds_ms: the program's spans of the five rounds and the wire ingest
(`prove/wire_ingest`, `prove/round1_wires` ... `prove/round5_openings`),
per proof of the measured window.  Each round ends by reading values back
for the transcript, so a span is the round's wall time."""

SPANS = ("prove/wire_ingest", "prove/round1_wires",
         "prove/round2_permutation", "prove/round3_quotient",
         "prove/round4_evaluations", "prove/round5_openings")


def read(w):
    s = w.span_mean_s(*SPANS)
    return None if s is None else 1e3 * s
