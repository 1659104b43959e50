"""msm_host_ms: the host's pace of a commit up to its read-back, in ms per
`commit_many_mont` call of the measured window: the program's MSM stage
spans (`prove/msm/<stage>`, counted by the last span of each key, so a
pause nested in a stage is not counted twice) summed, but `host decode`,
which waits for the device.  Against `msm_device_ms`, it says whether the
host's launches or the card set a call's pace."""

PREFIX = "prove/msm/"
WAIT = "host decode"


def _stage(key: str):
    """The stage of a key whose last span is an MSM stage, else None."""
    i = key.rfind(PREFIX)
    if i < 0 or (i and key[i - 1] != "/"):
        return None
    stage = key[i + len(PREFIX):]
    return None if "/" in stage else stage


def read(w):
    s = [t for k, (t, _) in w.spans.items()
         if _stage(k) not in (None, WAIT)]
    if not s or not w.records:
        return None
    return 1e3 * sum(s) / len(w.records)
