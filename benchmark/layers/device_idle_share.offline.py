"""Share of the profiled calls' wall time in which no operation ran on the
device: 1 - union of device activity intervals / wall."""
from benchmark import readings


def read(rec):
    prof = readings.profile(rec, "offline")
    return None if prof is None else 1.0 - prof["busy_s"] / prof["window_s"]
