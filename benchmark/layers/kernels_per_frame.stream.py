"""Device kernels a stream frame launches, from the profiled calls."""
from benchmark import readings


def read(rec):
    prof = readings.profile(rec, "stream")
    return None if prof is None else prof["kernels"] / prof["calls"]
