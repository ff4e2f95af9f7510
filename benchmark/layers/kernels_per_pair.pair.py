"""Device kernels a frame pair launches, from the profiled calls."""
from benchmark import readings


def read(rec):
    prof = readings.profile(rec, "pair")
    return None if prof is None else prof["kernels"] / prof["calls"]
