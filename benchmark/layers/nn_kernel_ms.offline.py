"""Device ms a call in the NN kernel (masked_nn_kernel, nn_finish_kernel),
from the profiled calls, summed over the sample's frame pairs."""
from benchmark import readings


def read(rec):
    prof = readings.profile(rec, "offline")
    return None if prof is None else prof["nn_kernel_s"] * 1e3 / prof["calls"]
