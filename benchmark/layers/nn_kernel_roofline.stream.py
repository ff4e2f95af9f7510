"""Percent of its FP32 bound the NN kernel reached over the profiled calls
(counter ``nn_valid.*`` through ``nn_bound.bound_ms``, over the profile's NN
kernel time)."""
from benchmark import program_spans


def read(rec):
    return program_spans.nn_roofline(rec, "stream")
