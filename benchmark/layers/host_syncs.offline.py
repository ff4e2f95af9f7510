"""Mean synchronizing CUDA calls a call, all spans (counter
``host_syncs``), summed over the sample's frame pairs and its preparation."""
from benchmark import program_spans


def read(rec):
    return program_spans.host_syncs(rec, "offline")
