"""Mean cluster pairs a call that the matcher solves (counter
``match_pairs``)."""
from benchmark import program_spans


def read(rec):
    return program_spans.counter(rec, "pair", "match_pairs")
