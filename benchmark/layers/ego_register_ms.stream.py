"""Mean host ms a frame in the odometry's registrations (span
``icpflow.ego.register``, four a frame)."""
from benchmark import program_spans


def read(rec):
    return program_spans.span_ms(rec, "stream", "icpflow.ego.register")
