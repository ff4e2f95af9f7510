"""Mean ms a call in the program's ``cluster`` stage (StageClock)."""
from benchmark import readings


def read(rec):
    return readings.stage_ms(rec, "stream", "cluster")
