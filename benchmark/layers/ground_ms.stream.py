"""Mean ms a frame in the program's ``ground`` stage (StageClock)."""
from benchmark import readings


def read(rec):
    return readings.stage_ms(rec, "stream", "ground")
