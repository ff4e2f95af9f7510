"""Mean ms a frame in the program's ``ego`` stage (StageClock)."""
from benchmark import readings


def read(rec):
    return readings.stage_ms(rec, "stream", "ego")
