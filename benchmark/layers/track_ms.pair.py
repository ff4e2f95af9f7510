"""Mean ms a call in the program's ``track`` stage (StageClock)."""
from benchmark import readings


def read(rec):
    return readings.stage_ms(rec, "pair", "track")
