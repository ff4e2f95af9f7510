"""Mean ms a call in the program's ``track`` stage (StageClock), summed over
the sample's frame pairs."""
from benchmark import readings


def read(rec):
    return readings.stage_ms(rec, "offline", "track")
