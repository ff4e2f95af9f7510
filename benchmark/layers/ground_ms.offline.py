"""Mean ms a call in the program's ``ground`` stage (StageClock): stateful
CZM ground over the sample's sweeps, one pass a sweep."""
from benchmark import readings


def read(rec):
    return readings.stage_ms(rec, "offline", "ground")
