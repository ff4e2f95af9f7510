"""Mean ms a call in the program's ``load`` stage (StageClock): the
sample's npz read back and decoded, cropped, its GT flow built."""
from benchmark import readings


def read(rec):
    return readings.stage_ms(rec, "offline", "load")
