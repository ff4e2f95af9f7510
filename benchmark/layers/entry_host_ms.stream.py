"""Mean ms a call spends outside the program's stages (the entry's
padding, host copies and bookkeeping): host clock less StageClock."""
from benchmark import readings


def read(rec):
    return readings.host_ms(rec, "stream")
