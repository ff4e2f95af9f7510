"""Mean ms a call in the program's ``cluster`` stage (StageClock): each
frame's joint DBSCAN with frame 0, one a frame pair."""
from benchmark import readings


def read(rec):
    return readings.stage_ms(rec, "offline", "cluster")
