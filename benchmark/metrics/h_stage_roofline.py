"""h_stage_roofline: the h stage's least time on the card (work/h_stage.py,
from the matrices' nonzeros, the domain and the witness's length, against
the peaks of peaks.json) over its measured time, for the window's untraced
steps. Says whether operations or bytes bound it."""

from benchmark.metrics import roofline


def read(rec):
    return roofline.share(rec, "h_stage", "h_s")
