"""msm_stage_roofline: the MSM stage's least time on the card
(work/msm_stage.py, from the domain, the queries' finite points and the
witnesses' scalars, taken from the witnesses the run kept for its check)
over its measured time, for the window's untraced steps. Says whether
operations or bytes bound it."""

from benchmark.metrics import roofline


def read(rec):
    return roofline.share(rec, "msm_stage", "msm_s")
