"""sharded_solve_s: solve_s in the four-card cell, whose host-bound solves
(one Python thread issuing every card's operations) follow the host's speed
far more than one card's deflated solves do; its own bound, set from its
spreads. The reader is solve_s's."""
from tkbench.harness import load_metric

_base = load_metric("solve_s")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
