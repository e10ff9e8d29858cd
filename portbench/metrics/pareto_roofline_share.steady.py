"""Dominance filter: the least time for the window's masks
(``pareto_masks_fast``, ``pareto_mask_fast`` as hmooc.py calls them),
bound from each bank's (n, k) shape, valid rows and survivors, over the
calls' wall time up to the masks on the host.  The same work whether K1
or numpy computes it."""
from portbench.harness.peaks import pareto_bound_s

NAME, UNIT = "pareto_roofline_share.steady", "%"


def read(rec):
    spans = rec.spans["pareto_masks"]
    wall = sum(sp.wall for sp in spans)
    bound = sum(pareto_bound_s(sp.info["banks"]) for sp in spans)
    return 100.0 * bound / wall if wall > 0 and bound > 0 else None
