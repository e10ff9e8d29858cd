"""Performance model: the least time the H100 could take for the GTN
embeddings and MLP-head rows of the window's ``embed_many`` and
``predict_rows`` calls (float32 peak or HBM bytes, whichever bounds; each
graph at its own operator count and rows as given, padding not counted)
over the calls' wall time.  Each call returns host numpy, so its span
holds its device work."""
from portbench.harness.peaks import gtn_bound_s, head_bound_s

NAME, UNIT = "perf_model_roofline_share.steady", "%"


def read(rec):
    emb, head = rec.spans["embed_many"], rec.spans["predict_rows"]
    wall = sum(sp.wall for sp in emb) + sum(sp.wall for sp in head)
    bound = sum(gtn_bound_s(sp.info["nodes"], rec.widths) for sp in emb
                if sp.info["nodes"]) \
        + sum(head_bound_s(sp.info["rows"], rec.widths) for sp in head
              if sp.info["rows"])
    return 100.0 * bound / wall if wall > 0 and bound > 0 else None
