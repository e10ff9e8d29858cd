"""Stage evaluation: wall time inside ``fused_stage_eval`` (as
serve/service.py calls it) over the queries the window solved
(``last_batch.n_solved`` of each flush)."""
NAME, UNIT = "stage_eval_ms_per_solve.steady", "ms"


def read(rec):
    solved = sum(sp.info["n_solved"] for sp in rec.spans["tune_batch"])
    if not solved:
        return None
    return sum(sp.wall for sp in rec.spans["stage_eval"]) / solved * 1e3
