"""Stage evaluation's host side: wall time inside the program's
``stage_eval`` spans less their ``model.predict_rows`` children (row
assembly and θ conversion, the float64 dollars), over the queries the
window's flushes solved."""
from portbench.harness.spans import named, program_trace, seconds, solved

NAME, UNIT = "stage_eval_host_ms_per_solve.steady", "ms"


def read(rec):
    tr = program_trace(rec)
    n = solved(tr) if tr is not None else 0
    if not n:
        return None
    model = [sp for sp in named(tr, "model.predict_rows")
             if sp.parent >= 0 and tr.spans[sp.parent].name == "stage_eval"]
    return (seconds(named(tr, "stage_eval")) - seconds(model)) / n * 1e3
