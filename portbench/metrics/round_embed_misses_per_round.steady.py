"""Runtime scoring: embedding-memo misses (each a batch-of-one GTN pass
in ``score_requests``) counted on the window's ``round`` spans, over the
rounds."""
from portbench.harness.spans import counter, named, program_trace

NAME, UNIT = "round_embed_misses_per_round.steady", "misses"


def read(rec):
    tr = program_trace(rec)
    rounds = named(tr, "round") if tr is not None else []
    return counter(rounds, "emb_misses") / len(rounds) if rounds else None
