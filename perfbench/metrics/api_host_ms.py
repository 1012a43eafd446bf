"""api_host_ms: the mean host self time of the traced estimates' ``solve``
spans: each one's duration less its children's (the sketch, the loop's
set-up and the loop, the objective), so the registry's checks and the
solver's own steps."""
from perfbench.metrics._window import spans_in


def read(rec):
    got = spans_in(rec)
    children: dict[int, float] = {}
    for s in got:
        children[s.parent] = children.get(s.parent, 0.0) + (s.end - s.start)
    own = [(s.end - s.start) - children.get(s.id, 0.0) for s in got if s.name == "solve"]
    return sum(own) / len(own) * 1e3 if own else None
