"""Host ms a substep inside world.update and covered by no span other
than substep, over the spans window (perfbench/spans.py): the integrator
and the Python around the stages (direct: around k1.launch; P3M: outside
every p3m.* stage)."""

from perfbench import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None or not any(s.name == spans.UPDATE for s in rec["spans"]):
        return None
    return spans.per_substep_ms(rec, spans.loop_self_ns(rec["spans"]))
