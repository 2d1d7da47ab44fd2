"""tables_span_ms.grad: the tables of a gradient step from the program's
spans, in ms: the summed `tables` spans of the traced steps (the split
tier's `_render_tables` in `integrator.trace_paths_counted`, once a
sample a pass, and again where remat recomputes a bounce's forward) over
the traced steps.  None without a gradient run's traced steps or without
such spans."""

from harness import readers


def read(run):
    got = readers.step_spans(run, lambda s: s.name == "tables")
    if got is None:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in got) / run.slice.renders
