"""(window - the prefill spans) / decode steps, in ms: the time of a
decode step with admissions and the host's bookkeeping in it."""
KIND, UNIT = "per_layer", "ms"


def read(run):
    spans = [s for e in run.episodes for s in e.spans]
    steps = sum(e.steps for e in run.episodes)
    if not spans or not steps:
        return None
    return 1e3 * (run.window_s - sum(spans)) / steps
