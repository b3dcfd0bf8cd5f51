"""Mean over the window's requests of the host clock around each pruned
prefill, ended by torch.cuda.synchronize() (the traced run's spans)."""
KIND, UNIT = "per_layer", "ms"


def read(run):
    spans = [s for e in run.episodes for s in e.spans]
    return 1e3 * sum(spans) / len(spans) if spans else None
