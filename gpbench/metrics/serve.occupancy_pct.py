"""Tokens generated over (decode steps x slots), in percent: how full the
batcher kept its decode batch. Decode steps are the batcher's own step
counter after each episode (one captured step replayed per step)."""
KIND, UNIT = "per_layer", "%"


def read(run):
    steps = sum(e.steps for e in run.episodes)
    if not steps:
        return None
    return 100.0 * run.window_numbers()["tokens"] / (steps * run.clients)
