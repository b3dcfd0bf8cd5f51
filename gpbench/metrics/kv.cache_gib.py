"""torch.cuda.memory_allocated after the batcher is built minus before:
the decode cache the traffic needs (slots x the schedule's length)."""
KIND, UNIT = "per_layer", "GiB"


def read(run):
    return None if run.kv_bytes is None else run.kv_bytes / 2 ** 30
