"""90th percentile over the window's measured requests of (completion -
first token) / (tokens - 1): the gap between output tokens as the client
sees it, stalls behind other requests' prefills included."""
KIND, UNIT = "end_to_end", "ms"


def read(run):
    return run.window_numbers().get("tpot_p90_ms")
