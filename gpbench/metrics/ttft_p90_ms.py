"""90th percentile over the window's measured requests (each episode's
ramp left out) of the first token's host time minus the request's send
time."""
KIND, UNIT = "end_to_end", "ms"


def read(run):
    return run.window_numbers().get("ttft_p90_ms")
