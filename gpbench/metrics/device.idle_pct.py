"""1 - the union of the device's kernel and copy intervals over the traced
window, in percent."""
KIND, UNIT = "per_layer", "%"


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
