"""The window's work at the card's published peaks over the window's
seconds, in percent: every pruned prefill (ViT, the layers to the reduce
layer over all tokens, the fuser, the layers after it over the kept
tokens; int8 products at the int8 peak where the tier runs them so) and
every decode step over its valid context."""
from gpbench.harness import window_flops_time

KIND, UNIT = "per_layer", "%"


def read(run):
    t = window_flops_time(run)
    return None if t is None or not run.window_s else 100.0 * t / run.window_s
