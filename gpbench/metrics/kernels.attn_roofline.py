"""The attention kernels K1 and K2 over the traced prefills: the sum of
each call's bound (gpbench.flops, from the shapes the requests need) over
the device time of the kernels named in their CUDA sources, in percent."""
from gpbench.harness import attention_roofline

KIND, UNIT = "per_layer", "%"


def read(run):
    return attention_roofline(run)
