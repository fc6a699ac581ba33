"""The query view's conv FLOPs (every excerpt or window of every query) at
the float32 peak over the device time of the conv kernels, in %."""

from port_bench import layer


def read(run):
    return layer.conv_roofline(run, "excerpts")
