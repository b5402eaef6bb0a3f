"""Binning's host time a frame, in ms: the program's ``Bin`` spans
(``raster_cuda.build_work_list``, its sync included), over the traced
loop's frames."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "Bin")
