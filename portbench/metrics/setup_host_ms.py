"""Triangle setup's host time a frame, in ms: the program's ``Setup``
spans (``raster.setup_components``, ``instance_bbox_components``, their
stacks and concatenations, ``raster_cuda.pack_setup`` and ``pack_vis``),
over the traced loop's frames."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "Setup")
