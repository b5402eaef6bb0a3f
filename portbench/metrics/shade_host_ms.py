"""Shading's host time a frame, in ms: the program's ``Shade`` spans
(the G-buffer from the raster's products, deferred lighting, the view
rays, eye adaptation, tonemap, sky and encode), over the traced loop's
frames."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "Shade")
