"""The light pass's host time a frame, in ms: the program's ``Light pass``
spans (``Renderer._light_depth_pass``, with its selection, geometry, setup,
binning and kernel B2's issue, and ``shadow_field_from_map``), over the
traced loop's frames. Map cells only."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "Light pass")
