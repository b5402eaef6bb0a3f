"""LOD selection's host time a frame, in ms: the program's ``Select``
spans (``quadtree.select_all_surfaces`` and the render budget's clip; in
map cells also the light view's selection and the main view's selection
that the shared geometry is masked to), their syncs included, over the
traced loop's frames."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "Select")
