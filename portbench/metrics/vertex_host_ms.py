"""The vertex stage's host time a frame, in ms: the program's ``Vertex``
spans (``vertex.vertex_stage``; in map cells ``vertex_geometry`` of the
light view and ``vertex_attrs`` of the shared geometry; the scene meshes'
shadow factors), over the traced loop's frames."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "Vertex")
