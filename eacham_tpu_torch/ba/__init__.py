"""Bundle adjustment of the port (``core.refine_ba``)."""
