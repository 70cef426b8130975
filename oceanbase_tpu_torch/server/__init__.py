"""Server-side pieces of the port (``calibrate``: the optimizer's machine
constants)."""
