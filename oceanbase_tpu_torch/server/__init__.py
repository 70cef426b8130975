"""Server plane of the port: ``Database`` (the single-node instance),
``Tenant`` (engine + WAL + transactions + catalog), ``Config`` (the knobs
the ported modules read) and ``calibrate`` (the optimizer's machine
constants)."""
