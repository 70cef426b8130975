"""Server plane of the port: ``Database`` (the single-node instance:
tenants, users, procedures, jobs), ``Tenant`` (engine + WAL +
transactions + catalog), ``Config`` (the knobs the ported modules read),
``admission`` (statement slots, deadlines, KILL), ``monitor`` (the live
session registry), ``mysql_protocol`` (``MySQLServer``, the wire entry
point) with ``tls``, ``jobs`` (the DBMS job scheduler), ``backend_info``
and ``calibrate`` (the optimizer's machine constants); the durability
plane's ``diskmgr`` (disk budgets, typed disk errors, read-only
degradation), ``errsim`` (fault points), ``backup`` (backup, archive,
point-in-time restore) and ``workload`` (the workload repository)."""
