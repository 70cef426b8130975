"""Benchmark harness of the port: TPC-H data generation (``tpch``), the
hand-built Q6/Q1/Q14 plans (``queries``) and numpy oracles
(``oracle_np``)."""
