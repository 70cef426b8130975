"""Parallel-execution helpers the streaming and spill tiers share (port of
the parts of ``oceanbase_tpu.px`` they use: the coordinator split of a
plan and the partial/final aggregate rewrite)."""
