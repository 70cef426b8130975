"""Host-side storage the executor spills to (port of the part of
``oceanbase_tpu.storage`` the spill tier uses: the temp-file store)."""
