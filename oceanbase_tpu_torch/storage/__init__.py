"""Storage of the port (port of ``oceanbase_tpu/storage``, host-side
numpy as in the reference): encoded, zone-mapped, crc-checked column
segments; MVCC memtables; tablets with freeze and mini/minor/major
compaction; RANGE-partitioned tablets; point and range lookups and the
batched key-existence test; secondary-index maintenance; the
``StorageEngine`` (slog, manifest, checkpoint, recovery) and the
``StorageCatalog`` that materializes tablet snapshots as device
relations; and the temp-file store the spill tier writes."""
