"""Multi-device graph builds: per-shard gene-mer tables on torch devices,
merged into one table (port of `amira_tpu/parallel/`)."""
