"""Parquet I/O of the port: the clustered table writer
(:mod:`tempo_tpu_torch.io.writer`) and out-of-core Parquet ingest onto a
port mesh (:mod:`tempo_tpu_torch.io.ingest`)."""
