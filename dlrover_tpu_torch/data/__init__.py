"""The data tier (port of ``dlrover_tpu/data``): the elastic sampler and
loader, the CUDA-stream device prefetcher, the master's shard client, the
text-shard reader, and the coworker loader (``coworker``) and its
cross-host service (``coworker_service``)."""
