"""The data tier (port of ``dlrover_tpu/data``): the elastic sampler and
loader, the CUDA-stream device prefetcher, the master's shard client and
the text-shard reader."""
