"""Data parallelism over `torch.distributed` (port of `overcooked_ai_tpu.parallel`)."""
