from repro_torch.distributed import sharding  # noqa: F401
