from repro_torch.checkpoint.store import CheckpointStore  # noqa: F401
