"""The synthetic token stream the trainer reads."""
from repro_torch.data.pipeline import DataConfig, SyntheticStream, to_device  # noqa: F401
