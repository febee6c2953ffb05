"""The training data pipeline: datasets, augmentation and the loader."""

from .loader import get_dataloader  # noqa: F401
