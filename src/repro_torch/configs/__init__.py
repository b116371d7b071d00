"""Architecture configs of the port (the paper's dataplane model only)."""

from repro_torch.configs.base import ArchConfig  # noqa: F401
