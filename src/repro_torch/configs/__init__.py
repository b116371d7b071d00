"""Architecture configs of the port: the paper's dataplane model and
Mixtral-8x7B (its softmax sliding-window MoE variant is served)."""

from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.registry import ARCHS, get_config, smoke_config  # noqa: F401
