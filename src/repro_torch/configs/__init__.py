"""Architecture configs of the port: the paper's dataplane model and the
model zoo's configs whose blocks the port has (Mixtral-8x7B, Yi-9B,
MiniCPM3-4B, Qwen3-32B, CodeQwen1.5-7B, Moonshot-v1-16B-A3B, Chameleon-34B,
Jamba-1.5-Large, xLSTM-125M, Whisper-tiny), Chimera attention by default."""

from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.registry import ARCHS, get_config, smoke_config  # noqa: F401
