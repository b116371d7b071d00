"""xLSTM-125M [arXiv:2405.04517]: alternating mLSTM and sLSTM blocks,
d_ff 0 (the xLSTM blocks carry their own up and down projections).  Same
values as ``repro.configs.xlstm_125m.CONFIG``.  Attention-free, so the
Chimera transform is off and no kernel of the port runs on its path; its
mLSTM chunk is ``chimera.chunk_size`` (256), as in the JAX package."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    use_chimera=False,  # attention-free: the technique is inapplicable
)
