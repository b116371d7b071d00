"""The paper's own model: Chimera traffic classifier (§4, Table 1 row).

A compact decoder with Chimera attention over packet-token streams, at the
operating point of Table 4 (bold row): m=256, d_v=64.  Same values as
``repro.configs.chimera_dataplane.CONFIG``."""

from repro_torch.configs.base import ArchConfig
from repro_torch.core.chimera_attention import ChimeraAttentionConfig
from repro_torch.core.feature_maps import FeatureMapConfig

CONFIG = ArchConfig(
    name="chimera-dataplane",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_head=64,
    d_ff=512,
    vocab_size=1024,  # packet-byte/field token alphabet
    vocab_pad_multiple=32,
    use_chimera=True,
    chimera=ChimeraAttentionConfig(
        feature_map=FeatureMapConfig(kind="exp_prf", m=256),
        chunk_size=64,  # the SRAM window (Eq. 13)
        n_global=64,  # TCAM static set
        sig_bits=64,
        match_hamming=24,
    ),
    dtype="float32",
    remat="none",
)
