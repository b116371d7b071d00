"""Model assembly (port of ``repro.models.model``: ``_init_block`` :60,
``_block_forward`` :89, ``_group_forward`` :176, ``init_model`` :188,
``_scan_groups`` :205, ``forward`` :221, ``_head`` :241, ``loss_fn`` :264,
``init_caches`` :300, ``_block_decode`` :309, ``decode_hidden_step`` :335,
``decode_step`` :363, ``_init_encdec`` :382, ``encode`` :413,
``_encdec_forward`` :433, ``init_encdec_caches`` :459,
``_encdec_decode_step`` :476, ``_block_prefill`` :500 and
``prefill_with_caches`` :526, with the dispatch of ``_init_block``,
``_block_forward``, ``_init_block_cache`` :286, ``_block_decode`` and
``_block_prefill`` on the block kind and on MLA, and of ``init_model``,
``forward`` and ``decode_step`` on ``encoder_layers``).

The parameter layout is the JAX package's: per-group block parameters are
stacked on a leading "layers" axis under ``params["blocks"]["b<j>"]``, and
the caches likewise.  The JAX ``scan`` over groups becomes a Python loop
over that axis, each group checkpointed when ``cfg.remat`` is "full" (as
JAX's scan body); the caches are updated in place.  The block kinds are
JAX's: ``attn`` (GQA, SWA or MLA attention, Chimera or softmax, banded or
full-causal), ``mamba`` (``models/mamba.py``), ``mlstm`` and ``slstm``
(``models/xlstm.py``); ``attn`` and ``mamba`` blocks carry a dense or MoE
MLP (MoE keyed on the block's position in the pattern), the xLSTM blocks
none.  The residual stream is in ``cfg.dtype``: the embedding is cast to it, and every
block's output is cast back to it before the residual add, as in JAX.

The encoder-decoder stack (whisper-tiny, ``encoder_layers`` > 0) serves and
trains: ``init_model``, ``encode`` (a stub frontend's frame embeddings
through ``enc_in`` and ``encoder_layers`` attention blocks with non-causal
softmax, RoPE on q and k), the teacher-forced ``forward`` and ``loss_fn``
(each decoder block: causal self-attention, then cross-attention to the
encoder's output behind ``ln_x``, then the MLP; ``make_train_step`` and the
``Trainer`` take a batch with ``enc_embeds``), ``init_encdec_caches`` (each
decoder block's self-attention cache beside its precomputed
cross-attention keys and values) and ``decode_step``.  With ``cfg.remat``
"full" and gradients on, each encoder layer and each decoder group
(its cross keys and values included) is checkpointed, as JAX's scan
bodies.  As in the JAX package there is no enc-dec ``prefill_with_caches``,
``decode_hidden_step`` or LM engine: those raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.chimera_attention import ChimeraState
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    apply_norm,
    dense,
    embed,
    init_dense,
    init_embedding,
    init_mlp,
    init_norm,
    mlp,
    remat_call,
)

Params = Dict[str, Any]


# the recurrent token mixers, by block kind: init, the full-sequence layer
# (with ``return_cache``), the zero decode cache, the one-token decode step
_MIXER_INIT = {"mamba": mamba_mod.init_mamba, "mlstm": xlstm_mod.init_mlstm,
               "slstm": xlstm_mod.init_slstm}
_MIXER_LAYER = {"mamba": mamba_mod.mamba_layer, "mlstm": xlstm_mod.mlstm_layer,
                "slstm": xlstm_mod.slstm_layer}
_MIXER_CACHE = {"mamba": mamba_mod.init_mamba_cache, "mlstm": xlstm_mod.init_mlstm_cache,
                "slstm": xlstm_mod.init_slstm_cache}
_MIXER_DECODE = {"mamba": mamba_mod.mamba_decode, "mlstm": xlstm_mod.mlstm_decode,
                 "slstm": xlstm_mod.slstm_decode}
BLOCK_KINDS = ("attn",) + tuple(_MIXER_INIT)


def _require_ported(cfg: ArchConfig) -> None:
    """The stacks the port has: any pattern of attention (GQA, SWA or MLA;
    Chimera or softmax), Mamba, mLSTM and sLSTM blocks, with or without an
    encoder (``encoder_layers``).  ``family`` is a label (the JAX package's
    dryrun prints it): a "vlm" such as Chameleon, whose image tokens are
    vocabulary ids, is a stack of attention blocks."""
    unknown = [kind for kind in cfg.pattern if kind not in BLOCK_KINDS]
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {unknown}")
    if "attn" in cfg.pattern:
        attn.require_ported(cfg)


def refuse_encdec(cfg: ArchConfig, what: str) -> None:
    """Raise for an encoder-decoder config where the JAX package has no
    enc-dec counterpart either (prefill, the hidden-state decode, the LM
    engine and its launcher build decoder-only caches)."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: {what} is decoder-only; the JAX package has no encoder-decoder "
            "prefill, hidden-state decode or LM engine either (serve an enc-dec model with "
            "init_encdec_caches and decode_step)")


def _is_mla(cfg: ArchConfig) -> bool:
    return cfg.attention_kind == "mla"


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _init_block(cfg: ArchConfig, kind: str, pos_in_pattern: int, g: torch.Generator,
                device) -> Params:
    if kind == "attn":
        init = attn.init_mla if _is_mla(cfg) else attn.init_attention
    else:
        init = _MIXER_INIT[kind]
    p = {"ln1": init_norm(cfg.d_model, device, cfg.norm_type), "attn": init(cfg, g, device)}
    if kind in ("attn", "mamba") and (cfg.d_ff or cfg.moe_experts):
        p["ln2"] = init_norm(cfg.d_model, device, cfg.norm_type)
        if cfg.layer_is_moe(pos_in_pattern):
            p["mlp"] = moe_mod.init_moe(cfg, g, device)
            p["_moe"] = torch.zeros((), device=device)  # structural marker
        else:
            p["mlp"] = init_mlp(g, cfg.d_model, cfg.d_ff, device)
    return p


def stack_params(trees: list) -> Params:
    """Stack identical dict trees (Chimera states among their leaves) along
    a new leading 'layers' axis.  One tree is viewed with that axis added,
    not copied: a single layer group of Jamba's cut holds 38.6 GB of
    experts, which a copy would double on an 80 GB card."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_params([t[k] for t in trees]) for k in first}
    if isinstance(first, ChimeraState):
        return ChimeraState(*(stack_params(list(ls)) for ls in zip(*(t.leaves() for t in trees))))
    if len(trees) == 1:
        return first.unsqueeze(0)
    return torch.stack(trees, dim=0)


def index_params(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: index_params(v, i) for k, v in tree.items()}
    return tree[i]


def init_model(cfg: ArchConfig, g: torch.Generator, device=None) -> Params:
    """Random weights with the JAX package's layout, drawn from ``g`` on its
    own device (a CUDA generator draws on the card).  ``device=None`` means
    ``"cuda"``; without a GPU it raises."""
    _require_ported(cfg)
    device = resolve_device(device, "init_model")
    if cfg.encoder_layers:
        return _init_encdec(cfg, g, device)
    p: Params = {"embed": init_embedding(g, cfg.padded_vocab, cfg.d_model, device)}
    groups = [
        {f"b{j}": _init_block(cfg, kind, j, g, device) for j, kind in enumerate(cfg.pattern)}
        for _ in range(cfg.n_groups)
    ]
    p["blocks"] = stack_params(groups)
    p["final_norm"] = init_norm(cfg.d_model, device, cfg.norm_type)
    if not cfg.tie_embeddings:
        p["head"] = init_dense(g, cfg.d_model, cfg.padded_vocab, device=device)
    return p


def _mlp_out(cfg: ArchConfig, bp: Params, h):
    """The block's MLP: ``(y, aux)``, MoE or SwiGLU."""
    if "_moe" in bp:
        return moe_mod.moe_layer(cfg, bp["mlp"], h)
    return mlp(bp["mlp"], h), None


def _block_forward(cfg: ArchConfig, kind: str, bp: Params, x, positions, causal: bool = True):
    """Returns ``(x, aux)``: aux is the MoE balance loss (0 without MoE)."""
    aux = torch.zeros((), device=x.device)
    h = apply_norm(bp["ln1"], x, cfg.norm_type)
    if kind == "attn":
        if _is_mla(cfg):
            y = attn.mla_attention_layer(cfg, bp["attn"], h, positions)
        else:
            y = attn.attention_layer(cfg, bp["attn"], h, positions, causal=causal)
    else:
        y = _MIXER_LAYER[kind](cfg, bp["attn"], h)
    x = x + y.to(x.dtype)
    if "ln2" in bp:
        h = apply_norm(bp["ln2"], x, cfg.norm_type)
        y, a = _mlp_out(cfg, bp, h)
        if a is not None:
            aux = aux + a
        x = x + y.to(x.dtype)
    return x, aux


def _group_forward(cfg: ArchConfig, gp: Params, x, positions, causal: bool = True):
    aux = torch.zeros((), device=x.device)
    for j, kind in enumerate(cfg.pattern):
        x, a = _block_forward(cfg, kind, gp[f"b{j}"], x, positions, causal)
        aux = aux + a
    return x, aux


def _scan_groups(cfg: ArchConfig, stacked: Params, x, positions, causal: bool = True):
    """The JAX scan over groups as a loop over the stacked layer axis; each
    group's forward checkpointed when ``cfg.remat != "none"``
    (:func:`remat_call`).  Returns ``(x, aux)``."""
    aux = torch.zeros((), device=x.device)
    for gi in range(cfg.n_groups):
        x, a = remat_call(cfg.remat != "none", _group_forward, cfg,
                          index_params(stacked, gi), x, positions, causal)
        aux = aux + a
    return x, aux


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """batch: {"tokens": (B,T) int[, "positions"][, "enc_embeds" (B, Te, d)
    for an enc-dec config]}.  Returns (logits (B,T,V_padded), aux_loss)."""
    _require_ported(cfg)
    if cfg.encoder_layers:
        return _encdec_forward(cfg, params, batch)
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = embed(params["embed"], tokens).to(_dtype(cfg))
    x, aux = _scan_groups(cfg, params["blocks"], x, positions)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return _head(cfg, params, x), aux


def _head(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T.to(x.dtype)
    return dense(params["head"], x)


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Next-token cross-entropy with the 1e-4 z-loss.  Returns
    (total, {"nll", "aux", "zloss"})."""
    logits, aux = forward(cfg, params, batch)
    logits = logits.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    zloss = 1e-4 * torch.mean(torch.square(logz))
    total = loss + zloss + 1e-2 * aux
    return total, {"nll": loss, "aux": aux, "zloss": zloss}


def _init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, dtype, device,
                      lead):
    if kind == "attn":
        init = attn.init_mla_cache if _is_mla(cfg) else attn.init_attention_cache
        return init(cfg, batch, max_len, dtype, device, lead=lead)
    return _MIXER_CACHE[kind](cfg, batch, dtype, device, lead=lead)


def init_caches(cfg: ArchConfig, batch: int, max_len: int = 0, dtype=None, device=None):
    """Zero decode caches, stacked on the layer axis: Chimera states, or
    softmax KV caches of ``max_len`` tokens (a ring of ``min(max_len,
    window)`` for SWA; MLA's latent cache), Mamba's conv tail and SSM state,
    mLSTM's (C, n) and sLSTM's (c, n, h, m).  ``dtype`` defaults to
    ``cfg.dtype``.  ``device=None`` means ``"cuda"``; without a GPU it
    raises."""
    _require_ported(cfg)
    device = resolve_device(device, "init_caches")
    dtype = dtype or _dtype(cfg)
    return {
        f"b{j}": _init_block_cache(cfg, kind, batch, max_len, dtype, device, (cfg.n_groups,))
        for j, kind in enumerate(cfg.pattern)
    }


def _layer_cache(c, gi: int):
    """Layer ``gi`` of a stacked block cache, as views that decode updates in
    place (a Chimera state's ``count`` is replaced: write it back after)."""
    if isinstance(c, ChimeraState):
        return ChimeraState(*(t[gi] for t in c.leaves()))
    return {k: t[gi] for k, t in c.items()}


def _block_decode(cfg: ArchConfig, kind: str, bp: Params, x_t, position, cache):
    h = apply_norm(bp["ln1"], x_t, cfg.norm_type)
    if kind == "attn":
        decode = attn.mla_decode if _is_mla(cfg) else attn.attention_decode
        y = decode(cfg, bp["attn"], h, position, cache)
    else:
        y = _MIXER_DECODE[kind](cfg, bp["attn"], h, cache)
    x_t = x_t + y.to(x_t.dtype)
    if "ln2" in bp:
        h = apply_norm(bp["ln2"], x_t, cfg.norm_type)
        y, _ = _mlp_out(cfg, bp, h)
        x_t = x_t + y.to(x_t.dtype)
    return x_t


def decode_hidden_step(
    cfg: ArchConfig,
    params: Params,
    token: torch.Tensor,  # (B,) int
    position: torch.Tensor,  # (B,) int
    caches,  # from init_caches, updated in place
) -> torch.Tensor:
    """One streaming step to the final-norm hidden state: (B,) -> (B, d).
    Decoder-only, as in JAX."""
    refuse_encdec(cfg, "decode_hidden_step")
    x = embed(params["embed"], token[:, None]).to(_dtype(cfg))
    for gi in range(cfg.n_groups):
        for j, kind in enumerate(cfg.pattern):
            c = caches[f"b{j}"]
            layer = _layer_cache(c, gi)
            bp = index_params(params["blocks"][f"b{j}"], gi)
            x = _block_decode(cfg, kind, bp, x, position, layer)
            if isinstance(c, ChimeraState):
                c.count[gi] = layer.count
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return x[:, 0]


def decode_step(cfg: ArchConfig, params: Params, token, position, caches) -> torch.Tensor:
    """One non-iterative serve step: (B,) token -> (B, V_padded) logits; the
    caches (``init_caches``, or ``init_encdec_caches`` for an enc-dec
    config) are updated in place."""
    if cfg.encoder_layers:
        return _encdec_decode_step(cfg, params, token, position, caches)
    x = decode_hidden_step(cfg, params, token, position, caches)
    return _head(cfg, params, x[:, None])[:, 0]


def _block_prefill(cfg: ArchConfig, kind: str, bp: Params, x, positions, max_len: int):
    h = apply_norm(bp["ln1"], x, cfg.norm_type)
    if kind == "attn":
        prefill = attn.mla_prefill if _is_mla(cfg) else attn.attention_prefill
        y, cache = prefill(cfg, bp["attn"], h, positions, max_len)
    else:
        y, cache = _MIXER_LAYER[kind](cfg, bp["attn"], h, return_cache=True)
    x = x + y.to(x.dtype)
    if "ln2" in bp:
        h = apply_norm(bp["ln2"], x, cfg.norm_type)
        y, _ = _mlp_out(cfg, bp, h)
        x = x + y.to(x.dtype)
    return x, cache


def prefill_with_caches(cfg: ArchConfig, params: Params, tokens: torch.Tensor, max_len: int):
    """tokens (B, T) -> (next-token logits (B, V_padded), decode caches).

    One forward over the prompt builds every layer's decode cache, with the
    continuation semantics of feeding the prompt through ``decode_step``
    token by token (up to MoE capacity drops, which prefill can have and
    one-token decode cannot).  Decoder-only, as in JAX."""
    _require_ported(cfg)
    refuse_encdec(cfg, "prefill_with_caches")
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = embed(params["embed"], tokens).to(_dtype(cfg))
    per_group = []
    for gi in range(cfg.n_groups):
        gp = index_params(params["blocks"], gi)
        caches = {}
        for j, kind in enumerate(cfg.pattern):
            x, caches[f"b{j}"] = _block_prefill(cfg, kind, gp[f"b{j}"], x, positions, max_len)
        per_group.append(caches)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = _head(cfg, params, x[:, -1:])[:, 0]
    return logits, stack_params(per_group)


# --------------------------------------------------------------------------
# Encoder-decoder (whisper)
# --------------------------------------------------------------------------

def _enc_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder's stack: ``encoder_layers`` attention blocks."""
    return dataclasses.replace(cfg, block_pattern=("attn",), n_layers=cfg.encoder_layers)


def _init_encdec(cfg: ArchConfig, g: torch.Generator, device) -> Params:
    """The enc-dec tree with JAX's names: ``enc_in`` (the stub frontend's
    adapter), ``enc_blocks`` (``encoder_layers`` attention blocks stacked),
    ``enc_norm``, ``embed``, ``blocks`` (the decoder's groups, each block
    with ``cross`` and ``ln_x``), ``final_norm`` and ``head``."""
    enc_cfg = _enc_cfg(cfg)
    p: Params = {"enc_in": init_dense(g, cfg.d_model, cfg.d_model, device=device)}
    p["enc_blocks"] = stack_params([{"b0": _init_block(enc_cfg, "attn", 0, g, device)}
                                    for _ in range(cfg.encoder_layers)])
    p["enc_norm"] = init_norm(cfg.d_model, device, cfg.norm_type)
    p["embed"] = init_embedding(g, cfg.padded_vocab, cfg.d_model, device)
    groups = []
    for _ in range(cfg.n_groups):
        gp = {}
        for j, kind in enumerate(cfg.pattern):
            gp[f"b{j}"] = _init_block(cfg, kind, j, g, device)
            gp[f"b{j}"]["cross"] = attn.init_cross_attention(cfg, g, device)
            gp[f"b{j}"]["ln_x"] = init_norm(cfg.d_model, device, cfg.norm_type)
        groups.append(gp)
    p["blocks"] = stack_params(groups)
    p["final_norm"] = init_norm(cfg.d_model, device, cfg.norm_type)
    p["head"] = init_dense(g, cfg.d_model, cfg.padded_vocab, device=device)
    return p


def encode(cfg: ArchConfig, params: Params, enc_embeds: torch.Tensor) -> torch.Tensor:
    """enc_embeds: (B, Te, d) precomputed frontend embeddings (stub) ->
    (B, Te, d) encoder output in ``cfg.dtype``: non-causal softmax
    self-attention in every layer (on the card, window_attention's
    non-causal mode)."""
    _require_ported(cfg)
    x = dense(params["enc_in"], enc_embeds.to(_dtype(cfg)))
    B, Te, _ = x.shape
    positions = torch.arange(Te, device=x.device).expand(B, Te)
    x, _ = _scan_groups(_enc_cfg(cfg), params["enc_blocks"], x, positions, causal=False)
    return apply_norm(params["enc_norm"], x, cfg.norm_type)


def _cross(cfg: ArchConfig, bp: Params, x, kv):
    """The decoder block's cross-attention sublayer with its residual add."""
    h = apply_norm(bp["ln_x"], x, cfg.norm_type)
    return x + attn.cross_attention_layer(cfg, bp["cross"], h, kv).to(x.dtype)


def _decoder_group(cfg: ArchConfig, gp: Params, x, positions, enc_out):
    """One decoder group: each block's self-attention and MLP, then its
    cross-attention to ``enc_out`` (keys and values computed here, as in
    JAX's scan body).  Returns ``(x, aux)``."""
    aux = torch.zeros((), device=x.device)
    for j, kind in enumerate(cfg.pattern):
        bp = gp[f"b{j}"]
        x, a = _block_forward(cfg, kind, bp, x, positions, causal=True)
        x = _cross(cfg, bp, x, attn.encode_cross_kv(cfg, bp["cross"], enc_out))
        aux = aux + a
    return x, aux


def _encdec_forward(cfg: ArchConfig, params: Params, batch):
    enc_out = encode(cfg, params, batch["enc_embeds"])
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = embed(params["embed"], tokens).to(_dtype(cfg))
    aux = torch.zeros((), device=x.device)
    for gi in range(cfg.n_groups):
        x, a = remat_call(cfg.remat != "none", _decoder_group, cfg,
                          index_params(params["blocks"], gi), x, positions, enc_out)
        aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return _head(cfg, params, x), aux


def init_encdec_caches(cfg: ArchConfig, params: Params, enc_embeds: torch.Tensor, batch: int,
                       max_len: int, dtype=None):
    """Decode caches for enc-dec, on ``enc_embeds``' device: ``{"b<j>":
    {"self": the block's zero self-attention cache, "cross_kv": (k, v) of
    the encoder's output, (n_groups, B, H, Te, dh) each}}``, every leaf
    stacked on the layer axis.  ``dtype`` (the self cache's) defaults to
    ``cfg.dtype``."""
    _require_ported(cfg)
    dtype = dtype or _dtype(cfg)
    enc_out = encode(cfg, params, enc_embeds)
    out = {}
    for j, kind in enumerate(cfg.pattern):
        kvs = [attn.encode_cross_kv(cfg, index_params(params["blocks"][f"b{j}"], gi)["cross"],
                                    enc_out) for gi in range(cfg.n_groups)]
        out[f"b{j}"] = {
            "self": _init_block_cache(cfg, kind, batch, max_len, dtype, enc_out.device,
                                      (cfg.n_groups,)),
            "cross_kv": tuple(torch.stack(t) for t in zip(*kvs)),
        }
    return out


def _encdec_decode_step(cfg: ArchConfig, params: Params, token, position, caches):
    x = embed(params["embed"], token[:, None]).to(_dtype(cfg))
    for gi in range(cfg.n_groups):
        for j, kind in enumerate(cfg.pattern):
            c = caches[f"b{j}"]
            layer = _layer_cache(c["self"], gi)
            bp = index_params(params["blocks"][f"b{j}"], gi)
            x = _block_decode(cfg, kind, bp, x, position, layer)
            if isinstance(c["self"], ChimeraState):
                c["self"].count[gi] = layer.count
            x = _cross(cfg, bp, x, tuple(t[gi] for t in c["cross_kv"]))
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return _head(cfg, params, x)[:, 0]
