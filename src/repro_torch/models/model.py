"""Top-level model API of every LM family the reference builds.

  model = Model(cfg)                    # on the card; Model(cfg, "cpu")
  params = model.init(key)              # nested dict of tensors
  logits, aux = model.forward(params, batch)
  logits, caches, extras = model.prefill(params, batch, caches)
  logits, caches = model.decode_step(params, batch, caches, index, extras)

``Model`` is an ``nn.Module`` whose parameters sit under the reference's
dotted paths: ``state_dict()`` keys equal the flattened reference tree
(``layers.mix.wq``, ...). The methods take the parameter tree explicitly,
as the reference's do; ``init`` and ``load_params`` register it on the
module, and ``params()`` reads it back.

`batch` is a dict:
  tokens           (B, S) int32            — LM tokens (decoder side)
  frontend_embeds  (B, F, D)               — VLM patch embeddings (optional)
  enc_embeds       (B, S_enc, D)           — audio frame embeddings (enc-dec)

``aux`` is the float32 sum of the MoE layers' load-balance losses (0 for
the other families). An enc-dec prefill returns ``{"enc_out": ...}`` in
its extras, and its decode steps take them back. The loss functions wait
for the training slice (ROADMAP item 17(c)).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.models.encdec import build_encdec_params, encdec_forward
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import (build_params, init_caches,
                                            lm_forward)


def _register(module: torch.nn.Module, tree: Dict[str, Any]) -> None:
    for name, value in tree.items():
        if isinstance(value, dict):
            child = torch.nn.Module()
            module.add_module(name, child)
            _register(child, value)
        else:
            module.register_parameter(
                name, torch.nn.Parameter(value, requires_grad=False))


def _tree(module: torch.nn.Module) -> Dict[str, Any]:
    out: Dict[str, Any] = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        out[name] = _tree(child)
    return out


class Model(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.is_encdec = cfg.is_encoder_decoder
        self.device = resolve_device(device)

    # -- parameter builders ------------------------------------------------
    def _build(self, make):
        if self.is_encdec:
            return build_encdec_params(make, self.cfg)
        return build_params(make, self.cfg)

    def init(self, key: torch.Tensor):
        """Random parameters from the port's threefry ``key`` (the
        reference's ``Model.init``), registered on the module."""
        tree = P.init_params(self._build, key,
                             dtype=dtype_of(self.cfg.param_dtype),
                             device=self.device)
        return self.load_params(tree)

    def load_params(self, tree: Dict[str, Any]):
        """Register a parameter tree (e.g. ``interop.model_params_from_numpy``
        of the reference's) on the module; returns the registered tree."""
        _register(self, tree)
        return self.params()

    def params(self) -> Dict[str, Any]:
        return _tree(self)

    def shapes(self):
        return P.param_shapes(self._build,
                              dtype=dtype_of(self.cfg.param_dtype))

    # -- forward -----------------------------------------------------------
    def forward(self, params, batch: Dict[str, Any], features_only=False):
        """Training/scoring forward (no cache). Returns (logits, aux)."""
        if self.is_encdec:
            out, _, aux, _ = encdec_forward(
                params, batch["tokens"], batch["enc_embeds"], self.cfg,
                features_only=features_only)
            return out, aux
        out, _, aux = lm_forward(
            params, batch["tokens"], self.cfg,
            frontend_embeds=batch.get("frontend_embeds"),
            features_only=features_only)
        return out, aux

    def unembed_table(self, params):
        return (params["embed"]["table"] if self.cfg.tie_embeddings
                else params["unembed"]["table"])

    # -- serving -----------------------------------------------------------
    def init_caches(self, batch: int, max_len: int):
        return init_caches(self.cfg, batch, max_len, dtype_of(self.cfg.dtype),
                           self.device)

    def prefill(self, params, batch, caches):
        """Prefill the cache with a full prompt; returns (logits, caches,
        extras). The caches are written in place; an enc-dec model encodes
        ``batch["enc_embeds"]`` and returns the encoder output as
        ``extras["enc_out"]``."""
        if self.is_encdec:
            logits, caches, _, enc_out = encdec_forward(
                params, batch["tokens"], batch["enc_embeds"], self.cfg,
                caches=caches, start_index=0)
            return logits, caches, {"enc_out": enc_out}
        logits, caches, _ = lm_forward(
            params, batch["tokens"], self.cfg, caches=caches,
            frontend_embeds=batch.get("frontend_embeds"), start_index=0)
        return logits, caches, {}

    def decode_step(self, params, batch, caches, index, extras=None):
        """One decode step. batch["tokens"]: (B, 1). index: host position.
        extras: the prefill's (an enc-dec model reads its ``enc_out``)."""
        if self.is_encdec:
            logits, caches, _, _ = encdec_forward(
                params, batch["tokens"], batch.get("enc_embeds"), self.cfg,
                caches=caches, enc_out=(extras or {}).get("enc_out"),
                start_index=index)
            return logits, caches
        logits, caches, _ = lm_forward(params, batch["tokens"], self.cfg,
                                       caches=caches, start_index=index)
        return logits, caches


# ---------------------------------------------------------------------------
# Analytic parameter counts (for 6ND roofline)
# ---------------------------------------------------------------------------

def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    total = cfg.vocab_size * d  # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d

    def attn_params():
        if cfg.mla is not None:
            m = cfg.mla
            dn, dr, dv, dc = (m.nope_head_dim, m.rope_head_dim, m.v_head_dim,
                              m.kv_lora_rank)
            return (d * cfg.num_heads * (dn + dr) + d * dc + d * dr
                    + dc * cfg.num_heads * (dn + dv) + cfg.num_heads * dv * d)
        return (d * cfg.num_heads * dh + 2 * d * cfg.num_kv_heads * dh
                + cfg.num_heads * dh * d)

    def mlp_params(ff):
        mult = 3 if cfg.mlp_kind == "swiglu" else 2
        return mult * d * ff

    def moe_params(active):
        m = cfg.moe
        routed = m.num_experts if not active else m.top_k
        p = d * m.num_experts  # router (always resident)
        p += routed * 3 * d * m.expert_ff
        p += mlp_params(m.expert_ff * m.num_shared) if m.num_shared else 0
        return p

    fam = cfg.family
    if fam == "ssm":
        c = cfg.ssm
        d_in = c.expand * d
        h = d_in // c.head_dim
        per = (d * (2 * d_in + 2 * c.state_dim + h)
               + c.conv_width * (d_in + 2 * c.state_dim)
               + 3 * h + d_in + d_in * d)
        total += cfg.num_layers * per
    elif fam == "hybrid":
        c = cfg.rglru
        w = c.lru_width or d
        per_rec = 2 * d * w + c.conv_width * w + 2 * w * w + w + w * d
        per_attn = attn_params()
        pat = c.block_pattern
        n_rec = sum(1 for k in pat if k == "recurrent")
        n_att = len(pat) - n_rec
        groups = cfg.num_layers // len(pat)
        total += groups * (n_rec * per_rec + n_att * per_attn
                           + len(pat) * mlp_params(cfg.d_ff))
    elif fam == "moe":
        m = cfg.moe
        first = m.first_moe_layer
        total += cfg.num_layers * attn_params()
        total += first * mlp_params(m.dense_ff or cfg.d_ff)
        total += (cfg.num_layers - first) * moe_params(active_only)
    else:
        layers = cfg.num_layers
        total += layers * (attn_params() + mlp_params(cfg.d_ff))
        if cfg.is_encoder_decoder:
            # encoder stack + decoder cross-attention
            total += cfg.num_encoder_layers * (attn_params()
                                               + mlp_params(cfg.d_ff))
            total += cfg.num_layers * attn_params()
    return int(total)
