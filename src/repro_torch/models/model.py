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
its extras, and its decode steps take them back. ``chunked_lm_loss`` (the
trainer's) and ``lm_loss`` are the reference's losses.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device, scalar
from repro_torch.models import params as P
from repro_torch.models.encdec import build_encdec_params, encdec_forward
from repro_torch.models.layers import dtype_of, softcap
from repro_torch.models.transformer import (build_params, init_caches,
                                            lm_forward)
from repro_torch.parallel import fsdp


def _register(module: torch.nn.Module, tree: Dict[str, Any],
              trainable: bool) -> None:
    for name, value in tree.items():
        if isinstance(value, dict):
            child = torch.nn.Module()
            module.add_module(name, child)
            _register(child, value, trainable)
        else:
            module.register_parameter(
                name, torch.nn.Parameter(value, requires_grad=trainable))


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

    def init(self, key: torch.Tensor, trainable: bool = False):
        """Random parameters from the port's threefry ``key`` (the
        reference's ``Model.init``), registered on the module
        (``load_params``)."""
        tree = P.init_params(self._build, key,
                             dtype=dtype_of(self.cfg.param_dtype),
                             device=self.device)
        return self.load_params(tree, trainable)

    def load_params(self, tree: Dict[str, Any], trainable: bool = False):
        """Register a parameter tree (e.g. ``interop.model_params_from_numpy``
        of the reference's) on the module; returns the registered tree.
        ``trainable`` leaves require a gradient (the trainer's); serving's
        do not, so a decode step builds no autograd graph."""
        _register(self, tree, trainable)
        return self.params()

    def params(self) -> Dict[str, Any]:
        return _tree(self)

    def shapes(self):
        return P.param_shapes(self._build,
                              dtype=dtype_of(self.cfg.param_dtype))

    def specs(self, mesh, rules=None):
        """The parameters' specs on ``mesh`` (``PARAM_RULES`` unless
        ``rules``)."""
        return P.param_specs(self._build, mesh, rules)

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
# Loss
# ---------------------------------------------------------------------------

def _chunk_nll(xb, table, lb, mb, cfg: ModelConfig):
    """(sum of the masked NLL, sum of the mask) of one chunk: the unembed
    in the features' dtype (the table cast inside the chunk, so each
    chunk's table gradient widens to float32 before the chunks add, as the
    reference's scan adds them), the softcap, the padded-vocab mask, then
    float32 log-sum-exp against the label's logit.

    A table of fewer rows than the padded vocab is this rank's vocab block
    under a step that splits over ``model`` (``parallel.fsdp``): the
    logits are the block's columns, the mask takes their global indices,
    and the max, the sum of exponentials and the label's logit (from the
    rank that holds it) are taken over the split axis."""
    rows = table.shape[0]
    first = 0 if rows == cfg.padded_vocab else fsdp.split_rank()[1] * rows
    logits = torch.matmul(xb, table.to(xb.dtype).t())
    logits = softcap(logits, cfg.final_logit_softcap).float()
    if cfg.padded_vocab != cfg.vocab_size:
        viota = torch.arange(first, first + rows, device=logits.device)
        logits = torch.where(viota < cfg.vocab_size, logits,
                             torch.full((), -1e9, dtype=torch.float32,
                                        device=logits.device))
    local = (lb.long() - first)[..., None]
    if rows == cfg.padded_vocab:
        logz = torch.logsumexp(logits, dim=-1)
        # the reference's iota-compare sum has one nonzero term: the gather
        ll = torch.gather(logits, -1, local)[..., 0]
    else:
        mx = fsdp.model_max(torch.amax(logits, dim=-1))
        logz = torch.log(fsdp.model_sum(torch.sum(
            torch.exp(logits - mx[..., None]), dim=-1))) + mx
        inside = (local >= 0) & (local < rows)
        ll = fsdp.model_sum(torch.where(
            inside, torch.gather(logits, -1, local.clamp(0, rows - 1)),
            torch.zeros((), dtype=torch.float32, device=logits.device)
        )[..., 0])
    return torch.sum((logz - ll) * mb), torch.sum(mb)


def chunked_lm_loss(features, table, labels, cfg: ModelConfig,
                    loss_mask=None, n_chunks: int = 8):
    """Fused unembed + cross-entropy over sequence chunks (the reference's
    scan): ``n_chunks`` lowered until it divides S (S - 1 = 4 095 gives 7
    chunks of 585), the chunks' sums added in order, and each chunk under
    ``torch.utils.checkpoint``, so no (B, S, V) logits are kept for the
    backward (the reference's ``nothing_saveable``). A masked loss on a
    batch split over ranks divides by the whole batch's mask sum
    (``_whole_batch_sums``). Under a step that splits over ``model`` the
    features are the whole sequence on every rank of the split and
    ``table`` is this rank's vocab block (``_chunk_nll``), or the whole
    table, in which case every rank computes the whole loss and takes a
    share of its gradient (``fsdp.model_share``)."""
    b, s, _ = features.shape
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    masked = loss_mask is not None
    if loss_mask is None:
        loss_mask = torch.ones((b, s), dtype=torch.float32,
                               device=features.device)
    tot = torch.zeros((), dtype=torch.float32, device=features.device)
    cnt = torch.zeros((), dtype=torch.float32, device=features.device)
    for i in range(n_chunks):
        sl = slice(i * cs, (i + 1) * cs)
        nll, m = checkpoint(_chunk_nll, features[:, sl], table,
                            labels[:, sl], loss_mask[:, sl], cfg,
                            use_reentrant=False)
        tot, cnt = tot + nll, cnt + m
    if table.shape[0] == cfg.padded_vocab:
        tot = fsdp.model_share(tot)
    if masked:
        tot, cnt = _whole_batch_sums(tot, cnt)
    return tot / torch.clamp_min(cnt, 1.0)


def _whole_batch_sums(tot, cnt):
    """A masked loss's (NLL sum, mask sum) over every rank that splits the
    batch (``fsdp.Layout.whole_batch``), so each rank divides by the whole
    batch's mask sum, as the reference does; the sums themselves without
    a split batch. Unmasked, every rank's rows count alike and the step's
    mean over the ranks is the whole batch's."""
    layout = fsdp.current_layout()
    if layout is None or layout.batch_n == 1:
        return tot, cnt
    return layout.whole_batch(tot), layout.batch_sum(cnt.detach())


def lm_loss(logits, labels, loss_mask=None):
    """Cross-entropy of full logits. labels: (B, S) int; mask optional
    (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if loss_mask is not None:
        tot, cnt = _whole_batch_sums(torch.sum(nll * loss_mask),
                                     torch.sum(loss_mask))
        return tot / torch.clamp_min(cnt, 1.0)
    return torch.sum(nll) / scalar(nll.numel(), nll)


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
