"""Decoder-only LM for the dense, moe, ssm, hybrid and vlm families.

The reference scans a repeating *period* of sublayers over stacked
parameters; the port keeps the period (``build_period``) and unrolls the
periods into an ``nn.ModuleList``.  Its parameter names mirror the
reference's tree: ``embed.table``, ``final_norm.scale``,
``layers.<i>.<sublayer>.norm.scale``, ``layers.<i>.<sublayer>.core.<w>``
(``models.convert.params_from_jax`` maps one onto the other).

Entry points:
  * ``loss(batch)``: training, ``(loss + 0.01 aux, {"loss", "aux_loss"})``
    for every family of this model (dense, moe with MoE and MLA, ssm,
    hybrid, vlm; a vlm's batch carries its ``image_embeds``), each layer
    recomputed in the backward when ``cfg.remat`` and ``kind == "train"``
    (on a rank, its collectives too); a Mamba sublayer's scan runs
    backwards through the ``ssm_scan_bwd`` kernel; over ranks for the
    dense and ssm families (attention and MLP sublayers, Mamba ones);
  * ``prefill(batch)``: ``(last-token float32 logits, caches)``, the caches
    stacked over periods as in the reference; a vlm's batch carries its
    ``image_embeds`` (b, num_image_tokens, d), the memory of its
    cross-attention layers;
  * ``decode_step(caches, tokens, t)``: one new token per sequence; writes
    its k and v (an MLA layer's latent and rope key, a Mamba layer's state
    and conv window) into the caches in place and returns ``(logits,
    caches)``; a cross layer reads its memory cache and leaves it;
  * ``apply_sublayer`` / ``decode_sublayer``: one sublayer's block on its
    normed input, as ``prefill`` and ``decode_step`` run it, for a
    comparison layer by layer.

On a rank of a (1, tp) mesh (``group``; every family of this model) the
layers hold their blocks by the reference's pspecs
(``models.common.Topo``): attention (MLA and the vlm's cross-attention
too) and MLP Megatron-style, MoE by its placement (``models.moe``), Mamba
over its channels (``models.ssm``).  ``prefill`` keeps the residual stream
sharded over the sequence (whole when tp does not divide the prompt, the
reference's fallback to replication), gathers the last position's normed
row from the rank that holds it and returns the logits whole on every
rank, the attention caches whole and a Mamba layer's caches the rank's
channels.  ``decode_step`` keeps the residual whole and reads attention
caches sharded over the sequence when the engine passes their length
(``cache_len``), each rank holding its run (a cross layer's cache its run
of the ``num_image_tokens`` memory positions, or all of them where tp
does not divide them), and a Mamba layer's caches over its channels.

The vlm's cross-attention sublayer (the last layer of each period of
``cross_attn_period``) is gated: its output times ``tanh(gate)``, taken in
float32 and cast to the output's dtype; the gate is zero at init, as in the
reference.  A MoE sublayer's load-balancing loss is dropped in serving, as
the reference's ``prefill`` and ``decode_step`` drop it, and summed over
the layers in ``loss``.
"""
from __future__ import annotations

import threading

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, MLAttention
from repro_torch.models.common import (NOT_RUN, ONE_DEVICE, ParamDef,
                                       ParamModule, ParamStore, Topo,
                                       init_param_, maybe_remat)
from repro_torch.models.layers import Embedding, Mlp, Norm, chunked_ce_loss
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import MambaBlock


# one whole-tensor draw at a time among the ranks of a process
_WHOLE_DRAWS = threading.Lock()


class SubLayer(nn.Module):
    """A norm and a block; ``gated`` adds the vlm's (1,) residual gate."""

    def __init__(self, name: str, kind: str, norm: Norm, block: nn.Module,
                 gated: bool = False, *, device=None, dtype=None):
        super().__init__()
        self.name, self.kind, self.gated = name, kind, gated
        self.norm, self.core = norm, block
        if gated:
            self.defs = {"gate": ParamDef((1,), (None,), init="zeros")}
            self.gate = nn.Parameter(torch.empty(
                1, dtype=dtype or torch.bfloat16, device=device),
                requires_grad=False)

    def gate_out(self, out: torch.Tensor) -> torch.Tensor:
        if not self.gated:
            return out
        return torch.tanh(self.gate.to(torch.float32)).to(out.dtype) * out


def apply_sublayer(sub: SubLayer, x: torch.Tensor, positions: torch.Tensor,
                   memory: torch.Tensor | None = None,
                   seq_sharded: bool = False):
    """One sublayer's block on its normed input over a prompt (a cross
    block over ``memory``): ``(out, its cache entry)``, the entry ``None``
    for a MoE or MLP block; a gated block's output is gated.  On a rank,
    ``seq_sharded``: x and out are the rank's run of the sequence."""
    if sub.kind in ("attn", "cross"):
        out, (k, v) = sub.core(x, positions, return_kv=True, memory=memory,
                               seq_sharded=seq_sharded)
        return sub.gate_out(out), {"k": k, "v": v}
    if sub.kind == "mla":
        out, (ckv, krope) = sub.core(x, positions, return_kv=True,
                                     seq_sharded=seq_sharded)
        return out, {"ckv": ckv, "krope": krope}
    if sub.kind == "mamba":
        out, (state, conv) = sub.core(x, return_state=True,
                                      seq_sharded=seq_sharded)
        return out, {"state": state, "conv": conv}
    if sub.kind == "moe":
        return sub.core(x, seq_sharded=seq_sharded)[0], None
    return sub.core(x, seq_sharded=seq_sharded), None


def decode_sublayer(sub: SubLayer, x: torch.Tensor, t: int,
                    entry: dict, lo: int | None = None) -> torch.Tensor:
    """One sublayer's block on its normed input at decode position ``t``;
    ``entry`` holds this period's cache slices, written in place (a cross
    block's only read); on a rank, positions [lo, ...) of a
    sequence-sharded cache (``lo`` None: the whole cache; a cross block's
    ``lo`` is its run of the memory)."""
    if sub.kind in ("attn", "cross"):
        return sub.gate_out(sub.core.decode(x, t, entry["k"], entry["v"],
                                            lo)[0])
    if sub.kind == "mla":
        return sub.core.decode(x, t, entry["ckv"], entry["krope"], lo)[0]
    if sub.kind == "mamba":
        return sub.core.decode(x, t, entry["state"], entry["conv"])[0]
    if sub.kind == "moe":
        return sub.core(x)[0]
    return sub.core(x)


def _attn_layout(cfg: ModelConfig, topo: Topo, kind: str) -> str:
    if kind == "decode":
        return "decode_rp"
    tp = topo.axis_size("tp")
    if cfg.num_heads and cfg.num_heads % max(tp, 1) == 0:
        return "megatron"
    return "fsdp_sp"


def _moe_placement(cfg: ModelConfig, topo: Topo, kind: str) -> str:
    tp = topo.axis_size("tp")
    ep_ok = cfg.moe_num_experts % max(tp, 1) == 0
    if kind == "decode":
        return "ep_decode" if ep_ok else "tp_decode"
    return "ep" if ep_ok else "gathered"


def build_period(cfg: ModelConfig, topo: Topo, kind: str, *, device,
                 dtype=None, group=None) -> tuple[list[SubLayer], int]:
    """Sublayers of one period + number of periods; with a ``group``, the
    period's blocks on that rank."""
    layout = _attn_layout(cfg, topo, kind)
    if cfg.family == "hybrid":
        period_len = cfg.attn_period
    elif cfg.family == "vlm":
        period_len = cfg.cross_attn_period
    elif cfg.layers_per_period and \
            cfg.num_layers % cfg.layers_per_period == 0:
        period_len = cfg.layers_per_period
    else:
        period_len = 1

    def norm(n: str) -> Norm:
        return Norm(f"{n}/norm", cfg.d_model, cfg.norm_type, cfg.norm_eps,
                    device=device, dtype=dtype)

    subs: list[SubLayer] = []
    for j in range(period_len):
        # ---- mixer ----
        if cfg.family == "ssm" or (cfg.family == "hybrid"
                                   and not cfg.is_attn_layer(j)):
            n = f"l{j}_mamba"
            subs.append(SubLayer(n, "mamba", norm(n), MambaBlock(
                f"{n}/core", cfg.d_model, cfg.d_inner, cfg.ssm_state,
                cfg.ssm_conv, cfg.dt_rank,
                layout=layout if kind == "decode" else "megatron",
                scan_impl=cfg.ssm_scan_impl, device=device, dtype=dtype,
                topo=topo, group=group)))
        elif cfg.use_mla:
            n = f"l{j}_mla"
            subs.append(SubLayer(n, "mla", norm(n), MLAttention(
                f"{n}/core", cfg.d_model, cfg.num_heads, cfg.kv_lora_rank,
                cfg.mla_qk_nope, cfg.qk_rope_dim, cfg.mla_v_dim,
                layout="decode_rp" if kind == "decode" else "megatron",
                rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                device=device, dtype=dtype, topo=topo, group=group)))
        else:
            n = f"l{j}_attn"
            subs.append(SubLayer(n, "attn", norm(n), Attention(
                f"{n}/core", cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, layout=layout, rope_theta=cfg.rope_theta,
                use_rope=cfg.rope_theta > 0, qkv_bias=cfg.qkv_bias,
                out_bias=cfg.attn_out_bias, device=device, dtype=dtype,
                topo=topo, group=group)))
        # ---- vlm cross-attention on the last layer of each period ----
        if cfg.family == "vlm" and j == period_len - 1:
            n = f"l{j}_cross"
            subs.append(SubLayer(n, "cross", norm(n), Attention(
                f"{n}/core", cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, layout=layout, use_rope=False, is_cross=True,
                causal=False, device=device, dtype=dtype, topo=topo,
                group=group), gated=True, device=device, dtype=dtype))
        # ---- ffn ----
        if cfg.is_moe_layer(j):
            n = f"l{j}_moe"
            subs.append(SubLayer(n, "moe", norm(n), MoE(
                f"{n}/core", cfg.d_model, cfg.moe_num_experts, cfg.moe_top_k,
                cfg.moe_d_ff, num_shared=cfg.moe_num_shared,
                group_size=cfg.moe_group_size,
                capacity_factor=cfg.capacity_factor,
                placement=_moe_placement(cfg, topo, kind), device=device,
                dtype=dtype, topo=topo, group=group)))
        elif cfg.d_ff:
            n = f"l{j}_mlp"
            subs.append(SubLayer(n, "mlp", norm(n), Mlp(
                f"{n}/core", cfg.d_model, cfg.d_ff, cfg.mlp_activation,
                zero3=kind != "decode", device=device, dtype=dtype,
                topo=topo, group=group)))
    return subs, cfg.num_layers // period_len


class ModelBase(nn.Module):
    """What ``LM`` and the enc-dec model share: the device of their
    embedding table, their defs by state-dict name, the seeded init, and
    on a rank which sequences are cut over the ranks."""

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _runs(self) -> None:
        """Raise unless this model can run: a layout over several devices
        runs on one of its ranks (a model built without the group holds
        whole tensors and only describes the layout)."""
        n = self.topo.axis_size("all")
        if n > 1 and self.group is None:
            raise ValueError(f"{self.cfg.name}: laid out over {n} devices; "
                             f"build it with the group of one rank to run "
                             f"it")

    def seq_sharded(self, n: int) -> bool:
        """A length-n sequence (a prompt, a cache) is cut over the ranks:
        on a rank, when tp divides n."""
        return self.group is not None and \
            self.topo.resolve("seq_tp", n) is not None

    def cache_start(self, cache_len: int | None) -> int | None:
        """The first position of this rank's run of a sequence-sharded
        cache of ``cache_len`` positions, or None where it holds the cache
        whole."""
        if cache_len is None or not self.seq_sharded(cache_len):
            return None
        return self.group.rank * (cache_len // self.group.size)

    def param_defs(self) -> ParamStore:
        """Every parameter's def under its state-dict name."""
        store = ParamStore()
        for mod_name, mod in self.named_modules():
            for path, d in getattr(mod, "defs", {}).items():
                store.add(f"{mod_name}.{path}" if mod_name else path, d)
        return store

    def blocks(self, rank: int | None = None) -> dict[str, tuple]:
        """Every parameter's index into its whole tensor, by state-dict
        name: rank ``rank``'s block (this rank's by default), or the whole
        tensor off a rank."""
        out = {}
        for mod_name, mod in self.named_modules():
            for path, d in getattr(mod, "defs", {}).items():
                name = f"{mod_name}.{path}" if mod_name else path
                out[name] = mod.block(path, rank) \
                    if getattr(mod, "tp_group", None) is not None \
                    else tuple(slice(0, n) for n in d.shape)
        return out

    def cut_params(self) -> list[str]:
        """The parameters a rank holds a block of, not the whole tensor."""
        defs = self.param_defs().defs
        return [name for name, p in self.named_parameters()
                if tuple(p.shape) != defs[name].shape]

    def grad_shares(self, seq_len: int) -> list[str]:
        """The parameters each rank holds whole whose gradient on a rank is
        its share of the whole gradient over a length-``seq_len`` batch
        (``ParamModule.grad_shares``: the norms' on the rank's run of the
        sequence, or a bias that meets the rank's heads only); the train
        step sums them over the ranks.  Off a rank, none."""
        if self.group is None:
            return []
        seq = self.seq_sharded(seq_len)
        return [f"{mod_name}.{path}" if mod_name else path
                for mod_name, mod in self.named_modules()
                if isinstance(mod, ParamModule)
                for path in mod.grad_shares(seq)]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator,
                    decode: "ModelBase | None" = None) -> None:
        """Seeded init in place, parameters in sorted name order.  A
        parameter that holds a rank's block is drawn whole on the
        generator's device, as one device draws it, and its block kept, so
        every rank keeps blocks of the same tensors; ``decode`` (the same
        parameters in the decode layout, the engine's decode model) keeps
        its blocks from the same draw, where it does not share the
        tensor.  The ranks of one process (threads) draw their whole
        tensors one at a time, so a card that holds several ranks holds
        one whole tensor beside their blocks, not one a rank."""
        params = dict(self.named_parameters())
        defs = self.param_defs().defs
        blocks = self.blocks()
        if decode is not None:
            dec_params, dec_blocks = dict(decode.named_parameters()), \
                decode.blocks()
        for name in sorted(params):
            p, d = params[name], defs[name]
            if tuple(p.shape) == d.shape and decode is None:
                init_param_(p, d, generator)
                continue
            with _WHOLE_DRAWS:
                whole = init_param_(torch.empty(d.shape, dtype=p.dtype,
                                                device=generator.device),
                                    d, generator)
                p.copy_(whole[blocks[name]])
                if decode is not None and dec_params[name] is not p:
                    dec_params[name].copy_(whole[dec_blocks[name]])
                del whole


class LM(ModelBase):
    """Decoder-only language model, the periods unrolled into layers.

    ``dtype`` overrides every parameter's dtype (the reference's defs are
    bfloat16); ``None`` keeps the defs' own."""

    def __init__(self, cfg: ModelConfig, topo: Topo = ONE_DEVICE,
                 kind: str = "prefill", *, device="cuda", dtype=None,
                 group=None):
        super().__init__()
        if kind not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown kind {kind!r}")
        dev = resolve_device(device)
        self.cfg, self.topo, self.kind = cfg, topo, kind
        self.group = group = rank_group(cfg, topo, group)
        period, self.n_periods = build_period(cfg, topo, kind, device=dev,
                                              dtype=dtype, group=group)
        self.period_kinds = [(s.name, s.kind) for s in period]
        layers = [nn.ModuleDict({s.name: s for s in period})]
        for _ in range(self.n_periods - 1):
            sub, _ = build_period(cfg, topo, kind, device=dev, dtype=dtype,
                                  group=group)
            layers.append(nn.ModuleDict({s.name: s for s in sub}))
        self.layers = nn.ModuleList(layers)
        self.embed = Embedding("embed", cfg.padded_vocab, cfg.d_model,
                               tie=cfg.tie_embeddings, device=dev,
                               dtype=dtype, topo=topo, group=group)
        self.final_norm = Norm("final_norm", cfg.d_model, cfg.norm_type,
                               cfg.norm_eps, device=dev, dtype=dtype)

    # ------------------------------------------------------------------
    def _memory(self, batch: dict) -> torch.Tensor | None:
        """The vlm's image embeddings on the model's device, else None."""
        mem = batch.get("image_embeds")
        return None if mem is None else torch.as_tensor(mem,
                                                        device=self.device)

    def _apply_layer(self, layer: nn.ModuleDict, h: torch.Tensor,
                     positions: torch.Tensor, memory=None,
                     seq_sharded: bool = False):
        kvs = {}
        for name, _ in self.period_kinds:
            sub = layer[name]
            out, kv = apply_sublayer(sub, sub.norm(h), positions, memory,
                                     seq_sharded)
            if kv is not None:
                kvs[name] = kv
            h = h + out
        return h, kvs

    def _train_layer(self, layer: nn.ModuleDict, h: torch.Tensor,
                     positions: torch.Tensor, memory=None,
                     seq_sharded: bool = False):
        """One layer's sublayers over the residual stream (a vlm's cross
        sublayer over ``memory``, gated): (h, the layer's MoE
        load-balancing loss, float32).  On a rank, h is its run of the
        sequence when ``seq_sharded``."""
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for name, kind in self.period_kinds:
            sub = layer[name]
            x = sub.norm(h)
            if kind == "moe":
                out, aux_i = sub.core(x)
                aux = aux + aux_i
            elif kind in ("attn", "mla"):
                out = sub.core(x, positions, seq_sharded=seq_sharded)
            elif kind == "cross":
                out = sub.gate_out(sub.core(x, positions, memory=memory))
            elif kind in ("mamba", "mlp"):
                out = sub.core(x, seq_sharded=seq_sharded)
            else:
                raise ValueError(f"unknown sublayer kind {kind!r}")
            h = h + out
        return h, aux

    def loss(self, batch: dict):
        """batch {"tokens", "labels": (b, s)[, "image_embeds": (b, m, d)]}
        -> (loss + 0.01 aux, {"loss": the mean cross-entropy, "aux_loss":
        the MoE layers' summed load-balancing loss}), float32 scalars with
        their graph.  On a rank (the dense and ssm families) every rank
        holds the whole batch and the same loss, the mean over all its
        tokens; the residual is cut over the sequence where tp divides
        it (Megatron-SP), else replicated, and each rank's backward
        gives its blocks' gradients (a parameter it holds whole: its
        share where ``grad_shares`` names it)."""
        cfg = self.cfg
        if self.group is not None:
            self._trains()
        self._runs()
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        seq = self.seq_sharded(tokens.shape[1])
        h = self.embed.embed(tokens, seq)
        positions = torch.arange(tokens.shape[1], device=self.device)
        memory = self._memory(batch)
        layer_fn = maybe_remat(self._train_layer,
                               cfg.remat and self.kind == "train")
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer in self.layers:
            h, aux_i = layer_fn(layer, h, positions, memory, seq)
            aux = aux + aux_i
        h = self.final_norm(h)
        loss = chunked_ce_loss(self.embed, h, labels, cfg.vocab_size, seq)
        return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}

    def _trains(self) -> None:
        """Raise ``NotImplementedError`` for a sublayer that does not train
        over ranks yet: MoE, MLA and cross-attention."""
        kinds = sorted({k for _, k in self.period_kinds}
                       & {"moe", "mla", "cross"})
        if kinds:
            raise NotImplementedError(
                f"{self.cfg.name}: sharded training of {', '.join(kinds)} "
                f"sublayers {NOT_RUN}")

    @torch.no_grad()
    def prefill(self, batch: dict):
        """batch {"tokens": (b, s)[, "image_embeds": (b, m, d)]} ->
        (logits (b, padded_vocab) float32, caches {sublayer: {"k", "v":
        (n_periods, b, s, KV, dh)} (a cross layer's over m),
        {"ckv": (n_periods, b, s, lora), "krope": (n_periods, b, s, rope)}
        or {"state": (n_periods, b, di, ds), "conv": (n_periods, b, K-1,
        di)}}).  On a rank the logits and the attention caches are whole,
        a Mamba layer's caches the rank's channels (di/tp of di)."""
        self._runs()
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        seq = self.seq_sharded(tokens.shape[1])
        h = self.embed.embed(tokens, seq)
        positions = torch.arange(tokens.shape[1], device=self.device)
        memory = self._memory(batch)
        per_layer = []
        for layer in self.layers:
            h, kvs = self._apply_layer(layer, h, positions, memory, seq)
            per_layer.append(kvs)
        h = self.final_norm(h)
        last = h[:, -1]
        if seq:                  # the last position is the last rank's
            last = self.group.broadcast(last.contiguous(),
                                        self.group.size - 1)
        logits = self.embed.logits(last)
        caches = {name: {key: torch.stack([kv[name][key] for kv in per_layer])
                         for key in entry}
                  for name, entry in per_layer[0].items()}
        return logits, caches

    def promote_conv(self, caches: dict, dtype: torch.dtype) -> None:
        """The reference's decode concatenates its bfloat16 conv cache with
        the new x, so from the first step on a Mamba layer's conv cache has
        the promoted dtype (float32 with float32 parameters)."""
        for name, kind in self.period_kinds:
            if kind == "mamba":
                conv = caches[name]["conv"]
                caches[name]["conv"] = conv.to(
                    torch.promote_types(conv.dtype, dtype))

    @torch.no_grad()
    def decode_step(self, caches: dict, tokens: torch.Tensor, t: int,
                    cache_len: int | None = None):
        """tokens (b,) at position t -> (logits (b, padded_vocab) float32,
        caches updated in place).  On a rank, ``cache_len`` is the whole
        caches' length, of which a cache that tp divides holds the rank's
        run (``cache_start``), a cross layer's cache its run of the
        ``num_image_tokens``; without it the caches are whole."""
        self._runs()
        lo = self.cache_start(cache_len)
        lo_x = None if cache_len is None \
            else self.cache_start(self.cfg.num_image_tokens)
        h = self.embed.embed(torch.as_tensor(tokens,
                                             device=self.device).long())
        self.promote_conv(caches, h.dtype)
        for i, layer in enumerate(self.layers):
            for name, kind in self.period_kinds:
                sub = layer[name]
                entry = {key: c[i] for key, c in caches.get(name, {}).items()}
                h = h + decode_sublayer(sub, sub.norm(h), t, entry,
                                        lo_x if kind == "cross" else lo)
        h = self.final_norm(h)
        return self.embed.logits(h), caches

    def cache_shape_structs(self, batch: int, seq: int) -> dict:
        """(shape, dtype) of every decode cache, stacked over periods, as in
        the reference's ``cache_shape_structs``: k and v bfloat16 (a cross
        layer's over the ``num_image_tokens`` of its memory), an MLA
        layer's latent and rope key bfloat16, a Mamba layer's state float32
        and its conv window bfloat16."""
        cfg, n = self.cfg, self.n_periods
        kvd = (n, batch, seq, cfg.num_kv_heads, cfg.head_dim)
        out = {}
        for name, kind in self.period_kinds:
            if kind == "attn":
                out[name] = {"k": (kvd, torch.bfloat16),
                             "v": (kvd, torch.bfloat16)}
            elif kind == "cross":
                kvx = (n, batch, cfg.num_image_tokens, cfg.num_kv_heads,
                       cfg.head_dim)
                out[name] = {"k": (kvx, torch.bfloat16),
                             "v": (kvx, torch.bfloat16)}
            elif kind == "mla":
                out[name] = {
                    "ckv": ((n, batch, seq, cfg.kv_lora_rank),
                            torch.bfloat16),
                    "krope": ((n, batch, seq, cfg.qk_rope_dim),
                              torch.bfloat16)}
            elif kind == "mamba":
                out[name] = {
                    "state": ((n, batch, cfg.d_inner, cfg.ssm_state),
                              torch.float32),
                    "conv": ((n, batch, cfg.ssm_conv - 1, cfg.d_inner),
                             torch.bfloat16)}
        return out

    def cache_pspecs(self, batch: int, seq: int) -> dict:
        """The reference's ``cache_pspecs``: each cache's pspec under
        ``topo``, congruent with ``cache_shape_structs``."""
        return {name: {key: self.topo.pspec(CACHE_AXES[key], shape)
                       for key, (shape, _) in entry.items()}
                for name, entry in self.cache_shape_structs(batch,
                                                            seq).items()}


#: the logical axes of each cache (stacked over periods), as the
#: reference's ``cache_pspecs`` names them
CACHE_AXES = {
    "k": (None, "batch", "seq_tp", None, None),
    "v": (None, "batch", "seq_tp", None, None),
    "ckv": (None, "batch", "seq_tp", None),
    "krope": (None, "batch", "seq_tp", None),
    "state": (None, "batch", "tp", None),
    "conv": (None, "batch", None, "tp"),
}


def rank_group(cfg: ModelConfig, topo: Topo, group):
    """The group a model of ``cfg`` runs its rank in: None on one device
    (a group of one rank included), else ``group``, checked against the
    mesh.  Every family and MLA serves over ranks, and the dense and ssm
    families train; a mesh with data > 1 raises ``NotImplementedError``
    (``Topo.tp``), as do ``fsdp_sp`` attention (``Attention``) and the
    training of MoE, MLA and cross sublayers (``loss``)."""
    if group is None:
        return None
    tp = topo.tp
    if group.size != tp:
        raise ValueError(f"a group of {group.size} ranks for a mesh of "
                         f"tp = {tp}")
    return None if tp == 1 else group
