"""Decoder-only LM for the dense and ssm families.

The reference scans a repeating *period* of sublayers over stacked
parameters; the port keeps the period (``build_period``) and unrolls the
periods into an ``nn.ModuleList``.  Its parameter names mirror the
reference's tree: ``embed.table``, ``final_norm.scale``,
``layers.<i>.<sublayer>.norm.scale``, ``layers.<i>.<sublayer>.core.<w>``
(``models.convert.params_from_jax`` maps one onto the other).

Entry points:
  * ``prefill(batch)``: ``(last-token float32 logits, caches)``, the caches
    stacked over periods as in the reference;
  * ``decode_step(caches, tokens, t)``: one new token per sequence; writes
    its k and v (or a Mamba layer's state and conv window) into the caches
    in place and returns ``(logits, caches)``.

Other families (moe, hybrid, vlm) and MLA raise ``NotImplementedError``
naming their ROADMAP item; training (``loss``) is not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.common import ONE_DEVICE, ParamStore, Topo, init_param_
from repro_torch.models.layers import Embedding, Mlp, Norm
from repro_torch.models.ssm import MambaBlock

# the ROADMAP item of every family still to port (item 3c); jamba's hybrid
# family has Mamba layers but needs MoE too
_LATER = "MoE, MLA, VLM and enc-dec serving"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1: "
                               f"{item})")


class SubLayer(nn.Module):
    def __init__(self, name: str, kind: str, norm: Norm, block: nn.Module):
        super().__init__()
        self.name, self.kind = name, kind
        self.norm, self.core = norm, block


def _attn_layout(cfg: ModelConfig, topo: Topo, kind: str) -> str:
    if kind == "decode":
        return "decode_rp"
    tp = topo.axis_size("tp")
    if cfg.num_heads and cfg.num_heads % max(tp, 1) == 0:
        return "megatron"
    return "fsdp_sp"


def build_period(cfg: ModelConfig, topo: Topo, kind: str, *, device,
                 dtype=None) -> tuple[list[SubLayer], int]:
    """Sublayers of one period + number of periods (dense and ssm
    families)."""
    if cfg.family not in ("dense", "ssm"):
        raise _not_ported(f"the {cfg.family!r} family", _LATER)
    if cfg.use_mla:
        raise _not_ported("MLA attention", _LATER)
    layout = _attn_layout(cfg, topo, kind)
    if cfg.layers_per_period and cfg.num_layers % cfg.layers_per_period == 0:
        period_len = cfg.layers_per_period
    else:
        period_len = 1

    def norm(n: str) -> Norm:
        return Norm(f"{n}/norm", cfg.d_model, cfg.norm_type, cfg.norm_eps,
                    device=device, dtype=dtype)

    subs: list[SubLayer] = []
    for j in range(period_len):
        if cfg.family == "ssm":
            n = f"l{j}_mamba"
            subs.append(SubLayer(n, "mamba", norm(n), MambaBlock(
                f"{n}/core", cfg.d_model, cfg.d_inner, cfg.ssm_state,
                cfg.ssm_conv, cfg.dt_rank,
                layout=layout if kind == "decode" else "megatron",
                scan_impl=cfg.ssm_scan_impl, device=device, dtype=dtype)))
            continue
        n = f"l{j}_attn"
        subs.append(SubLayer(n, "attn", norm(n), Attention(
            f"{n}/core", cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, layout=layout, rope_theta=cfg.rope_theta,
            use_rope=cfg.rope_theta > 0, qkv_bias=cfg.qkv_bias,
            out_bias=cfg.attn_out_bias, device=device, dtype=dtype)))
        if cfg.d_ff:
            n = f"l{j}_mlp"
            subs.append(SubLayer(n, "mlp", norm(n), Mlp(
                f"{n}/core", cfg.d_model, cfg.d_ff, cfg.mlp_activation,
                device=device, dtype=dtype)))
    return subs, cfg.num_layers // period_len


class LM(nn.Module):
    """Decoder-only language model, the periods unrolled into layers.

    ``dtype`` overrides every parameter's dtype (the reference's defs are
    bfloat16); ``None`` keeps the defs' own."""

    def __init__(self, cfg: ModelConfig, topo: Topo = ONE_DEVICE,
                 kind: str = "prefill", *, device="cuda", dtype=None):
        super().__init__()
        if kind not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown kind {kind!r}")
        dev = resolve_device(device)
        self.cfg, self.topo, self.kind = cfg, topo, kind
        period, self.n_periods = build_period(cfg, topo, kind, device=dev,
                                              dtype=dtype)
        self.period_kinds = [(s.name, s.kind) for s in period]
        layers = [nn.ModuleDict({s.name: s for s in period})]
        for _ in range(self.n_periods - 1):
            sub, _ = build_period(cfg, topo, kind, device=dev, dtype=dtype)
            layers.append(nn.ModuleDict({s.name: s for s in sub}))
        self.layers = nn.ModuleList(layers)
        self.embed = Embedding("embed", cfg.padded_vocab, cfg.d_model,
                               tie=cfg.tie_embeddings, device=dev,
                               dtype=dtype)
        self.final_norm = Norm("final_norm", cfg.d_model, cfg.norm_type,
                               cfg.norm_eps, device=dev, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # ------------------------------------------------------------------
    def param_defs(self) -> ParamStore:
        """Every parameter's def under its state-dict name."""
        store = ParamStore()
        for mod_name, mod in self.named_modules():
            for path, d in getattr(mod, "defs", {}).items():
                store.add(f"{mod_name}.{path}" if mod_name else path, d)
        return store

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Seeded init in place, parameters in sorted name order."""
        params = dict(self.named_parameters())
        defs = self.param_defs().defs
        for name in sorted(params):
            init_param_(params[name], defs[name], generator)

    # ------------------------------------------------------------------
    def _apply_layer(self, layer: nn.ModuleDict, h: torch.Tensor,
                     positions: torch.Tensor):
        kvs = {}
        for name, kind in self.period_kinds:
            sub = layer[name]
            x = sub.norm(h)
            if kind == "attn":
                out, (k, v) = sub.core(x, positions, return_kv=True)
                kvs[name] = {"k": k, "v": v}
            elif kind == "mamba":
                out, (state, conv) = sub.core(x, return_state=True)
                kvs[name] = {"state": state, "conv": conv}
            else:
                out = sub.core(x)
            h = h + out
        return h, kvs

    @torch.no_grad()
    def prefill(self, batch: dict):
        """batch {"tokens": (b, s)} -> (logits (b, padded_vocab) float32,
        caches {sublayer: {"k", "v": (n_periods, b, s, KV, dh)} or
        {"state": (n_periods, b, di, ds), "conv": (n_periods, b, K-1,
        di)}})."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        h = self.embed.embed(tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)
        per_layer = []
        for layer in self.layers:
            h, kvs = self._apply_layer(layer, h, positions)
            per_layer.append(kvs)
        h = self.final_norm(h)
        logits = self.embed.logits(h[:, -1])
        caches = {name: {key: torch.stack([kv[name][key] for kv in per_layer])
                         for key in entry}
                  for name, entry in per_layer[0].items()}
        return logits, caches

    @torch.no_grad()
    def decode_step(self, caches: dict, tokens: torch.Tensor, t: int):
        """tokens (b,) at position t -> (logits (b, padded_vocab) float32,
        caches updated in place)."""
        h = self.embed.embed(torch.as_tensor(tokens,
                                             device=self.device).long())
        for name, kind in self.period_kinds:
            if kind == "mamba":
                # the reference's decode concatenates its bfloat16 conv
                # cache with the new x, so from the first step on the cache
                # has the promoted dtype (float32 with float32 parameters)
                conv = caches[name]["conv"]
                caches[name]["conv"] = conv.to(
                    torch.promote_types(conv.dtype, h.dtype))
        for i, layer in enumerate(self.layers):
            for name, kind in self.period_kinds:
                sub = layer[name]
                x = sub.norm(h)
                if kind == "attn":
                    out, _ = sub.core.decode(x, t, caches[name]["k"][i],
                                             caches[name]["v"][i])
                elif kind == "mamba":
                    out, _ = sub.core.decode(x, t, caches[name]["state"][i],
                                             caches[name]["conv"][i])
                else:
                    out = sub.core(x)
                h = h + out
        h = self.final_norm(h)
        return self.embed.logits(h), caches

    def cache_shape_structs(self, batch: int, seq: int) -> dict:
        """(shape, dtype) of every decode cache, stacked over periods, as in
        the reference's ``cache_shape_structs``: k and v bfloat16, a Mamba
        layer's state float32 and its conv window bfloat16."""
        cfg, n = self.cfg, self.n_periods
        kvd = (n, batch, seq, cfg.num_kv_heads, cfg.head_dim)
        out = {}
        for name, kind in self.period_kinds:
            if kind == "attn":
                out[name] = {"k": (kvd, torch.bfloat16),
                             "v": (kvd, torch.bfloat16)}
            elif kind == "mamba":
                out[name] = {
                    "state": ((n, batch, cfg.d_inner, cfg.ssm_state),
                              torch.float32),
                    "conv": ((n, batch, cfg.ssm_conv - 1, cfg.d_inner),
                             torch.bfloat16)}
        return out
