"""Whisper-style encoder-decoder backbone (the ``audio`` family).

The conv/mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (b, frames, d_model).  Positions
are sinusoidal on both sides.  The encoder is non-causal self-attention and
an MLP per layer, then ``enc_final_norm``; each decoder layer is causal
self-attention, cross-attention over the encoder's output, then the MLP.
Every attention goes through ``ops.flash_attention`` in prefill (the CUDA
kernel on the card); whisper's LayerNorm has no kernel and stays plain
PyTorch (``layers.Norm``).

The parameter names mirror the reference's tree: ``embed.*``,
``enc_final_norm.*``, ``final_norm.*``,
``enc_layers.<i>.{enc_attn,enc_mlp}.{norm,core}.*`` and
``dec_layers.<i>.{dec_self,dec_cross,dec_mlp}.{norm,core}.*``
(``models.convert.params_from_jax`` splits the reference's stacked
``enc_layers`` / ``dec_layers`` leaves).

Entry points, as ``transformer.LM``'s: ``loss(batch)`` with ``frames``,
``tokens`` and ``labels`` -> ``(loss, {"loss", "aux_loss": 0})`` (no
auxiliary term, as the reference's), each encoder and decoder layer
recomputed in the backward when ``cfg.remat`` and ``kind == "train"``;
``prefill(batch)`` with ``frames``
and ``tokens`` -> ``(last-token float32 logits, caches)``, the caches
``{"self": {"k", "v"}, "cross": {"k", "v"}}`` stacked over decoder layers;
``decode_step(caches, tokens, t)`` writes the new token's self-attention k
and v in place and reads the cross caches; ``cache_shape_structs(batch,
seq, memory_len=)``.  A float32 ``frames`` promotes the encoder (and the
cross caches) to float32 through bfloat16 weights, as jnp does.

On a rank of a (1, tp) mesh (``group``) every block holds its blocks by
the reference's pspecs, as ``transformer.LM``'s dense layers do: the
encoder runs ``megatron`` over the frames with its residual
sequence-sharded (whole where tp does not divide the frames), and its
normed output is gathered once, the memory of every cross layer; the
decoder's prefill keeps its residual sequence-sharded over the prompt and
its decode runs ``decode_rp``.  ``prefill`` returns the logits and every
cache whole on every rank; ``decode_step`` reads the self caches sharded
over ``cache_len`` and the cross caches over ``memory_len`` (each the
rank's run where tp divides the length, else whole).  Sharded training
is not ported (ROADMAP.md queue 1).
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.common import NOT_RUN, ONE_DEVICE, Topo, maybe_remat
from repro_torch.models.layers import (Embedding, Mlp, Norm, chunked_ce_loss,
                                       seq_run)
from repro_torch.models.transformer import (ModelBase, SubLayer,
                                            apply_sublayer, decode_sublayer,
                                            rank_group)


@functools.lru_cache(maxsize=None)
def _frequencies(dim: int, device: torch.device) -> torch.Tensor:
    """exp(-log(10000) i / (half - 1)) in float32, made on the host once per
    device (a host-to-device copy at every step would wait for the card).
    A constant, not a step's work: made outside any dispatch mode (a cost
    counter), so a step counts the same whether or not it is the first."""
    half = dim // 2
    f32 = torch.float32
    with _disable_current_modes():
        freqs = torch.exp(torch.tensor(-math.log(10000.0), dtype=f32)
                          * torch.arange(half, dtype=f32)
                          / torch.tensor(float(max(half - 1, 1)), dtype=f32))
        return freqs.to(device)


def sinusoidal(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(s,) integer -> (s, dim) float32 sinusoidal embeddings."""
    freqs = _frequencies(dim, positions.device)
    ang = positions[:, None].to(torch.float32) * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# the decoder's cache groups and the sublayers that fill them
_CACHED = (("self", "dec_self"), ("cross", "dec_cross"))


class EncDecLM(ModelBase):
    def __init__(self, cfg: ModelConfig, topo: Topo = ONE_DEVICE,
                 kind: str = "prefill", *, device="cuda", dtype=None,
                 group=None):
        super().__init__()
        if kind not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown kind {kind!r}")
        dev = resolve_device(device)
        self.cfg, self.topo, self.kind = cfg, topo, kind
        self.group = group = rank_group(cfg, topo, group)
        layout = "decode_rp" if kind == "decode" else (
            "megatron" if cfg.num_heads % max(topo.axis_size("tp"), 1) == 0
            else "fsdp_sp")
        d = cfg.d_model

        def norm(n: str) -> Norm:
            return Norm(f"{n}/norm", d, cfg.norm_type, cfg.norm_eps,
                        device=dev, dtype=dtype)

        def attn(n: str, causal: bool = True, cross: bool = False,
                 lo: str = layout) -> SubLayer:
            return SubLayer(n, "cross" if cross else "attn", norm(n),
                            Attention(f"{n}/core", d, cfg.num_heads,
                                      cfg.num_kv_heads, cfg.head_dim,
                                      layout=lo, use_rope=False,
                                      qkv_bias=cfg.qkv_bias,
                                      out_bias=cfg.attn_out_bias,
                                      causal=causal, is_cross=cross,
                                      device=dev, dtype=dtype, topo=topo,
                                      group=group))

        def mlp(n: str, zero3: bool = True) -> SubLayer:
            return SubLayer(n, "mlp", norm(n), Mlp(
                f"{n}/core", d, cfg.d_ff, cfg.mlp_activation, zero3=zero3,
                device=dev, dtype=dtype, topo=topo, group=group))

        # the encoder runs over the whole input, even for a decode model
        enc_layout = "megatron" if kind != "decode" else "decode_rp"
        self.enc_layers = nn.ModuleList(
            nn.ModuleDict({"enc_attn": attn("enc_attn", causal=False,
                                            lo=enc_layout),
                           "enc_mlp": mlp("enc_mlp")})
            for _ in range(cfg.num_encoder_layers))
        self.dec_layers = nn.ModuleList(
            nn.ModuleDict({"dec_self": attn("dec_self"),
                           "dec_cross": attn("dec_cross", cross=True),
                           "dec_mlp": mlp("dec_mlp", kind != "decode")})
            for _ in range(cfg.num_layers))
        self.embed = Embedding("embed", cfg.padded_vocab, d, device=dev,
                               dtype=dtype, topo=topo, group=group)
        self.enc_final_norm = Norm("enc_final_norm", d, cfg.norm_type,
                                   cfg.norm_eps, device=dev, dtype=dtype)
        self.final_norm = Norm("final_norm", d, cfg.norm_type, cfg.norm_eps,
                               device=dev, dtype=dtype)

    # ------------------------------------------------------------------
    @staticmethod
    def _enc_layer(layer: nn.ModuleDict, h: torch.Tensor,
                   pos: torch.Tensor, seq: bool = False) -> torch.Tensor:
        for sub in layer.values():
            h = h + apply_sublayer(sub, sub.norm(h), pos,
                                   seq_sharded=seq)[0]
        return h

    @staticmethod
    def _dec_layer(layer: nn.ModuleDict, h: torch.Tensor, pos: torch.Tensor,
                   enc: torch.Tensor) -> torch.Tensor:
        """A training decoder layer: self-attention, cross-attention over
        ``enc``, the MLP."""
        for name in ("dec_self", "dec_cross"):
            sub = layer[name]
            h = h + sub.core(sub.norm(h), pos, memory=enc)
        sub = layer["dec_mlp"]
        return h + sub.core(sub.norm(h))

    def _encode(self, frames) -> torch.Tensor:
        """frames (b, s_enc, d) stub embeddings -> the encoder's output, in
        the dtype the frames promote to, with its graph; on a rank, whole
        (gathered over the frames when they were cut)."""
        h = torch.as_tensor(frames, device=self.device)
        pos = torch.arange(h.shape[1], device=self.device)
        h = h + sinusoidal(pos, self.cfg.d_model)[None].to(h.dtype)
        seq = self.seq_sharded(h.shape[1])
        if seq:
            h = seq_run(h, self.group)
        layer_fn = maybe_remat(self._enc_layer,
                               self.cfg.remat and self.kind == "train")
        for layer in self.enc_layers:
            h = layer_fn(layer, h, pos, seq)
        h = self.enc_final_norm(h)
        return self.group.all_gather(h, 1) if seq else h

    @torch.no_grad()
    def encode(self, frames) -> torch.Tensor:
        """``_encode`` without a graph (serving)."""
        return self._encode(frames)

    def _embed(self, tokens: torch.Tensor, positions: torch.Tensor,
               seq: bool = False):
        """Token embeddings plus sinusoidal positions; with ``seq`` the
        rank's run of the sequence."""
        h = self.embed.embed(tokens, seq)
        if seq:
            positions = seq_run(positions[None], self.group)[0]
        return h + sinusoidal(positions, self.cfg.d_model).to(h.dtype)

    def loss(self, batch: dict):
        """batch {"frames": (b, m, d), "tokens", "labels": (b, s)} ->
        (loss, {"loss": the mean cross-entropy, "aux_loss": 0}), float32
        scalars, the loss with its graph."""
        cfg = self.cfg
        if self.group is not None:
            raise NotImplementedError(f"sharded training {NOT_RUN}")
        enc = self._encode(batch["frames"])
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        pos = torch.arange(tokens.shape[1], device=self.device)
        h = self._embed(tokens, pos)
        layer_fn = maybe_remat(self._dec_layer,
                               cfg.remat and self.kind == "train")
        for layer in self.dec_layers:
            h = layer_fn(layer, h, pos, enc)
        h = self.final_norm(h)
        loss = chunked_ce_loss(self.embed, h, labels, cfg.vocab_size)
        return loss, {"loss": loss, "aux_loss": torch.zeros(
            (), dtype=torch.float32, device=self.device)}

    @torch.no_grad()
    def prefill(self, batch: dict):
        """batch {"frames": (b, m, d), "tokens": (b, s)} -> (logits (b,
        padded_vocab) float32, caches {"self": {"k", "v": (L, b, s, KV,
        dh)}, "cross": {"k", "v": (L, b, m, KV, dh)}}); on a rank the
        logits and the caches whole."""
        self._runs()
        enc = self.encode(batch["frames"])
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        pos = torch.arange(tokens.shape[1], device=self.device)
        seq = self.seq_sharded(tokens.shape[1])
        h = self._embed(tokens, pos, seq)
        kvs = {grp: [] for grp, _ in _CACHED}
        for layer in self.dec_layers:
            for grp, name in _CACHED:
                sub = layer[name]
                out, kv = apply_sublayer(sub, sub.norm(h), pos, enc, seq)
                kvs[grp].append(kv)
                h = h + out
            sub = layer["dec_mlp"]
            h = h + sub.core(sub.norm(h), seq_sharded=seq)
        h = self.final_norm(h)
        last = h[:, -1]
        if seq:                  # the last position is the last rank's
            last = self.group.broadcast(last.contiguous(),
                                        self.group.size - 1)
        logits = self.embed.logits(last)
        caches = {grp: {key: torch.stack([kv[key] for kv in entries])
                        for key in ("k", "v")}
                  for grp, entries in kvs.items()}
        return logits, caches

    @torch.no_grad()
    def decode_step(self, caches: dict, tokens: torch.Tensor, t: int,
                    cache_len: int | None = None,
                    memory_len: int | None = None):
        """tokens (b,) at position t -> (logits (b, padded_vocab) float32,
        caches, the self-attention ones updated in place).  On a rank,
        ``cache_len`` and ``memory_len`` are the whole self and cross
        caches' lengths, of which a cache that tp divides holds the rank's
        run; without them the caches are whole."""
        self._runs()
        if (cache_len is None) != (memory_len is None):
            raise ValueError("decode_step: give both cache_len and "
                             "memory_len, or neither")
        los = {"self": self.cache_start(cache_len),
               "cross": self.cache_start(memory_len)}
        tokens = torch.as_tensor(tokens, device=self.device).long()
        pos = torch.full((1,), t, dtype=torch.int64, device=self.device)
        h = self._embed(tokens, pos)
        for i, layer in enumerate(self.dec_layers):
            for grp, name in _CACHED:
                sub = layer[name]
                entry = {key: c[i] for key, c in caches[grp].items()}
                h = h + decode_sublayer(sub, sub.norm(h), t, entry,
                                        los[grp])
            sub = layer["dec_mlp"]
            h = h + sub.core(sub.norm(h))
        h = self.final_norm(h)
        return self.embed.logits(h), caches

    def cache_shape_structs(self, batch: int, seq: int,
                            memory_len: int | None = None) -> dict:
        """(shape, dtype) of the decode caches, bfloat16: ``seq`` sizes the
        growing self-attention caches, ``memory_len`` (default: ``seq``)
        the cross caches over the encoder's output."""
        cfg = self.cfg
        mem = memory_len if memory_len is not None else seq
        kvd = (cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim)
        kvx = (cfg.num_layers, batch, mem, cfg.num_kv_heads, cfg.head_dim)
        return {"self": {"k": (kvd, torch.bfloat16),
                         "v": (kvd, torch.bfloat16)},
                "cross": {"k": (kvx, torch.bfloat16),
                          "v": (kvx, torch.bfloat16)}}

    def cache_pspecs(self, batch: int, seq: int,
                     memory_len: int | None = None) -> dict:
        """The reference's ``cache_pspecs``: every cache sharded over the
        sequence where the mesh divides it."""
        axes = (None, "batch", "seq_tp", None, None)
        return {grp: {key: self.topo.pspec(axes, shape)
                      for key, (shape, _) in entry.items()}
                for grp, entry in self.cache_shape_structs(
                    batch, seq, memory_len).items()}
