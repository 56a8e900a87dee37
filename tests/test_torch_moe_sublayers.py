"""The port's bfloat16 MoE, MLA and hybrid models against the reference,
sublayer by sublayer, each port sublayer fed the reference's input.

``test_torch_moe_models.test_bf16_models_agree_up_to_routing_near_ties``
holds the whole bfloat16 models only up to the first MoE layer at which a
nearly tied token routes differently (there the two hidden states part by
O(1), so nothing after it can be compared whole).  Here the reference's
prefill and 8 teacher-forced decode steps of the reduced
granite-moe-3b-a800m, deepseek-v2-236b and jamba-1.5-large-398b (bfloat16
parameters from ``moe_tree`` seed 3, the prompt of ``_prompt``) are
unrolled sublayer by sublayer (``LM._apply_period``'s and
``LM.decode_step``'s order), and at each sublayer the port's norm gets the
reference's residual stream, the port's block the reference's normed
input (and at decode a copy of the reference's cache slices).  So every
layer, step, cache and logit is compared whatever the routing upstream
did.

Tolerances: every norm, block output (attention, MLA, Mamba, MoE, MLP),
cache entry (prefill's and each decode step's update, the Mamba state and
conv window included), final norm and logit within ``BF16_TOL`` (rtol
2e-2 + atol 5e-2, ``test_torch_models``'s: the reference's jnp attention
rounds ``q * scale`` and the softmax weights to bfloat16, the port keeps
them in float32).  A MoE block given the same input in both packages
routes by float32 products of the same bfloat16 operands, summed in
another order, so a choice may flip only at a near tie: every token whose
top-k order differs must have a reference margin (the least gap between
neighbouring probabilities among its first k + 1) below
``SAME_INPUT_NEAR_TIE`` = 1e-4 (``chip_smoke.py``'s, for the card against
the host), a capacity slot may move only in a group where a choice
flipped, and only those tokens are left out of that block's comparison.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import SMOKE_TOPO
from repro_torch.models.transformer import apply_sublayer, decode_sublayer
from test_torch_models import BF16_TOL, _f32
from test_torch_moe_models import (DEEPSEEK, GRANITE, JAMBA, MOE_ARCHS,
                                   _engines, _prompt, top_order)

SAME_INPUT_NEAR_TIE = 1e-4
DECODE_STEPS = 8
KINDS = ("norm", "attn", "mla", "mamba", "moe", "mlp", "cache", "logits")
PHASES = ("prefill", "decode")


def _t(x) -> torch.Tensor:
    """A jax array as a torch tensor of the same dtype (bfloat16 through
    float32, exactly)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


class Comparison:
    """Every comparison of one model: the largest |difference| and the
    largest fraction of ``BF16_TOL`` used, per kind; every comparison
    beyond the tolerance, listed."""

    def __init__(self, arch: str):
        self.arch = arch
        self.err = dict.fromkeys(KINDS, 0.0)
        self.used = dict.fromkeys(KINDS, 0.0)
        self.count = {phase: dict.fromkeys(KINDS, 0) for phase in PHASES}
        self.failures, self.flips, self.margins = [], [], {}

    def note(self, kind: str, got, want, what: str, keep=None) -> None:
        d = want.shape[-1]
        g, w = _f32(got).reshape(-1, d), _f32(want).reshape(-1, d)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if keep is not None:
            g, w = g[keep], w[keep]
        if not w.size:
            return
        err = np.abs(g - w)
        frac = float((err / (BF16_TOL["atol"]
                             + BF16_TOL["rtol"] * np.abs(w))).max())
        self.err[kind] = max(self.err[kind], float(err.max()))
        self.used[kind] = max(self.used[kind], frac)
        self.count[what.split()[0]][kind] += 1
        if not frac <= 1:
            self.failures.append(f"{self.arch} {what}: max|err| "
                                 f"{float(err.max()):.3e}, {frac:.2f} x "
                                 f"BF16_TOL")

    def summary(self) -> str:
        """The numbers ROADMAP queue 3 records: per kind compared, the
        largest |difference| and its share of ``BF16_TOL``; the tokens
        routed differently on the same input; the least routing margin."""
        kinds = ", ".join(
            f"{k} {self.err[k]:.3g} ({self.used[k]:.2f})" for k in KINDS
            if any(count[k] for count in self.count.values()))
        return (f"{self.arch}: {kinds}; {len(self.flips)} token(s) routed "
                f"differently; least margin {min(self.margins.values()):.3g}")

    def raise_failures(self, phase: str = "") -> None:
        """Every failure (of ``phase``, "prefill" or "decode", if given)."""
        failed = [f for f in self.failures
                  if f.startswith(f"{self.arch} {phase}")]
        if failed:
            raise AssertionError(f"{len(failed)} comparison(s) beyond "
                                 f"BF16_TOL:\n" + "\n".join(failed[:40]))


def route_diff(sub_r, core_r: dict, moe_p, x_r, what: str, cmp: Comparison
               ) -> np.ndarray:
    """Both packages' routings of the reference's MoE input ``x_r``: a
    (tokens,) mask of the tokens whose choices or slots differ.  A flipped
    choice must be a near tie of the reference's probabilities, and a slot
    may move only in a group where a choice flipped."""
    moe_r = sub_r.block
    xs = x_r[:, None, :] if x_r.ndim == 2 else x_r
    b, s, d = xs.shape
    T = b * s
    S = moe_p.group(T)
    xg = xs.reshape(T // S, S, d)
    _, dispatch_r, _ = moe_r._route(core_r, xg)
    probs_r = np.asarray(jax.nn.softmax(jnp.einsum(
        "gsd,de->gse", xg, core_r["router"].astype(xg.dtype),
        preferred_element_type=jnp.float32), axis=-1)).reshape(T, -1)
    topi_r = np.asarray(jax.lax.top_k(probs_r, moe_r.top_k)[1])
    _, margin = top_order(probs_r, moe_r.top_k)
    route = moe_p._route(_t(xg))
    G, _, E, C = dispatch_r.shape
    dispatch_p = torch.zeros((G, S, E, C), dtype=torch.bool)
    g, t, j = torch.nonzero(route.dispatched, as_tuple=True)
    dispatch_p[g, t, route.topi[g, t, j], route.pos[g, t, j]] = True
    flip = np.any(route.topi.reshape(T, -1).numpy() != topi_r, axis=-1)
    moved = np.any(dispatch_p.reshape(T, -1).numpy()
                   != np.asarray(dispatch_r).reshape(T, -1).astype(bool),
                   axis=-1)
    for tok in np.flatnonzero(flip):
        cmp.flips.append(dict(where=what, token=int(tok),
                              margin=float(margin[tok])))
        if margin[tok] >= SAME_INPUT_NEAR_TIE:
            cmp.failures.append(f"{cmp.arch} {what}: token {tok} routes "
                                f"differently on the same input, margin "
                                f"{margin[tok]:.3e} (not below "
                                f"{SAME_INPUT_NEAR_TIE})")
    flip_groups = set((np.flatnonzero(flip) // S).tolist())
    for tok in np.flatnonzero(moved & ~flip):
        if tok // S not in flip_groups:
            cmp.failures.append(f"{cmp.arch} {what}: token {tok}'s slots "
                                f"differ on the same input with no flipped "
                                f"choice in its group")
    cmp.margins[what] = float(margin.min())
    return flip | moved


def sublayer_pass(arch: str, decode: bool, mutate=None) -> Comparison:
    """The reference's prefill (and, with ``decode``, its 8 greedy
    teacher-forced decode steps) unrolled, every port sublayer compared on
    the reference's input; ``mutate(port model)`` first, if given."""
    ref, params, port = _engines(arch, "bfloat16")
    model = port.model
    if mutate is not None:
        with torch.no_grad():
            mutate(model)
    tokens = _prompt(port.cfg)
    b, s = tokens.shape
    cmp = Comparison(arch)
    topo = SMOKE_TOPO
    embed, final = params["embed"], params["final_norm"]

    def layer_params(i):
        return jax.tree.map(lambda a: a[i], params["layers"])

    def head(h_r, step: str):
        hn_r = ref.prefill_model.final_norm(final, h_r)
        cmp.note("norm", model.final_norm(_t(h_r)), hn_r,
                 f"{step} final norm")
        last = hn_r if hn_r.ndim == 2 else hn_r[:, -1]
        logits_r = ref.prefill_model.embedding.logits(embed, last, topo)
        cmp.note("logits", model.embed.logits(_t(last)), logits_r,
                 f"{step} logits")
        return logits_r

    # prefill
    positions = jnp.arange(s, dtype=jnp.int32)
    pos_p = torch.arange(s)
    h = ref.prefill_model.embedding.embed(embed, jnp.asarray(tokens), topo)
    kvs: dict = {}
    with torch.no_grad():
        for i in range(ref.prefill_model.n_periods):
            lp = layer_params(i)
            for sub in ref.prefill_model.period:
                sp, sub_p = lp[sub.name], model.layers[i][sub.name]
                what = f"prefill layer {i} {sub.name}"
                x = sub.norm(sp["norm"], h)
                cmp.note("norm", sub_p.norm(_t(h)), x, f"{what} norm")
                keep, kv = None, None
                if sub.kind in ("attn", "mla"):
                    out, (a, c) = sub.block(sp["core"], x, positions, topo,
                                            return_kv=True)
                    kv = dict(zip(("ckv", "krope") if sub.kind == "mla"
                                  else ("k", "v"), (a, c)))
                elif sub.kind == "mamba":
                    out, (state, conv) = sub.block(sp["core"], x, positions,
                                                   topo, return_state=True)
                    kv = {"state": state, "conv": conv}
                elif sub.kind == "moe":
                    keep = ~route_diff(sub, sp["core"], sub_p.core, x, what,
                                       cmp)
                    out = sub.block(sp["core"], x, topo)[0]
                else:
                    out = sub.block(sp["core"], x, topo)
                got, kv_p = apply_sublayer(sub_p, _t(x), pos_p)
                cmp.note(sub.kind, got, out, f"{what} output",
                         keep)
                for key, c in (kv or {}).items():
                    cmp.note("cache", kv_p[key], c, f"{what} cache {key}")
                    kvs.setdefault(sub.name, {}).setdefault(key, []).append(c)
                h = h + out
        logits = head(h, "prefill")
        if decode:
            caches = ref._pad_caches(
                {name: {key: jnp.stack(v) for key, v in entry.items()}
                 for name, entry in kvs.items()}, b, s)
            decode_steps(ref, params, model, caches, logits, s, cmp,
                         layer_params, head)
    return cmp


def decode_steps(ref, params, model, caches, logits, s, cmp, layer_params,
                 head) -> None:
    """``DECODE_STEPS`` decode steps of the reference, each fed its own
    greedy token; every port sublayer on the reference's normed input and a
    copy of its cache slices, compared with the reference's output and its
    cache update."""
    topo, dm = SMOKE_TOPO, ref.decode_model
    for f in range(DECODE_STEPS):
        t = s + f
        step = f"decode {f}"
        nxt = jnp.argmax(logits[:, :ref.cfg.vocab_size], axis=-1) \
            .astype(jnp.int32)
        h = dm.embedding.embed(params["embed"], nxt, topo)
        tj = jnp.asarray(t, jnp.int32)
        for i in range(dm.n_periods):
            lp = layer_params(i)
            for sub in dm.period:
                sp, sub_p = lp[sub.name], model.layers[i][sub.name]
                what = f"{step} layer {i} {sub.name}"
                x = sub.norm(sp["norm"], h)
                cmp.note("norm", sub_p.norm(_t(h)), x, f"{what} norm")
                keep, new = None, None
                entry = {key: c[i] for key, c in caches.get(sub.name,
                                                            {}).items()}
                if sub.kind in ("attn", "mla", "mamba"):
                    names = {"attn": ("k", "v"), "mla": ("ckv", "krope"),
                             "mamba": ("state", "conv")}[sub.kind]
                    out, cs = sub.block.decode(sp["core"], x, tj,
                                               *(entry[k] for k in names),
                                               topo)
                    new = dict(zip(names, cs))
                elif sub.kind == "moe":
                    keep = ~route_diff(sub, sp["core"], sub_p.core, x, what,
                                       cmp)
                    out = sub.block(sp["core"], x, topo)[0]
                else:
                    out = sub.block(sp["core"], x, topo)
                copy = {key: _t(c) for key, c in entry.items()}
                got = decode_sublayer(sub_p, _t(x), t, copy)
                cmp.note(sub.kind, got, out, f"{what} output",
                         keep)
                for key, c in (new or {}).items():
                    cmp.note("cache", copy[key], c, f"{what} cache {key}")
                    caches[sub.name][key] = caches[sub.name][key].at[i].set(c)
                h = h + out
        logits = head(h, step)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
# (sublayer kinds of the period, MoE sublayers of the model)
MODELS = {GRANITE: ({"attn", "moe"}, 4), DEEPSEEK: ({"mla", "moe"}, 4),
          JAMBA: ({"mamba", "mlp", "attn", "moe"}, 2)}


@functools.lru_cache(maxsize=None)
def _model_pass(arch: str) -> Comparison:
    """One pass of the unmutated model (prefill and decode), shared by the
    prefill test and the decode test."""
    return sublayer_pass(arch, decode=True)


def _check(arch: str, phase: str, forwards: int) -> None:
    """``phase``'s comparisons of ``arch``; prints the model's summary
    (seen with ``pytest -s``)."""
    cmp = _model_pass(arch)
    print(cmp.summary())
    cmp.raise_failures(phase)
    kinds, n_moe = MODELS[arch]
    count = cmp.count[phase]
    assert {k for k in KINDS if count[k]} == kinds | {"norm", "cache",
                                                       "logits"}, count
    assert count["logits"] == forwards
    assert len([w for w in cmp.margins if w.startswith(phase)]) == \
        n_moe * forwards


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_prefill_sublayers_match_the_reference(arch):
    """Every norm, block output and cache entry of the prefill, the final
    norm and the logits, on the reference's inputs, within BF16_TOL."""
    _check(arch, "prefill", 1)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_decode_sublayers_match_the_reference(arch):
    """8 teacher-forced decode steps after the prefill: each sublayer's
    output and cache update on the reference's input and a copy of its
    cache slices, each step's final norm and logits, within BF16_TOL."""
    _check(arch, "decode", DECODE_STEPS)


def _scale_expert(model):
    model.layers[1]["l0_moe"].core.w_down[2] *= 1.1


def _move_router(model):
    r = model.layers[1]["l0_moe"].core.router
    r.add_(0.05 * torch.randn(r.shape, generator=torch.Generator()
                              .manual_seed(0)).to(r.dtype))


def _scale_latent_norm(model):
    model.layers[1]["l0_mla"].core.kv_norm.mul_(1.1)


def _scale_decode(model):
    core = model.layers[2]["l0_attn"].core
    decode = core.decode
    core.decode = lambda *a: (decode(*a)[0] * 1.1, None)


def _scale_mamba_state(model):
    core = model.layers[0]["l0_mamba"].core
    decode = core.decode

    def scaled(x, t, state, conv):
        out = decode(x, t, state, conv)
        state.mul_(2.0)
        return out
    core.decode = scaled


@pytest.mark.parametrize("arch, mutate, decode, where", [
    (GRANITE, _scale_expert, False, "prefill layer 1 l0_moe output"),
    (GRANITE, _move_router, False, "routes differently on the same input"),
    (DEEPSEEK, _scale_latent_norm, False, "prefill layer 1 l0_mla cache ckv"),
    (GRANITE, _scale_decode, True, "decode 0 layer 2 l0_attn output"),
    (JAMBA, _scale_mamba_state, True, "decode 0 layer 0 l0_mamba cache "
                                      "state")],
    ids=["expert", "router", "latent_norm", "decode_only", "mamba_state"])
def test_the_sublayer_check_catches_a_fault(arch, mutate, decode, where):
    """A port model that differs in one expert, the router, MLA's latent
    norm, one layer's decode or one Mamba state update fails there."""
    cmp = sublayer_pass(arch, decode, mutate)
    with pytest.raises(AssertionError, match=where):
        cmp.raise_failures()
