"""Decoder LM (``repro.models.transformer``) for the dense, MoE and
recurrent archs.

A model is: embed (with a frontend's embeddings prepended, llava) ->
one block per layer (an ``nn.ModuleList``, in place of the reference's
dense head blocks, ``lax.scan`` over stacked periods and unrolled tail)
-> final norm -> (tied) LM head.  Layer i has kind
``cfg.layer_kinds[i]``: attention (global or sliding-window), RG-LRU or
RWKV.  Its FFN is an MLP, or in an MoE config ``models/moe.py``'s MoE
past the ``first_k_dense`` head blocks (dense, ``d_ff *
dense_ff_mult`` wide).  Blocks are sequential (x + attn, then + ffn) or
parallel (stablelm: x + attn(n1) + ffn(n1)).

A cache is a list with one dict per layer: {"k", "v"}, each (B, L, KV,
dh), for attention; {"h", "conv"} for RG-LRU; {"wkv", "shift_t",
"shift_c"} for RWKV.  ``convert.lm_cache_from_reference`` maps the
reference's stacked cache onto it.

Parameters come in two forms.  Serving holds a ``Transformer`` module
whose matrices are stored in ``cfg.dtype``.  Training holds a *tree*:
nested dicts (and a list of layers under "blocks") of float32 master
tensors with the module's names, {"embed": {"table"}, "blocks": [...],
"final_norm": {...}, "lm_head": {...}} — the reference's parameter
pytree with its periods unstacked into layers.  ``view`` casts a tree's
leaves to the module's dtypes (inside autograd, so gradients land on the
float32 masters, as the reference's ``pregather_params`` cast does) and
hands the forward the same attribute names a module has.
``init_tree`` draws a tree from a threefry key split for split as the
reference's ``init_params``.  ``lm_loss`` and ``predict_argmax`` run the
LM head in chunks of ``HEAD_CHUNK`` positions, so the (B, S, vocab)
logits never exist at once.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import List

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.configs.base import ATTN, ATTN_LOCAL, RGLRU, RWKV, \
    ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import rwkv as W
from repro_torch.tree_util import tree_map

ATTN_KINDS = (ATTN, ATTN_LOCAL)
HEAD_CHUNK = 512


def _check_ported(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        raise NotImplementedError("encoder-decoder models (models/encdec.py) "
                                  "are not ported yet")
    bad = sorted({k for k in cfg.pattern
                  if k not in ATTN_KINDS + (RGLRU, RWKV)})
    if bad:
        raise ValueError(f"unknown block kinds {bad}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """One layer of kind ``kind``, with the reference's subtree names:
    norm1, norm2 and attn or rglru, then ffn (an MLP ``dense_ff`` wide,
    ``cfg.d_ff`` by default, or with ``use_moe`` an MoE) and gemma2's
    post-norms; an RWKV layer holds norm1, norm2 and tm (time- and
    channel-mix).  A parallel block holds norm2 and never reads it, as
    in the reference."""

    def __init__(self, cfg: ModelConfig, kind, device, generator=None,
                 use_moe=False, dense_ff=None):
        super().__init__()
        self.norm1 = L.Norm(cfg, device)
        self.norm2 = L.Norm(cfg, device)
        if kind == RWKV:
            self.tm = W.RWKV(cfg, device, generator)
            return
        if kind in ATTN_KINDS:
            self.attn = L.Attn(cfg, device, generator)
        else:
            self.rglru = R.RGLRU(cfg, device, generator)
        self.ffn = M.MoE(cfg, device, generator) if use_moe \
            else L.MLP(cfg, device, generator, d_ff=dense_ff)
        if cfg.post_norm:
            self.post_norm1 = L.Norm(cfg, device)
            self.post_norm2 = L.Norm(cfg, device)


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        self.table = L.dense((cfg.vocab_size, cfg.d_model),
                             L.dtype_of(cfg.dtype), device, generator,
                             scale=0.02)


class LMHead(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        self.w = L.dense((cfg.d_model, cfg.vocab_size),
                         L.dtype_of(cfg.dtype), device, generator,
                         scale=0.02)


class Transformer(nn.Module):
    """The parameters of one decoder LM."""

    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        _check_ported(cfg)
        self.embed = Embed(cfg, device, generator)
        fkd = cfg.layer_plan()[0]
        use_moe = cfg.moe is not None
        dense_ff = cfg.d_ff * cfg.moe.dense_ff_mult if use_moe else None
        self.blocks = nn.ModuleList(
            Block(cfg, kind, device, generator, use_moe=use_moe and i >= fkd,
                  dense_ff=dense_ff if i < fkd else None)
            for i, kind in enumerate(cfg.layer_kinds))
        self.final_norm = L.Norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg, device, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random parameters at ``cfg``'s widths, drawn on ``device`` from
    ``generator`` (which must live on that device)."""
    return Transformer(cfg, device, generator)


# ---------------------------------------------------------------------------
# Parameter trees (training)
# ---------------------------------------------------------------------------
def _as_tree(named):
    """{"a.0.b": t} -> {"a": [{"b": t}]}: a module's dotted parameter
    names as nested dicts, with the layer list under "blocks"."""
    tree: dict = {}
    for name, t in named:
        node, parts = tree, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    tree["blocks"] = [tree["blocks"][str(i)]
                      for i in range(len(tree["blocks"]))]
    return tree


@functools.lru_cache(maxsize=None)
def param_dtypes(cfg: ModelConfig):
    """The dtype of every parameter of ``cfg``'s module, as a tree."""
    return _as_tree((n, p.dtype) for n, p in
                    Transformer(cfg, "meta").named_parameters())


def tree_of(params: Transformer):
    """A module's parameters as a float32 tree (copies): the masters a
    training run starts from."""
    return _as_tree((n, p.detach().to(torch.float32).clone())
                    for n, p in params.named_parameters())


def _ns(tree):
    if isinstance(tree, dict):
        return SimpleNamespace(**{k: _ns(v) for k, v in tree.items()})
    if isinstance(tree, list):
        return [_ns(v) for v in tree]
    return tree


def view(cfg: ModelConfig, params):
    """What the forward reads: a module as it is, or a tree's leaves cast
    to the module's dtypes (``cfg.dtype`` for matrices, float32 for
    norms and the leaves the reference reads in float32), under the
    module's attribute names.  The casts are recorded by autograd."""
    if isinstance(params, (Transformer, SimpleNamespace)):
        return params
    return _ns(tree_map(lambda t, dt: t.to(dt), params, param_dtypes(cfg)))


def to_module(cfg: ModelConfig, tree, device=None) -> Transformer:
    """A tree as a serving ``Transformer`` (each leaf cast to the
    module's dtype) on ``device`` (the tree's own by default)."""
    dev = device or tree["embed"]["table"].device
    module = Transformer(cfg, dev)
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[int(part)] if isinstance(node, list) \
                    else node[part]
            p.copy_(node.to(p.dtype))
    return module


def _normal(key, shape, scale):
    return prng.normal(key, shape) * np.float32(scale)


def _dense(key, shape, scale=None):
    return _normal(key, shape, shape[0] ** -0.5 if scale is None else scale)


def _norm_np(cfg):
    p = {"scale": np.ones((cfg.d_model,), np.float32)}
    if cfg.norm == "layernorm":
        p["bias"] = np.zeros((cfg.d_model,), np.float32)
    return p


def _attn_np(cfg, key):
    dh, D = cfg.head_dim_, cfg.d_model
    k1, k2, k3, k4 = prng.split(key, 4)
    return {"wq": _dense(k1, (D, cfg.num_heads * dh)),
            "wk": _dense(k2, (D, cfg.num_kv_heads * dh)),
            "wv": _dense(k3, (D, cfg.num_kv_heads * dh)),
            "wo": _dense(k4, (cfg.num_heads * dh, D))}


def _mlp_np(cfg, key, d_ff=None):
    d_ff = d_ff or cfg.d_ff
    k1, k2, k3 = prng.split(key, 3)
    p = {"w_up": _dense(k1, (cfg.d_model, d_ff)),
         "w_down": _dense(k2, (d_ff, cfg.d_model))}
    if cfg.mlp in L.GATED_MLPS:
        p["w_gate"] = _dense(k3, (cfg.d_model, d_ff))
    return p


def _moe_np(cfg, key):
    """``repro.models.moe.init_moe``'s draws, key reuse included: the
    router and the shared experts' w_down both come from ks[0], the
    experts' w_up and the shared w_gate both from ks[1]; the expert
    tensors are drawn, then scaled by fan_in ** -0.5."""
    m = cfg.moe
    E, D, Fe = m.num_experts, cfg.d_model, cfg.d_ff
    ks = prng.split(key, 5)
    gated = cfg.mlp in L.GATED_MLPS
    p = {"router": _dense(ks[0], (D, E), 0.02),
         "w_up": _normal(ks[1], (E, D, Fe), D ** -0.5),
         "w_down": _normal(ks[2], (E, Fe, D), Fe ** -0.5)}
    if gated:
        p["w_gate"] = _normal(ks[3], (E, D, Fe), D ** -0.5)
    if m.num_shared_experts:
        Fs = m.num_shared_experts * Fe
        sp = {"w_up": _dense(ks[4], (D, Fs)), "w_down": _dense(ks[0], (Fs, D))}
        if gated:
            sp["w_gate"] = _dense(ks[1], (D, Fs))
        p["shared"] = sp
    return p


def _rglru_np(cfg, key):
    D, width = cfg.d_model, cfg.rglru_conv_width
    ks = prng.split(key, 7)
    a0 = prng.uniform(ks[0], (D,), 0.9, 0.999)
    z = -np.log(a0) / np.float32(cfg.rglru_c)
    return {"w_in": _dense(ks[1], (D, D)), "w_gate": _dense(ks[2], (D, D)),
            "conv_w": _normal(ks[3], (width, D), width ** -0.5),
            "conv_b": np.zeros((D,), np.float32),
            "w_a": _dense(ks[4], (D, D)), "w_x": _dense(ks[5], (D, D)),
            "lam": np.log(np.expm1(z)).astype(np.float32),
            "w_out": _dense(ks[6], (D, D))}


def _rwkv_np(cfg, key):
    D, H, dh = cfg.d_model, cfg.num_heads, cfg.rwkv_head_dim
    ks = prng.split(key, 12)

    def mix(k):
        return prng.uniform(k, (D,))

    return {"mu_r": mix(ks[0]), "mu_k": mix(ks[1]), "mu_v": mix(ks[2]),
            "mu_w": mix(ks[3]), "mu_g": mix(ks[4]),
            "w_r": _dense(ks[5], (D, D)), "w_k": _dense(ks[6], (D, D)),
            "w_v": _dense(ks[7], (D, D)), "w_g": _dense(ks[8], (D, D)),
            "w_o": _dense(ks[9], (D, D)),
            "w0": np.full((D,), -0.6, np.float32),
            "w_lora_a": _dense(ks[10], (D, W._W_LORA), 0.01),
            "w_lora_b": _dense(ks[11], (W._W_LORA, D), 0.01),
            "u": _normal(ks[0], (H, dh), 0.1),
            "ln_scale": np.ones((H, dh), np.float32),
            "cm_mu_k": mix(ks[1]), "cm_mu_r": mix(ks[2]),
            "cm_w_r": _dense(ks[3], (D, D)),
            "cm_w_up": _dense(ks[4], (D, cfg.d_ff)),
            "cm_w_down": _dense(ks[5], (cfg.d_ff, D))}


def _block_np(cfg, key, kind, use_moe=False, dense_ff=None):
    ks = prng.split(key, 6)
    p = {"norm1": _norm_np(cfg), "norm2": _norm_np(cfg)}
    if kind == RWKV:
        p["tm"] = _rwkv_np(cfg, ks[0])
        return p
    if kind in ATTN_KINDS:
        p["attn"] = _attn_np(cfg, ks[0])
    else:
        p["rglru"] = _rglru_np(cfg, ks[0])
    p["ffn"] = _moe_np(cfg, ks[1]) if use_moe \
        else _mlp_np(cfg, ks[1], dense_ff)
    if cfg.post_norm:
        p["post_norm1"] = _norm_np(cfg)
        p["post_norm2"] = _norm_np(cfg)
    return p


def init_tree(cfg: ModelConfig, key, device):
    """A float32 parameter tree drawn from the threefry ``key`` as the
    reference's ``transformer.init_params`` draws it: the same splits
    for the embedding (keys[0]), head block i (keys[1 + i]), every
    period's blocks (keys[1 + fkd] split over the periods, each period
    key split over the pattern), tail block i (keys[2 + fkd + i]) and
    the head (keys[-1]), and ``prng``'s draws (normal within 2.5e-7 of
    ``jax.random.normal``).  Drawn on the host: meant for the smoke and
    test widths."""
    _check_ported(cfg)
    fkd, nper, tail = cfg.layer_plan()
    n = len(cfg.pattern)
    use_moe = cfg.moe is not None
    keys = prng.split(key, 4 + fkd + len(tail))
    dense_ff = cfg.d_ff * (cfg.moe.dense_ff_mult if use_moe else 1)
    blocks = [_block_np(cfg, keys[1 + i], cfg.pattern[0], dense_ff=dense_ff)
              for i in range(fkd)]
    for k in (prng.split(keys[1 + fkd], nper) if nper else []):
        kk = prng.split(k, n)
        blocks += [_block_np(cfg, kk[j], kind, use_moe)
                   for j, kind in enumerate(cfg.pattern)]
    blocks += [_block_np(cfg, keys[2 + fkd + i], kind, use_moe)
               for i, kind in enumerate(tail)]
    tree = {"embed": {"table": _normal(keys[0], (cfg.vocab_size,
                                                 cfg.d_model), 0.02)},
            "blocks": blocks, "final_norm": _norm_np(cfg)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": _normal(keys[-1], (cfg.d_model,
                                                   cfg.vocab_size), 0.02)}
    return tree_map(lambda a: torch.from_numpy(a).to(device), tree)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def _init_layer_cache(cfg: ModelConfig, kind, batch, cache_len, dtype,
                      device):
    if kind == RGLRU:
        return R.init_rglru_state(cfg, batch, dtype, device)
    if kind == RWKV:
        return W.init_rwkv_state(cfg, batch, dtype, device)
    return L.init_attn_cache(
        cfg, batch, min(cache_len, cfg.window) if kind == ATTN_LOCAL
        else cache_len, dtype, device)


def init_cache(cfg: ModelConfig, batch, cache_len, dtype=None,
               device="cpu") -> List[dict]:
    """Zero caches: global layers linear at ``cache_len``, sliding-window
    layers as ``min(cache_len, window)``-slot rings, recurrent layers
    their zero state."""
    dtype = dtype or L.dtype_of(cfg.dtype)
    return [_init_layer_cache(cfg, kind, batch, cache_len, dtype, device)
            for kind in cfg.layer_kinds]


def grow_cache(cfg: ModelConfig, cache, extra_tokens: int):
    """Grows every KV cache by ``extra_tokens`` decode slots.  A
    sliding-window layer's linear prefill cache longer than the window
    becomes a ``window``-slot ring (last ``window`` keys, position p at
    slot p % window); shorter ones grow up to the window.  Recurrent
    state has no length axis and passes through untouched."""
    out = []
    for kind, c in zip(cfg.layer_kinds, cache):
        if kind not in ATTN_KINDS:
            out.append(c)
            continue
        cur = c["k"].shape[L.ATTN_CACHE_LEN_AXIS]
        if kind == ATTN_LOCAL:
            if cur > cfg.window:
                out.append(L.ring_attn_cache(c, cfg.window, cur))
            else:
                out.append(L.grow_attn_cache(
                    c, min(cur + extra_tokens, cfg.window)))
        else:
            out.append(L.grow_attn_cache(c, cur + extra_tokens))
    return out


def insert_cache(cfg: ModelConfig, slot_cache, prefill_cache, slots, plens):
    """Writes a padded-bucket prefill's per-request KV into rows of the
    persistent slot cache, in place; returns ``slot_cache``.

    ``prefill_cache`` is the linear cache of a (b, Pb) bucket prefill
    (every layer holds Pb entries, pads included).  ``slots`` (b,) names
    each request's destination row; a row whose slot is out of range
    (the bucket's padding rows use ``num_slots``) is dropped, as the
    reference's ``mode="drop"`` scatter does.  ``plens`` (b,) are the
    TRUE prompt lengths: a sliding-window layer whose ring is shorter
    than Pb keeps each request's last ``L`` real keys (positions from
    max(plen - L, 0)), rolled so position p sits at slot p % L.  Rows
    shorter than the slot length are zero-filled past Pb.  ``slots``
    and ``plens`` are host integers (numpy or lists).
    """
    bad = sorted({k for k in cfg.layer_kinds if k not in ATTN_KINDS})
    if bad:
        raise ValueError(f"insert_cache: {bad} blocks have no insertable KV")
    slots = np.asarray(slots).reshape(-1)
    plens = np.asarray(plens).reshape(-1)
    keep = [i for i, s in enumerate(slots)
            if 0 <= s < slot_cache[0]["k"].shape[0]]
    if not keep:
        return slot_cache
    device = slot_cache[0]["k"].device
    idx = torch.as_tensor(slots[keep], device=device)
    src_rows = torch.as_tensor(keep, device=device)
    for kind, dst, src in zip(cfg.layer_kinds, slot_cache, prefill_cache):
        for name in ("k", "v"):
            d, s = dst[name], src[name]
            Pb, Lc = s.shape[1], d.shape[1]
            if Pb <= Lc:      # linear prefix fits: zero-fill the tail
                d[idx, :Pb] = s[src_rows].to(d.dtype)
                d[idx, Pb:] = 0
                continue
            if kind != ATTN_LOCAL:
                raise ValueError("insert_cache: global cache shorter than "
                                 "a prompt bucket")
            for i in keep:    # ring-convert with the request's true length
                start = int(np.clip(plens[i] - Lc, 0, Pb - Lc))
                d[int(slots[i])] = torch.roll(
                    s[i, start:start + Lc], start, dims=0).to(d.dtype)
    return slot_cache


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------
def _apply_block(cfg: ModelConfig, kind, bp: Block, x, *, mode, cache,
                 pos):
    """Returns (x, new_cache, aux): ``aux`` the block's MoE load-balance
    loss (a float32 tensor), or None for a block without an MoE."""
    aux = None
    if kind == RWKV:
        n1 = L.apply_norm(cfg, bp.norm1, x)
        y, st = W.rwkv_time_mix(cfg, bp.tm, n1, state=cache)
        x = x + y
        n2 = L.apply_norm(cfg, bp.norm2, x)
        y2, st_c = W.rwkv_channel_mix(cfg, bp.tm, n2, state=cache)
        new_cache = None if cache is None else {
            "wkv": st["wkv"], "shift_t": st["shift_t"], "shift_c": st_c}
        return x + y2, new_cache, aux

    n1 = L.apply_norm(cfg, bp.norm1, x)
    if kind in ATTN_KINDS:
        y, new_cache = L.attn_apply(cfg, bp.attn, n1, kind=kind, mode=mode,
                                    cache=cache, pos=pos)
    else:
        y, new_cache = R.rglru_apply(cfg, bp.rglru, n1, mode=mode,
                                     state=cache)
    if cfg.post_norm:
        y = L.apply_norm(cfg, bp.post_norm1, y)
    if cfg.parallel_block:
        # norm2 and post_norm2 are not read, as in the reference
        return x + y + L.mlp_apply(cfg, bp.ffn, n1), new_cache, aux
    x = x + y
    n2 = L.apply_norm(cfg, bp.norm2, x)
    if hasattr(bp.ffn, "router"):          # an MoE block
        m, aux = M.moe_apply(cfg, bp.ffn, n2)
    else:
        m = L.mlp_apply(cfg, bp.ffn, n2)
    if cfg.post_norm:
        m = L.apply_norm(cfg, bp.post_norm2, m)
    return x + m, new_cache, aux


def forward(cfg: ModelConfig, params, tokens, *, embeds=None, mode="train",
            cache=None, pos=None, remat=False):
    """Returns (hidden (B, S, D), new_cache, aux).  ``params``: a module
    or a tree (``view``).  tokens: (B, St) integer tensor; ``embeds``:
    an optional (B, Se, D) frontend embedding (llava's patches),
    prepended to the token embeddings in their dtype, so S = Se + St.
    ``aux`` is the float32 sum of the MoE blocks' load-balance losses,
    the Python float 0.0 without MoE (a dense model launches nothing
    for it).  "prefill" returns a fresh cache: a linear KV cache
    of S entries per attention layer, the final state of each recurrent
    one (run from a zero state, as the reference's prefill is);
    "decode" updates the KV caches in place and returns the list with
    the new recurrent states.  ``remat`` (train mode, with gradients)
    recomputes each block in the backward (non-reentrant
    checkpointing), as the reference checkpoints its period body in
    train mode."""
    params = view(cfg, params)
    x = params.embed.table[tokens.long()]
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    serve = mode in ("prefill", "decode")
    if mode == "decode" and cache is None:
        raise ValueError("decode requires an existing cache")
    new_cache = [] if serve else None
    aux = 0.0
    B = x.shape[0]
    for i, (kind, bp) in enumerate(zip(cfg.layer_kinds, params.blocks)):
        if mode == "decode":
            c = cache[i]
        elif mode == "prefill" and kind not in ATTN_KINDS:
            c = _init_layer_cache(cfg, kind, B, 0, x.dtype, x.device)
        else:
            c = None
        if remat and mode == "train" and torch.is_grad_enabled():
            x, nc, a = checkpoint(
                lambda x, kind=kind, bp=bp: _apply_block(
                    cfg, kind, bp, x, mode=mode, cache=None, pos=pos),
                x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, nc, a = _apply_block(cfg, kind, bp, x, mode=mode, cache=c,
                                    pos=pos)
        if a is not None:
            aux = aux + a
        if serve:
            new_cache.append(nc)
    return L.apply_norm(cfg, params.final_norm, x), new_cache, aux


# ---------------------------------------------------------------------------
# LM head
# ---------------------------------------------------------------------------
def _head_w(cfg: ModelConfig, params: Transformer):
    if cfg.tie_embeddings:
        return params.embed.table.T
    return params.lm_head.w


def _softcap(cfg, logits):
    if cfg.final_softcap > 0:
        return cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def logits_fn(cfg: ModelConfig, params, hidden):
    """Full float32 logits — for decode-sized (B, 1, D) hidden states."""
    w = _head_w(cfg, view(cfg, params)).to(hidden.dtype)
    return _softcap(cfg, (hidden @ w).float())


def _chunks(S):
    """(number of chunks, chunk length): HEAD_CHUNK positions a chunk,
    or one chunk of all S when S is not a multiple (the reference's
    fallback for ragged small cases)."""
    cs = min(HEAD_CHUNK, S)
    if S % cs:
        cs = S
    return S // cs, cs


def _maybe_checkpoint(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def lm_loss(cfg: ModelConfig, params, hidden, labels, mask=None):
    """Mean masked cross-entropy over (B, S) positions, in float32 and
    one ``HEAD_CHUNK`` of positions at a time, each chunk recomputed in
    the backward, so the (B, S, V) logits never exist at once."""
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    n, cs = _chunks(S)
    w = _head_w(cfg, view(cfg, params))

    def chunk(h, lab, mk):
        logits = _softcap(cfg, (h @ w.to(h.dtype)).float())
        lse = torch.logsumexp(logits, dim=-1)
        lab_logit = torch.gather(logits, -1, lab[..., None].long())[..., 0]
        return ((lse - lab_logit) * mk).sum()

    tot = hidden.new_zeros((), dtype=torch.float32)
    for i in range(n):
        sl = slice(i * cs, (i + 1) * cs)
        tot = tot + _maybe_checkpoint(chunk, hidden[:, sl], labels[:, sl],
                                      mask[:, sl].float())
    return tot / torch.clamp(mask.float().sum(), min=1.0)


def _chunk_scan(cfg, params, hidden, fn):
    """``fn`` of each chunk's float32 (soft-capped) logits, over chunks
    of HEAD_CHUNK positions, each recomputed in the backward; the list
    of results in position order."""
    n, cs = _chunks(hidden.shape[1])
    w = _head_w(cfg, view(cfg, params))

    def body(h):
        return fn(_softcap(cfg, (h @ w.to(h.dtype)).float()))

    return [_maybe_checkpoint(body, hidden[:, i * cs:(i + 1) * cs])
            for i in range(n)]


def predict_argmax(cfg: ModelConfig, params, hidden):
    """Greedy per-position prediction (B, S) int32 — the teacher vote;
    the first of equal maxima, as ``jnp.argmax``."""
    return torch.cat(_chunk_scan(cfg, params, hidden,
                                 lambda lg: torch.argmax(lg, dim=-1)),
                     dim=1).to(torch.int32)
