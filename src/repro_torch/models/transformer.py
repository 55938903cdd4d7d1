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
(an encoder-decoder's ``encdec.EncDec``: ``new_module``) whose matrices
are stored in ``cfg.dtype``.  Training holds a *tree*:
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
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import rwkv as W
from repro_torch.models.layers import _attn_np, _mlp_np, _norm_np, _normal
from repro_torch.models.moe import _moe_np
from repro_torch.models.rglru import _rglru_np
from repro_torch.models.rwkv import _rwkv_np
from repro_torch.tree_util import tree_map

ATTN_KINDS = (ATTN, ATTN_LOCAL)
HEAD_CHUNK = 512


def _check_ported(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        raise ValueError("an encoder-decoder config builds models/encdec.py's "
                         "EncDec (new_module), not a Transformer")
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
        self.embed = L.Embed(cfg, device, generator)
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


def new_module(cfg: ModelConfig, device, generator=None) -> nn.Module:
    """``cfg``'s parameter module: an ``encdec.EncDec`` for an
    encoder-decoder, else a ``Transformer``."""
    if cfg.is_encoder_decoder:
        return E.EncDec(cfg, device, generator)
    return Transformer(cfg, device, generator)


# ---------------------------------------------------------------------------
# Parameter trees (training)
# ---------------------------------------------------------------------------
# the layer lists of a tree: a decoder's blocks, an encoder-decoder's
# encoder and decoder layers
LAYER_LISTS = ("blocks", "enc", "dec")


def _as_tree(named):
    """{"a.0.b": t} -> {"a": [{"b": t}]}: a module's dotted parameter
    names as nested dicts, with the layer lists (``LAYER_LISTS``) as
    lists."""
    tree: dict = {}
    for name, t in named:
        node, parts = tree, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    for key in LAYER_LISTS:
        if key in tree:
            tree[key] = [tree[key][str(i)] for i in range(len(tree[key]))]
    return tree


@functools.lru_cache(maxsize=None)
def _meta_module(cfg: ModelConfig) -> nn.Module:
    """``cfg``'s parameter module on the meta device (shapes and dtypes,
    no data), built once per config."""
    return new_module(cfg, "meta")


@functools.lru_cache(maxsize=None)
def param_dtypes(cfg: ModelConfig):
    """The dtype of every parameter of ``cfg``'s module, as a tree."""
    return _as_tree((n, p.dtype) for n, p in
                    _meta_module(cfg).named_parameters())


def tree_of(params: nn.Module):
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
    if isinstance(params, (nn.Module, SimpleNamespace)):
        return params
    return _ns(tree_map(lambda t, dt: t.to(dt), params, param_dtypes(cfg)))


def to_module(cfg: ModelConfig, tree, device=None) -> nn.Module:
    """A tree as a serving module (``new_module``; each leaf cast to the
    module's dtype) on ``device`` (the tree's own by default)."""
    dev = device or tree["embed"]["table"].device
    module = new_module(cfg, dev)
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[int(part)] if isinstance(node, list) \
                    else node[part]
            p.copy_(node.to(p.dtype))
    return module


def _block_np(cfg, key, kind, use_moe=False, dense_ff=None, device=None):
    ks = prng.split(key, 6)
    p = {"norm1": _norm_np(cfg), "norm2": _norm_np(cfg)}
    if kind == RWKV:
        p["tm"] = _rwkv_np(cfg, ks[0], device)
        return p
    if kind in ATTN_KINDS:
        p["attn"] = _attn_np(cfg, ks[0], device)
    else:
        p["rglru"] = _rglru_np(cfg, ks[0], device)
    p["ffn"] = _moe_np(cfg, ks[1], device) if use_moe \
        else _mlp_np(cfg, ks[1], dense_ff, device)
    if cfg.post_norm:
        p["post_norm1"] = _norm_np(cfg)
        p["post_norm2"] = _norm_np(cfg)
    return p


def init_tree(cfg: ModelConfig, key, device):
    """A parameter tree, each leaf in ``init_dtype`` (float32 in every
    registered config), drawn from the threefry ``key`` as the
    reference's ``transformer.init_params`` draws it: the same splits
    for the embedding (keys[0]), head block i (keys[1 + i]), every
    period's blocks (keys[1 + fkd] split over the periods, each period
    key split over the pattern), tail block i (keys[2 + fkd + i]) and
    the head (keys[-1]), and ``prng``'s draws (normal within 2.5e-7 of
    ``jax.random.normal``).  On the CPU the normal draws are
    ``prng.normal``'s on the host; on another device
    ``prng.normal_tensor``'s, the same steps on that device (a
    full-width model's billions of draws take minutes on the host)."""
    _check_ported(cfg)
    draw = None if torch.device(device).type == "cpu" else device
    fkd, nper, tail = cfg.layer_plan()
    n = len(cfg.pattern)
    use_moe = cfg.moe is not None
    keys = prng.split(key, 4 + fkd + len(tail))
    dense_ff = cfg.d_ff * (cfg.moe.dense_ff_mult if use_moe else 1)
    blocks = [_block_np(cfg, keys[1 + i], cfg.pattern[0], dense_ff=dense_ff,
                        device=draw)
              for i in range(fkd)]
    for k in (prng.split(keys[1 + fkd], nper) if nper else []):
        kk = prng.split(k, n)
        blocks += [_block_np(cfg, kk[j], kind, use_moe, device=draw)
                   for j, kind in enumerate(cfg.pattern)]
    blocks += [_block_np(cfg, keys[2 + fkd + i], kind, use_moe, device=draw)
               for i, kind in enumerate(tail)]
    tree = {"embed": {"table": _normal(keys[0], (cfg.vocab_size,
                                                 cfg.d_model), 0.02, draw)},
            "blocks": blocks, "final_norm": _norm_np(cfg)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": _normal(keys[-1], (cfg.d_model,
                                                   cfg.vocab_size), 0.02,
                                        draw)}
    return _init_tensors(cfg, tree, device)


# leaves the reference's init makes in float32 whatever cfg.param_dtype
# (repro/models/rglru.py: lam; rwkv.py: w0, u)
FLOAT32_INIT = ("lam", "w0", "u")


def init_dtype(cfg: ModelConfig, name) -> torch.dtype:
    """The dtype the reference's init gives a parameter named ``name``."""
    return torch.float32 if name in FLOAT32_INIT else \
        L.dtype_of(cfg.param_dtype)


def _init_tensors(cfg, tree, device, name=""):
    """A tree of draws (numpy arrays or tensors) as tensors on
    ``device``, each leaf in ``init_dtype``."""
    if isinstance(tree, dict):
        return {k: _init_tensors(cfg, v, device, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_init_tensors(cfg, v, device, name) for v in tree]
    return torch.as_tensor(tree).to(device, init_dtype(cfg, name))


def init_shapes(cfg: ModelConfig):
    """The tree ``init_tree`` returns (a decoder's or an
    encoder-decoder's), path for path, with every leaf a meta tensor of
    its shape and dtype: the counterpart of ``jax.eval_shape`` of the
    reference's init.  Draws no numbers and allocates nothing."""
    return _as_tree(
        (n, torch.empty(p.shape, device="meta",
                        dtype=init_dtype(cfg, n.rsplit(".", 1)[-1])))
        for n, p in _meta_module(cfg).named_parameters())


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
def _head_w(cfg: ModelConfig, params):
    """The LM head (d_model, vocab): the embedding's transpose when tied
    (an encoder-decoder's always is), else ``lm_head.w``."""
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
