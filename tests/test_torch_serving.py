"""The port's serving tier against the JAX reference's, on the CPU.

  1. Scheduler: admissions, slots and evictions on seeded request
     streams identical to ``repro.serving.Scheduler``'s.
  2. Engine: every stream against the JAX ``Engine``'s stream for the
     same prompt and against the port's own solo ``serve_batch`` run —
     staggered arrivals, arrival-order permutations, one bucket of
     mixed lengths, EOS early exit — on the tiny LM and the phi4-mini
     and gemma2 (window-64 ring, prompts crossing it) smokes in float32,
     with the reference's parameters carried across.  Plus the
     engine's refusals, and the CLI.

The parity rule (``serving.compare_stream``): a product of one row and
the same row inside a product of several rows round differently, so
two runs of one stream agree up to their logits, which must be within
1e-5 of the largest logit; the streams must be identical token for
token, except from a step where the reference's top-1 minus top-2
logit gap is within what that logit difference can flip (gap <= 2 x the
step's max |difference|), after which their histories differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model, tiny_lm_config
from repro.models import Model as JModel
from repro.serving import Engine as JEngine
from repro.serving import Scheduler as JScheduler
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import Model
from repro_torch.serving import (Engine, Scheduler, compare_stream,
                                 effective_tokens, serve_batch)

RTOL = 1e-5


def port_config(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


# ---------------------------------------------------------------------------
# 1. scheduler decisions against the reference's
# ---------------------------------------------------------------------------
def _replay(sched, stream, seed):
    """The engine's admit + sweep loop without a model; returns the log
    of every decision."""
    rng = np.random.default_rng(seed)
    pending, log = list(stream), []

    def emit(r):
        r.tokens.append(0)
        if len(r.tokens) >= r.max_tokens:
            sched.evict(r, "length")
            log.append(("evict", r.rid, r.slot))

    while pending or not sched.idle:
        for _ in range(int(rng.integers(0, 3))):
            if pending:
                plen, mt = pending.pop(0)
                r = sched.submit(np.zeros(plen, np.int32), mt)
                log.append(("submit", r.rid, r.max_tokens))
        adm = sched.next_admission()
        if adm is not None:
            log.append(("admit", adm.bucket_len, adm.batch,
                        [(r.rid, r.slot) for r in adm.reqs]))
            for r in adm.reqs:
                emit(r)
        for r in list(sched.running):
            log.append(("decode", r.rid, r.slot, r.next_pos))
            emit(r)
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_decisions_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    cache_len = int(rng.choice([32, 48, 64]))
    kw = dict(num_slots=int(rng.integers(1, 6)), cache_len=cache_len,
              max_batch=[None, 2, 4][seed % 3], min_bucket=[8, 4][seed % 2])
    stream = [(int(rng.integers(1, cache_len)),
               int(rng.integers(1, 2 * cache_len))) for _ in range(25)]
    mine = _replay(Scheduler(**kw), stream, seed)
    theirs = _replay(JScheduler(**kw), stream, seed)
    assert mine == theirs
    assert sum(e[0] == "evict" for e in mine) == 25


def test_scheduler_refusals_equal_the_reference():
    for cls in (Scheduler, JScheduler):
        s = cls(num_slots=2, cache_len=64)
        with pytest.raises(ValueError):
            s.submit(np.arange(64), 4)
        with pytest.raises(ValueError):
            s.submit(np.arange(3), 0)
        assert s.submit(np.arange(60), 100).max_tokens == 4
        with pytest.raises(ValueError):
            cls(num_slots=2, cache_len=64, max_batch=3)


# ---------------------------------------------------------------------------
# 2. engine streams against the JAX engine and the port's serve_batch
# ---------------------------------------------------------------------------
class Served:
    """One model in both packages, its prompts, and the reference
    streams for them: the port's solo serve_batch runs (with logits) and
    the JAX Engine's streams."""

    def __init__(self, jcfg, jm, plens, gen, seed, num_slots, cache_len):
        self.jm, self.gen = jm, gen
        self.jp = jm.init(jax.random.PRNGKey(0))
        self.cfg = port_config(jcfg)
        self.model = Model(self.cfg)
        self.params = lm_params_from_reference(
            self.cfg, jax.tree.map(np.asarray, self.jp), device="cpu")
        rng = np.random.default_rng(seed)
        self.prompts = [rng.integers(0, self.cfg.vocab_size, (p,))
                        .astype(np.int32) for p in plens]
        self.refs, self.ref_logits = [], []
        for p in self.prompts:
            toks, stats = serve_batch(self.model, self.params, p[None], gen,
                                      verbose=False, keep_logits=True)
            self.refs.append(toks[0].tolist())
            self.ref_logits.append(stats["logits"][0])
        eng = JEngine(jm, self.jp, num_slots=num_slots, cache_len=cache_len)
        self.jax_streams = [r.tokens for r in eng.serve(self.prompts, gen)]

    def engine(self, **kw):
        base = dict(num_slots=4, cache_len=64, device="cpu",
                    keep_logits=True)
        base.update(kw)
        return Engine(self.model, self.params, **base)

    def jax_logits(self, i, tokens):
        """The reference's logits for each of ``tokens`` after prompt i,
        from one full forward over the prompt and the tokens."""
        seq = np.concatenate([self.prompts[i], tokens[:-1]]).astype(np.int32)
        lg, _ = self.jm.logits(self.jp, {"tokens": jnp.asarray(seq[None])})
        plen = len(self.prompts[i])
        return np.asarray(lg[0, plen - 1:plen - 1 + len(tokens)])

    def check(self, i, res, eos=None):
        """Stream ``res`` of prompt i against both references (each cut
        after its first EOS when ``eos`` is given)."""
        def cut(ref):
            return ref[:ref.index(eos) + 1] if eos in ref else ref
        want = cut(self.refs[i])
        info = compare_stream(res.tokens, res.logits, want,
                              self.ref_logits[i])
        scale = float(self.ref_logits[i].abs().max())
        assert info["max_diff"] <= RTOL * scale, info
        assert info["explained"], info
        if info["match"]:
            assert res.tokens == want
            assert res.finish_reason == ("eos" if eos in want
                                         else "length")
        jt = cut(self.jax_streams[i])
        if res.tokens != jt:
            jinfo = compare_stream(res.tokens, res.logits, jt,
                                   self.jax_logits(i, jt))
            assert jinfo["max_diff"] <= RTOL * scale, jinfo
            assert jinfo["explained"], jinfo
        return info["match"]


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_lm_config()
    return Served(jcfg, JModel(jcfg), [3, 5, 8, 12, 16, 13], 10, 0, 4, 64)


@pytest.fixture(scope="module")
def phi4():
    jcfg, jm = smoke_model("phi4-mini-3.8b", dtype="float32",
                           param_dtype="float32")
    return Served(jcfg, jm, [5, 8, 12], 8, 1, 2, 64)


@pytest.fixture(scope="module")
def gemma2():
    jcfg, jm = smoke_model("gemma2-27b", dtype="float32",
                           param_dtype="float32")
    assert jcfg.window == 64
    return Served(jcfg, jm, [30, 70, 100], 8, 2, 2, 256)


def test_staggered_arrivals(tiny):
    """Mixed prompt lengths, arrivals staggered across steps, more
    requests than slots."""
    eng = tiny.engine()
    eng.submit(tiny.prompts[0], 10)
    eng.submit(tiny.prompts[1], 10)
    eng.step()
    eng.submit(tiny.prompts[2], 10)
    eng.submit(tiny.prompts[3], 10)
    eng.step()
    eng.step()
    eng.submit(tiny.prompts[4], 10)
    eng.submit(tiny.prompts[5], 10)
    res = eng.run()
    assert [r.rid for r in res] == list(range(6))
    for r in res:
        tiny.check(r.rid, r)
        assert r.num_tokens == 10 and r.logits.shape == (10, 64)
        assert len(r.timing["token_latencies"]) == 10
        assert r.timing["total"] >= r.timing["ttft"] >= \
            r.timing["queue"] >= 0


@pytest.mark.parametrize("perm", [[2, 0, 4, 1, 5, 3], [5, 4, 3, 2, 1, 0]])
def test_arrival_order_permutations(tiny, perm):
    eng = tiny.engine(num_slots=2)
    rid_to_prompt = {eng.submit(tiny.prompts[i], 10).rid: i for i in perm}
    for r in eng.run():
        tiny.check(rid_to_prompt[r.rid], r)


def test_one_bucket_mixed_lengths(tiny):
    """Lengths 3/5/8 round to ONE 8-bucket and prefill in one dispatch;
    the right padding is invisible."""
    eng = tiny.engine()
    for i in (0, 1, 2):
        eng.submit(tiny.prompts[i], 10)
    res = eng.run()
    assert eng.dispatches["prefill"] == 1
    assert list(eng.prefill_seconds) == [(4, 8)]
    for r in res:
        tiny.check(r.rid, r)


def test_eos_early_exit(tiny):
    """EOS eviction: each stream is its reference up to and including
    the first EOS, and the freed slots take the waiting requests."""
    eos = tiny.refs[2][3]
    eng = tiny.engine(num_slots=2, eos_id=eos)
    for p in tiny.prompts[:4]:
        eng.submit(p, 10)
    res = eng.run()
    assert len(res) == 4
    for r in res:
        tiny.check(r.rid, r, eos=eos)
    assert any(r.finish_reason == "eos" for r in res)


def test_closed_loop_after_warmup(tiny):
    eng = tiny.engine(num_slots=8)
    shapes = eng.warmup(buckets=[len(p) for p in tiny.prompts])
    assert shapes == [(b, n) for n in (8, 16) for b in (1, 2, 4, 8)]
    assert eng.dispatches == {"prefill": 0, "decode": 0}
    res = eng.serve(tiny.prompts, max_tokens=10)
    assert eng.dispatches["prefill"] == 2       # the 8- and 16-buckets
    for r in res:
        tiny.check(r.rid, r)


def test_smoke_global_attention(phi4):
    eng = phi4.engine(num_slots=2)
    eng.submit(phi4.prompts[0], 8)
    eng.submit(phi4.prompts[1], 8)
    eng.step()
    eng.submit(phi4.prompts[2], 8)
    for r in eng.run():
        phi4.check(r.rid, r)


def test_smoke_ring_window_crossing(gemma2):
    """gemma2 smoke (window 64): prompts shorter and longer than the
    window, so insert_cache's per-request ring conversion and the
    sliding mask both run mid-stream."""
    eng = gemma2.engine(num_slots=2, cache_len=256)
    eng.submit(gemma2.prompts[0], 8)
    eng.submit(gemma2.prompts[1], 8)
    eng.step()
    eng.submit(gemma2.prompts[2], 8)
    res = eng.run()
    assert [r.prompt_len for r in res] == [30, 70, 100]
    for r in res:
        gemma2.check(r.rid, r)


# -- refusals ---------------------------------------------------------------
def test_engine_refusals(tiny):
    from repro_torch.configs.base import RGLRU
    rec = Model(tiny.cfg.replace(pattern=(RGLRU, "attn")))
    with pytest.raises(NotImplementedError, match="recurrent"):
        Engine(rec, tiny.params, device="cpu")
    encdec = Model(tiny.cfg.replace(is_encoder_decoder=True))
    with pytest.raises(NotImplementedError, match="decoder-only"):
        Engine(encdec, tiny.params, device="cpu")


def test_engine_refuses_short_cache_for_window(gemma2):
    with pytest.raises(ValueError, match="window"):
        gemma2.engine(cache_len=32)              # < window 64


# ---------------------------------------------------------------------------
# 3. serve_batch, the parity rule, the CLI
# ---------------------------------------------------------------------------
def test_effective_tokens():
    toks = np.array([[3, 9, 9, 9], [5, 6, 3, 8], [5, 6, 7, 8]])
    assert effective_tokens(toks, 3).tolist() == [1, 3, 4]
    assert effective_tokens(toks, None).tolist() == [4, 4, 4]


def test_serve_batch_stats(tiny):
    prompts = np.stack([p[:3] for p in tiny.prompts[:3]])
    toks, stats = serve_batch(tiny.model, tiny.params, prompts, 6,
                              verbose=False)
    assert toks.shape == (3, 6)
    eos = int(toks[0, 2])
    _, s2 = serve_batch(tiny.model, tiny.params, prompts, 6, eos_id=eos,
                        verbose=False)
    assert s2["generated"] == sum(s2["effective_lens"]) < 18
    assert s2["tok_per_s"] == pytest.approx(
        s2["generated"] / s2["decode_s"], rel=1e-6)


def test_compare_stream_rule():
    ref = torch.tensor([[0.0, 1.0, 0.5], [2.0, 1.9999, 0.0],
                        [0.0, 0.0, 1.0]])
    same = compare_stream([1, 0, 2], ref, [1, 0, 2], ref)
    assert same["match"] and same["max_diff"] == 0.0 and same["explained"]
    # a flip at a near-tie that a 1e-4 logit difference can explain
    near = ref.clone()
    near[1, 1] += 2e-4
    info = compare_stream([1, 1, 0], near, [1, 0, 2], ref)
    assert info["step"] == 1 and not info["match"]
    assert info["gap"] == pytest.approx(1e-4, abs=1e-6)
    assert info["explained"]
    # a flip the logit difference cannot explain
    far = ref.clone()
    far[0, 2] += 1e-6
    info = compare_stream([2, 0, 2], far, [1, 0, 2], ref)
    assert info["step"] == 0 and not info["explained"]


def test_launch_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--device", "cpu", "--smoke", "--concurrent", "3",
                      "--max-tokens", "4", "--prompt-len", "16",
                      "--slots", "2", "--cache-len", "64"])
    assert len(res) == 3 and all(r.num_tokens == 4 for r in res)
    stats = serve.main(["--device", "cpu", "--smoke", "--arch",
                        "gemma2-27b", "--serial", "--concurrent", "2",
                        "--max-tokens", "3", "--prompt-len", "8"])
    assert stats["generated"] == 6
    opened = serve.main(["--device", "cpu", "--smoke", "--concurrent", "3",
                         "--max-tokens", "2", "--prompt-len", "8",
                         "--arrival", "1000"])
    assert [r.num_tokens for r in opened] == [2, 2, 2]
    assert "tok/s" in capsys.readouterr().out


def test_chip_smoke_serving_phases_on_cpu():
    """chip_smoke.py's serving and window phases, rehearsed on the CPU at
    the smoke widths (their launch-count check applies on the card)."""
    import chip_smoke
    from repro_torch.configs import get_smoke
    cfg = get_smoke("phi4-mini-3.8b")
    m, launches = chip_smoke.phase_serving(
        cfg, [109, 82, 3, 23, 125], device="cpu", max_tokens=4,
        num_slots=4, cache_len=256, compare=2)
    assert m["tokens"] == 20 and launches == 0
    assert m["dispatches"]["prefill"] == sum(
        len(v) for v in m["prefill_ms_by_bucket"].values())
    w, _ = chip_smoke.phase_window(device="cpu")
    assert w["streams"] == 6 and w["tokens"] == 48


def test_launch_serve_recurrent_takes_the_serial_path(capsys):
    """The engine refuses recurrent blocks, so the CLI serves the
    recurrent archs through serve_batch, as the reference's CLI does,
    and says so."""
    from repro_torch.launch import serve
    for arch, plen in (("rwkv6-7b", 16), ("recurrentgemma-2b", 100)):
        stats = serve.main(["--device", "cpu", "--smoke", "--arch", arch,
                            "--concurrent", "3", "--max-tokens", "4",
                            "--prompt-len", str(plen)])
        assert stats["generated"] == 12 and stats["prompt_len"] == plen
        out = capsys.readouterr().out
        assert "serial fixed-batch path (recurrent blocks" in out


def test_chip_smoke_recurrent_phases_on_cpu():
    """chip_smoke.py's recurrent serving and parity phases, rehearsed on
    the CPU at the smoke widths (their launch-count check applies on the
    card)."""
    import chip_smoke
    from repro_torch.configs import get_smoke
    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        m, launches = chip_smoke.phase_batch_serving(
            get_smoke(arch), device="cpu", batch=2, prompt_len=70, gen=3)
        assert m["generated"] == 6 and m["logits_finite"]
        assert launches == {"rglru_scan": 0, "wkv6": 0,
                            "flash_attention": 0}
        row = chip_smoke.phase_smoke_parity(arch, device="cpu")
        assert row["matched_whole"] == 3 and row["max_diff"] == 0.0
