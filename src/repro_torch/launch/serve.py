"""Serving CLI: thin front-end over the continuous-batching engine
(``repro.launch.serve``).

Closed loop (submit everything, drain), on the card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --concurrent 8 --max-tokens 32 --slots 8 --cache-len 1024

On the CPU, at the smoke widths:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke

Open loop: ``--arrival R`` submits the requests at seeded Poisson
arrivals of R req/s.  ``--serial`` serves them through the fixed-batch
``serve_batch`` instead, which is also the path of the models the
engine refuses (recurrent blocks, frontends, the encoder-decoder, which
serves random stub ``frames``), as in the reference:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-2b --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch whisper-tiny --device cpu --smoke

Weights are random, from ``--seed``, unless ``--checkpoint PATH``
names a checkpoint in the reference's format (``launch/train
--checkpoint PATH`` writes one; so does the reference's train CLI).
"""
from __future__ import annotations

import argparse
import time


def _percentile(xs, q):
    return sorted(xs)[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


def _drive(eng, prompts, max_tokens, arrival, seed):
    """Submit ``prompts`` and run to drain.  arrival <= 0: closed loop
    (all at once).  arrival > 0: open loop — seeded exponential
    inter-arrival gaps at ``arrival`` req/s, submitted as engine steps
    pass their deadline."""
    import numpy as np
    if arrival <= 0:
        for p in prompts:
            eng.submit(p, max_tokens)
        return eng.run()
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / arrival, len(prompts))
    t0 = eng.clock()
    deadlines = list(zip(t0 + np.cumsum(gaps), prompts))
    results = []
    while deadlines or not eng.scheduler.idle:
        now = eng.clock()
        while deadlines and deadlines[0][0] <= now:
            _, p = deadlines.pop(0)
            eng.submit(p, max_tokens)
        if eng.scheduler.idle and deadlines:
            time.sleep(min(max(deadlines[0][0] - now, 0.0), 0.01))
            continue                      # idle-wait for next arrival
        results.extend(eng.step())
    return sorted(results, key=lambda r: r.rid)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length; lengths are drawn "
                         "uniformly from [1, this] per request")
    ap.add_argument("--max-tokens", "--gen", type=int, default=16,
                    dest="max_tokens")
    ap.add_argument("--concurrent", type=int, default=4,
                    help="number of request streams to serve")
    ap.add_argument("--arrival", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in req/s "
                         "(0 = closed loop: submit all up front)")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine KV-cache slots (concurrent decodes)")
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--eos", type=int, default=None,
                    help="EOS token id for early stream termination")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serial", action="store_true",
                    help="serve through the fixed-batch serve_batch path")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import checkpoint as ckpt_lib
    from repro_torch import convert
    from repro_torch import device as D
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.serving import Engine, serve_batch
    from repro_torch.serving.engine import refusal

    if args.arch not in ARCH_IDS:
        ap.error(f"unknown or unported arch {args.arch!r} (choose from "
                 f"{ARCH_IDS})")
    dev = D.resolve(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    if args.checkpoint:
        params = convert.lm_params_from_reference(
            cfg, ckpt_lib.load(args.checkpoint), dev)
    else:
        params = model.init(
            torch.Generator(device=dev).manual_seed(args.seed), device=dev)

    rng = np.random.default_rng(args.seed)
    lens = rng.integers(1, args.prompt_len + 1, args.concurrent)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]

    why = "--serial" if args.serial else refusal(cfg)
    if why:
        print(f"serial fixed-batch path ({why})")
        batch = np.stack([np.resize(p, args.prompt_len) for p in prompts])
        extra = {}
        if cfg.is_encoder_decoder:     # the stubbed frontend's frames
            extra["frames"] = torch.as_tensor(rng.normal(
                0, 1, (len(prompts), cfg.encoder_seq_len, cfg.d_model))
            ).to(L.dtype_of(cfg.dtype))
        tokens, stats = serve_batch(model, params, batch, args.max_tokens,
                                    extra=extra, eos_id=args.eos)
        print("generated:", tokens[:, :8], "...")
        return stats

    eng = Engine(model, params, num_slots=args.slots,
                 cache_len=args.cache_len, eos_id=args.eos, device=dev)
    eng.warmup(buckets=[p.shape[0] for p in prompts])
    t0 = eng.clock()
    results = _drive(eng, prompts, args.max_tokens, args.arrival,
                     args.seed)
    wall = eng.clock() - t0
    toks = sum(r.num_tokens for r in results)
    lats = [t for r in results for t in r.timing["token_latencies"]]
    print(f"{len(results)} streams, {toks} tokens in {wall:.2f}s "
          f"({toks / max(wall, 1e-9):.1f} tok/s aggregate) on {dev}")
    print(f"per-token latency p50 {_percentile(lats, .5)*1e3:.1f}ms "
          f"p95 {_percentile(lats, .95)*1e3:.1f}ms; dispatches "
          f"{eng.dispatches}")
    for r in results[:4]:
        print(f"  req {r.rid} plen {r.prompt_len}: {r.tokens[:8]} ...")
    return results


if __name__ == "__main__":
    main()
