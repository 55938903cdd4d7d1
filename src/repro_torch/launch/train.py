"""Training / distillation driver (``repro.launch.train``).

Implements the LM-scale FedKT flow: train per-party teachers on private
shards, vote-label the public stream (one round), distill the students,
then the server-side consistent vote and the final model's distillation.
Plain LM training (``train_lm``) is the same train step on next-token
labels.

On the card (full width, random weights, bf16 compute on float32
masters):

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --steps 8 --batch-size 4 --seq-len 512 --lr 3e-4

On the CPU, at the smoke widths (``--fedkt`` for the FedKT flow,
``--checkpoint PATH`` to save the result in the reference's format,
which ``launch/serve --checkpoint PATH`` serves):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --steps 20
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint, convert, prng
from repro_torch import device as D
from repro_torch.configs import (ARCH_IDS, FedKTConfig, TrainConfig,
                                 get_config, get_smoke)
from repro_torch.core.distill import make_train_step
from repro_torch.data import TokenDataset, synthetic
from repro_torch.models import Model


def train_lm(model: Model, dataset: TokenDataset, tcfg: TrainConfig,
             *, labels: Optional[np.ndarray] = None, params=None,
             log_every: int = 10, extra_batch: Optional[Dict] = None,
             verbose=True, device=D.DEFAULT) -> Dict[str, Any]:
    """Plain LM (or distillation, when ``labels`` given) training loop.
    ``params``: a float32 parameter tree to start from (updated in
    place), else one drawn from ``tcfg.seed``.  Each logged history
    entry has the step, its loss and the seconds since the first step
    began (read after the loss, which waits for the step)."""
    dev = D.resolve(device)
    step_fn, opt = make_train_step(model, tcfg)
    if params is None:
        params = model.init_tree(prng.PRNGKey(tcfg.seed), dev)
    history = []
    with D.full_float32(dev):
        opt_state = opt.init(params)
        t0 = time.time()
        for i, batch in enumerate(dataset.batches(tcfg.batch_size,
                                                  steps=tcfg.steps,
                                                  labels=labels)):
            if extra_batch:
                batch = {**batch, **extra_batch}
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if (i + 1) % log_every == 0 or i == 0:
                loss = float(metrics["loss"])
                history.append({"step": i + 1, "loss": loss,
                                "seconds": time.time() - t0})
                if verbose:
                    print(f"  step {i+1:5d} loss {loss:.4f} "
                          f"({time.time()-t0:.1f}s)")
    return {"params": params, "history": history}


def eval_lm(model: Model, params, dataset: TokenDataset, batch_size=8,
            max_batches=8, device=D.DEFAULT) -> float:
    dev = D.resolve(device)
    losses = []
    with torch.no_grad(), D.full_float32(dev):
        for batch in dataset.batches(batch_size, steps=max_batches):
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            losses.append(float(model.loss(params, batch, remat=False)))
    return float(np.mean(losses))


def fedkt_lm(model: Model, seqs: np.ndarray, public: np.ndarray,
             fcfg: FedKTConfig, tcfg: TrainConfig, *, test=None,
             engine: str = "lm", transport="inprocess", parallelism=None,
             verbose=True, device=D.DEFAULT) -> Dict[str, Any]:
    """LM-scale FedKT: per-token voting distillation, driven by the
    session stack every other learner uses.  An ``LMLearner`` wraps the
    distill.py label and train steps behind the Learner contract and
    ``FedKTSession`` runs the protocol (party split, subset plan, key
    schedule, wire codec and privacy accounting).  ``test`` supplies
    held-out sequences for the next-token accuracy (default: the public
    block)."""
    from repro_torch.core.learners import LMLearner
    from repro_torch.data.pipeline import lm_session_data
    from repro_torch.federation import FedKTSession

    dev = str(D.resolve(device))
    teacher = LMLearner(model, tcfg, device=dev)
    # students and the final model distill on the public stream, which
    # the reference's legacy loop shuffled with the federation seed
    distiller = LMLearner(model, tcfg, data_seed=fcfg.seed, device=dev)
    data = lm_session_data(seqs, public, public if test is None else test)
    session = FedKTSession(teacher, data, fcfg, student_learner=distiller,
                           final_learner=distiller, engine=engine,
                           transport=transport, parallelism=parallelism,
                           device=dev)
    res = session.run(verbose=verbose)
    if verbose:
        print(f"fedkt-lm [{res.meta['engine']}]: next-token acc "
              f"{res.accuracy:.4f}, "
              f"{res.meta['wire_bytes']['updates']} update wire bytes")
    return {"final_params": res.final_state,
            "students": res.student_states, "result": res}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fedkt", action="store_true",
                    help="run the LM FedKT distillation flow")
    ap.add_argument("--parties", type=int, default=2)
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args(argv)

    dev = D.resolve(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    tcfg = TrainConfig(batch_size=args.batch_size, seq_len=args.seq_len,
                       steps=args.steps, learning_rate=args.lr)
    data = synthetic.tokens(n_seqs=256, seq_len=args.seq_len + 1,
                            vocab=cfg.vocab_size)

    if args.fedkt:
        fcfg = FedKTConfig(num_parties=args.parties, num_partitions=2,
                           num_subsets=2, num_classes=cfg.vocab_size)
        out = fedkt_lm(model, data["train"], data["public"], fcfg, tcfg,
                       test=data["test"], device=dev)
        params = out["final_params"]
    else:
        out = train_lm(model, TokenDataset(data["train"]), tcfg, device=dev)
        params = out["params"]

    test_loss = eval_lm(model, params, TokenDataset(data["test"]),
                        device=dev)
    print(f"test loss: {test_loss:.4f}")
    if args.checkpoint:
        checkpoint.save(args.checkpoint,
                        convert.lm_params_to_reference(cfg, params),
                        metrics={"test_loss": test_loss})
        print(f"saved {args.checkpoint}")
    return {"test_loss": test_loss, "params": params, **out}


if __name__ == "__main__":
    main()
