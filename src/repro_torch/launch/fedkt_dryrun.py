"""Dry-run of FedKT's own step, the paper's single communication round at
datacenter scale (``repro.launch.fedkt_dryrun``).

The server holds M = n*s student models, one member per data index of
the mesh (tensor-parallel over "model" within it).  The traced step is
``LMLearner.label_step``, the function the session's ``lm`` engine runs
for each partition: every member greedily predicts the public batch,
and the vocabulary-free sort vote folds the predictions.  It runs on
meta tensors under ``launch/analysis.py``'s counters, at depth probes
of 1 and 2 periods and at full depth, as ``launch/dryrun.py`` runs its
steps.  The cross-member vote is the paper's one round: the step's
collectives are the members' own tensor-parallel reduces and one
all-gather of the (M, B, S) int32 predictions, O(T) integers a member,
not O(T * vocab) or O(M * params).

The record's "protocol" section prices both message kinds (PartyUpdate
up, TokenLabels down) as the wire codec's exact framed bytes
(``codec.lm_protocol_bytes``), from the meta tree of one member.

  PYTHONPATH=src python -m repro_torch.launch.fedkt_dryrun [--arch ...] \\
      [--members 16] [--out build/dryrun/fedkt_step.json]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import ARCH_IDS, TrainConfig, get_config
from repro_torch.core.learners import LMLearner
from repro_torch.federation import codec
from repro_torch.launch import analysis
from repro_torch.launch.dryrun import OUT_DIR, effective_periods, probe_cfg
from repro_torch.launch.inputs import sds
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.sharding.specs import (NamedSharding, P, _map_with_path,
                                        resident_bytes, spec_for_param)
from repro_torch.tree_util import tree_map


def member_shardings(pshapes, mesh):
    """Stacked member params (a leading member dim on every leaf): that
    dim over 'data', the inner spec with the FSDP axis dropped (each
    member is TP-sharded within its group)."""
    def f(path, leaf):
        inner = spec_for_param(path, tuple(leaf.shape[1:]), mesh)
        inner = [None if a == "data" else a for a in inner]
        return NamedSharding(mesh, P("data", *inner))
    return _map_with_path(f, pshapes)


def lower_label_step(arch, members, B, S, mesh, cfg=None):
    """Traces the label step of ``members`` models of ``arch`` (bf16
    weights) on a (B, S) public block.  Returns (analysis.Lowered,
    cfg).  ``members`` must be a multiple of the mesh's data axis."""
    cfg = cfg or get_config(arch).replace(param_dtype="bfloat16")
    d = mesh.shape.get("data", 1)
    if members % d:
        raise ValueError(f"{members} members do not divide over the "
                         f"{d}-wide data axis")
    model = Model(cfg)
    one = model.init_shapes()
    stacked = tree_map(lambda a: sds((members,) + tuple(a.shape), a.dtype),
                       one)
    resident = resident_bytes(stacked, member_shardings(stacked, mesh))
    tokens = sds((B, S), torch.int32)
    step = LMLearner(model, TrainConfig(), device="meta").label_step(members)
    _, tr = analysis.trace(step, [one] * members, {"tokens": tokens})
    lowered = analysis.Lowered(
        trace=tr, kind="label", cfg=cfg, mesh=mesh, param_shapes=one,
        batch=B, seq=S,
        resident_bytes=resident + tokens.numel() * tokens.element_size(),
        batch_parts=1, members=members)
    return lowered, cfg


def price_label_step(arch, members, batch, seq, mesh, mesh_name, cfg=None):
    """The record of one label step on ``mesh``: the full-depth trace
    for the peak memory, the depth probes extrapolated for the rest,
    and the protocol's framed bytes."""
    ndev = mesh.devices.size
    full, cfg = lower_label_step(arch, members, batch, seq, mesh, cfg)
    pcount = analysis.count_params(full.param_shapes)
    mf = analysis.model_flops(cfg, "prefill", batch * seq * members, pcount)
    roof_full = analysis.analyze(arch, "fedkt_label", mesh_name, full, ndev,
                                 mf)
    probes = [analysis.analyze(arch, "fedkt_label", mesh_name,
                               lower_label_step(arch, members, batch, seq,
                                                mesh, probe_cfg(cfg, n))[0],
                               ndev, mf) for n in (1, 2)]
    rec = analysis.extrapolate(roof_full, probes[0], probes[1],
                               effective_periods(cfg)).to_dict()
    rec["members"] = members
    rec["resident_bytes"] = full.resident_bytes
    rec["kernels"] = full.trace.kernels
    # each member ships its state once as a PartyUpdate; the vote labels
    # come back as one TokenLabels message of O(T) integers whatever the
    # vocabulary or the member count
    rec["protocol"] = codec.lm_protocol_bytes(full.param_shapes, members,
                                              batch, seq)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="phi4-mini-3.8b")
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--out", default=os.path.join(OUT_DIR,
                                                  "fedkt_step.json"))
    args = ap.parse_args(argv)

    mesh = make_production_mesh()
    rec = price_label_step(args.arch, args.members, args.batch, args.seq,
                           mesh, "pod1_16x16")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"[fedkt-step] {args.arch} M={args.members} B={args.batch} "
          f"S={args.seq}: t_c={rec['t_compute']:.3f}s "
          f"t_m={rec['t_memory']:.3f}s t_x={rec['t_collective']:.3f}s "
          f"dom={rec['dominant']} useful={rec['useful_ratio']:.3f}")
    print("collectives:", {k: f"{v/1e9:.2f}GB"
                           for k, v in rec["collective"].items()})
    pr = rec["protocol"]
    print(f"protocol: {pr['update_bytes_per_member']/1e9:.2f}GB/member up "
          f"(once), {pr['label_bytes']/1e6:.1f}MB labels down")


if __name__ == "__main__":
    main()
