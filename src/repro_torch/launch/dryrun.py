"""Dry-run: trace every (architecture x input shape) step on the meta
device, price it on a mesh of H100s, and extract the roofline terms
(``repro.launch.dryrun``).

The step is the port's own (``core/distill.make_train_step``,
``make_prefill_step``, ``make_decode_step``), run on meta tensors
under ``launch/analysis.py``'s counters: nothing is allocated and no
card is needed, so it runs anywhere.  As in the reference, two depth
probes (1 and 2 periods of the layer pattern) are extrapolated to full
depth for FLOPs, bytes and collectives, and a trace at full depth
gives the peak memory.  A trace does not depend on the mesh: ``main``
shares each one between the meshes it prices.

Usage (records go to ``--out``, by default ``build/dryrun/``):
  python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, TrainConfig,
                                 get_config, long_context_variant)
from repro_torch.configs.base import InputShape
from repro_torch.core.distill import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.launch import analysis
from repro_torch.launch.inputs import (decode_specs, prefill_batch_specs,
                                       train_batch_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.sharding import (batch_sharding, cache_sharding,
                                  opt_state_sharding, param_shardings)
from repro_torch.sharding.specs import batch_parts, resident_bytes

SKIPS = {
    # whisper's decoder has 448 positions in the real model; a 500k
    # decoder cache has no meaning for it
    ("whisper-tiny", "long_500k"): "enc-dec decoder has no 500k context",
}

# The reference's per-arch policies, kept so both dry-runs price the
# same steps: gradient accumulation where it fixed an out-of-memory
# pair, and no bf16 pre-gather for deepseek's 64-expert dispatch.
PREGATHER_POLICY = {"deepseek-moe-16b": False}

MICROBATCH_POLICY = {
    "rwkv6-7b": 4,
    "recurrentgemma-2b": 4,
    "gemma2-27b": 4,
    "llava-next-mistral-7b": 4,
    "granite-20b": 4,
}

OUT_DIR = os.path.join("build", "dryrun")


def probe_cfg(cfg, n_periods: int):
    """Depth-reduced variant with the same per-period structure:
    fkd dense layers + n_periods full patterns, no tail.  Costs are
    affine in depth, so two probes recover exact per-period deltas."""
    fkd = cfg.moe.first_k_dense if cfg.moe else 0
    kw = {"num_layers": fkd + n_periods * len(cfg.pattern)}
    if cfg.is_encoder_decoder:
        kw["num_encoder_layers"] = n_periods
    return cfg.replace(**kw)


def effective_periods(cfg) -> float:
    fkd = cfg.moe.first_k_dense if cfg.moe else 0
    p = len(cfg.pattern)
    rem = cfg.num_layers - fkd
    return rem // p + (rem % p) / p


def resolve_cfg(arch: str, shape_name: str):
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    notes = ""
    if shape_name == "long_500k":
        new = long_context_variant(cfg)
        if new is not cfg:
            notes = "SWA long-context variant (window 4096)"
        cfg = new
    if shape.kind != "train":
        cfg = cfg.replace(param_dtype="bfloat16")  # serving weights
    return cfg, shape, notes


def train_config(arch: str, shape: InputShape) -> TrainConfig:
    """The TrainConfig the dry-run prices ``arch`` at ``shape`` with."""
    return TrainConfig(batch_size=shape.global_batch, seq_len=shape.seq_len,
                       steps=1000, microbatches=MICROBATCH_POLICY.get(arch, 1),
                       pregather=PREGATHER_POLICY.get(arch, True))


def _trace_step(cfg, shape, tcfg):
    """The Trace of one step of ``cfg`` at ``shape`` on meta tensors."""
    model = Model(cfg)
    pshapes = model.init_shapes()
    if shape.kind == "train":
        step_fn, opt = make_train_step(model, tcfg)
        opt_state = opt.init(pshapes)
        return analysis.trace(step_fn, pshapes, opt_state,
                              train_batch_specs(cfg, shape))[1]
    if shape.kind == "prefill":
        return analysis.trace(make_prefill_step(model), pshapes,
                              prefill_batch_specs(cfg, shape))[1]
    token, cache, _ = decode_specs(cfg, shape)
    # the last slot of the cache: a decode step's attention reads every
    # slot whatever its position
    return analysis.trace(make_decode_step(model), pshapes, token, cache,
                          shape.seq_len - 1)[1]


def lower_combo(arch: str, shape_name, mesh, *, cfg=None, tcfg=None,
                traces=None):
    """Traces one (arch, shape) step and prices it on ``mesh``.  Returns
    (lowered, num_tokens, cfg, param_count, shape, notes); ``lowered``
    is an ``analysis.Lowered``.  ``shape_name`` may be an InputShape
    (then with ``cfg``); ``tcfg`` overrides the train step's config;
    ``traces``, a dict, keeps each trace for the other meshes."""
    shape = shape_name if isinstance(shape_name, InputShape) \
        else INPUT_SHAPES[shape_name]
    notes = ""
    if cfg is None:
        cfg, shape, notes = resolve_cfg(arch, shape.name)
    if shape.kind == "train" and tcfg is None:
        tcfg = train_config(arch, shape)
    traces = {} if traces is None else traces
    key = (cfg, shape, tcfg)
    if key not in traces:
        traces[key] = _trace_step(cfg, shape, tcfg)
    model = Model(cfg)
    pshapes = model.init_shapes()
    pshard = param_shardings(pshapes, mesh)
    resident = resident_bytes(pshapes, pshard)
    B = shape.global_batch
    if shape.kind == "train":
        oshapes = make_train_step(model, tcfg)[1].init(pshapes)
        resident += resident_bytes(oshapes, opt_state_sharding(oshapes, pshard,
                                                          mesh))
        bspecs = train_batch_specs(cfg, shape)
    elif shape.kind == "prefill":
        bspecs = prefill_batch_specs(cfg, shape)
    else:
        token, cache, _ = decode_specs(cfg, shape)
        bspecs = {"tokens": token}
        resident += resident_bytes(cache, cache_sharding(cache, mesh, B))
    resident += resident_bytes(bspecs, batch_sharding(bspecs, mesh))
    seq = 1 if shape.kind == "decode" else shape.seq_len
    lowered = analysis.Lowered(
        trace=traces[key], kind=shape.kind, cfg=cfg, mesh=mesh,
        param_shapes=pshapes, batch=B, seq=seq, resident_bytes=resident,
        batch_parts=batch_parts(mesh, B),
        remat=bool(tcfg and tcfg.remat),
        pregather=tcfg.pregather if tcfg else True)
    pcount = analysis.count_params(pshapes)
    return lowered, B * seq, cfg, pcount, shape, notes


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            *, force=False, quiet=False, traces=None):
    mesh_name = "pod2_2x16x16" if multi_pod else "pod1_16x16"
    out_path = os.path.join(
        out_dir, f"dryrun_{arch}_{shape_name}_{mesh_name}.json")
    if os.path.exists(out_path) and not force:
        if not quiet:
            print(f"[skip-cached] {arch} {shape_name} {mesh_name}")
        with open(out_path) as f:
            return json.load(f)
    if (arch, shape_name) in SKIPS:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "skipped": SKIPS[(arch, shape_name)]}
        _write(out_path, rec)
        if not quiet:
            print(f"[skip] {arch} {shape_name}: {SKIPS[(arch, shape_name)]}")
        return rec

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    ndev = mesh.devices.size
    traces = {} if traces is None else traces
    try:
        rec = price(arch, shape_name, mesh, mesh_name, traces=traces)
        rec["compile_seconds"] = round(time.time() - t0, 1)
        _write(out_path, rec)
        if not quiet:
            print(f"[ok] {arch:24s} {shape_name:12s} {mesh_name:14s} "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"bytes/dev={rec['bytes_per_device']:.3e} "
                  f"wire/dev={rec['wire_bytes_per_device']:.3e} "
                  f"dom={rec['dominant']:10s} "
                  f"({rec['compile_seconds']}s)")
        return rec
    except Exception as e:   # a pair's failure is its record; go on
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "num_devices": ndev, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
        _write(out_path, rec)
        print(f"[FAIL] {arch} {shape_name} {mesh_name}: "
              f"{type(e).__name__}: {e}")
        return rec


def price(arch, shape_name, mesh, mesh_name, *, cfg=None, tcfg=None,
          traces=None):
    """The record of one (arch, shape) on ``mesh``: the full-depth trace
    for the peak memory, the depth probes extrapolated for FLOPs, bytes
    and collectives.  ``cfg``, ``tcfg`` and an InputShape for
    ``shape_name`` price a step outside the registry's pairs."""
    traces = {} if traces is None else traces
    ndev = mesh.devices.size
    lowered, ntok, cfg, pcount, shape, notes = lower_combo(
        arch, shape_name, mesh, cfg=cfg, tcfg=tcfg, traces=traces)
    mf = analysis.model_flops(cfg, shape.kind, ntok, pcount)
    roof_full = analysis.analyze(arch, shape.name, mesh_name, lowered, ndev,
                                 mf, notes=notes)
    probes = [analysis.analyze(arch, shape.name, mesh_name, lower_combo(
        arch, shape, mesh, cfg=probe_cfg(cfg, npd), tcfg=tcfg,
        traces=traces)[0], ndev, mf) for npd in (1, 2)]
    roof = analysis.extrapolate(roof_full, probes[0], probes[1],
                                effective_periods(cfg))
    rec = roof.to_dict()
    rec.update({
        "param_count": pcount,
        "num_devices": ndev,
        "resident_bytes": lowered.resident_bytes,
        "activation_peak_bytes": (lowered.trace.peak_live_bytes
                                  // lowered.batch_parts),
        "kernels": lowered.trace.kernels,
        "skipped": None,
    })
    return rec


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or
                               (args.all and not args.multi_pod)) \
        else [args.multi_pod]

    n_fail = 0
    traces: dict = {}
    for a in archs:
        for s in shapes:
            for mp in meshes:
                rec = run_one(a, s, mp, args.out, force=args.force,
                              traces=traces)
                if rec.get("error"):
                    n_fail += 1
            traces.clear()
    print(f"done; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
