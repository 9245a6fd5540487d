"""Four-card checks of the SPMD backend and of the aggregator across
cards: what one card cannot show (``chip_smoke.py`` runs on one).

    python -m repro_torch.multicard_smoke [--out FILE]

needs four cards on one host.  It prints one line per check, raises on
the first that fails (the exit code is then non-zero) and catches
nothing.  The SPMD runs are ``torchrun --standalone`` jobs (a free
rendezvous port) of ``python -m repro_torch run --backend spmd``, one
rank per card on NCCL unless a phase says otherwise:

* ``[nccl]``: xlstm-350m at its published width, ``chip_smoke.py``'s
  ``[spmd]`` spec (hybrid g 1 -> 2 -> 4, 3 steps of 32 x 64, SGD):
  twice on NCCL, final params bitwise equal, then the same spec as
  ``[spmd]`` runs it (four gloo ranks sharing one card), final params
  and losses within rtol 1e-5 / atol 1e-6;
* ``[fsdp]``: phi4-mini-3.8b at full width, remat "block", sync g 4
  over the four cards in the FSDP layout, AdamW, S 4096 with 2 rows a
  card taken as 2 micro-batches of one row (``train_4k``'s micro-batch
  under ``dryrun --cards 4``); each card's state against the dry-run's
  ``fsdp_partition_rules`` to the byte, its step peak within 10% or
  256 MiB, the step's seconds and tokens/s;
* ``[hybrid]``: h2o-danube-1.8b at full width, hybrid g 1 -> 2 -> 4,
  two steps a phase: merges at K 4, 2, 1, one ``flush`` launch on every
  rank each, divergence > 0 exactly while R > 1;
* ``[staging]``: ``SlabAggregator`` with its chunks on the four cards
  against one card, ``flush``, ``flush_momentum`` and ``flush_adamw``,
  f32 and bf16 rows, bitwise; then zoo:xlstm x1.0 in the simulator,
  25 workers, its staging across the cards;
* ``[tensor]`` (after ``[fsdp]``, whose first loss it reads): the model
  axis (``parallel/tensor.py``).  phi4-mini-3.8b as ``[fsdp]`` runs it
  (full width, remat "block", sync, AdamW, S 4096, 8 rows a step) at
  ``--mesh-model 2`` (data 2) and 4 (data 1), each in the micro-batches
  the dry-run derives for its tensor-parallel step at that shape: each
  card's state against the dry-run to the byte, its step peak within
  10% or 256 MiB of the traced peak, the first loss within 3e-2 of
  ``[fsdp]``'s (same seed and rows; the row-parallel sums add in
  another order), the step seconds, tokens/s and collective seconds by
  kind; then h2o-danube-1.8b hybrid step:2 at ``--mesh-model 2`` (g 1 ->
  2, R 2 -> 1, SGD, 1 x 1024 a data position) twice: merges at K 2 and
  K 1 with one ``flush`` launch on every rank each, divergence > 0
  exactly while R > 1, final params bitwise equal;
* ``[tensor-moe]``: the model axis for MLA and the MoE.
  deepseek-v2-lite-16b at its published width and depth (27 MLA + MoE
  groups, bf16 weights), sync, SGD, one row of 4096 a card a step, in
  three layouts of the same model and rows side by side: data 4 (FSDP),
  data 2 x model 2 and data 1 x model 4, each in the micro-batches the
  dry-run derives: each card's state against the dry-run to the byte,
  its step peak within 10% or 256 MiB of the traced peak, the first
  loss at M 2 and 4 within 3e-2 of data 4's, the whole leaves' and
  every MoE layer's routing digests equal across each model group,
  steps/s, tokens/s and collective seconds by kind, and the final
  params assembled in rank 0's host memory (the config's shapes,
  finite, the whole leaves the ranks' bit for bit).  AdamW does not fit
  at full depth (the dry-run's traced peak is 123.5 GB a card at every
  M), so the step is SGD's;
* ``[tensor-moe-hybrid]``: deepseek-v2-lite-16b hybrid step:1 at
  ``--mesh-model 2`` (g 1 -> 2, R 2 -> 1, 1 x 1024 a data position) at
  the most groups whose phase switch (by its count) and g 1 step (by
  the dry-run's trace) fit a card with 10% to spare: merges at K 2 and
  K 1 per model column with one ``flush`` launch a rank each,
  divergence > 0 exactly while R > 1, the digests equal, the final
  params assembled as ``[tensor-moe]``'s;
* ``[tensor-ssm]``: the model axis for mamba and the xLSTM cells.
  jamba-v0.1-52b at its published width (mamba + attention, MLP and
  MoE; bf16 weights), sync, SGD, one row of 4096 a card a step, at data
  2 x model 2 and data 1 x model 4, at ``SSM_GROUPS`` of its 4 block
  groups (the host's draw, not the card, caps the depth), in the fewest
  micro-batches whose traced step peak fits a card with 10% to spare at
  both M: each card's state
  against the dry-run to the byte, its step peak within 10% or 256 MiB
  of the traced peak, the first loss at M 4 within 3e-2 of M 2's, the
  whole leaves' and the routing digests equal across each model group,
  the final params assembled in rank 0's host memory (the cut config's
  shapes, mamba's ``w_in`` whole, finite); then xlstm-350m at its
  published width and depth, hybrid step:1 at data 2 x model 2 (g 1 ->
  2, R 2 -> 1), twice: merges at K 2 and K 1 with one ``flush`` launch
  on every rank each, divergence > 0 exactly while R > 1, the whole
  leaves equal across each model group, final params bitwise equal;
* ``[serve-tp]``: the serving forward over the model axis (ROADMAP
  A16c.5, ``serve_smoke.py``).  jamba-v0.1-52b at ``SSM_GROUPS`` of its
  4 groups (the only card path through mamba's sliced decode) and
  deepseek-v2-lite-16b at full depth, full width, bf16, the params
  drawn sliced from one seed on each card: 8 prompts of 32 tokens, 16
  new, a cache of 48, at data 2 x model 2 and at data 1 x model 4; and
  1 prompt (``long_500k``'s B 1, which the data axis does not divide:
  every card serves the row, the cache cut along its sequence or
  channels, ROADMAP A16c.5b) at data 2 x model 2 (in the same torchrun)
  and at data 4 x model 1.  bf16 for the launches and times; then the
  same slices drawn in float32, whose prefill's last-position logits
  and decode's logits fed rank 0's whole run's tokens are within 1e-3
  of the same params served whole in float32 (``serve_smoke.F32_TOL``),
  each card's cache bytes the dry-run's to the byte, the tokens and
  routing digests equal across the cards serving the same rows, rmsnorm
  and flash launched on every card; decode ms a step and collective
  seconds by kind.  All the runs end before any is checked, so a failed
  check still leaves every run's figures.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

XLSTM_BATCH, XLSTM_SEQ, XLSTM_LR = 32, 64, 3e-5
XLSTM_RUN = ["--arch", "xlstm-350m", "--no-smoke", "--mode", "hybrid",
             "--schedule", "step:1", "--steps", "3", "--batch",
             str(XLSTM_BATCH), "--seq", str(XLSTM_SEQ), "--lr",
             str(XLSTM_LR), "--optimizer", "sgd", "--log-every", "1"]
PHI4 = "phi4-mini-3.8b"
PHI4_SEQ, PHI4_ROWS, PHI4_MICRO, PHI4_STEPS = 4096, 2, 2, 3
H2O_RUN = ["--arch", "h2o-danube-1.8b", "--no-smoke", "--mode", "hybrid",
           "--schedule", "step:2", "--steps", "6", "--batch", "4", "--seq",
           "1024", "--lr", "1e-5", "--optimizer", "sgd", "--log-every", "1"]
CARDS = 4
TOL = (1e-5, 1e-6)             # float32, across backends
PEAK_RTOL, PEAK_SLACK = 0.10, 256 << 20     # chip_smoke.py's [dryrun] rule
ZOO_WORKERS, ZOO_HORIZON, ZOO_LR = 25, 0.125, 3e-5
RUN_TIMEOUT = 900.0
FSDP_CHILD = "--fsdp-child"
TENSOR_CHILD = "--tensor-child"
TENSOR_MODELS = (2, 4)
TENSOR_LOSS_ATOL = 3e-2
DS = "deepseek-v2-lite-16b"
DS_SEQ, DS_ROWS, DS_STEPS, DS_LR = 4096, 1, 3, 1e-5
MOE_MODELS = (1, 2, 4)
MOE_CHILD = "--moe-child"
DS_HYBRID_SEQ, DS_HYBRID_MODEL = 1024, 2
# what a rank holds at the hybrid run's phase switch besides its params
# (launch/train.py): 8 bytes a padded slab element (the float32
# all-to-all's send and receive copies, or the (R, c) rows with their
# merge, or the reshard with the replica it assembles), and one
# SEGMENT_PIECE of temporaries at 16 bytes an element
MERGE_SLAB_BYTES, MERGE_PIECE_BYTES = 8, 16
JAMBA = "jamba-v0.1-52b"
SSM_SEQ, SSM_ROWS, SSM_STEPS, SSM_LR = 4096, 1, 3, 1e-5
SSM_MODELS = (2, 4)
# jamba's depth: every rank draws every parameter on the host to take its
# slices, 97-114 M a second on the four-card host, so one group (13.3 G
# parameters) takes 115-140 s a run; two would fit the cards (traced peak
# 0.770 of one) but double a phase that already takes about 20 minutes
SSM_GROUPS = 1
XLSTM_TP_RUN = ["--arch", "xlstm-350m", "--no-smoke", "--mode", "hybrid",
                "--schedule", "step:1", "--steps", "2", "--batch", "4",
                "--seq", "512", "--lr", "1e-5", "--optimizer", "sgd",
                "--log-every", "1", "--mesh-model", "2"]
# [serve-tp]: the batch, prompt, new tokens and cache length (M 2 and 4
# divide 48)
SERVE_TP = dict(batch=8, prompt=32, gen=16, max_seq=48)
SERVE_RUNS = ((JAMBA, SSM_GROUPS), (DS, 27))       # deepseek: all 27
# the batches each model width serves, in one torchrun: 8 rows, and 1
# row, which the data positions do not divide (regime (b))
SERVE_MODELS = {2: (8, 1), 4: (8,), 1: (1,)}
SERVE_CHILD = "--serve-child"
H2O_TP_RUN = ["--arch", "h2o-danube-1.8b", "--no-smoke", "--mode", "hybrid",
              "--schedule", "step:2", "--steps", "4", "--batch", "2",
              "--seq", "1024", "--lr", "1e-5", "--optimizer", "sgd",
              "--log-every", "1", "--mesh-model", "2"]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _env(**extra):
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1", **extra)


def _torchrun(args, env, timeout=RUN_TIMEOUT) -> str:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(CARDS), *args]
    proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=timeout)
    check(proc.returncode == 0, f"torchrun {' '.join(args[:4])} exited "
          f"{proc.returncode}:\n{proc.stdout[-4000:]}")
    return proc.stdout


def spmd_run(args, out, ckpt_dir=None, **env) -> dict:
    """``python -m repro_torch run --backend spmd`` on four ranks; the
    RunResult rank 0 writes."""
    extra = ["--ckpt-dir", ckpt_dir] if ckpt_dir else []
    _torchrun(["-m", "repro_torch", "run", "--backend", "spmd", *args,
               "--device", "cuda", "--quiet", "--out", out, *extra],
              _env(**env))
    with open(out) as f:
        return json.load(f)


def _npz(path):
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _kinds(extra) -> str:
    by_kind = extra["collective_s_by_kind"]
    return "; ".join(f"{k} {[round(r[k], 3) for r in by_kind]}"
                     for k in by_kind[0])


def _walls(history):
    w = [h["wall_s"] for h in history]
    return [round(b - a, 2) for a, b in zip([0.0] + w[:-1], w)]


# ------------------------------------------------------------------ [nccl]

def phase_nccl(tmp: str) -> dict:
    import numpy as np
    runs = {}
    for label, env in (("nccl-a", {}), ("nccl-b", {}),
                       ("gloo", {"CUDA_VISIBLE_DEVICES": "0"})):
        t0 = time.time()
        runs[label] = spmd_run(XLSTM_RUN, os.path.join(tmp, label + ".json"),
                               ckpt_dir=os.path.join(tmp, label), **env)
        runs[label]["outer_s"] = time.time() - t0
    for label, res in runs.items():
        ex = res["extra"]
        want = "gloo" if label == "gloo" else "nccl"
        check(ex["backend"] == want and ex["world_size"] == CARDS,
              f"[nccl] {label}: backend {ex['backend']}, world "
              f"{ex['world_size']}")
        hist = res["extra"]["history"]
        check([h["group_size"] for h in hist] == [1, 2, 4],
              f"[nccl] {label}: group sizes {[h['group_size'] for h in hist]}")
        check([m["K"] for m in ex["merges"]] == [4, 2, 1],
              f"[nccl] {label}: merges {ex['merges']}")
        check(all((h["divergence"] > 0) == (h["replicas"] > 1)
                  for h in hist), f"[nccl] {label}: divergence "
              f"{[h['divergence'] for h in hist]}")
        log(f"[nccl] xlstm-350m full width, {label}: backend "
            f"{ex['backend']}, world {ex['world_size']}, devices "
            f"{ex['device_name']}; layout "
            f"{[(p['g'], p['fsdp']) for p in ex['layout']]}; wall "
            f"{res['wall_s']:.2f} s in rank 0's trainer "
            f"({res['num_updates'] / res['wall_s']:.3f} steps/s), "
            f"{res['outer_s']:.2f} s with torchrun; step walls "
            f"{_walls(hist)} s; losses "
            f"{[round(h['loss'], 6) for h in hist]}; divergence "
            f"{[float('%.6g' % h['divergence']) for h in hist]}; "
            f"collective s by rank {[round(x, 3) for x in ex['collective_s']]}"
            f", by kind: {_kinds(ex)}; peak GiB by rank "
            f"{[round(b / 2**30, 2) for b in ex['peak_memory_bytes']]}")
    final = {label: _npz(os.path.join(tmp, label, "step_3.npz"))
             for label in runs}
    a, b = final["nccl-a"], final["nccl-b"]
    check(sorted(a) == sorted(b) and all(
        a[k].tobytes() == b[k].tobytes() for k in a),
        "[nccl] two NCCL runs' final params differ")
    ha = runs["nccl-a"]["extra"]["history"]
    hb = runs["nccl-b"]["extra"]["history"]
    check([(h["loss"], h["divergence"]) for h in ha] ==
          [(h["loss"], h["divergence"]) for h in hb],
          "[nccl] two NCCL runs' histories differ")
    log("[nccl] two NCCL runs: final params bitwise equal, histories "
        "equal")
    rtol, atol = TOL
    worst = 0.0
    for k, want in final["gloo"].items():
        got = a[k]
        worst = max(worst, float(np.abs(got.astype(np.float64)
                                        - want.astype(np.float64)).max()))
        check(np.allclose(got, want, rtol=rtol, atol=atol),
              f"[nccl] {k}: NCCL vs gloo beyond rtol {rtol} atol {atol}")
    for x, y in zip(ha, runs["gloo"]["extra"]["history"]):
        for key in ("loss", "divergence"):
            check(math.isclose(x[key], y[key], rel_tol=rtol, abs_tol=atol),
                  f"[nccl] {key} NCCL {x[key]} vs gloo {y[key]}")
    log(f"[nccl] NCCL against gloo on one card: final params max abs diff "
        f"{worst:.3e} (rtol {rtol:g}, atol {atol:g}), losses and "
        f"divergence within it")
    return {k: {"wall_s": v["wall_s"], "outer_s": v["outer_s"],
                "collective_s_by_kind": v["extra"]["collective_s_by_kind"],
                "layout": v["extra"]["layout"]} for k, v in runs.items()}


# ------------------------------------------------------------------ [fsdp]

def _phi4_spec(mesh_model: int = 1):
    from repro_torch.api.spec import ExperimentSpec
    return ExperimentSpec(arch=PHI4, backend="spmd", mode="sync",
                          steps=PHI4_STEPS, batch=PHI4_ROWS * CARDS,
                          seq=PHI4_SEQ, lr=3e-4, optimizer="adamw",
                          beta2=0.95, smoke=False, log_every=1,
                          mesh_model=mesh_model)


def fsdp_child(out: str) -> int:
    """A rank of ``[fsdp]`` (started by torchrun): phi4-mini-3.8b's sync
    run with 2 micro-batches a step."""
    from repro_torch.launch.train import run_training
    run_training(_phi4_spec(), out_json=out, verbose=True, device="cuda",
                 microbatch=PHI4_MICRO)
    return 0


def phase_fsdp(tmp: str) -> dict:
    from repro_torch.configs.registry import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.optim.optimizers import adamw
    spec = _phi4_spec()
    shape = InputShape("fsdp", PHI4_SEQ, PHI4_ROWS * CARDS, "train")
    t0 = time.time()
    pred = dryrun.fsdp_layout(get_config(PHI4), shape, CARDS,
                              microbatch=PHI4_MICRO, hybrid_rep=1,
                              optimizer=adamw(spec.lr, b2=spec.beta2))
    log(f"[fsdp] the dry-run's fsdp_partition_rules for {PHI4} on "
        f"{CARDS} cards, {PHI4_ROWS} rows of {PHI4_SEQ} a card in "
        f"{PHI4_MICRO} micro-batches (meta device, "
        f"{time.time() - t0:.1f} s): state {pred['state_bytes']} B, peak "
        f"{pred['peak_bytes']} B, collectives a step "
        f"{ {k: int(v) for k, v in pred['collective_bytes_per_device'].items()} } B")
    out = os.path.join(tmp, "fsdp.json")
    t0 = time.time()
    text = _torchrun(["-m", "repro_torch.multicard_smoke", FSDP_CHILD, out],
                     _env())
    outer = time.time() - t0
    with open(out) as f:
        res = json.load(f)
    st, hist = res["stats"], res["history"]
    check(st["backend"] == "nccl" and st["world_size"] == CARDS,
          f"[fsdp] backend {st['backend']}, world {st['world_size']}")
    (lay,) = st["layout"]
    check((lay["g"], lay["fsdp"]) == (CARDS, True), f"[fsdp] layout {lay}")
    state = pred["state_bytes_total"]
    check(all(b == state for b in lay["state_bytes"]),
          f"[fsdp] state bytes by card {lay['state_bytes']}, the dry-run's "
          f"{state}")
    peak = pred["peak_bytes"]
    tol = max(PEAK_RTOL * peak, PEAK_SLACK)
    check(all(abs(b - peak) <= tol for b in lay["step_peak_bytes"]),
          f"[fsdp] step peaks by card {lay['step_peak_bytes']}, the "
          f"dry-run's {peak} within {tol:.0f}")
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"[fsdp] losses {losses}")
    steps = _walls(hist)
    tokens = spec.batch * spec.seq
    log(f"[fsdp] {PHI4} full width, remat {st['remat']}, sync g {CARDS} "
        f"over {CARDS} x {st['device_name']} on {st['backend']}, AdamW, "
        f"{PHI4_ROWS} x {PHI4_SEQ} a card in {PHI4_MICRO} micro-batches: "
        f"state {lay['state_bytes'][0]} B a card = the dry-run's to the "
        f"byte; held before the first step by card {lay['held_bytes']} B; "
        f"step peak by card {lay['step_peak_bytes']} B against "
        f"{peak} B (ratios "
        f"{[round(b / peak, 6) for b in lay['step_peak_bytes']]})")
    log(f"[fsdp] step walls {steps} s (the first builds the groups); "
        f"last step {steps[-1]:.3f} s = {tokens / steps[-1]:.1f} tokens/s "
        f"({tokens} tokens a step); losses {[round(x, 4) for x in losses]};"
        f" collective s by kind: "
        f"{_kinds({'collective_s_by_kind': st['collective_s_by_kind']})};"
        f" {outer:.1f} s with torchrun and start-up")
    return {"prediction": pred, "layout": lay, "step_walls": steps,
            "tokens_per_step": tokens, "losses": losses,
            "collective_s_by_kind": st["collective_s_by_kind"],
            "outer_s": outer, "log_tail": text[-2000:]}


# ---------------------------------------------------------------- [tensor]

def tensor_child(out: str, mesh_model: int, microbatch: int) -> int:
    """A rank of ``[tensor]``'s phi4-mini-3.8b run (started by
    torchrun)."""
    from repro_torch.launch.train import run_training
    run_training(_phi4_spec(mesh_model), out_json=out, verbose=True,
                 device="cuda", microbatch=microbatch)
    return 0


def _tensor_prediction(spec, mesh_model: int, cfg=None, opt=None,
                       label: str = "[tensor]"):
    """The micro-batch the dry-run derives for the tensor-parallel step
    at ``spec``'s shape on four cards (the smallest power of two whose
    traced peak fits a card), and its ``fsdp_partition_rules`` layout;
    ``cfg`` and ``opt`` default to phi4-mini-3.8b's and AdamW."""
    from repro_torch.configs.registry import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import card_memory_bytes, derive_microbatch
    from repro_torch.optim.optimizers import adamw
    cfg = cfg or get_config(PHI4)
    shape = InputShape("tensor", spec.seq, spec.batch, "train")
    opt = opt or adamw(spec.lr, b2=spec.beta2)
    rows = spec.batch // (CARDS // mesh_model)
    micro, fits = derive_microbatch(
        rows, lambda m: dryrun.analyze_step(
            cfg, shape, CARDS, m, fsdp=True, optimizer=opt,
            model=mesh_model)[0].peak_bytes, card_memory_bytes("meta"))
    check(fits, f"{label} M {mesh_model}: no micro-batch of {rows} rows "
          "fits a card")
    return micro, dryrun.fsdp_layout(cfg, shape, CARDS, microbatch=micro,
                                     optimizer=opt, model=mesh_model)


def phase_tensor(tmp: str, fsdp: dict) -> dict:
    out = {}
    first = fsdp["losses"][0]
    for mm in TENSOR_MODELS:
        spec = _phi4_spec(mm)
        t0 = time.time()
        micro, pred = _tensor_prediction(spec, mm)
        log(f"[tensor] the dry-run for {PHI4} on {CARDS} cards as data "
            f"{CARDS // mm} x model {mm}, {spec.batch} rows of {spec.seq} "
            f"a step: micro-batches {micro} (derived), state "
            f"{pred['state_bytes']} B, traced peak {pred['peak_bytes']} B, "
            f"collectives a step "
            f"{ {k: int(v) for k, v in pred['collective_bytes_per_device'].items()} }"
            f" B (meta device, {time.time() - t0:.1f} s)")
        path = os.path.join(tmp, f"tensor{mm}.json")
        t0 = time.time()
        _torchrun(["-m", "repro_torch.multicard_smoke", TENSOR_CHILD, path,
                   str(mm), str(micro)], _env())
        outer = time.time() - t0
        with open(path) as f:
            res = json.load(f)
        st, hist = res["stats"], res["history"]
        check(st["backend"] == "nccl" and st["world_size"] == CARDS
              and st["mesh_model"] == mm,
              f"[tensor] M {mm}: backend {st['backend']}, world "
              f"{st['world_size']}, mesh_model {st['mesh_model']}")
        (lay,) = st["layout"]
        check((lay["g"], lay["model"]) == (CARDS // mm, mm),
              f"[tensor] M {mm}: layout {lay}")
        state = pred["state_bytes_total"]
        check(all(b == state for b in lay["state_bytes"]),
              f"[tensor] M {mm}: state bytes by card {lay['state_bytes']}, "
              f"the dry-run's {state}")
        peak = pred["peak_bytes"]
        tol = max(PEAK_RTOL * peak, PEAK_SLACK)
        check(all(abs(b - peak) <= tol for b in lay["step_peak_bytes"]),
              f"[tensor] M {mm}: step peaks by card "
              f"{lay['step_peak_bytes']}, the dry-run's {peak} within "
              f"{tol:.0f}")
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(x) for x in losses)
              and abs(losses[0] - first) <= TENSOR_LOSS_ATOL,
              f"[tensor] M {mm}: losses {losses}, [fsdp]'s first {first}")
        steps = _walls(hist)
        tokens = spec.batch * spec.seq
        by_kind = st["collective_s_by_kind"]
        log(f"[tensor] {PHI4} full width, remat {st['remat']}, sync over "
            f"{CARDS} x {st['device_name']} on {st['backend']} as data "
            f"{lay['g']} x model {mm}, AdamW, {spec.batch} x {spec.seq} a "
            f"step in {micro} micro-batches a data position: state "
            f"{lay['state_bytes'][0]} B a card = the dry-run's to the byte; "
            f"step peak by card {lay['step_peak_bytes']} B against {peak} B "
            f"(ratios {[round(b / peak, 6) for b in lay['step_peak_bytes']]}"
            f"); first loss {losses[0]:.6f} against [fsdp]'s {first:.6f} "
            f"(diff {losses[0] - first:.3e})")
        log(f"[tensor] M {mm}: step walls {steps} s; last step "
            f"{steps[-1]:.3f} s = {tokens / steps[-1]:.1f} tokens/s "
            f"({tokens} tokens a step); losses {[round(x, 4) for x in losses]}"
            f"; collective s by kind and card: " + "; ".join(
                f"{k} {[round(r[k], 3) for r in by_kind]}"
                for k in by_kind[0]) + f"; {outer:.1f} s with torchrun")
        out[f"phi4 M{mm}"] = {"microbatch": micro, "prediction": pred,
                              "layout": lay, "losses": losses,
                              "step_walls": steps, "tokens_per_step": tokens,
                              "collective_s_by_kind": by_kind,
                              "outer_s": outer}
    runs = []
    for label in ("a", "b"):
        t0 = time.time()
        res = spmd_run(H2O_TP_RUN, os.path.join(tmp, f"h2o-tp-{label}.json"),
                       ckpt_dir=os.path.join(tmp, f"h2o-tp-{label}"))
        ex, hist = res["extra"], res["extra"]["history"]
        check(ex["backend"] == "nccl" and ex["mesh_model"] == 2,
              f"[tensor] h2o: backend {ex['backend']}, mesh_model "
              f"{ex.get('mesh_model')}")
        check([(h["group_size"], h["replicas"]) for h in hist] ==
              [(1, 2), (1, 2), (2, 1), (2, 1)], f"[tensor] h2o: {hist}")
        check([m["K"] for m in ex["merges"]] == [2, 1],
              f"[tensor] h2o: merges {ex['merges']}")
        check(all(r == {"1": 1, "2": 1}
                  for r in ex["flush_launches_by_rank"]),
              f"[tensor] h2o: flush launches by rank "
              f"{ex['flush_launches_by_rank']}")
        check(all((h["divergence"] > 0) == (h["replicas"] > 1)
                  and math.isfinite(h["loss"]) for h in hist),
              f"[tensor] h2o: history {hist}")
        log(f"[tensor] h2o-danube-1.8b full width, remat {ex['remat']}, "
            f"NCCL data 2 x model 2, run {label}: g "
            f"{[h['group_size'] for h in hist]}, merges K "
            f"{[m['K'] for m in ex['merges']]}, flush launches by rank "
            f"{ex['flush_launches_by_rank']}; divergence "
            f"{[float('%.6g' % h['divergence']) for h in hist]}; losses "
            f"{[round(h['loss'], 6) for h in hist]}; layout "
            f"{[(p['g'], p['model'], p['fsdp'], p['state_bytes'][0]) for p in ex['layout']]}"
            f"; step walls {_walls(hist)} s; collective s by kind: "
            + "; ".join(f"{k} {[round(r[k], 3) for r in ex['collective_s_by_kind']]}"
                        for k in ex["collective_s_by_kind"][0])
            + f"; {time.time() - t0:.1f} s with torchrun")
        runs.append(res)
    a, b = (_npz(os.path.join(tmp, f"h2o-tp-{x}", "step_4.npz"))
            for x in ("a", "b"))
    check(sorted(a) == sorted(b) and all(
        a[k].tobytes() == b[k].tobytes() for k in a),
        "[tensor] h2o: two runs' final params differ")
    log("[tensor] h2o: two runs' final params bitwise equal")
    out["h2o"] = [{"history": r["extra"]["history"],
                   "merges": r["extra"]["merges"],
                   "layout": r["extra"]["layout"],
                   "collective_s_by_kind": r["extra"]["collective_s_by_kind"]}
                  for r in runs]
    return out


# ------------------------------------------------------------ [tensor-moe]

def _ds_spec(mesh_model: int, hybrid: bool = False):
    from repro_torch.api.spec import ExperimentSpec
    if hybrid:
        return ExperimentSpec(
            arch=DS, backend="spmd", mode="hybrid", schedule="step:1",
            steps=2, batch=CARDS // mesh_model, seq=DS_HYBRID_SEQ,
            lr=DS_LR, optimizer="sgd", smoke=False, log_every=1,
            mesh_model=mesh_model)
    return ExperimentSpec(arch=DS, backend="spmd", mode="sync",
                          steps=DS_STEPS, batch=DS_ROWS * CARDS, seq=DS_SEQ,
                          lr=DS_LR, optimizer="sgd", smoke=False,
                          log_every=1, mesh_model=mesh_model)


def _ds_config(groups: int):
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(DS), num_groups=groups)


def at_depth(arch: str, groups: int) -> None:
    """In this process, ``arch``'s registry config cut to ``groups`` of
    its block groups, its widths unchanged: a smoke run's own config,
    which ``run_training`` reads through ``get_config``."""
    import dataclasses
    import importlib
    from repro_torch.configs import registry
    mod = importlib.import_module(
        f"repro_torch.configs.{registry._MODULES[arch]}")
    mod.CONFIG = dataclasses.replace(mod.CONFIG, num_groups=groups)


def moe_child(out: str, spec_path: str, micro: int, groups: int) -> int:
    """A rank of a ``[tensor-moe]`` or ``[tensor-ssm]`` run (started by
    torchrun): the spec at ``spec_path`` on its arch cut to ``groups`` of
    its block groups.  Rank 0 writes what it assembled of the final
    params (in its host memory) beside ``out``."""
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.launch.train import run_training
    with open(spec_path) as f:
        spec = ExperimentSpec.from_json(f.read())
    at_depth(spec.arch, groups)
    t0 = time.time()
    final, _, _ = run_training(spec, out_json=out, verbose=True,
                               device="cuda", microbatch=micro)
    if final is not None:
        with open(out + ".final.json", "w") as f:
            json.dump(final_summary(final, spec.mesh_model,
                                    time.time() - t0), f)
    return 0


def final_summary(final, model: int, seconds: float) -> dict:
    """What rank 0 holds of a run's final params: their leaves' devices,
    shapes and dtypes, whether every value is finite, and 48 bits of the
    SHA-256 of the leaves whole on every model rank at ``model`` > 1,
    in the slab's leaf order (``launch/train.py`` digests the same
    leaves in that order after the last step, and a merge of one
    replica changes no bit of them)."""
    import hashlib
    import torch
    from repro_torch.core.slab import slab_codec
    from repro_torch.parallel.tensor import model_dims
    dims = model_dims(final, model)
    h = hashlib.sha256()
    leaves = []
    for path, t in slab_codec(final).items(final):
        path = tuple(str(n) for n in path)
        leaves.append(["/".join(path), list(t.shape), str(t.dtype),
                       str(t.device), bool(torch.isfinite(t).all())])
        if model > 1 and dims[path] is None:
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return {"leaves": leaves, "seconds": seconds,
            "whole_digest": int.from_bytes(h.digest()[:6], "big")}


def check_final(label: str, res: dict, cfg, model: int) -> None:
    """The final params rank 0 assembled: the whole shapes and dtypes of
    ``cfg``'s params, in host memory, finite, and their whole leaves the
    trained ranks' bit for bit."""
    from repro_torch.launch import dryrun
    from repro_torch.parallel.partition import map_with_path
    want = {}
    map_with_path(lambda p, t: want.__setitem__(
        "/".join(p), [list(t.shape), str(t.dtype)]),
        dryrun.meta_params(cfg))
    fin = res["final"]
    got = {leaf[0]: leaf[1:3] for leaf in fin["leaves"]}
    diff = sorted(k for k in set(got) | set(want)
                  if got.get(k) != want.get(k))
    check(not diff, f"{label}: assembled leaves unlike the config's: "
          + "; ".join(f"{k} {got.get(k)} against {want.get(k)}"
                      for k in diff[:4]))
    check(all(leaf[3] == "cpu" and leaf[4] for leaf in fin["leaves"]),
          f"{label}: assembled leaves not finite or not in host memory")
    whole = res["stats"].get("whole_digest_by_rank", [fin["whole_digest"]])
    check(model == 1 or fin["whole_digest"] == whole[0],
          f"{label}: the assembled whole leaves' digest "
          f"{fin['whole_digest']}, the ranks' {whole}")


def _moe_run(tmp: str, label: str, spec, micro: int, groups: int):
    spec_path = os.path.join(tmp, label + ".spec.json")
    with open(spec_path, "w") as f:
        f.write(spec.to_json())
    out = os.path.join(tmp, label + ".json")
    t0 = time.time()
    _torchrun(["-m", "repro_torch.multicard_smoke", MOE_CHILD, out,
               spec_path, str(micro), str(groups)], _env())
    with open(out) as f:
        res = json.load(f)
    with open(out + ".final.json") as f:
        res["final"] = json.load(f)
    res["outer_s"] = time.time() - t0
    return res


def _groups_equal(values, mm: int) -> bool:
    return all(values[r] == values[r - r % mm] for r in range(len(values)))


def _hybrid_groups(opt):
    """The most of deepseek-v2-lite-16b's 27 block groups whose hybrid
    run at model 2 fits a card: what a rank holds at the phase switch
    (its model slices' bytes, ``MERGE_SLAB_BYTES`` a padded element of
    its model column's slab and ``MERGE_PIECE_BYTES`` a
    ``SEGMENT_PIECE`` element) and the dry-run's traced peak of the g 1
    step, each within the card with the peak check's own margin
    (``PEAK_RTOL``).  Returns the groups, the switch's bytes and each
    phase's dry-run layout."""
    from repro_torch.configs.registry import InputShape, get_config
    from repro_torch.core.slab import slab_codec
    from repro_torch.core.spmd_hybrid import SEGMENT_PIECE
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import tree_bytes
    from repro_torch.launch.steps import card_memory_bytes
    from repro_torch.parallel.fsdp import shard_tree
    from repro_torch.parallel.tensor import model_dims
    card = card_memory_bytes("meta")
    mm = DS_HYBRID_MODEL
    spec = _ds_spec(mm, hybrid=True)
    shape = InputShape("moe-hybrid", spec.seq, spec.batch, "train")
    data = CARDS // mm
    for groups in range(get_config(DS).num_groups, 0, -1):
        cfg = _ds_config(groups)
        params = dryrun.meta_params(cfg)
        sliced = shard_tree(params, 0, mm, model_dims(params, mm))
        merge = tree_bytes(sliced) \
            + MERGE_SLAB_BYTES * slab_codec(sliced).padded_size \
            + MERGE_PIECE_BYTES * SEGMENT_PIECE
        if merge * (1 + PEAK_RTOL) > card:
            continue
        preds = [dryrun.fsdp_layout(cfg, shape, CARDS, hybrid_rep=data // g,
                                    optimizer=opt, model=mm)
                 for g in (1, data)]
        if preds[0]["peak_bytes"] * (1 + PEAK_RTOL) <= card:
            return groups, merge, preds
    raise AssertionError("[tensor-moe] no depth of the hybrid run fits")


def phase_tensor_moe(tmp: str) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.optimizers import sgd
    cfg = get_config(DS)
    opt = sgd(DS_LR)
    out = {}
    first = None
    for mm in MOE_MODELS:
        spec = _ds_spec(mm)
        t0 = time.time()
        micro, pred = _tensor_prediction(spec, mm, cfg, opt, "[tensor-moe]")
        log(f"[tensor-moe] the dry-run for {DS} on {CARDS} cards as data "
            f"{CARDS // mm} x model {mm}, {spec.batch} rows of {spec.seq} "
            f"a step, SGD: micro-batches {micro} (derived), state "
            f"{pred['state_bytes']} B, traced peak {pred['peak_bytes']} B, "
            f"collectives a step "
            f"{ {k: int(v) for k, v in pred['collective_bytes_per_device'].items()} }"
            f" B (meta device, {time.time() - t0:.1f} s)")
        res = _moe_run(tmp, f"moe{mm}", spec, micro, cfg.num_groups)
        st, hist = res["stats"], res["history"]
        check(st["backend"] == "nccl" and st["world_size"] == CARDS
              and st["mesh_model"] == mm,
              f"[tensor-moe] M {mm}: backend {st['backend']}, world "
              f"{st['world_size']}, mesh_model {st['mesh_model']}")
        (lay,) = st["layout"]
        check((lay["g"], lay["model"]) == (CARDS // mm, mm),
              f"[tensor-moe] M {mm}: layout {lay}")
        state = pred["state_bytes_total"]
        check(all(b == state for b in lay["state_bytes"]),
              f"[tensor-moe] M {mm}: state bytes by card "
              f"{lay['state_bytes']}, the dry-run's {state}")
        peak = pred["peak_bytes"]
        tol = max(PEAK_RTOL * peak, PEAK_SLACK)
        check(all(abs(b - peak) <= tol for b in lay["step_peak_bytes"]),
              f"[tensor-moe] M {mm}: step peaks by card "
              f"{lay['step_peak_bytes']}, the dry-run's {peak} within "
              f"{tol:.0f}")
        losses = [h["loss"] for h in hist]
        auxes = [h["aux"] for h in hist]
        check(all(math.isfinite(x) for x in losses + auxes),
              f"[tensor-moe] M {mm}: losses {losses}, aux {auxes}")
        if first is None:
            first = losses[0]
        check(abs(losses[0] - first) <= TENSOR_LOSS_ATOL,
              f"[tensor-moe] M {mm}: first loss {losses[0]}, data 4's "
              f"{first}")
        if mm > 1:
            for key in ("whole_digest_by_rank", "routing_digest_by_rank"):
                check(_groups_equal(st[key], mm),
                      f"[tensor-moe] M {mm}: {key} {st[key]}")
        check_final(f"[tensor-moe] M {mm}", res, cfg, mm)
        steps = _walls(hist)
        tokens = spec.batch * spec.seq
        by_kind = st["collective_s_by_kind"]
        log(f"[tensor-moe] {DS} full width and depth, remat {st['remat']}, "
            f"sync over {CARDS} x {st['device_name']} on {st['backend']} as "
            f"data {lay['g']} x model {mm}, SGD, {spec.batch} x {spec.seq} "
            f"a step in {micro} micro-batches a data position: state "
            f"{lay['state_bytes'][0]} B a card = the dry-run's to the byte; "
            f"step peak by card {lay['step_peak_bytes']} B against {peak} B "
            f"(ratios {[round(b / peak, 6) for b in lay['step_peak_bytes']]}"
            f"); first loss {losses[0]:.6f} against data 4's {first:.6f} "
            f"(diff {losses[0] - first:.3e}); aux "
            f"{[round(a, 6) for a in auxes]}"
            + ("; whole-leaf and routing digests equal across each model "
               f"group ({st['routing_digest_by_rank']})" if mm > 1 else ""))
        log(f"[tensor-moe] M {mm}: step walls {steps} s; last step "
            f"{steps[-1]:.3f} s = {1 / steps[-1]:.4f} steps/s = "
            f"{tokens / steps[-1]:.1f} tokens/s ({tokens} tokens a step); "
            f"losses {[round(x, 4) for x in losses]}; collective s by kind "
            "and card: " + "; ".join(
                f"{k} {[round(r[k], 3) for r in by_kind]}"
                for k in by_kind[0]) + f"; {res['outer_s']:.1f} s with "
            f"torchrun; final params assembled in rank 0's host memory "
            f"({len(res['final']['leaves'])} leaves, finite) by "
            f"{res['final']['seconds']:.1f} s into rank 0's run")
        out[f"M{mm}"] = {"microbatch": micro, "prediction": pred,
                         "layout": lay, "losses": losses, "aux": auxes,
                         "step_walls": steps, "tokens_per_step": tokens,
                         "collective_s_by_kind": by_kind,
                         "routing_digest_by_rank":
                             st.get("routing_digest_by_rank"),
                         "final": res["final"], "outer_s": res["outer_s"]}
    return out


def phase_tensor_moe_hybrid(tmp: str) -> dict:
    from repro_torch.optim.optimizers import sgd
    mm = DS_HYBRID_MODEL
    t0 = time.time()
    groups, merge, preds = _hybrid_groups(sgd(DS_LR))
    log(f"[tensor-moe-hybrid] model {mm}: {groups} of {DS}'s 27 block "
        f"groups (the phase switch holds {merge} B a card by the count; "
        f"the dry-run's g 1 step peak {preds[0]['peak_bytes']} B; each "
        f"with {PEAK_RTOL:.0%} to spare within the card; meta device, "
        f"{time.time() - t0:.1f} s)")
    res = _moe_run(tmp, "moe-hybrid", _ds_spec(mm, hybrid=True), 1, groups)
    st, hist = res["stats"], res["history"]
    check(st["backend"] == "nccl" and st["mesh_model"] == mm,
          f"[tensor-moe-hybrid]: backend {st['backend']}, mesh_model "
          f"{st['mesh_model']}")
    check([(h["group_size"], h["replicas"]) for h in hist] ==
          [(1, 2), (2, 1)], f"[tensor-moe-hybrid]: {hist}")
    check([m["K"] for m in st["merges"]] == [2, 1],
          f"[tensor-moe-hybrid]: merges {st['merges']}")
    check(all(r == {"1": 1, "2": 1} for r in st["flush_launches_by_rank"]),
          f"[tensor-moe-hybrid]: flush launches by rank "
          f"{st['flush_launches_by_rank']}")
    check(all((h["divergence"] > 0) == (h["replicas"] > 1)
              and math.isfinite(h["loss"]) for h in hist),
          f"[tensor-moe-hybrid]: history {hist}")
    for key in ("whole_digest_by_rank", "routing_digest_by_rank"):
        check(_groups_equal(st[key], mm),
              f"[tensor-moe-hybrid]: {key} {st[key]}")
    for p, pred in zip(st["layout"], preds):
        check(all(b == pred["state_bytes_total"] for b in p["state_bytes"]),
              f"[tensor-moe-hybrid] g {p['g']}: state bytes by card "
              f"{p['state_bytes']}, the dry-run's {pred['state_bytes_total']}")
    log(f"[tensor-moe-hybrid] {DS} full width, {groups} groups, NCCL data "
        f"{CARDS // mm} x model {mm}, hybrid step:1: g "
        f"{[h['group_size'] for h in hist]}, merges K "
        f"{[m['K'] for m in st['merges']]}, flush launches by rank "
        f"{st['flush_launches_by_rank']}; divergence "
        f"{[float('%.6g' % h['divergence']) for h in hist]}; losses "
        f"{[round(h['loss'], 6) for h in hist]}; state by phase "
        f"{[(p['g'], p['state_bytes'][0]) for p in st['layout']]} B a card "
        f"= the dry-run's; step peaks by phase "
        f"{[(p['g'], max(p['step_peak_bytes'])) for p in st['layout']]} B "
        f"against the dry-run's {[q['peak_bytes'] for q in preds]}; peak "
        f"by card {st['peak_memory_bytes']} B ("
        f"{[round(b / 2**30, 2) for b in st['peak_memory_bytes']]} GiB) "
        f"against the switch's count {merge} B; digests "
        f"equal across each model group; step walls {_walls(hist)} s; "
        f"collective s by kind: " + "; ".join(
            f"{k} {[round(r[k], 3) for r in st['collective_s_by_kind']]}"
            for k in st["collective_s_by_kind"][0])
        + f"; {res['outer_s']:.1f} s with torchrun")
    check_final("[tensor-moe-hybrid]", res, _ds_config(groups), mm)
    log(f"[tensor-moe-hybrid] final params assembled in rank 0's host "
        f"memory: {len(res['final']['leaves'])} leaves of the config's "
        f"shapes, finite, the whole leaves the ranks' bit for bit; the run "
        f"took {res['final']['seconds']:.1f} s in rank 0")
    return {"groups": groups, "merge_bytes": merge,
            "history": hist, "merges": st["merges"],
            "layout": st["layout"],
            "peak_memory_bytes": st["peak_memory_bytes"],
            "collective_s_by_kind": st["collective_s_by_kind"],
            "outer_s": res["outer_s"]}


# ------------------------------------------------------------ [tensor-ssm]

def _ssm_spec(mesh_model: int):
    from repro_torch.api.spec import ExperimentSpec
    return ExperimentSpec(arch=JAMBA, backend="spmd", mode="sync",
                          steps=SSM_STEPS, batch=SSM_ROWS * CARDS,
                          seq=SSM_SEQ, lr=SSM_LR, optimizer="sgd",
                          smoke=False, log_every=1, mesh_model=mesh_model)


def _at_groups(arch: str, groups: int):
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch), num_groups=groups)


def _ssm_plans(opt, cfg):
    """For each M of ``SSM_MODELS``, the fewest micro-batches whose traced
    step peak fits a card with ``PEAK_RTOL`` to spare (the SGD update,
    which holds every leaf's float32 update at once, can peak above the
    forward, so more micro-batches, whose float32 accumulator adds to
    it, need not lower it) and the dry-run's layout there."""
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import card_memory_bytes
    card = card_memory_bytes("meta")
    plans = {}
    for mm in SSM_MODELS:
        spec = _ssm_spec(mm)
        shape = InputShape("ssm", spec.seq, spec.batch, "train")
        rows = spec.batch // (CARDS // mm)
        for micro in (m for m in range(1, rows + 1) if rows % m == 0):
            peak = dryrun.analyze_step(cfg, shape, CARDS, micro, fsdp=True,
                                       optimizer=opt,
                                       model=mm)[0].peak_bytes
            if peak * (1 + PEAK_RTOL) <= card:
                plans[mm] = (micro, dryrun.fsdp_layout(
                    cfg, shape, CARDS, microbatch=micro, optimizer=opt,
                    model=mm))
                break
        check(mm in plans, f"[tensor-ssm] {SSM_GROUPS} group(s) of {JAMBA} "
              f"fit no card at M {mm}")
    return plans


def phase_tensor_ssm(tmp: str) -> dict:
    import numpy as np
    from repro_torch.optim.optimizers import sgd
    opt = sgd(SSM_LR)
    t0 = time.time()
    from repro_torch.convert import tree_leaves
    from repro_torch.models.model import meta_params
    groups = SSM_GROUPS
    cfg = _at_groups(JAMBA, groups)
    plans = _ssm_plans(opt, cfg)
    n = sum(t.numel() for t in tree_leaves(meta_params(cfg)))
    log(f"[tensor-ssm] {JAMBA} at {groups} of its 4 block groups ({n:,} "
        f"parameters; the host's draw caps the depth), its step fitting a "
        f"card with {PEAK_RTOL:.0%} to spare at M {SSM_MODELS}: "
        + "; ".join(
            f"M {mm}: {micro} micro-batch(es), state "
            f"{pred['state_bytes_total']} B, traced peak "
            f"{pred['peak_bytes']} B, collectives a step "
            f"{ {k: int(v) for k, v in pred['collective_bytes_per_device'].items()} } B"
            for mm, (micro, pred) in plans.items())
        + f" (meta device, {time.time() - t0:.1f} s); cut: depth only, "
        "every width the published one")
    out = {"groups": groups, "parameters": n}
    first = None
    for mm in SSM_MODELS:
        micro, pred = plans[mm]
        spec = _ssm_spec(mm)
        res = _moe_run(tmp, f"ssm{mm}", spec, micro, groups)
        st, hist = res["stats"], res["history"]
        check(st["backend"] == "nccl" and st["world_size"] == CARDS
              and st["mesh_model"] == mm,
              f"[tensor-ssm] M {mm}: backend {st['backend']}, world "
              f"{st['world_size']}, mesh_model {st['mesh_model']}")
        (lay,) = st["layout"]
        check((lay["g"], lay["model"]) == (CARDS // mm, mm),
              f"[tensor-ssm] M {mm}: layout {lay}")
        state = pred["state_bytes_total"]
        check(all(b == state for b in lay["state_bytes"]),
              f"[tensor-ssm] M {mm}: state bytes by card "
              f"{lay['state_bytes']}, the dry-run's {state}")
        peak = pred["peak_bytes"]
        tol = max(PEAK_RTOL * peak, PEAK_SLACK)
        check(all(abs(b - peak) <= tol for b in lay["step_peak_bytes"]),
              f"[tensor-ssm] M {mm}: step peaks by card "
              f"{lay['step_peak_bytes']}, the dry-run's {peak} within "
              f"{tol:.0f}")
        losses = [h["loss"] for h in hist]
        auxes = [h["aux"] for h in hist]
        check(all(math.isfinite(x) for x in losses + auxes),
              f"[tensor-ssm] M {mm}: losses {losses}, aux {auxes}")
        if first is None:
            first = losses[0]
        check(abs(losses[0] - first) <= TENSOR_LOSS_ATOL,
              f"[tensor-ssm] M {mm}: first loss {losses[0]}, M "
              f"{SSM_MODELS[0]}'s {first}")
        for key in ("whole_digest_by_rank", "routing_digest_by_rank"):
            check(_groups_equal(st[key], mm),
                  f"[tensor-ssm] M {mm}: {key} {st[key]}")
        check_final(f"[tensor-ssm] M {mm}", res, cfg, mm)
        steps = _walls(hist)
        tokens = spec.batch * spec.seq
        by_kind = st["collective_s_by_kind"]
        log(f"[tensor-ssm] {JAMBA} full width, {groups} of 4 groups, remat "
            f"{st['remat']}, sync over {CARDS} x {st['device_name']} on "
            f"{st['backend']} as data {lay['g']} x model {mm}, SGD, "
            f"{spec.batch} x {spec.seq} a step in {micro} micro-batch(es) "
            f"a data position: state {lay['state_bytes'][0]} B a card = "
            f"the dry-run's to the byte; step peak by card "
            f"{lay['step_peak_bytes']} B against {peak} B (ratios "
            f"{[round(b / peak, 6) for b in lay['step_peak_bytes']]}); "
            f"first loss {losses[0]:.6f} against M {SSM_MODELS[0]}'s "
            f"{first:.6f} (diff {losses[0] - first:.3e}); aux "
            f"{[round(a, 6) for a in auxes]}; whole-leaf and routing "
            f"digests equal across each model group "
            f"({st['routing_digest_by_rank']}); params drawn and moved to "
            f"the card in {st['draw_s']:.1f} s on rank 0")
        log(f"[tensor-ssm] M {mm}: step walls {steps} s; last step "
            f"{steps[-1]:.3f} s = {tokens / steps[-1]:.1f} tokens/s "
            f"({tokens} tokens a step); losses "
            f"{[round(x, 4) for x in losses]}; peak card memory by card "
            f"{[round(b / 2**30, 2) for b in st['peak_memory_bytes']]} GiB; "
            f"collective s by kind and card: " + "; ".join(
                f"{k} {[round(r[k], 3) for r in by_kind]}"
                for k in by_kind[0]) + f"; {res['outer_s']:.1f} s with "
            f"torchrun; final params assembled in rank 0's host memory "
            f"({len(res['final']['leaves'])} leaves of the cut config's "
            f"shapes, finite) by {res['final']['seconds']:.1f} s into rank "
            f"0's run")
        out[f"M{mm}"] = {"microbatch": micro, "prediction": pred,
                         "layout": lay, "losses": losses, "aux": auxes,
                         "step_walls": steps, "tokens_per_step": tokens,
                         "collective_s_by_kind": by_kind,
                         "peak_memory_bytes": st["peak_memory_bytes"],
                         "draw_s": st["draw_s"], "final": res["final"],
                         "outer_s": res["outer_s"]}
    runs = []
    for label in ("a", "b"):
        t0 = time.time()
        res = spmd_run(XLSTM_TP_RUN, os.path.join(tmp, f"xl-tp-{label}.json"),
                       ckpt_dir=os.path.join(tmp, f"xl-tp-{label}"))
        ex, hist = res["extra"], res["extra"]["history"]
        check(ex["backend"] == "nccl" and ex["mesh_model"] == 2,
              f"[tensor-ssm] xlstm: backend {ex['backend']}, mesh_model "
              f"{ex.get('mesh_model')}")
        check([(h["group_size"], h["replicas"]) for h in hist] ==
              [(1, 2), (2, 1)], f"[tensor-ssm] xlstm: {hist}")
        check([m["K"] for m in ex["merges"]] == [2, 1],
              f"[tensor-ssm] xlstm: merges {ex['merges']}")
        check(all(r == {"1": 1, "2": 1}
                  for r in ex["flush_launches_by_rank"]),
              f"[tensor-ssm] xlstm: flush launches by rank "
              f"{ex['flush_launches_by_rank']}")
        check(all((h["divergence"] > 0) == (h["replicas"] > 1)
                  and math.isfinite(h["loss"]) for h in hist),
              f"[tensor-ssm] xlstm: history {hist}")
        check(_groups_equal(ex["whole_digest_by_rank"], 2),
              f"[tensor-ssm] xlstm: whole digests "
              f"{ex['whole_digest_by_rank']}")
        log(f"[tensor-ssm] xlstm-350m full width and depth, remat "
            f"{ex['remat']}, NCCL data 2 x model 2, run {label}: g "
            f"{[h['group_size'] for h in hist]}, merges K "
            f"{[m['K'] for m in ex['merges']]}, flush launches by rank "
            f"{ex['flush_launches_by_rank']}; divergence "
            f"{[float('%.6g' % h['divergence']) for h in hist]}; losses "
            f"{[round(h['loss'], 6) for h in hist]}; layout "
            f"{[(p['g'], p['model'], p['fsdp'], p['state_bytes'][0]) for p in ex['layout']]}"
            f"; step walls {_walls(hist)} s; collective s by kind: "
            + "; ".join(f"{k} {[round(r[k], 3) for r in ex['collective_s_by_kind']]}"
                        for k in ex["collective_s_by_kind"][0])
            + f"; {time.time() - t0:.1f} s with torchrun")
        runs.append(res)
    a, b = (_npz(os.path.join(tmp, f"xl-tp-{x}", "step_2.npz"))
            for x in ("a", "b"))
    check(sorted(a) == sorted(b) and all(
        np.array_equal(a[k], b[k]) and a[k].tobytes() == b[k].tobytes()
        for k in a), "[tensor-ssm] xlstm: two runs' final params differ")
    log("[tensor-ssm] xlstm: two runs' final params bitwise equal")
    out["xlstm"] = [{"history": r["extra"]["history"],
                     "merges": r["extra"]["merges"],
                     "layout": r["extra"]["layout"],
                     "collective_s_by_kind":
                         r["extra"]["collective_s_by_kind"]}
                    for r in runs]
    return out


# ---------------------------------------------------------------- [hybrid]

def serve_child(out: str, arch: str, groups: int, model: int) -> int:
    """A rank of a ``[serve-tp]`` run (started by torchrun): ``arch`` at
    ``groups`` of its block groups served sliced at ``model``, each
    batch of ``SERVE_MODELS[model]`` in turn; rank 0 writes the figures
    to ``out``, by batch."""
    from repro_torch.launch.mesh import distributed, rank_device
    from repro_torch.serve_smoke import sliced_serve
    cfg = _at_groups(arch, groups)
    served = {}
    with distributed(rank_device("cuda")):
        for batch in SERVE_MODELS[model]:
            served[batch] = sliced_serve(cfg, model, batch,
                                         SERVE_TP["prompt"], SERVE_TP["gen"],
                                         SERVE_TP["max_seq"])
    if None not in served.values():
        with open(out, "w") as f:
            json.dump(served, f)
    return 0


def phase_serve_tp(tmp: str) -> dict:
    from repro_torch.serve_smoke import check_served, summary
    runs = {}
    for arch, groups in SERVE_RUNS:
        for mm in SERVE_MODELS:
            out = os.path.join(tmp, f"serve-{arch}-{mm}.json")
            t0 = time.time()
            _torchrun(["-m", "repro_torch.multicard_smoke", SERVE_CHILD, out,
                       arch, str(groups), str(mm)], _env())
            with open(out) as f:
                for batch, sv in json.load(f).items():
                    runs[(arch, mm, int(batch))] = sv
                    sv["outer_s"] = time.time() - t0
    # every run's figures before any check
    fails = []
    for (arch, mm, batch), sv in runs.items():
        groups = dict(SERVE_RUNS)[arch]
        tag = f"[serve-tp] {arch} M {mm} B {batch}"
        try:
            want = check_served(tag, sv, _at_groups(arch, groups), CARDS, mm)
        except AssertionError as e:
            fails.append(str(e))
            want = sv["by_rank"]["cache_bytes"][0]
        log(f"{tag}: {groups} of {_full_groups(arch)} groups, full width, "
            f"bf16, NCCL: {summary(sv, want)}; {sv['outer_s']:.1f} s with "
            "the torchrun (its batches together)")
    check(not fails, "; ".join(fails))
    return {f"{arch} M{mm} B{batch}": sv
            for (arch, mm, batch), sv in runs.items()}


def _full_groups(arch: str) -> int:
    from repro_torch.configs.registry import get_config
    return get_config(arch).num_groups


def phase_hybrid(tmp: str) -> dict:
    t0 = time.time()
    res = spmd_run(H2O_RUN, os.path.join(tmp, "h2o.json"))
    outer = time.time() - t0
    ex, hist = res["extra"], res["extra"]["history"]
    check(ex["backend"] == "nccl", f"[hybrid] backend {ex['backend']}")
    check([h["group_size"] for h in hist] == [1, 1, 2, 2, 4, 4],
          f"[hybrid] group sizes {[h['group_size'] for h in hist]}")
    check([m["K"] for m in ex["merges"]] == [4, 2, 1],
          f"[hybrid] merges {ex['merges']}")
    check(all(r == {"1": 1, "2": 1, "4": 1}
              for r in ex["flush_launches_by_rank"]),
          f"[hybrid] flush launches by rank {ex['flush_launches_by_rank']}")
    check(all((h["divergence"] > 0) == (h["replicas"] > 1) for h in hist),
          f"[hybrid] divergence {[h['divergence'] for h in hist]}")
    check(all(math.isfinite(h["loss"]) for h in hist),
          f"[hybrid] losses {[h['loss'] for h in hist]}")
    log(f"[hybrid] h2o-danube-1.8b full width, remat {ex['remat']}, NCCL "
        f"world {ex['world_size']}: g {[h['group_size'] for h in hist]}, "
        f"merges K {[m['K'] for m in ex['merges']]}, flush launches by "
        f"rank {ex['flush_launches_by_rank']}; divergence "
        f"{[float('%.6g' % h['divergence']) for h in hist]}; layout "
        f"{[(p['g'], p['fsdp'], p['state_bytes'][0]) for p in ex['layout']]}"
        f"; step walls {_walls(hist)} s; collective s by kind: "
        f"{_kinds(ex)}; peak GiB by rank "
        f"{[round(b / 2**30, 2) for b in ex['peak_memory_bytes']]}; "
        f"{outer:.1f} s with torchrun")
    return {"history": hist, "merges": ex["merges"],
            "layout": ex["layout"],
            "collective_s_by_kind": ex["collective_s_by_kind"],
            "outer_s": outer}


# --------------------------------------------------------------- [staging]

def phase_staging(torch) -> dict:
    import numpy as np
    from repro_torch.core.slab import SlabAggregator, slab_codec
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.optim import SlabOptimizer
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = {"w": torch.randn(24 * 8192 * 64 - 1000, device="cuda:0",
                               generator=gen)}
    kernel = {"sgd": "flush", "momentum": "flush_momentum",
              "adamw": "flush_adamw"}
    for dtype in ("f32", "bf16"):
        codec = slab_codec(params, slab_dtype=dtype)
        rows = [torch.randn(codec.padded_size, device="cuda:0",
                            generator=gen).to(codec.slab_dtype)
                for _ in range(4)]
        for opt in ("sgd", "momentum", "adamw"):
            got, launches = [], []
            for devices in (None, ["cuda:0"]):
                agg = SlabAggregator(codec, params, 4,
                                     optimizer=SlabOptimizer(opt),
                                     devices=devices)
                before = dict(ha.LAUNCHES_BY_K)
                for w in ([1.0, 0.5, 0.25, 0.125], [0.3, 0.3, 0.3]):
                    for slot, r in enumerate(rows[:len(w)]):
                        agg.stage(r, slot)
                    agg.flush_apply(np.asarray(w, np.float32), 0.1)
                for d in agg.chunk_devices:
                    torch.cuda.synchronize(d)
                launches.append(sum(
                    n - before.get(key, 0) for key, n in
                    ha.LAUNCHES_BY_K.items() if key[0] == kernel[opt]))
                got.append((agg.params_slab.cpu(), agg.opt_state_host(),
                            [str(d) for d in agg.chunk_devices]))
                del agg
            (p4, s4, d4), (p1, s1, d1) = got
            check(d4 == [f"cuda:{i}" for i in range(CARDS)] and
                  d1 == ["cuda:0"], f"[staging] chunk devices {d4}, {d1}")
            check(launches == [2 * CARDS, 2],
                  f"[staging] {kernel[opt]} launches {launches}")
            check(torch.equal(p4, p1), f"[staging] {opt} {dtype}: params "
                  "on four cards differ from one card")
            if s1 is not None:
                check(all(np.array_equal(s4[k], s1[k]) for k in s1),
                      f"[staging] {opt} {dtype}: optimizer state differs")
            log(f"[staging] {kernel[opt]} {dtype}: P_pad "
                f"{codec.padded_size:,} in chunks on {d4}, two flushes "
                f"(K 4 and 3): params"
                f"{'' if s1 is None else ', moments, count'} bitwise equal "
                f"to one card; launches {launches[0]} across the cards, "
                f"{launches[1]} on one")
            out[f"{kernel[opt]} {dtype}"] = launches
    del params, rows
    torch.cuda.empty_cache()
    out["zoo"] = zoo_across_cards(torch)
    return out


def zoo_across_cards(torch) -> dict:
    from repro_torch.api import ExperimentSpec, SimulatorTrainer
    from repro_torch.core.simulator import WorkerPool
    from repro_torch.kernels import hybrid_aggregate as ha
    spec = ExperimentSpec(
        arch="zoo:xlstm", zoo_scale=1.0, mode="hybrid", schedule="step:10",
        batch=32, lr=ZOO_LR, horizon=ZOO_HORIZON,
        sample_every=ZOO_HORIZON / 2, smoke=True,
        pool=WorkerPool(num_workers=ZOO_WORKERS))
    for i in range(CARDS):
        torch.cuda.reset_peak_memory_stats(i)
    before = sum(n for (name, _), n in ha.LAUNCHES_BY_K.items()
                 if name == "flush")
    trainer = SimulatorTrainer(device="cuda")
    t0 = time.time()
    res = trainer.run(spec)
    for i in range(CARDS):
        torch.cuda.synchronize(i)
    wall = time.time() - t0
    (agg,) = trainer.engine(spec)._agg_cache.values()
    launches = sum(n for (name, _), n in ha.LAUNCHES_BY_K.items()
                   if name == "flush") - before
    staging = {}
    for rows in agg._staging:
        key = str(rows.device)
        staging[key] = staging.get(key, 0) + rows.numel() * rows.element_size()
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(CARDS)]
    losses = res.metrics["train_loss"]
    check(agg.shards == CARDS and sorted(staging) ==
          [f"cuda:{i}" for i in range(CARDS)],
          f"[staging] zoo:xlstm chunks {agg.chunk_devices}")
    check(launches == CARDS * res.num_updates > 0,
          f"[staging] zoo:xlstm flush launches {launches}, updates "
          f"{res.num_updates}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"[staging] zoo:xlstm train loss {losses}")
    P = agg.codec.padded_size
    log(f"[staging] zoo:xlstm x1.0 (P_pad {P:,}, f32) in the simulator, "
        f"{ZOO_WORKERS} workers, hybrid step:10, {ZOO_HORIZON} virtual s: "
        f"{res.num_gradients} gradients, {res.num_updates} updates, "
        f"{launches} flush launches ({CARDS} chunks each) in {wall:.2f} s "
        f"({res.num_gradients / wall:.2f} grads/s); staging bytes by card "
        f"{staging}; peak bytes by card {peaks}; train loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"gradients": res.num_gradients, "updates": res.num_updates,
            "wall_s": wall, "staging_bytes": staging, "peak_bytes": peaks}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.multicard_smoke")
    ap.add_argument("--out", default=None,
                    help="write every phase's figures here as JSON")
    ap.add_argument("--phases",
                    default="nccl,fsdp,hybrid,staging,tensor,tensor-moe,"
                            "tensor-moe-hybrid,tensor-ssm,serve-tp",
                    help="a comma-separated subset, in order; tensor "
                         "needs fsdp before it")
    ap.add_argument(FSDP_CHILD, default=None, help=argparse.SUPPRESS)
    ap.add_argument(TENSOR_CHILD, nargs=3, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument(MOE_CHILD, nargs=4, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument(SERVE_CHILD, nargs=4, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.serve_child:
        out, arch, groups, mm = args.serve_child
        return serve_child(out, arch, int(groups), int(mm))
    if args.fsdp_child:
        return fsdp_child(args.fsdp_child)
    if args.tensor_child:
        out, mm, micro = args.tensor_child
        return tensor_child(out, int(mm), int(micro))
    if args.moe_child:
        out, spec_path, micro, groups = args.moe_child
        return moe_child(out, spec_path, int(micro), int(groups))
    phases = args.phases.split(",")
    if "tensor" in phases and ("fsdp" not in phases
                               or phases.index("fsdp")
                               > phases.index("tensor")):
        ap.error("--phases: tensor reads [fsdp]'s first loss; put fsdp "
                 "before it")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print(f"multicard_smoke: needs {CARDS} CUDA cards, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    log(f"[device] {smi()}")
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    figures = {}
    with tempfile.TemporaryDirectory(prefix="multicard-") as tmp:
        for name in phases:
            t0 = time.time()
            if name == "staging":
                figures[name] = phase_staging(torch)
            elif name == "tensor":
                figures[name] = phase_tensor(tmp, figures["fsdp"])
            elif name == "tensor-moe":
                figures[name] = phase_tensor_moe(tmp)
            elif name == "tensor-moe-hybrid":
                figures[name] = phase_tensor_moe_hybrid(tmp)
            elif name == "tensor-ssm":
                figures[name] = phase_tensor_ssm(tmp)
            elif name == "serve-tp":
                figures[name] = phase_serve_tp(tmp)
            else:
                figures[name] = {"nccl": phase_nccl, "fsdp": phase_fsdp,
                                 "hybrid": phase_hybrid}[name](tmp)
            log(f"[phase] {name} done in {time.time() - t0:.1f} s, at "
                f"{time.time() - t_start:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(figures, f, indent=2, default=str)
    log(f"[device] {smi()}")
    log(f"[multicard] OK: {args.phases} in {time.time() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
