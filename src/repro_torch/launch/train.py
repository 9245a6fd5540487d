"""SPMD training driver (the ``spmd`` backend of :mod:`repro_torch.api`).

Modes:
  * ``sync``   — fully synchronous data parallelism (the paper's
                 synchronous baseline; also the hybrid schedule's end);
  * ``async``  — group size 1 throughout (per-rank local SGD, the SPMD
                 analogue of the asynchronous baseline);
  * ``hybrid`` — the Smooth Switch: the reduction-group size annealed by
                 the threshold schedule, replicas merged at each switch.

Every rank of a ``torch.distributed`` job runs :func:`run_training`
(launched by ``torchrun``; with no process group it is one rank, and
R = 1).  Each step a rank takes the gradient of its own rows of the
batch; with g > 1 the gradient is averaged over its replica group and
every rank of the group applies the same update.  At a phase switch one
rank per group sends its replica's slab to rank 0, which merges the
``(R, P)`` rows through the flush kernel (one launch at K = R), reshards
them to the next phase's R and broadcasts the result; each rank takes
its new group's replica.  Rank 0 writes the history, the checkpoints and
``out_json``.

Example (equivalently ``python -m repro_torch run --backend spmd ...``):
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch xlstm-350m --smoke --steps 8 --mode hybrid \\
      --schedule step:4 --batch 4 --seq 32 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs.registry import ARCH_NAMES, get_config, smoke_variant
from repro_torch.convert import Device, params_from_numpy, tree_to
from repro_torch.core.slab import SlabCodec, slab_codec
from repro_torch.core.spmd_hybrid import (build_phases, merge_replicas_slab,
                                          replica, replica_divergence,
                                          reshard_replicas, stack_replicas)
from repro_torch.data.pipeline import shard_batch
from repro_torch.data.synthetic import token_stream
from repro_torch.kernels import hybrid_aggregate
from repro_torch.launch.mesh import (Collectives, describe_layout,
                                     distributed, rank_device)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim.optimizers import adamw, momentum, sgd


def _optimizer(spec):
    """The per-replica optimizer the spec names (the same fields the
    server-side slab optimizer reads)."""
    if spec.optimizer == "adamw":
        return adamw(spec.lr, b1=spec.beta1, b2=spec.beta2,
                     weight_decay=spec.weight_decay)
    if spec.optimizer == "momentum":
        return momentum(spec.lr, beta=spec.beta1)
    return sgd(spec.lr)


def _phases(spec, data_axis: int) -> List[Tuple[int, int]]:
    """``[(t_start, g)]`` from the mode (``src/repro/launch/train.py:109``)."""
    from repro_torch.api.schedules import parse_schedule
    if spec.mode == "sync":
        return [(0, data_axis)]
    if spec.mode == "async":
        return [(0, 1)]
    sched = parse_schedule(spec.schedule, data_axis)
    return [(p.t_start, p.group_size)
            for p in build_phases(sched, spec.steps, data_axis)]


def _gather_rows(comm: Collectives, slab: torch.Tensor, R: int,
                 g: int) -> Optional[torch.Tensor]:
    """The ``(R, P)`` slab of the R replicas on rank 0 (None elsewhere):
    the first rank of each group sends its replica's slab."""
    if comm.rank == 0:
        rows = torch.empty((R,) + tuple(slab.shape), dtype=slab.dtype,
                           device=slab.device)
        rows[0].copy_(slab)
        for r in range(1, R):
            comm.recv_(rows[r], r * g)
        return rows
    if comm.rank % g == 0:
        comm.send(slab, 0)
    return None


def _replicas(codec: SlabCodec, rows: torch.Tensor):
    """The tree with a leading replica axis that ``rows`` encodes."""
    return stack_replicas([codec.decode(rows[r])
                           for r in range(rows.shape[0])])


def _group_mean(codec: SlabCodec, comm: Collectives, g: int):
    """The gradient averaged over this rank's replica group, as one
    float32 slab summed across the group."""
    def reduce(grads):
        slab = codec.encode_master(grads)
        with comm.timing("gradient"):
            comm.all_reduce_sum_(slab, g)
        return codec.decode(slab / g)
    return reduce


def run_training(spec, ckpt_dir: Optional[str] = None,
                 out_json: Optional[str] = None, verbose: bool = True,
                 device: Device = None, params: Any = None):
    """Run this rank's part of the SPMD driver for an
    :class:`repro_torch.api.ExperimentSpec`.

    Returns ``(params_final, history, stats)``.  On rank 0
    ``params_final`` is the final merge of the replicas and ``history``
    the logged per-step metrics; other ranks return ``None`` and ``[]``.
    ``stats`` has the exact counters (``num_updates``, and
    ``num_gradients``: one gradient per replica per step) on every rank,
    and on rank 0 also the layout (``backend``, ``world_size``,
    ``device``), each merge's K (``merges``), the flush launches by K
    (``launches_by_k``), and each rank's peak device memory and host
    seconds in collectives (``collective_s``), split into the gradient
    all-reduce, the divergence gathers of logged steps and the merges'
    gathers and broadcasts (``collective_s_by_kind``).

    ``params`` (tests) is an initial params tree of numpy arrays, such
    as the reference's, in place of the port's own initialisation."""
    dev = rank_device(device)
    with distributed(dev) as backend:
        return _run(spec, ckpt_dir, out_json, verbose, dev, params,
                    backend or "none")


def _run(spec, ckpt_dir, out_json, verbose, dev, params, backend):
    cfg = get_config(spec.arch)
    if spec.smoke:
        cfg = dataclasses.replace(smoke_variant(cfg), name=cfg.name)
    if cfg.frontend is not None:
        raise ValueError(f"{spec.arch}: the train driver uses token "
                         "streams, not a frontend's inputs")
    if spec.mesh_model != 1:
        raise ValueError(
            f"mesh_model={spec.mesh_model}: a model-parallel axis within "
            "a replica group is not ported; it comes with the multi-card "
            "item of ROADMAP.md (A16); use mesh_model=1")
    comm = Collectives(dev)
    rank, W = comm.rank, comm.world
    data_axis = W           # / mesh_model, which is 1
    if dev.type == "cuda":
        from repro_torch.cluster.mptransport import (CUDA_DETERMINISTIC,
                                                     set_torch_flags)
        set_torch_flags(CUDA_DETERMINISTIC)
        torch.cuda.set_device(dev)     # initialises CUDA in this process
        torch.cuda.reset_peak_memory_stats(dev)
    if verbose and rank == 0:
        print(f"[spmd] {describe_layout(dev, backend)}", flush=True)
    opt = _optimizer(spec)
    stream = token_stream(spec.seed, cfg.vocab_size, spec.batch, spec.seq)
    phases = _phases(spec, data_axis)
    if params is None:
        params = M.init_params(torch.Generator().manual_seed(spec.seed),
                               cfg)
    else:
        params = params_from_numpy(params)
    params = tree_to(params, dev)
    codec = slab_codec(params)
    launches_before = dict(hybrid_aggregate.LAUNCHES_BY_K)

    history: List[Dict[str, Any]] = []
    merges: List[Dict[str, Any]] = []
    t0 = time.time()
    tokens_done = grads_done = step = 0
    rows = params_final = None
    last: Optional[Tuple[Any, float, Any]] = None   # (rows, alpha, merge)

    def merged(rows, alpha, kind):
        # one merge per phase end: the checkpoint's is reused by the
        # switch or the final merge that takes the same alpha
        nonlocal last
        if last is not None and last[0] is rows and last[1] == alpha:
            return last[2]
        merges.append({"step": step, "K": int(rows.shape[0]),
                       "alpha": alpha, "kind": kind})
        out = merge_replicas_slab(_replicas(codec, rows), alpha=alpha,
                                  rows=rows)
        last = (rows, alpha, out)
        return out

    for idx, (t_start, g) in enumerate(phases):
        t_end = phases[idx + 1][0] if idx + 1 < len(phases) else spec.steps
        R = data_axis // g
        if idx > 0:
            # the phase switch (the paper's buffer flush): rank 0 merges
            # the replicas through the flush kernel, reshards them to
            # this phase's R and sends each rank its group's replica
            host_R = None
            if rank == 0:
                host_R = reshard_replicas(
                    merged(rows, spec.merge_alpha, "switch"), R)
            rows = last = None
            buf = torch.empty((codec.padded_size,), dtype=torch.float32,
                              device=dev)
            for r in range(R):
                if rank == 0:
                    buf.copy_(codec.encode_master(replica(host_R, r)))
                with comm.timing("merge"):
                    comm.broadcast_(buf, 0)
                if r == rank // g:
                    params = codec.decode(buf)
            del host_R, buf
        opt_state = opt.init(params)
        step_fn = make_train_step(
            cfg, opt, reduce_grads=_group_mean(codec, comm, g)
            if g > 1 else None)

        while step < t_end:
            batch = shard_batch(next(stream), rank, W, dev)
            params, opt_state, loss = step_fn(params, opt_state, batch)
            tokens_done += spec.batch * spec.seq
            grads_done += R     # one gradient per replica this step
            if step % spec.log_every == 0 or step == t_end - 1:
                reported = comm.gather_host([rank // g, float(loss)])
                div_rows = None
                if R > 1:
                    with comm.timing("divergence"):
                        div_rows = _gather_rows(
                            comm, codec.encode_master(params), R, g)
                if rank == 0:
                    by_rep: Dict[int, List[float]] = {}
                    for rid, value in reported:
                        by_rep.setdefault(int(rid), []).append(value)
                    per_rep = torch.stack(
                        [torch.tensor(v, dtype=torch.float32).mean()
                         for _, v in sorted(by_rep.items())])
                    # the replicas that reported a loss must be the R
                    # this phase runs
                    assert len(by_rep) == R, (len(by_rep), R)
                    div = float(replica_divergence(_replicas(
                        codec, div_rows))) if R > 1 else 0.0
                    rec = {"step": step, "group_size": g, "replicas": R,
                           "loss": float(per_rep.mean()),
                           "divergence": div,
                           "wall_s": round(time.time() - t0, 2),
                           "tokens": tokens_done}
                    history.append(rec)
                    if verbose:
                        print(f"step {step:5d}  g={g:3d} R={R:3d} "
                              f"loss={rec['loss']:.4f} div={div:.3e}",
                              flush=True)
                del div_rows
            step += 1

        with comm.timing("merge"):
            rows = _gather_rows(comm, codec.encode_master(params), R, g)
        if ckpt_dir and rank == 0:
            one = replica(merged(rows, 1.0, "checkpoint"), 0)
            save_checkpoint(os.path.join(ckpt_dir, f"step_{step}"), one,
                            step, extra={"arch": spec.arch,
                                         "mode": spec.mode})

    # final merge for the returned model
    if rank == 0:
        params_final = replica(merged(rows, 1.0, "final"), 0)
    stats: Dict[str, Any] = {"num_updates": step,
                             "num_gradients": grads_done}
    kinds = ("gradient", "divergence", "merge")
    by_rank = comm.gather_host(
        [torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
         comm.seconds] + [comm.seconds_by.get(k, 0.0) for k in kinds])
    if rank == 0:
        after = hybrid_aggregate.LAUNCHES_BY_K
        by_k: Dict[str, Dict[str, int]] = {}
        for (name, K), n in sorted(after.items()):
            n -= launches_before.get((name, K), 0)
            if n:
                by_k.setdefault(name, {})[str(K)] = n
        stats.update(
            backend=backend, world_size=W, device=str(dev),
            remat=cfg.remat,
            device_name=torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            merges=merges, launches_by_k=by_k,
            peak_memory_bytes=[int(r[0]) for r in by_rank],
            collective_s=[r[1] for r in by_rank],
            collective_s_by_kind=[dict(zip(kinds, r[2:]))
                                  for r in by_rank])
        if out_json:
            with open(out_json, "w") as f:
                json.dump({"arch": spec.arch, "mode": spec.mode,
                           "spec": spec.to_dict(), "stats": stats,
                           "history": history}, f, indent=2)
    comm.barrier()
    return params_final, history, stats


def main(argv=None):
    from repro_torch.api.spec import ExperimentSpec

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="xlstm-350m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mode", choices=("sync", "async", "hybrid"),
                    default="hybrid")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="step:30",
                    help='schedule spec, e.g. "step:30" or '
                         '"cosine:horizon=200"')
    ap.add_argument("--merge-alpha", type=float, default=1.0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where each rank computes (default cuda; a host "
                         "without CUDA needs --device cpu)")
    args = ap.parse_args(argv)

    try:
        spec = ExperimentSpec(
            arch=args.arch, backend="spmd", mode=args.mode,
            schedule=args.schedule if args.mode == "hybrid" else None,
            seed=args.seed, lr=args.lr, batch=args.batch, steps=args.steps,
            seq=args.seq, merge_alpha=args.merge_alpha, smoke=args.smoke)
    except ValueError as e:
        ap.error(str(e))     # clean CLI error, as the old choices= gave
    run_training(spec, ckpt_dir=args.ckpt_dir, out_json=args.out_json,
                 device=args.device)


if __name__ == "__main__":
    main()
