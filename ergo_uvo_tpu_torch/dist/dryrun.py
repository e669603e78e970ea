"""A world of processes through the distributed layer, and the launcher for such worlds.

    python -m ergo_uvo_tpu_torch.dist.dryrun [--device cpu] [--nprocs N] [--timeout S]

Counterpart of ``tools/dryrun_multiprocess.py``.  It spawns a world of N
processes (default: 2 on the CPU over gloo, one a card over NCCL) and in it
runs:

1. landmark-sharded BA (``sharded_ba.sharded_ba_solve``, 5 LM steps on 4
   poses x 16 N landmarks), each process feeding only its landmark rows
   (``local=True``); the cost trajectory must match ``optim.ba.ba_solve`` on
   the whole problem within 2e-3 relative, and the gathered landmarks its
   landmarks within 1e-3;
2. per-process frame ingestion
   (``data_parallel.shard_frame_batches_multiprocess``): each process decodes
   only its rows of every global batch; the rows must equal what
   ``shard_frame_batches`` gives from the whole batch, and their sum over
   the world the batch's sum.

It prints one JSON line, ``{"ok": true, ...}``, and exits 0; a failed check,
a process that dies or a world that outlives ``--timeout`` seconds prints
``{"ok": false, ...}`` and exits non-zero.  ``device=None`` (no
``--device``) is the card, and raises without one.

:func:`spawn_world` runs any ``fn(rank, world_size, *args)`` in a fresh
world with a wall-clock limit and a timeout on every collective; a process
that hangs or dies is killed and the call raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ergo_uvo_tpu_torch.device import resolve_device
from ergo_uvo_tpu_torch.dist.mesh import init_world

COLLECTIVE_TIMEOUT = timedelta(seconds=60)  # every collective of a spawned world


def _entry(rank, fn, world_size, device, init_method, args):
    torch.set_num_threads(1)
    init_world(rank, world_size, device, init_method, COLLECTIVE_TIMEOUT)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world_size: int, args=(), device: str = "cpu", timeout: float = 300.0) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned processes
    joined by :func:`~ergo_uvo_tpu_torch.dist.mesh.init_world` on ``device``
    (``"cpu"``: gloo; ``"cuda"``: NCCL, a card a rank).

    ``fn`` must be importable by its module path.  Each process runs eager
    ops on one thread.  Every collective times out after
    :data:`COLLECTIVE_TIMEOUT`; the world gets ``timeout`` seconds of
    wall clock, after which every process still alive is killed and
    ``TimeoutError`` raised.  A process that raises or dies raises here.
    """
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "init")
        ctx = mp.start_processes(
            _entry, args=(fn, world_size, device, init_method, tuple(args)),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a world of {world_size} processes outlived {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


def _ba_problem(L):
    """``tools/dryrun_multiprocess.py``'s problem: (K, obs (4, L, 2), R, t, X0)."""
    rng = np.random.default_rng(0)
    P = 4
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-2, 2, L), rng.uniform(4, 8, L)],
                 -1).astype(np.float32)
    K = np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]], np.float32)
    obs = np.zeros((P, L, 2), np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
    ts = np.zeros((P, 3), np.float32)
    for p in range(P):
        ts[p] = [0.2 * p, 0.0, 0.0]
        pc = X + ts[p]
        obs[p] = pc[:, :2] / pc[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    obs += 0.05 * rng.standard_normal(obs.shape).astype(np.float32)
    X0 = X + 0.1 * rng.standard_normal((L, 3)).astype(np.float32)
    return K, obs, Rs, ts, X0


def _worker(rank: int, world_size: int, out_dir: str) -> None:
    from ergo_uvo_tpu_torch.dist.data_parallel import (
        shard_frame_batches,
        shard_frame_batches_multiprocess,
    )
    from ergo_uvo_tpu_torch.dist.mesh import make_mesh
    from ergo_uvo_tpu_torch.dist.sharded_ba import sharded_ba_solve
    from ergo_uvo_tpu_torch.io.sequence import ArraySource
    from ergo_uvo_tpu_torch.optim.ba import BAProblem, ba_solve

    dev = resolve_device("cuda" if dist.get_backend() == "nccl" else "cpu")
    mesh = make_mesh(device=dev)

    # 1. Landmark-sharded BA, each process holding only its landmark rows.
    L, iters = 16 * world_size, 5
    K, obs, Rs, ts, X0 = _ba_problem(L)
    lo, hi = rank * L // world_size, (rank + 1) * L // world_size
    state, costs = sharded_ba_solve(mesh, K, obs[:, lo:hi], np.ones((4, hi - lo), bool), Rs, ts,
                                    X0[lo:hi], iters=iters, num_fixed=2, local=True)
    costs = costs.cpu().numpy()
    put = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    prob = BAProblem(put(K), put(obs), torch.ones((4, L), dtype=torch.bool, device=dev), 2)
    ref_state, ref_costs = ba_solve(prob, put(Rs), put(ts), put(X0), iters=iters)
    ref_costs = ref_costs.cpu().numpy()
    if not (np.isfinite(costs).all() and np.allclose(costs, ref_costs, rtol=2e-3)):
        raise RuntimeError(f"rank {rank}: sharded BA costs {costs} against {ref_costs}")
    x_err = float((state.X - ref_state.X).abs().max())
    if not x_err <= 1e-3:
        raise RuntimeError(f"rank {rank}: gathered landmarks {x_err} from ba_solve's")

    # 2. Per-process ingestion: this process decodes only its rows of each
    # global batch of B frames.
    B, H, W = 2 * world_size, 8, 8
    frames = np.arange(2 * B * H * W, dtype=np.float32).reshape(2 * B, H, W)
    stamps = np.arange(2 * B, dtype=np.float32)
    share = B // world_size
    mine = np.concatenate([np.arange(g * B + rank * share, g * B + (rank + 1) * share)
                           for g in range(2)])
    local = shard_frame_batches_multiprocess(
        ArraySource(frames[mine], stamps[mine]), mesh, B)
    whole = shard_frame_batches(ArraySource(frames, stamps), mesh, B)
    seen = 0
    for g, ((imgs, tss, rgs), (imgs_w, tss_w, _)) in enumerate(zip(local, whole)):
        if not (torch.equal(imgs, imgs_w) and torch.equal(tss, tss_w) and rgs is None):
            raise RuntimeError(f"rank {rank}: batch {g}: the two ingestion paths differ")
        total = imgs.sum().reshape(1)
        dist.all_reduce(total)
        if float(total) != float(frames[g * B:(g + 1) * B].sum()):
            raise RuntimeError(f"rank {rank}: batch {g} sums to {float(total)} over the world")
        seen += 1
    if seen != 2:
        raise RuntimeError(f"rank {rank}: {seen} batches")
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump({"ba_costs": costs.tolist(), "ref_costs": ref_costs.tolist(),
                       "landmarks_max_abs_diff": x_err, "batches": seen}, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="processes (default: 2 on the CPU, one a card on CUDA)")
    ap.add_argument("--timeout", type=float, default=300.0, help="wall-clock limit, seconds")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.nprocs or (2 if device.type == "cpu" else torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as out:
        try:
            spawn_world(_worker, n, (out,), device.type, args.timeout)
            with open(os.path.join(out, "result.json")) as f:
                result = json.load(f)
        except BaseException as e:
            print(json.dumps({"ok": False, "processes": n, "device": device.type,
                              "error": repr(e)[-1000:]}), flush=True)
            raise
    print(json.dumps({"ok": True, "processes": n, "device": device.type, **result}), flush=True)
    return 0


if __name__ == "__main__":
    from ergo_uvo_tpu_torch.dist import dryrun  # the workers pickle by this module's path

    sys.exit(dryrun.main())
