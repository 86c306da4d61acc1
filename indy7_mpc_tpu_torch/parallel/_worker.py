"""Run a function on R fresh processes, one rank each, and the rank jobs
of the port's sharding tests.

:func:`spawn` starts R processes with the ``spawn`` method (a parent that
has started CUDA cannot fork), joins them into one process group through
a file store in a new temporary directory (no fixed port), runs
``target(mesh, *args)`` on every rank and returns the ranks' results in
rank order.  A rank that raises, dies or outlives the timeout fails the
call, and every process it started is ended.  Arguments and results cross
the process boundary by pickling: pass numpy arrays, configs and module
level functions, not tensors.

The jobs below (``*_job``) are what tests/test_torch_parallel.py and
tests/test_torch_gpu.py run on each rank; they live in the package so
that a rank never imports a test module (the tests' conftest imports
JAX).  :func:`run_jobs` runs several in one spawn.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch


def spawn(target, world: int, *args, device=None, backend: str = "gloo",
          timeout: float = 300.0) -> list:
    """``[target(mesh, *args) on rank r for r in range(world)]``, each rank
    a process of its own on ``device`` (default: its card) over
    ``backend``.  Raises RuntimeError with the failing rank's traceback,
    or TimeoutError."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="indy7_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            target, rank, world, init, backend, device, args, results)) for rank in range(world)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < world:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with {procs[dead[0]].exitcode} "
                                           "without a result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10.0 if len(out) == world else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]


def _rank_main(target, rank, world, init, backend, device, args, results):
    import torch.distributed as tdist

    from .distributed import initialize

    try:
        torch.set_num_threads(1)  # R ranks beside other work: no oversubscription
        mesh = initialize(init, world, rank, backend=backend, device=device)
        results.put((rank, True, target(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def run_jobs(mesh, jobs):
    """``[fn(mesh, **kwargs) for fn, kwargs in jobs]``: several jobs in one
    spawn."""
    return [fn(mesh, **kwargs) for fn, kwargs in jobs]


def _np(t):
    return t.detach().cpu().numpy()


def _model(mesh, dtype):
    from ..models import indy7

    return indy7(torch.float32 if np.dtype(dtype) == np.float32 else torch.float64,
                 mesh.device)


def batch_solve_job(mesh, cost_cfg, sqp_cfg, dt, arrays, backend="auto"):
    """The sharded batch solve of the full B-major ``arrays`` (xs, goals,
    X, U, wrench); the whole result, gathered, and this rank's K1
    launches."""
    from ..ops.kernels.sqp_kernel import sqp_solve
    from .distributed import gather_lanes, global_lanes
    from .sharding import make_sharded_batch_solve

    solve = make_sharded_batch_solve(_model(mesh, arrays[0].dtype), cost_cfg, sqp_cfg, dt,
                                     mesh, backend)
    local = global_lanes(mesh, arrays)
    before = sqp_solve.launches
    res = solve(*local)
    return {"lanes": local[0].shape[0], "launches": sqp_solve.launches - before,
            "X": _np(gather_lanes(mesh, res.X)), "U": _np(gather_lanes(mesh, res.U)),
            "alphas": _np(gather_lanes(mesh, res.stats.alphas))}


def tick_job(mesh, cost_cfg, sqp_cfg, sample_cfg, dt, inputs, normals, backend="auto"):
    """Two sharded host ticks: the first on ``inputs`` (x_obs, x_last,
    u_last, goals, X_warm, U_warm, the full f_batch) with the full
    ``normals``, the second on the same inputs with the first's returned
    block of f_batch (the feedback edge)."""
    from .distributed import fetch_replicated, gather_lanes, global_lanes, replicated_global
    from .sharding import make_sharded_sampled_tick

    *rep, f_full = inputs
    rep = replicated_global(mesh, rep)
    tick = make_sharded_sampled_tick(_model(mesh, f_full.dtype), cost_cfg, sqp_cfg, sample_cfg,
                                     dt, mesh, backend)
    normals = replicated_global(mesh, normals)
    out, _ = tick(*rep, global_lanes(mesh, f_full), normals=normals)
    again, _ = tick(*rep, out.f_batch, normals=normals)
    res = {f: fetch_replicated(v) for f, v in out._asdict().items() if f != "f_batch"}
    res.update(f_batch=_np(gather_lanes(mesh, out.f_batch)),
               f_batch_block=tuple(out.f_batch.shape), again_u=_np(again.u),
               again_f_batch_block=tuple(again.f_batch.shape))
    return res


def loop_job(mesh, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, ref, ticks, backend="auto",
             plant_cfg=None, carry0=None, draws=None, x0=None, f_true0=None, seed=None):
    """The sharded closed loop for ``ticks`` ticks (one chunk) from
    ``carry0`` (a ``SampledLoopCarry`` of numpy arrays, f_batch whole) with
    ``draws`` (full-tick ``TickDraws`` of numpy arrays), or from
    ``init_loop_carry(x0, f_true0)`` and a generator on the mesh's device
    seeded with ``seed``.  The trace, the final carry with its f_batch
    gathered, the block's shape and this rank's launches."""
    from ..mpc.sampled import init_loop_carry
    from ..ops.kernels.sqp_kernel import sqp_solve
    from ..ops.kernels.tick_kernel import tick_epilogue
    from .distributed import gather_lanes
    from .sharding import make_sharded_sampled_loop, shard_lanes

    dtype = np.asarray(ref).dtype
    model = _model(mesh, dtype)
    gen = None if seed is None else torch.Generator(device=mesh.device).manual_seed(seed)
    loop, layout = make_sharded_sampled_loop(
        model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, mesh, torch.as_tensor(ref), ticks,
        backend=backend, plant_cfg=plant_cfg, generator=gen)
    if carry0 is None:
        carry0 = init_loop_carry(model, mpc_cfg, sample_cfg,
                                 torch.as_tensor(x0, device=mesh.device),
                                 f_true0, gen)
    carry = shard_lanes(mesh, carry0, layout)
    before = sqp_solve.launches, tick_epilogue.launches
    final, trace = loop(carry, None if draws is None else shard_lanes(mesh, draws, None))
    launches = sqp_solve.launches - before[0], tick_epilogue.launches - before[1]
    return {"trace": {f: _np(v) for f, v in trace._asdict().items()},
            "carry": {f: _np(gather_lanes(mesh, v) if f == "f_batch" else v)
                      for f, v in final._asdict().items()},
            "f_batch_block": tuple(final.f_batch.shape), "launches": launches}


def consensus_job(mesh, err, X, U, f_batch, iters):
    """``cross_rank_consensus`` on the rank's blocks of full arrays."""
    from . import cross_rank_consensus, shard_lanes

    w = cross_rank_consensus(mesh, *shard_lanes(mesh, (err, X, U, f_batch, iters)))
    return {f: _np(v) for f, v in w._asdict().items()}


def resample_job(mesh, normals, f_batch, best, sample_cfg):
    """``resample_lanes`` of the rank's block of the full ``f_batch`` around
    global lane ``best``; the whole result, gathered."""
    from . import resample_lanes, shard_lanes
    from .distributed import gather_lanes

    f_full = torch.as_tensor(f_batch)
    f = resample_lanes(mesh, shard_lanes(mesh, normals, None), shard_lanes(mesh, f_full),
                       torch.tensor(best, device=mesh.device),
                       f_full[best].to(mesh.device), sample_cfg)
    return _np(gather_lanes(mesh, f))


def reinit_job(mesh):
    """``initialize`` again: as the same rank of the same group (its mesh
    comes back) and as a rank of a larger group (RuntimeError).  Returns
    (rank, ranks, same mesh, refused)."""
    import torch.distributed as tdist

    from .distributed import initialize

    backend = tdist.get_backend()
    same = initialize("file:///unused", mesh.size, mesh.rank, backend, mesh.device) == mesh
    try:
        initialize("file:///unused", mesh.size + 1, mesh.rank, backend, mesh.device)
        refused = False
    except RuntimeError:
        refused = True
    return mesh.rank, mesh.size, same, refused
