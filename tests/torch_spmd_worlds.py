"""Gloo worlds for the port's device-mesh tests (imported by the tests, not
collected).  Imports neither jax nor the reference package: its ranks are
fresh interpreters.

``World(scenario, nprocs, tmp)`` spawns ``nprocs`` ranks with
``torch.multiprocessing.start_processes(start_method="spawn")`` (never fork:
the parent has jax loaded), joined through a ``FileStore`` under ``tmp`` (no
TCP port to collide between test workers), each single-threaded
(``OMP_NUM_THREADS=1`` and ``torch.set_num_threads(1)``) with a timeout on
its process group.  Each rank runs ``SCENARIOS[scenario](rank, world,
device, *args)`` and writes what it returns — numpy arrays, ``as_dict()``s,
strings — to ``tmp``; :meth:`World.results` joins with a deadline (killing
every rank past it), raises if any rank failed, and returns the ranks'
results in rank order.

PE bodies are lambdas and do not pickle, so the scenarios build their graphs
inside the ranks, from the same seeds the parent uses for the reference."""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TOPOLOGIES = ("ring", "mesh", "torus", "fattree")
CUTS8 = ((0,) * 4 + (1,) * 4, (0, 1) * 4, (0, 0, 1, 2, 2, 1, 0, 1))


@contextlib.contextmanager
def _rank_env():
    """Environment the spawned ranks inherit: one OpenMP thread, and gloo on
    the loopback interface."""
    keys = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_entry(rank, world, tmp, scenario, args, device, pg_timeout):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=pg_timeout))
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        out = SCENARIOS[scenario](rank, world, device, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class World:
    """A running world; :meth:`results` waits for it."""

    def __init__(self, scenario, nprocs, tmp, args=(), device="cpu", timeout=120.0,
                 pg_timeout=60.0):
        self.tmp, self.nprocs, self.timeout = str(tmp), nprocs, timeout
        Path(self.tmp).mkdir(parents=True, exist_ok=True)
        with _rank_env():
            self.ctx = mp.start_processes(
                _rank_entry, args=(nprocs, self.tmp, scenario, tuple(args), device, pg_timeout),
                nprocs=nprocs, join=False, start_method="spawn")
        self.t0 = time.monotonic()
        self._results = None

    def results(self) -> list:
        if self._results is None:
            try:
                while not self.ctx.join(timeout=1.0):
                    if time.monotonic() - self.t0 > self.timeout:
                        raise TimeoutError(f"world of {self.nprocs} ranks still running "
                                           f"after {self.timeout:.0f} s")
            finally:
                self.close()
            self._results = []
            for r in range(self.nprocs):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results

    def close(self) -> None:
        """Kill whatever still runs (a test that never read the results)."""
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def same(a, b) -> bool:
    """Equal trees of dicts, lists, tuples and arrays (arrays bit for bit)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b


def one_result(world: World):
    """The result every rank returned (they must all be the same)."""
    res = world.results()
    for r, other in enumerate(res[1:], 1):
        assert same(res[0], other), f"rank {r} returned another result than rank 0"
    return res[0]


# ---------------------------------------------------------------------------
# graphs and inputs, built inside the ranks
# ---------------------------------------------------------------------------

def diamond(core):
    g = core.TaskGraph("diamond")
    g.add(core.PE("src", lambda x: {"a": x + 1, "b": x * 3}, (core.Port("x", (4,)),),
                  (core.Port("a", (4,)), core.Port("b", (4,)))))
    g.add(core.PE("l", lambda a: {"o": a * a}, (core.Port("a", (4,)),), (core.Port("o", (4,)),)))
    g.add(core.PE("r", lambda b: {"o": b - 2}, (core.Port("b", (4,)),), (core.Port("o", (4,)),)))
    g.add(core.PE("join", lambda l, r: {"out": l + r},
                  (core.Port("l", (4,)), core.Port("r", (4,))), (core.Port("out", (4,)),)))
    g.connect("src.a", "l.a")
    g.connect("src.b", "r.b")
    g.connect("l.o", "join.l")
    g.connect("r.o", "join.r")
    return g


def diamond_case(seed, n=6):
    """The reference's diamond differential (tests/test_spmd_engine.py): a
    random placement and a random 2-pod cut of ``n`` nodes."""
    rng = np.random.default_rng(seed)
    placement = {name: int(rng.integers(0, n)) for name in ("src", "l", "r", "join")}
    pods = [int(p) for p in np.random.default_rng(seed + 1).integers(0, 2, n)]
    return placement, pods


DIAMOND_X = np.arange(4.0, dtype=np.float32)
DIAMOND_BATCH = np.stack([np.arange(4.0, dtype=np.float32) * (b + 1) for b in range(3)])


def route_cube(n, c=7):
    return np.random.default_rng(n).integers(0, 255, (n, n, c)).astype(np.uint8)


def bmvm_inputs():
    rng = np.random.default_rng(0)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    return A, rng.integers(0, 2, (64,)).astype(np.uint8)


def bmvm_spmd_inputs():
    rng = np.random.default_rng(0)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    return A, rng.integers(0, 2, (3, 64)).astype(np.uint8)


def ldpc_llr():
    from repro_torch.apps import ldpc

    return ldpc.awgn_llr(np.zeros(7, np.int8), 3.0, np.random.default_rng(0))


def pf_inputs():
    from repro_torch.apps import particle_filter as pf

    cfg = pf.PFConfig(img=64, roi=16, n_particles=64, n_bins=16)
    frames, _ = pf.synth_video(cfg, 4, np.random.default_rng(3))
    return cfg, frames


def _np(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# scenarios (rank, world, device, *args) -> what the rank returns
# ---------------------------------------------------------------------------

def routes(rank, world, device):
    """Route programs on their own axes and linearized, the handwritten
    schedules, the fused transpose and the bridged programs, each gathered
    to every rank; and the too-few-ranks error."""
    from repro_torch import core
    from repro_torch.core.collectives import make_mesh
    from repro_torch.core.interchip import run_bridged_program

    dev = torch.device(device)
    out = {}
    for n in (4, 8):
        cube = torch.as_tensor(route_cube(n), device=dev)
        flat = torch.as_tensor(np.random.default_rng(n).normal(size=(n, n, 3)), device=dev,
                               dtype=torch.float32)
        for name in TOPOLOGIES:
            topo = core.make_topology(name, n)
            prog = core.compile_routes(topo)
            mesh = core.mesh_for_topology(topo)
            model = make_mesh((("model", n),), range(world))
            on = mesh.node >= 0
            row = cube[mesh.node] if on else torch.zeros_like(cube[0])
            frow = flat[mesh.node] if on else torch.zeros_like(flat[0])
            got = {
                "own": core.run_route_program(row, prog, mesh) if on else row,
                "schedule": core.all_to_all_for(topo, mesh)(row) if on else row,
                "oracle": core.transpose_oracle(row, mesh.axis(mesh.axis_names)) if on else row,
                "linearized": (core.run_route_program(frow, prog, model, axis_name="model")
                               if on else frow),
            }
            for k, v in got.items():
                out[(k, name, n)] = model.gather_nodes(v).cpu().numpy()
    cube = torch.as_tensor(route_cube(8), device=dev)
    for name in TOPOLOGIES:
        topo = core.make_topology(name, 8)
        for pods in CUTS8:
            plan = core.PartitionPlan({}, pods, (), (),
                                      core.QuasiSerdesConfig(wire_bits=16, lanes=4))
            bprog = core.compile_bridges(core.compile_routes(topo), plan,
                                         core.BridgeConfig(serdes=plan.serdes_cfg))
            mesh = core.mesh_for_partition(topo, plan)
            got = run_bridged_program(cube[mesh.node], bprog, mesh, mesh.axis_names)
            out[("bridged", name, pods)] = mesh.gather_nodes(got).cpu().numpy()
            out[("bridged_axes", name, pods)] = (mesh.axis_names, mesh.shape)
    try:
        core.mesh_for_topology(core.make_topology("ring", 2 * world))
        out["too_few"] = None
    except RuntimeError as e:
        out["too_few"] = str(e)
    return out


def executor(rank, world, device):
    """The NoC executor in mode="spmd": the diamond (6 of the ranks, random
    placement and 2-pod cut, run and run_batch), BMVM, LDPC and PF on the
    four topologies over 8 nodes (run_iterative), and a traced BMVM run."""
    from repro_torch import core
    from repro_torch.apps import bmvm, ldpc
    from repro_torch.apps import particle_filter as pf
    from repro_torch.telemetry import Tracer, trace_stats

    out = {}
    for name in TOPOLOGIES:
        for seed in (0, 1, 2):
            placement, pods = diamond_case(seed)
            g = diamond(core)
            ex = core.NoCExecutor(g, core.make_topology(name, 6), placement=placement,
                                  plan=core.cut(g, placement, pods), device=device)
            o, st = ex.run({"src.x": DIAMOND_X}, mode="spmd")
            ob, stb = ex.run_batch({"src.x": DIAMOND_BATCH}, mode="spmd")
            out[("diamond", name, seed)] = (_np(o), st.as_dict(), _np(ob), stb.as_dict())
    A, v = bmvm_inputs()
    cfg = bmvm.BMVMConfig(n=64, k=8, fold=2)
    lut = bmvm.preprocess(A, cfg, device=device)
    llr = ldpc_llr()
    pcfg, frames = pf_inputs()
    for name in TOPOLOGIES:
        o, st = bmvm.iterate_noc_sim(lut, v, cfg, 3, topology=name, mode="spmd", device=device)
        out[("bmvm", name)] = (o, st.as_dict())
        bits, post, st = ldpc.decode_on_noc(ldpc.fano_plane_H(), llr, 5, topology=name,
                                            n_nodes=8, mode="spmd", device=device)
        out[("ldpc", name)] = (bits, post, st.as_dict())
        c, st = pf.track_on_noc(frames, pcfg, n_pe=4, topology=name, n_nodes=8, mode="spmd",
                                device=device)
        out[("pf", name)] = (c, st.as_dict())
    tracer = Tracer()
    _, st = bmvm.iterate_noc_sim(lut, v, cfg, 2, topology="mesh", mode="spmd", tracer=tracer,
                                 device=device)
    out["traced"] = (st.as_dict(), trace_stats(tracer).as_dict(),
                     [(e.ts, e.name, e.track, e.kind, e.dur, e.value,
                       {k: a for k, a in (e.args or {}).items() if k != "mode"})
                      for e in tracer.events()])
    return out


def partitioned(rank, world, device):
    """The three apps cut into pods, mode="spmd" (bridge counters included)."""
    from repro_torch.apps import bmvm, ldpc
    from repro_torch.apps import particle_filter as pf

    out = {}
    llr = ldpc_llr()
    for name in ("mesh", "ring", "fattree"):
        for pods in ([0] * 4 + [1] * 4, [0, 1] * 4, [0, 0, 1, 1, 2, 2, 3, 3]):
            bits, post, st = ldpc.decode_on_noc(ldpc.fano_plane_H(), llr, 5, topology=name,
                                                n_nodes=8, pods=pods, mode="spmd",
                                                device=device)
            out[("ldpc", name, tuple(pods))] = (bits, post, st.as_dict())
    A, v = bmvm_inputs()
    cfg = bmvm.BMVMConfig(n=64, k=8, fold=2)
    lut = bmvm.preprocess(A, cfg, device=device)
    pcfg, frames = pf_inputs()
    for pods in ([0] * 4 + [1] * 4, [0, 1] * 4):
        for name in ("mesh", "torus"):
            o, st = bmvm.iterate_noc_sim(lut, v, cfg, 3, topology=name, pods=pods, mode="spmd",
                                         device=device)
            out[("bmvm", name, tuple(pods))] = (o, st.as_dict())
        for name in ("mesh", "fattree"):
            c, st = pf.track_on_noc(frames, pcfg, n_pe=4, topology=name, n_nodes=8, pods=pods,
                                    mode="spmd", device=device)
            out[("pf", name, tuple(pods))] = (c, st.as_dict())
    return out


def iterate_spmd(rank, world, device):
    """bmvm.iterate_spmd on the four topologies over every rank."""
    from repro_torch.apps import bmvm
    from repro_torch.kernels import ops

    A, V = bmvm_spmd_inputs()
    cfg = bmvm.BMVMConfig(n=64, k=8, fold=1)
    lut = bmvm.preprocess(A, cfg, device=device)
    out = {}
    for name in TOPOLOGIES:
        ops.reset_launch_counts()
        out[name] = bmvm.iterate_spmd(lut, V, cfg, 3, topology=name, device=device).cpu().numpy()
        if device == "cuda":
            out[("launches", name)] = ops.launch_counts()["gf2_bmvm"]
    return out


def noc_diamond(rank, world, device):
    """tests/test_torch_noc.py's spmd cases: the diamond on the 4-node mesh,
    uncut (run, run_batch) and under a 2-pod plan, against sim in the rank."""
    from repro_torch import core

    g = diamond(core)
    topo = core.make_topology("mesh", 4)
    x = {"src.x": DIAMOND_X}
    xb = {"src.x": DIAMOND_X[None]}
    out = {}
    ex = core.NoCExecutor(g, topo, device=device)
    for key, call, inp in (("run", ex.run, x), ("run_batch", ex.run_batch, xb)):
        (o, st), (o_sim, st_sim) = call(inp, mode="spmd"), call(inp, mode="sim")
        out[key] = (_np(o), st.as_dict(), _np(o_sim), st_sim.as_dict())
    placement = {p: i for i, p in enumerate(g.pes)}
    ex = core.NoCExecutor(g, topo, plan=core.cut(g, placement, [0, 0, 1, 1]), device=device)
    (o, st), (o_sim, st_sim) = ex.run(x, mode="spmd"), ex.run(x, mode="sim")
    out["plan"] = (_np(o), st.as_dict(), _np(o_sim), st_sim.as_dict())
    return out


def main(rank, world, device):
    """Every scenario above in one world, in order (one start-up for all)."""
    return {f.__name__: f(rank, world, device)
            for f in (routes, executor, partitioned, iterate_spmd)}


def fail(rank, world, device, how):
    """Rank 1 raises, or hangs while rank 0 waits on it."""
    from repro_torch import core

    mesh = core.mesh_for_topology(core.make_topology("ring", world))
    if rank == 1:
        if how == "raises":
            raise RuntimeError("rank 1 fails on purpose")
        time.sleep(600)
    return core.ring_all_to_all_unidir(torch.zeros(world, 2), mesh.axis("noc")).numpy()


# the scenarios a world starts with (main runs the first four in turn)
SCENARIOS = {f.__name__: f for f in (main, iterate_spmd, noc_diamond, fail)}
