"""The port's multi-process layer on the CPU: the pod mesh's axis policy (the
twin of tests/test_multihost.py), the backend rule, a genuine 2-process gloo
smoke over localhost (parallel/_smoke.py, the twin of the JAX package's slow
smoke, here fast enough for tier 1), and every solver across 2 processes.

Each worker of the solver matrix owns 2 of 4 CPU shard slots and runs every
case in layout (a), 'factor' across the processes (factor_parallel=2), and
layout (b), 'mode' across them (factor_parallel=1, the halo between slots 1
and 2 crossing), on both comms. Its results are digested (sha256 of every
tensor's bytes) and must equal, bit for bit, the single-controller solve on
the same layout (make_mesh over 4 CPU slots) run in this process: psum
all-gathers the partials and adds them in shard order, so the bits cannot
move. The paths that are not ported across processes must raise their named
NotImplementedError. Every wait on a worker has a timeout, after which the
workers are killed.

Run as a script (python tests/test_torch_multihost.py --worker RANK PORT) it
is one such worker.
"""
import dataclasses
import hashlib
import json
import os
import re
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.models.gallery import _banded_operator
from tensorkrylov_tpu_torch.parallel import make_mesh, make_pod_mesh, shard_operator
from tensorkrylov_tpu_torch.parallel.multihost import choose_backend
from tensorkrylov_tpu_torch.parallel.sharding import Mesh, comm_stats

# bit-equality with another process needs the same BLAS threading on both sides
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
WORKER_TIMEOUT = 600     # seconds for one worker process, start to end: a guard against a hang, not a limit on speed
LAYOUTS = {"a": 2, "b": 1}   # factor_parallel of the 2 x 2 slots: 'factor' or 'mode' across the processes
SETUPS = [(lay, comm) for lay in LAYOUTS for comm in ("ring", "gspmd")]
D, N = 4, 32


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(argvs, timeout=WORKER_TIMEOUT, meanwhile=None):
    """Start one process per argv, run meanwhile() (if given) while they
    work, wait for all with a timeout, kill them all on timeout or on any
    failure; returns their stdouts (and meanwhile's result)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for argv in argvs]
    try:
        mine = meanwhile() if meanwhile is not None else None
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker exited {p.returncode}:\n{out}\n{err[-4000:]}"
    outs = [out for out, _ in outs]
    return outs if meanwhile is None else (outs, mine)


def digest(x) -> str:
    """sha256 over every tensor, array and number of a result, in field order."""
    h = hashlib.sha256()

    def feed(v):
        if isinstance(v, torch.Tensor):
            h.update(str(v.dtype).encode() + str(tuple(v.shape)).encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(v, np.ndarray):
            h.update(np.ascontiguousarray(v).tobytes())
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                if f.name != "config":
                    feed(getattr(v, f.name))
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            for f in v._fields:
                feed(getattr(v, f))
        elif isinstance(v, (list, tuple)):
            for e in v:
                feed(e)
        elif isinstance(v, (int, float, bool, str)) or v is None:
            h.update(repr(v).encode())
    feed(x)
    return h.hexdigest()


def _penta(d, n):
    """An SPD pentadiagonal operator: a halo two columns wide."""
    return _banded_operator({-2: 1.0, -1: -4.0, 0: 6.5, 1: -4.0, 2: 1.0}, d, n, torch.float64, True, CPU)


def _unit_rhs(d, n, seed):
    b = tkt.random_rhs(d, n, seed=seed)
    return b / torch.linalg.vector_norm(b, dim=1, keepdim=True)


def _block_rhs(R, d, n, seed):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((R, d, n))
    return torch.from_numpy(B / np.linalg.norm(B, axis=-1, keepdims=True))


LAP = dict(kmax=32, tol=1e-8, check_every=4)


def _solve(orth):
    def run(mesh, comm):
        op = tkt.conv_diff(D, N, device=CPU) if orth == "arnoldi" else tkt.laplace(D, N, device=CPU)
        cfg = tkt.SolverConfig(**(dict(kmax=12, tol=1e-6, tmax=151) if orth == "arnoldi" else LAP), orth=orth)
        return tkt.solve(shard_operator(op, mesh, comm), _unit_rhs(D, N, 1), cfg)
    return run


def _sharded(mesh, comm):
    return tkt.parallel.solve_sharded(tkt.laplace(D, N, device=CPU), _unit_rhs(D, N, 1), tkt.SolverConfig(**LAP),
                                      mesh, comm)


def _penta_solve(mesh, comm):
    return tkt.solve(shard_operator(_penta(D, N), mesh, comm), _unit_rhs(D, N, 2), tkt.SolverConfig(**LAP))


def _two_pass(mesh, comm):
    cfg = tkt.SolverConfig(**LAP, orth="lanczos")
    return tkt.solve_two_pass(shard_operator(tkt.laplace(D, N, device=CPU), mesh, comm), _unit_rhs(D, N, 3), cfg)


def _block(mesh, comm):
    cfg = tkt.SolverConfig(kmax=12, tol=1e-9, check_every=1)
    return tkt.solve_block(shard_operator(tkt.laplace(D, N, device=CPU), mesh, comm), _block_rhs(2, D, N, 5), cfg)


def _deflated(storage):
    def run(mesh, comm):
        op = tkt.laplace(D, N, shift=50.0, device=CPU)
        return tkt.solve_deflated(op, _unit_rhs(D, N, 7), tkt.SolverConfig(kmax=24, tol=1e-7), m=4,
                                  checkpoints=[8, 16, 24], storage=storage, mesh=mesh, comm=comm)
    return run


def _host_projected(mesh, comm):
    cfg = tkt.SolverConfig(kmax=32, tol=1e-8, check_every=4)
    return tkt.solve_host_projected(shard_operator(tkt.laplace(D, N, device=CPU), mesh, comm), _unit_rhs(D, N, 1), cfg)


def _resumable(mesh, comm):
    return tkt.solve_resumable(shard_operator(tkt.laplace(D, N, device=CPU), mesh, comm), _unit_rhs(D, N, 1),
                               tkt.SolverConfig(**LAP), chunk=5)


def _refined(mesh, comm):
    return tkt.solve_refined(shard_operator(tkt.laplace(D, N, device=CPU), mesh, comm), _unit_rhs(D, N, 3),
                             tkt.SolverConfig(kmax=10, tol=1e-5), max_restarts=1, residual_rank=4)


def _multi_rhs(mesh, comm):
    return tkt.solve_multi_rhs(shard_operator(tkt.laplace(D, N, device=CPU), mesh, comm), _block_rhs(2, D, N, 9),
                               tkt.SolverConfig(**LAP))


def _multi_rhs_mesh(mesh, comm):
    return tkt.solve_multi_rhs(tkt.laplace(D, N, device=CPU), _block_rhs(2, D, N, 9), tkt.SolverConfig(**LAP),
                               mesh=mesh, comm=comm)


# name: the solve, run on a mesh and a comm
CASES = {
    "solve_lanczos_reorth": _solve("lanczos_reorth"),
    "solve_lanczos": _solve("lanczos"),
    "solve_lanczos_reorth_auto": _solve("lanczos_reorth_auto"),
    "solve_arnoldi": _solve("arnoldi"),
    "solve_sharded": _sharded,
    "solve_pentadiagonal": _penta_solve,
    "solve_two_pass": _two_pass,
    "solve_block": _block,
    "solve_deflated_full": _deflated("full"),
    "solve_deflated_twopass": _deflated("twopass"),
    "solve_host_projected": _host_projected,
    "solve_resumable": _resumable,
    "solve_refined": _refined,
    "solve_multi_rhs": _multi_rhs,
    "solve_multi_rhs_mesh": _multi_rhs_mesh,
}


def _refusals(mesh, tmp):
    """Each path that is not ported across processes: name → the call."""
    op = tkt.laplace(D, N, shift=50.0, device=CPU)
    b = _unit_rhs(D, N, 7)
    cfg = tkt.SolverConfig(kmax=24, tol=1e-7)
    return {
        "df64": lambda: tkt.solve_deflated(op, b, cfg, m=4, storage="df64", mesh=mesh, comm="gspmd"),
        "state_cache": lambda: tkt.solve_deflated(op, b, cfg, m=4, storage="twopass", mesh=mesh,
                                                  state_cache=os.path.join(tmp, "s.npz")),
        "resumable_checkpoint": lambda: tkt.solve_resumable(shard_operator(op, mesh, "ring"), b, cfg, chunk=5,
                                                            checkpoint_path=os.path.join(tmp, "c.pt")),
        "rhs_groups": lambda: Mesh(mesh.devices, ("rhs", "factor", "mode"), (mesh.devices,), mesh.ranks, mesh.rank),
    }


REFUSED = {"df64": "#11", "state_cache": "#12", "resumable_checkpoint": "#13", "rhs_groups": "#14"}


def worker(rank: int, port: int) -> None:
    """One rank of the 2-process matrix: every case in every setup, the
    refusals and the ownership facts, printed as one JSON line."""
    from tensorkrylov_tpu_torch.parallel import global_array, init_distributed

    init_distributed(f"localhost:{port}", 2, rank, 2)
    out = {"cases": {}, "refused": {}, "owned": {}}
    for lay, fp in LAYOUTS.items():
        mesh = make_pod_mesh(factor_parallel=fp, devices=[CPU] * 2)
        sop = shard_operator(tkt.laplace(D, N, device=CPU), mesh, "gspmd")
        x = np.arange(D * N, dtype=np.float64).reshape(D, N)
        out["owned"][lay] = dict(shards=[sh.index for sh in sop.shards], mesh_ranks=[list(r) for r in mesh.ranks],
                                 pieces=[p.tolist() for p in global_array(x, mesh, ("factor", "mode"))])
        for comm in ("ring", "gspmd"):
            for name, run in CASES.items():
                out["cases"][f"{name}/{lay}/{comm}"] = digest(run(mesh, comm))
        with tempfile.TemporaryDirectory() as tmp:
            for name, call in _refusals(mesh, tmp).items():
                try:
                    call()
                    out["refused"][f"{name}/{lay}"] = None
                except NotImplementedError as e:
                    out["refused"][f"{name}/{lay}"] = str(e)
    out["comm_stats"] = dict(comm_stats)
    print("RESULT " + json.dumps(out), flush=True)


def _single():
    """The single-controller digests on the same layouts: 4 CPU slots."""
    return {f"{name}/{lay}/{comm}": digest(run(make_mesh(devices=[CPU] * 4, factor_parallel=fp), comm))
            for lay, fp in LAYOUTS.items() for comm in ("ring", "gspmd") for name, run in CASES.items()}


@pytest.fixture(scope="module")
def runs():
    """(each worker's results, the single-controller digests), the latter
    computed here while the workers run."""
    port = _free_port()
    outs, single = _run_workers([[sys.executable, os.path.abspath(__file__), "--worker", str(r), str(port)]
                                 for r in range(2)], meanwhile=_single)
    return [json.loads(re.search(r"^RESULT (.*)$", o, re.M).group(1)) for o in outs], single


@pytest.fixture(scope="module")
def matrix(runs):
    return runs[0]


@pytest.fixture(scope="module")
def single(runs):
    return runs[1]


# ---- the axis policy and the backend rule ----

def test_pod_mesh_axis_policy():
    """'factor' spans the process-major dimension, 'mode' the local one: the
    rows of the grid are contiguous slot ranges (tests/test_multihost.py:17)."""
    mesh = make_pod_mesh(factor_parallel=2, devices=[CPU] * 8)
    assert mesh.axis_names == ("factor", "mode")
    assert mesh.shape == {"factor": 2, "mode": 4}
    assert all(dev == CPU for row in mesh.devices for dev in row)
    assert mesh.processes == 1 and mesh.lead == CPU
    with pytest.raises(ValueError, match="not divisible by factor_parallel=3"):
        make_pod_mesh(factor_parallel=3, devices=[CPU] * 8)


def test_pod_mesh_needs_a_card_or_cpu_devices():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default devices are its")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pod_mesh()


def test_init_without_a_group_is_one_process(monkeypatch):
    for k in ("TK_COORDINATOR", "TK_NUM_PROCESSES", "TK_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tkt.parallel.init_distributed() == 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cards, backend", [
    (["cpu", "cpu"], "gloo"),
    (["cpu"] * 4, "gloo"),
    (["host/GPU-a", "host/GPU-a"], "gloo"),                           # two ranks share a card
    (["host/GPU-a", "host/GPU-b", "host/GPU-a", "host/GPU-c"], "gloo"),
    (["host/GPU-a", "host/GPU-b"], "nccl"),                           # a card per rank
    (["h1/GPU-a", "h2/GPU-a", "h1/GPU-b", "h2/GPU-b"], "nccl"),
    (["host/GPU-a", "cpu"], "gloo"),
])
def test_backend_rule(cards, backend):
    assert choose_backend(cards) == backend


_GROUP = ("import torch.distributed as dist; from tensorkrylov_tpu_torch.parallel import init_distributed;"
          "r = init_distributed({args});"
          "print(f'GROUP {{r}} {{dist.get_backend()}} {{dist.get_world_size()}}', flush=True)")


@pytest.mark.parametrize("how", ["arguments", "TK_variables", "torchrun"])
def test_gloo_group_starts_on_the_cpu(how):
    """A 2-process group on the CPU starts as the rule says (gloo) and sees
    its peer, named by init_distributed's arguments, by the TK_* variables
    or by torchrun's."""
    port = _free_port()
    if how == "torchrun":
        argvs = [[sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_port", str(port),
                  "--no-python", sys.executable, "-c", _GROUP.format(args="")]]
    elif how == "TK_variables":
        argvs = [["env", f"TK_COORDINATOR=localhost:{port}", "TK_NUM_PROCESSES=2", f"TK_PROCESS_ID={r}",
                  sys.executable, "-c", _GROUP.format(args="")] for r in range(2)]
    else:
        argvs = [[sys.executable, "-c", _GROUP.format(args=f"'localhost:{port}', 2, {r}")] for r in range(2)]
    out = "".join(_run_workers(argvs))
    assert sorted(re.findall(r"GROUP \d+ \w+ \d+", out)) == ["GROUP 0 gloo 2", "GROUP 1 gloo 2"]


# ---- the 2-process smoke ----

def test_two_process_cpu_smoke():
    """Two _smoke workers over localhost (gloo), each with 2 CPU slots, on the
    pod mesh (tests/test_multihost.py:42): both print the same SMOKE line,
    bit-equal to the single-controller solve_sharded on the same layout and
    within the JAX test's 1e-2 of the JAX package's solve."""
    port = _free_port()
    outs = _run_workers([[sys.executable, "-m", "tensorkrylov_tpu_torch.parallel._smoke", "--coordinator",
                          f"localhost:{port}", "--num-processes", "2", "--process-id", str(r), "--local-devices",
                          "2", "--cpu"] for r in range(2)])
    lines = [re.search(r"^SMOKE .*$", o, re.M).group(0) for o in outs]
    assert lines[0] == lines[1], lines
    m = re.match(r"SMOKE (\d+) (\d+) ([0-9.e+-]+) procs=2 devices=4$", lines[0])
    assert m, lines[0]
    status, ni, rel = int(m.group(1)), int(m.group(2)), float(m.group(3))
    assert status == 1 and rel < 1e-6

    res = tkt.parallel.solve_sharded(tkt.laplace(4, 32, device=CPU), _unit_rhs(4, 32, 1),
                                     tkt.SolverConfig(kmax=32, tol=1e-6),
                                     make_mesh(devices=[CPU] * 4, factor_parallel=2))
    assert (res.status, res.niterations) == (status, ni)
    assert f"{float(res.relative_residual[ni]):.12e}" == m.group(3)

    import tensorkrylov_tpu as tk

    op = tk.laplace(4, 32)
    b = tk.random_rhs(4, 32, seed=1)
    b = b / np.linalg.norm(np.asarray(b), axis=1, keepdims=True)
    jres = tk.solve(op, b, tk.SolverConfig(kmax=32, tol=1e-6))
    rel_jax = float(np.asarray(jres.relative_residual)[int(jres.niterations)])
    assert abs(rel - rel_jax) < 1e-2 * max(rel, rel_jax) + 1e-9


# ---- every solver across 2 processes ----

@pytest.mark.parametrize("setup", SETUPS, ids=[f"{lay}-{comm}" for lay, comm in SETUPS])
@pytest.mark.parametrize("name", list(CASES))
def test_solver_bit_equal_across_processes(matrix, single, name, setup):
    key = f"{name}/{setup[0]}/{setup[1]}"
    assert matrix[0]["cases"][key] == matrix[1]["cases"][key], "the two ranks differ"
    assert matrix[0]["cases"][key] == single[key], "the ranks differ from the single-controller solve"


@pytest.mark.parametrize("lay", list(LAYOUTS))
@pytest.mark.parametrize("name", list(REFUSED))
def test_named_refusal_across_processes(matrix, name, lay):
    for rank in matrix:
        msg = rank["refused"][f"{name}/{lay}"]
        assert msg is not None and "not ported" in msg and f"Queue 1, {REFUSED[name]}" in msg, msg


def test_refused_paths_run_on_one_process():
    """The refusals are of the multi-process mesh only: one controller runs them."""
    mesh = make_mesh(devices=[CPU] * 4, factor_parallel=2)
    with tempfile.TemporaryDirectory() as tmp:
        for name, call in _refusals(mesh, tmp).items():
            call()


@pytest.mark.parametrize("lay", list(LAYOUTS))
def test_rank_owns_its_shards(matrix, lay):
    """A rank's ShardedOperator holds only the shards of its slots, and
    global_array returns only its pieces."""
    x = np.arange(D * N, dtype=np.float64).reshape(D, N)
    for rank, out in enumerate(matrix):
        owned = out["owned"][lay]
        assert owned["shards"] == [2 * rank, 2 * rank + 1]
        fp = LAYOUTS[lay]
        P = 4 // fp
        rows = [(q // P, q % P) for q in owned["shards"]]
        want = [x[g * D // fp:(g + 1) * D // fp, p * N // P:(p + 1) * N // P].tolist() for g, p in rows]
        assert owned["pieces"] == want
        assert owned["mesh_ranks"] == ([[0, 0], [1, 1]] if fp == 2 else [[0, 0, 1, 1]])


def test_halo_and_allgather_traffic_is_counted(matrix):
    """Layout (b) sends halos across the processes, every psum all-gathers,
    and so does every gathered vector."""
    for out in matrix:
        stats = out["comm_stats"]
        assert stats["halo_calls"] > 0 and stats["halo_bytes"] > 0
        assert stats["psum_calls"] > 0 and stats["psum_bytes"] > 0
        assert stats["gather_calls"] > 0 and stats["gather_bytes"] > 0
        assert stats.get("halo_host_bytes", 0) == 0      # CPU tensors go straight to gloo


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]))
