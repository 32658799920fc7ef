"""The port's user entry points on the CPU: convergence telemetry, the system
API, the CLI (in-process), the bench's measurements at a tiny size and the
reproduction runner, each against the JAX package on the same inputs."""
import dataclasses
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu import convergence as jconv
from tensorkrylov_tpu.experiments.reproduction import run_reproduction as jax_reproduction
from tensorkrylov_tpu_torch import bench, convergence
from tensorkrylov_tpu_torch.__main__ import main
from tensorkrylov_tpu_torch.experiments.reproduction import run_reproduction
from tensorkrylov_tpu_torch.ops import _build

# many small eigh calls: one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)

TRACE_RTOL = 1e-10  # the two packages' d=3, n=30 traces agree to ~1e-12 (f64 rounding of two eigh routines)


def _solves(check_every):
    jb = tk.random_rhs(3, 30, seed=7)
    jb = jb / jnp.linalg.norm(jb, axis=1, keepdims=True)
    ref = tk.solve(tk.laplace(3, 30), jb, tk.SolverConfig(kmax=30, tol=1e-8, check_every=check_every))
    res = tkt.solve(tkt.laplace(3, 30, device="cpu"), torch.tensor(np.asarray(jb)),
                    tkt.SolverConfig(kmax=30, tol=1e-8, check_every=check_every))
    return ref, res


@pytest.mark.parametrize("check_every", [1, 3])
def test_trim_matches_jax(check_every):
    """Same keys and lengths; traces to 1e-10 (inf at the unchecked steps in
    the same places). The orthogonality-loss estimate is rounding noise
    (~1e-12 in both packages), so it is held to an absolute 1e-11."""
    ref, res = _solves(check_every)
    a, b = jconv.trim(ref), convergence.trim(res)
    assert list(a) == list(b)
    for key in a:
        assert b[key].shape == a[key].shape, key
        if key == "orthogonality":
            np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-11)
        elif key in ("iterations", "expsum_rank"):
            np.testing.assert_array_equal(b[key], a[key])
        else:
            np.testing.assert_allclose(b[key], a[key], rtol=TRACE_RTOL)


def test_summarize_and_to_json_match_jax():
    """The same table (status line, header, rows) but for the orth.loss
    column; the same JSON keys, status name and iteration count."""
    ref, res = _solves(3)

    def rows(text):
        lines = text.splitlines()
        return lines[:2] + [" ".join(ln.split()[:3] + ln.split()[4:]) for ln in lines[2:]]

    assert rows(convergence.summarize(res)) == rows(jconv.summarize(ref))
    assert rows(convergence.summarize(res, every=4)) == rows(jconv.summarize(ref, every=4))
    a, b = json.loads(jconv.to_json(ref)), json.loads(convergence.to_json(res))
    assert sorted(a) == sorted(b) and a["status"] == b["status"] == "CONVERGED"
    assert a["niterations"] == b["niterations"] == 30
    np.testing.assert_allclose(b["relative_residual"], a["relative_residual"], rtol=TRACE_RTOL)


def test_tensorized_system_matches_jax():
    b = tk.random_rhs(3, 30, seed=11)
    jsys = tk.TensorizedSystem.create(tk.laplace(3, 30), b)
    sys_ = tkt.TensorizedSystem.create(tkt.laplace(3, 30, device="cpu"), torch.tensor(np.asarray(b)))
    assert repr(sys_) == repr(jsys) and (sys_.d, sys_.n) == (3, 30)
    np.testing.assert_allclose(sys_.b.numpy(), np.asarray(jsys.b), rtol=1e-15)
    raw = tkt.TensorizedSystem.create(tkt.laplace(3, 30, device="cpu"), torch.tensor(np.asarray(b)), normalize_rhs=False)
    np.testing.assert_array_equal(raw.b.numpy(), np.asarray(b))
    assert "nonsymmetric" in repr(tkt.TensorizedSystem.create(tkt.conv_diff(2, 8, device="cpu"), torch.ones((2, 8))))
    with pytest.raises(ValueError, match=r"b must be \(d, n\)"):
        tkt.TensorizedSystem.create(tkt.laplace(3, 30, device="cpu"), torch.ones((3, 29)))

    ref = tk.solve_tensorized_system(jsys, nmax=30, tol=1e-8)
    res = tkt.solve_tensorized_system(sys_, nmax=30, tol=1e-8)
    assert (res.status, res.niterations) == (int(ref.status), int(ref.niterations)) == (tkt.Status.CONVERGED, 30)
    k = res.niterations
    np.testing.assert_allclose(res.relative_residual[1:k + 1].numpy(), np.asarray(ref.relative_residual)[1:k + 1],
                               rtol=TRACE_RTOL)
    assert tkt.kron_residual_dense(sys_.op, res.x, sys_.b) <= 1e-8
    assert res.config.kmax == 30 and res.config.orth == "lanczos_reorth"
    cfg = tkt.SolverConfig(kmax=12, tol=1e-30, orth="lanczos")
    assert tkt.solve_tensorized_system(sys_, config=cfg).config.orth == "lanczos"


def test_multiple_rhs_matches_jax():
    got = tkt.multiple_rhs([2, 4], 17, seed=5)
    ref = tk.system.multiple_rhs([2, 4], 17, seed=5)
    assert [tuple(g.shape) for g in got] == [(2, 17), (4, 17)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_cli_solve(tmp_path, capsys):
    out = tmp_path / "traces.json"
    rc = main(["solve", "--gallery", "laplace", "--d", "3", "--n", "40", "--tol", "1e-8", "--cpu",
               "--json", str(out)])
    assert rc == 0
    assert "CONVERGED" in capsys.readouterr().out
    payload = json.loads(out.read_text())
    assert payload["status"] == "CONVERGED" and len(payload["relative_residual"]) == payload["niterations"]


def test_cli_solve_maxiter_exit_code(capsys):
    assert main(["solve", "--d", "2", "--n", "20", "--kmax", "3", "--tol", "1e-12", "--cpu"]) == 2
    assert "MAXITER" in capsys.readouterr().out


def test_cli_info(capsys):
    assert main(["info", "--cpu"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["backend"] == "cpu" and payload["version"] == tkt.__version__
    assert isinstance(payload["native_runtime"], bool) and payload["devices"] == ["cpu"]


@pytest.mark.parametrize("argv", [["solve"], ["info"], ["reproduce", "--dims", "2"]])
def test_cli_without_card_refuses(monkeypatch, argv):
    """Without --cpu the CLI runs on the card; with none it stops, not on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv)


TINY = dict(d=2, n=256, iters=2, cpu_iters=2, solver=(2, 64, 16), loop_steps=((2, 4), (2, 4)), solve_kmaxes=(8, 16))


def test_bench_keys_and_values():
    """Every key of the JAX bench's line (the v5e roofline replaced by the
    H100's), positive finite rates; on the CPU the kernels' plain versions run."""
    launches = dict(_build.launches)
    out = bench.measure("cpu", **TINY)
    assert dict(_build.launches) == launches
    assert {"metric", "value", "unit", "vs_baseline", "extra"} <= set(out)
    extra = out["extra"]
    rates = ["xla_scan_gnnz_s", "resident_pallas_gnnz_s", "cpu_numpy_gnnz_s", "solver_iters_per_s_f64",
             "solver_loop_xla_gnnz_s", "solver_loop_resident_gnnz_s", "solve_resident_gnnz_s",
             "solve_xla_segment_gnnz_s"]
    assert set(rates + ["platform", "spmv_config", "roofline_3350GBps"]) <= set(extra)
    assert "roofline_819GBps" not in extra and extra["platform"] == "cpu"
    for key in rates:
        assert np.isfinite(extra[key]) and extra[key] > 0, key
    assert out["value"] == max(extra["xla_scan_gnnz_s"], extra["resident_pallas_gnnz_s"])
    assert extra["resident_spmv"]["gate_max_abs_err"] == 0.0
    roof = extra["roofline_3350GBps"]
    # 20 B per element per apply: d·(3n−2) nonzeros per 5·d·n·4 bytes at 3.35 TB/s
    assert roof["stream_gnnz_s"] == pytest.approx(2 * (3 * 256 - 2) / (5 * 2 * 256 * 4 / 3.35e12) / 1e9)
    assert roof["bands_resident_gnnz_s"] == pytest.approx(2.5 * roof["stream_gnnz_s"])


def test_bench_gate_raises(monkeypatch):
    """A resident result that differs from its plain version stops the bench."""
    monkeypatch.setattr(bench, "spmv_multi_apply", lambda op, v, m, scale: v.clone())
    with pytest.raises(RuntimeError, match="differs from its plain version"):
        bench.bench_spmv_resident(torch.device("cpu"), 2, 64, 2)


@pytest.mark.parametrize("kernel", ["spmv", "lanczos_resident_steps"])
def test_bench_gates_each_timed_kernel(monkeypatch, kernel):
    """The SpMV loop and the resident Lanczos kernel are gated as the
    multi-apply SpMV is: a result off by one ulp stops the bench."""
    real = getattr(bench, kernel)

    def off_by_one_ulp(*args):
        out = real(*args)
        first = out[0] if isinstance(out, tuple) else out
        first.view(torch.int32)[..., 0] += 1
        return out

    monkeypatch.setattr(bench, kernel, off_by_one_ulp)
    run = bench.bench_spmv if kernel == "spmv" else bench.bench_solver_loop
    with pytest.raises(RuntimeError, match="differs from its plain version"):
        run(torch.device("cpu"), 2, 64, *((2,) if kernel == "spmv" else ((2, 4), (2, 4))))


@pytest.mark.skipif(not (shutil.which("g++") or shutil.which("c++")), reason="no C++ compiler")
def test_native_matches_plain_and_reuses_its_build(monkeypatch):
    """The host C++ SpMV (built through _build.build_shared) against the
    port's plain SpMV and the numpy fallback; a second build is a reuse."""
    from tensorkrylov_tpu_torch import native
    from tensorkrylov_tpu_torch.ops.banded import spmv_reference

    op = tkt.conv_diff(3, 50, device="cpu")
    v = np.random.default_rng(3).standard_normal((3, 50))
    ref = spmv_reference(op, torch.tensor(v)).numpy()
    assert native.runtime() == "native", native.build_info
    np.testing.assert_allclose(native.banded_spmv(op.bands.numpy(), op.offsets, v), ref, rtol=1e-12, atol=1e-12)
    path, log = _build.build_shared("tkcore", [native.SOURCE], native.CXX_FLAGS, native.BUILD_DIR, None)
    assert str(path) == native.build_info["path"] and log == "(reused)"
    monkeypatch.setattr(native, "_load", lambda: None)
    np.testing.assert_allclose(native.banded_spmv(op.bands.numpy(), op.offsets, v), ref, rtol=1e-12, atol=1e-12)


def test_bench_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])


@pytest.mark.parametrize("symmetric", [True, False], ids=["laplace", "convdiff"])
def test_reproduction_matches_jax(tmp_path, symmetric):
    """run_reproduction at dims (3,), n=30: same status and steps, traces to
    1e-10, ranks equal, and the JSON file written where out_dir says."""
    ref = jax_reproduction((3,), 30, symmetric=symmetric, verbose=False)[3]
    res = run_reproduction((3,), 30, symmetric=symmetric, out_dir=str(tmp_path), verbose=False, device="cpu")[3]
    assert (res["status"], res["niterations"]) == (ref["status"], ref["niterations"]) == (1, 30)
    np.testing.assert_allclose(res["relative_residual"], ref["relative_residual"], rtol=TRACE_RTOL)
    assert res["expsum_rank"] == ref["expsum_rank"]
    tag = "laplace" if symmetric else "convdiff"
    saved = json.loads((tmp_path / f"reproduction_{tag}_n30.json").read_text())
    assert saved["3"]["niterations"] == 30 and saved["3"]["final_relative_residual"] < 1e-9


def test_reproduction_writes_nothing_by_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = run_reproduction((2,), 12, verbose=False, device="cpu")
    assert res[2]["status"] == 1 and not list(tmp_path.iterdir())


def test_reproduction_default_device_is_the_card(monkeypatch):
    """Without device, the sweep runs on the CUDA device; without a card it
    raises and names device="cpu" instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_reproduction(dims=(2,), n=8, verbose=False)
