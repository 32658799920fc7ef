"""Plot recipes for convergence traces and spectra: counterpart of
``tensorkrylov_tpu/experiments/plotting.py``. Each function takes
SolveResults or the JSON trace dicts the experiment modules write, and saves
a PNG with matplotlib's headless Agg backend."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..convergence import trim
from ..types import SolveResult

__all__ = ["plot_convergence", "plot_orthogonality", "plot_spectrum_hist"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _trace_of(obj):
    if isinstance(obj, SolveResult):
        t = trim(obj)
        return t["iterations"], t["relative_residual"]
    rr = np.asarray(obj["relative_residual"])
    return np.arange(1, len(rr) + 1), rr


def _save(plt, fig, path):
    fig.tight_layout()
    fig.savefig(path, dpi=140)
    plt.close(fig)
    return path


def plot_convergence(traces: Dict, path: str, title: str = "Relative residual", ylabel: str = r"$\|r\|/\|b\|$"):
    """Log-y relative-residual curves, one per labelled trace."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, obj in traces.items():
        it, rr = _trace_of(obj)
        ax.semilogy(it, rr, label=str(label), linewidth=1.2)
    ax.set_xlabel("iteration k")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    return _save(plt, fig, path)


def plot_orthogonality(results: Dict[str, SolveResult], path: str):
    """Orthogonality-loss estimate traces."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, res in results.items():
        t = trim(res)
        ax.semilogy(t["iterations"], np.maximum(t["orthogonality"], 1e-20), label=str(label))
    ax.set_xlabel("iteration k")
    ax.set_ylabel("orthogonality loss estimate")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    return _save(plt, fig, path)


def plot_spectrum_hist(spectrum: np.ndarray, path: str, bins: int = 80, title: str = "Kronecker-sum spectrum"):
    """Spectrum histogram."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.hist(np.asarray(spectrum), bins=bins)
    ax.set_xlabel(r"$\lambda$")
    ax.set_ylabel("count")
    ax.set_title(title)
    return _save(plt, fig, path)
