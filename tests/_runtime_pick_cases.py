"""Candidate-set cases of a runtime round's pick, shared by the CPU parity
tests (``test_torch_runtime_pick.py``), the card tests
(``test_torch_cuda.py``) and ``chip_smoke.py``.  numpy only: no JAX, no
torch.  Each case plants something that routes a pick elsewhere.
"""
import numpy as np

SHARED = np.array([0.9, 0.1])
# (kernel_min_n, ws_min_scores) for the card checks: the card's defaults
# (every set prefiltered, float32 unless tied), the host's (no prefilter,
# float64), and a mix (prefilter from 64 rows, float32 from 100 scores).
PICK_THRESHOLDS = [(0, 0), (1 << 30, 1 << 60), (64, 100)]


def _mixed(seed=0, sizes=(5, 17, 66, 130, 257)):
    rng = np.random.default_rng(seed)
    return [rng.random((n, 2)) * 10 for n in sizes]


def _groups(R):
    rows = np.array([[0.9, 0.1], [0.5, 0.5], [0.2, 0.8]])
    return rows[np.arange(R) % 3]


def _raw_tie():
    """A set whose first column holds two values 1e-12 apart: equal in
    float32, so the reference's mask of it takes the float64 route."""
    Fs = _mixed(seed=1)
    Fs[2][3, 0] = Fs[2][7, 0] + 1e-12
    Fs[2][3, 1] = Fs[2][7, 1] - 1.0       # both rows on the front
    return Fs


def _bank_tie():
    """Two sets of one group with the same range whose kept rows normalise
    1e-12 apart: a float32 tie across the group's bank (its float64
    route), though neither set holds one alone."""
    rng = np.random.default_rng(2)
    base = np.array([[0.0, 10.0], [10.0, 0.0]])
    a = np.concatenate([base, [[5.0, 5.0]], 5 + rng.random((20, 2)) * 5])
    b = np.concatenate([base, [[5.0 + 1e-11, 5.0 - 1e-11]],
                        5 + rng.random((30, 2)) * 5])
    return [a, b, rng.random((12, 2)) * 10]


def _constant():
    Fs = _mixed(seed=3)
    Fs[1][:, 1] = 2.5                    # hi == lo: span 1
    Fs[3][:, 0] = -4.0
    return Fs


def _keeps_nothing():
    """Every row of a set has a non-finite entry: its mask keeps nothing,
    so every row is scored."""
    Fs = _mixed(seed=4)
    Fs[1][:, 1] = np.nan
    Fs[2][::2, 0] = np.inf
    Fs[2][1::2, 1] = np.inf
    return Fs


def _zero_weight():
    """Under weight (1, 0) a dominated row ties its dominator: the first
    row (1, 5) wins unprefiltered, its dominator (1, 3) once the mask drops
    it."""
    rng = np.random.default_rng(5)
    F = np.concatenate([[[1.0, 5.0], [1.0, 3.0], [2.0, 1.0], [3.0, 0.5]],
                        2 + rng.random((40, 2)) * 8])
    return [F] + _mixed(seed=5, sizes=(9, 70))


def _nonfinite():
    """NaN, +inf and -inf rows among finite ones (a -inf minimum makes
    every normalised value of its column NaN)."""
    Fs = _mixed(seed=6)
    Fs[0][2] = np.nan
    Fs[1][[3, 9], 0] = np.inf
    Fs[2][5, 1] = -np.inf
    Fs[4][[0, 100], 1] = np.nan
    Fs[4][50] = np.inf
    return Fs


def _late_dominators():
    """Sets whose kernel scans race if rows are counted before every scan
    ends.  The kernel gives a set of 85 rows three threads a row, the
    threads of row i being 3i to 3i + 2, and thread t counts row t.  Rows
    0-2 dominate rows 3-63, so threads 64-84 (rows 21-28) stop at their
    first test; rows 64-83 lie on a front that only row 84 dominates, so
    the threads that clear them (192-249) test every row first.  Each set
    keeps rows 0, 1, 2 and 84."""
    Fs = []
    for shift in (0.0, 0.3, 0.7, 1.1):
        top = np.array([[1.0, 5.0], [1.05, 4.95], [0.95, 5.05]])
        i = np.arange(3, 64)
        quick = np.stack([1.2 + 0.01 * i, 6.0 - 0.01 * i], -1)
        t = np.arange(20)
        front = np.stack([0.1 + 0.03 * t, 9.0 - 0.1 * t], -1)
        F = np.concatenate([top, quick, front, [[0.05, 5.9]]])
        Fs.append(F + shift)
    return Fs


CASES = {"mixed": _mixed, "raw_tie": _raw_tie, "bank_tie": _bank_tie,
         "constant": _constant, "keeps_nothing": _keeps_nothing,
         "zero_weight": _zero_weight, "nonfinite": _nonfinite,
         "late_dominators": _late_dominators}


def case_weights(case, per_set, R):
    """The shared weight row, or per-set rows in three groups."""
    if case == "zero_weight":
        return np.array([[1.0, 0.0]] * R) if per_set else np.array([1.0, 0.0])
    return _groups(R) if per_set else SHARED


def budget_round(k, seed=40):
    """A round past the kernel's shared-memory budget for one set (40 KB:
    about 2,400 rows at k = 2, 620 at k = 8): two long sets near one
    trade-off surface (most rows survive), a short one and a set of
    non-finite rows, in two weight groups."""
    rng = np.random.default_rng(seed)
    n = 3000 if k == 2 else 700
    Fs = []
    for m in (n, n + 17):
        F = rng.dirichlet(np.ones(k), m) * 10 + rng.random((m, k)) * 1e-3
        F[rng.random(m) < 0.03] = np.inf
        Fs.append(F)
    Fs.append(rng.random((50, k)))
    Fs.append(np.full((40, k), np.nan))
    w = rng.dirichlet(np.ones(k), 2)[[0, 1, 0, 1]]
    return Fs, w
