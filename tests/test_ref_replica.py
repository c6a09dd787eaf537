"""Eigenvalue adjudication: neutfem_jax vs the independent scipy transcription of the
reference discrete operator (tests/ref_replica.py).

Round-1 VERDICT Missing #1: the reference README claims -0.3 pcm on IAEA-2D at
4x4/assembly (README.md:289) while the rebuild measures -19.5 pcm.  The replica —
a from-the-C++ transcription sharing nothing with neutfem_jax or tests/oracle.py —
settles it: the true discrete eigenvalue of the reference operator at 4x4 is
k = 1.0293786 (-19.48 pcm vs the 1.029585 literature value), matching neutfem_jax
to < 0.001 pcm.  Even at the reference's own loose driver tolerances
(set_tol(1e-5, 1e-4, ...), iaea2d.py:346) the replica gives -20.3 pcm, so the
README's -0.3 pcm is NOT reproducible from the published math: -19.5 pcm is
RT0-P0 discretization error at the 5 cm mesh (it converges -56.5 -> -19.5 ->
... -> +0.1 pcm at 988k cells, consistent with O(h^2)).
"""

import numpy as np
import pytest

from benchmarks.data import BENCHMARKS
from benchmarks.runner import BenchmarkRun

from ref_replica import replica_from_benchmark, solve_keff

KREF = 1.029585  # IAEA-2D literature k-eff (iaea2d.py:39)

# Discrete eigenvalues of the reference operator, computed by the replica converged
# to tol_keff=1e-9 (see module docstring).  Pinned so regressions in EITHER code
# show up as a specific side's failure.
REPLICA_K = {1: 1.02863518, 2: 1.02898627, 4: 1.02937858}


def _pcm(k1, k2):
    return 1e5 * (1.0 / k1 - 1.0 / k2)


@pytest.mark.parametrize("mesh_n", [1, 2, 4])
def test_iaea2d_matches_reference_replica(mesh_n):
    run = BenchmarkRun(BENCHMARKS["iaea2d"], mesh_n=mesh_n)
    prob = replica_from_benchmark(run)
    k_rep, _, outers = solve_keff(prob, tol_keff=1e-9, tol_flux=1e-8, cg_tol=1e-11)
    assert outers < 2000
    # replica reproduces its pinned value (guards the replica itself)
    assert abs(_pcm(k_rep, REPLICA_K[mesh_n])) < 0.01

    run.solve(tol=(1e-9, 1e-8, 1e-8, 3000, 3000))
    # neutfem_jax agrees with the independent transcription of the reference math
    assert abs(_pcm(k_rep, run.keff)) < 0.1  # measured: < 0.001 pcm


def test_reference_readme_claim_not_reproducible():
    """At the reference's own driver tolerances the 4x4 eigenvalue is ~-20 pcm, not
    the -0.3 pcm of README.md:289 — documents that BASELINE.md's accuracy rows are
    discretization-limited, not solver-limited."""
    run = BenchmarkRun(BENCHMARKS["iaea2d"], mesh_n=2)
    prob = replica_from_benchmark(run)
    k_loose, _, _ = solve_keff(prob, tol_keff=1e-5, tol_flux=1e-4, cg_tol=1e-10)
    # 2x2: tight -56.5 pcm; loose differs by ~1 pcm of iteration error — far from
    # the sub-pcm agreement the README table implies at these meshes.
    assert abs(_pcm(KREF, k_loose)) > 30.0


def test_replica_1d_analytic_slab():
    """Replica sanity vs the analytic bare-slab eigenvalue: one-group slab with the
    reference's Marshak term (2*D*G_ff, i.e. Robin phi + 2D^2 dphi/dn = 0 — the
    bug-compat D factor makes the extrapolation distance d = 2D^2, not 2D).
    Exact buckling from the transcendental condition B*d = cot(B a/2)."""
    from scipy.optimize import brentq

    from ref_replica import assemble

    D, SigR, NSF = 1.2, 0.03, 0.032
    a = 200.0
    nx = 400
    xb = np.linspace(0, a, nx + 1)
    prob = assemble(
        0, 0, 1, xb, None, None,
        D=np.full((1, nx), D), SigR=np.full((1, nx), SigR),
        NSF=np.full((1, nx), NSF), Chi=np.ones((1, nx)),
        SigS=np.zeros((1, 1, nx)),
        dirichlet={(0, False): True, (0, True): True},
    )
    k, _, _ = solve_keff(prob, tol_keff=1e-10, tol_flux=1e-9)
    d = 2.0 * D * D
    B = brentq(lambda b: b * d - 1.0 / np.tan(b * a / 2.0), 1e-6, np.pi / a - 1e-9)
    k_analytic = (NSF / SigR) / (1.0 + (D / SigR) * B * B)
    assert abs(k - k_analytic) < 5e-5
