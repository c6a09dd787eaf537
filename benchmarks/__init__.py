"""Literature benchmark suite for the NeutFEM rebuild.

Five classic PWR multigroup diffusion benchmarks (IAEA-2D/3D, BIBLIS-2D,
KOEBERG-2D 4-group, ZION-2D with baffle), implemented as one data-driven runner
over the reference-compatible `neutfem` API.  Run e.g.:

    python -m benchmarks.iaea2d --mesh 4x4 --adjoint
"""

from .data import BENCHMARKS, IAEA2D_POWER_MAP  # noqa: F401
from .runner import BenchmarkRun, run_benchmark  # noqa: F401
