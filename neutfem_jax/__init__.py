"""neutfem_jax — GPU-resident mixed finite-element multigroup neutron diffusion framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of jujuC31/NeutFEM
(C++17/Eigen3/pybind11 reference): RT_k-P_m mixed-dual discretization of the multigroup
diffusion k-effective eigenvalue problem on structured Cartesian meshes, with matrix-free
Schur-complement solves, accelerated power iteration, adjoint and fixed-source modes,
CMFD, coarse-grid initialization, and VTK export — all running on-device inside
``jax.jit``.
"""

from . import config  # noqa: F401  — must be first (enables x64)

from .mesh import CartesianMesh  # noqa: E402
from .bc import BCKind, BCSpec  # noqa: E402
from .fespace import FESpace, make_fespace, zeros_state  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "CartesianMesh",
    "BCKind",
    "BCSpec",
    "FESpace",
    "make_fespace",
    "zeros_state",
    "config",
]
