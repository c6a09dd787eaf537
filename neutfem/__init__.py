"""neutfem — drop-in reference-compatible API package.

Mirrors the import surface of the reference build (``import neutfem._neutfem_eigen``,
/root/reference/src/wrapper.cpp:20): benchmark drivers written for the C++/pybind11
module run unmodified against this pure-Python + JAX implementation.
"""

from ._neutfem_eigen import (  # noqa: F401
    BCType,
    BoundaryID,
    LinearSolverType,
    NeutFEM,
    VerbosityLevel,
)

__all__ = ["NeutFEM", "BCType", "BoundaryID", "LinearSolverType", "VerbosityLevel"]
