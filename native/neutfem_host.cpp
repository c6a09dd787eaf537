// Host-side runtime kernels for neutfem_jax (C ABI, loaded via ctypes).
//
// The device owns the compute path (JAX/XLA); these are the host-side pieces that
// the reference implements in C++ (assembly precomputation, IO) rebuilt for the
// grid-based design:
//   * batched LDL^T factorization of the per-(group,direction) face-tridiagonal
//     A blocks (ops/context.py builds these once per BuildMatrices; the inner
//     sequential recurrence is the only O(n)-serial host loop in the framework),
//   * volume-weighted block coarsening of XS grids (coarse.py),
//   * buffered ASCII legacy-VTK export (NeutFEM.cpp:2137-2332 equivalent).
//
// Build: native/build.sh -> neutfem_jax/_libneutfem_host.so ; python falls back
// to numpy implementations when the library is absent.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Batched symmetric-tridiagonal LDL^T.
//   diag : [batch, n]   main diagonal (overwritten with 1/pivots)
//   off  : [batch, n-1] sub-diagonal  (overwritten with multipliers l_i)
// Recurrence: d_0 = a_0; l_i = b_i / d_i; d_{i+1} = a_{i+1} - b_i * l_i.
// ---------------------------------------------------------------------------
void nf_tridiag_ldlt_batch(double* diag, double* off, int64_t batch, int64_t n) {
  for (int64_t b = 0; b < batch; ++b) {
    double* d = diag + b * n;
    double* l = off + b * (n - 1);
    double dp = d[0];
    for (int64_t i = 0; i + 1 < n; ++i) {
      const double li = l[i] / dp;
      const double dn = d[i + 1] - l[i] * li;
      l[i] = li;
      d[i] = 1.0 / dp;
      dp = dn;
    }
    d[n - 1] = 1.0 / dp;
  }
}

// ---------------------------------------------------------------------------
// Volume-weighted block mean over a (lead, nz, ny, nx) array.
//   a   : [lead, nz, ny, nx]
//   w   : [nz, ny, nx] weights (volumes)
//   out : [lead, nz/rz, ny/ry, nx/rx]
// ---------------------------------------------------------------------------
void nf_block_mean(const double* a, const double* w, double* out, int64_t lead,
                   int64_t nz, int64_t ny, int64_t nx, int64_t rz, int64_t ry,
                   int64_t rx) {
  const int64_t czn = nz / rz, cyn = ny / ry, cxn = nx / rx;
  std::vector<double> wsum(czn * cyn * cxn, 0.0);
  for (int64_t z = 0; z < nz; ++z)
    for (int64_t y = 0; y < ny; ++y)
      for (int64_t x = 0; x < nx; ++x)
        wsum[((z / rz) * cyn + (y / ry)) * cxn + (x / rx)] +=
            w[(z * ny + y) * nx + x];
  for (int64_t L = 0; L < lead; ++L) {
    const double* al = a + L * nz * ny * nx;
    double* ol = out + L * czn * cyn * cxn;
    std::memset(ol, 0, sizeof(double) * czn * cyn * cxn);
    for (int64_t z = 0; z < nz; ++z)
      for (int64_t y = 0; y < ny; ++y)
        for (int64_t x = 0; x < nx; ++x) {
          const int64_t c = ((z / rz) * cyn + (y / ry)) * cxn + (x / rx);
          ol[c] += al[(z * ny + y) * nx + x] * w[(z * ny + y) * nx + x];
        }
    for (int64_t c = 0; c < czn * cyn * cxn; ++c) ol[c] /= wsum[c];
  }
}

// ---------------------------------------------------------------------------
// Buffered ASCII legacy-VTK writer (STRUCTURED_GRID).
// points   : xb [nx+1], yb [ny_p], zb [nz_p]
// scalars  : n_scalars fields of [n_cells] doubles, names packed \0-separated
// vectors  : n_vectors fields of [n_cells*3] doubles, names packed \0-separated
// Returns 0 on success, nonzero on IO failure.
// ---------------------------------------------------------------------------
int nf_write_vtk(const char* path, const char* title, const double* xb,
                 int64_t nxp, const double* yb, int64_t nyp, const double* zb,
                 int64_t nzp, int64_t n_cells, const char* scalar_names,
                 const double* scalars, int64_t n_scalars,
                 const char* vector_names, const double* vectors,
                 int64_t n_vectors) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  std::string buf;
  buf.reserve(1 << 22);
  char line[256];

  buf += "# vtk DataFile Version 3.0\n";
  buf += title;
  buf += "\nASCII\nDATASET STRUCTURED_GRID\n";
  std::snprintf(line, sizeof line, "DIMENSIONS %lld %lld %lld\n",
                (long long)nxp, (long long)nyp, (long long)nzp);
  buf += line;
  std::snprintf(line, sizeof line, "POINTS %lld double\n",
                (long long)(nxp * nyp * nzp));
  buf += line;
  for (int64_t z = 0; z < nzp; ++z)
    for (int64_t y = 0; y < nyp; ++y)
      for (int64_t x = 0; x < nxp; ++x) {
        std::snprintf(line, sizeof line, "%.10g %.10g %.10g\n", xb[x], yb[y],
                      zb[z]);
        buf += line;
      }
  std::snprintf(line, sizeof line, "\nCELL_DATA %lld\n", (long long)n_cells);
  buf += line;

  const char* name = scalar_names;
  for (int64_t s = 0; s < n_scalars; ++s) {
    std::snprintf(line, sizeof line, "SCALARS %s double 1\nLOOKUP_TABLE default\n",
                  name);
    buf += line;
    const double* v = scalars + s * n_cells;
    for (int64_t c = 0; c < n_cells; ++c) {
      std::snprintf(line, sizeof line, "%.10g\n", v[c]);
      buf += line;
    }
    name += std::strlen(name) + 1;
  }
  name = vector_names;
  for (int64_t s = 0; s < n_vectors; ++s) {
    std::snprintf(line, sizeof line, "VECTORS %s double\n", name);
    buf += line;
    const double* v = vectors + s * n_cells * 3;
    for (int64_t c = 0; c < n_cells; ++c) {
      std::snprintf(line, sizeof line, "%.10g %.10g %.10g\n", v[3 * c],
                    v[3 * c + 1], v[3 * c + 2]);
      buf += line;
    }
    name += std::strlen(name) + 1;
  }
  const size_t written = std::fwrite(buf.data(), 1, buf.size(), f);
  const int rc = (written == buf.size()) ? 0 : 2;
  return std::fclose(f) == 0 ? rc : 3;
}

}  // extern "C"
