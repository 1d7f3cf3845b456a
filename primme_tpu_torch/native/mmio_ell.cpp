// Native I/O + packing kernels for primme_tpu_torch (a copy of the JAX
// package's native/mmio_ell.cpp).
//
// Replaces the reference test harness's C MatrixMarket reader + symmetric
// expansion (tests/COMMON/mmio.c, tests/COMMON/ssrcsr.c) with a single
// fast path: parse a coordinate .mtx file, expand symmetry, sort to CSR,
// and pack to the padded ELL layout (the JAX package's ELLOperator
// layout). Exposed through a plain C ABI consumed via ctypes
// (primme_tpu_torch/native.py) — no pybind11 dependency.
//
// Build: primme_tpu_torch.native builds it at first use (g++ -shared
// -fPIC, into primme_tpu_torch/_build/libprimme_tpu_torch_native-<hash>.so).

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Coo {
  std::vector<int64_t> row, col;
  std::vector<double> re, im;
  int64_t m = 0, n = 0;
  bool complex_ = false;
  std::string error;
};

// Fast manual parsing: fgets + strtod beats iostreams by ~10x.
bool parse_mtx(const char* path, Coo* out) {
  FILE* f = std::fopen(path, "r");
  if (!f) {
    out->error = "cannot open file";
    return false;
  }
  char line[1024];
  if (!std::fgets(line, sizeof line, f)) {
    out->error = "empty file";
    std::fclose(f);
    return false;
  }
  // banner: %%MatrixMarket matrix coordinate real|complex|integer|pattern
  //         general|symmetric|hermitian|skew-symmetric
  std::string banner(line);
  for (auto& c : banner) c = std::tolower(c);
  const bool is_pattern = banner.find("pattern") != std::string::npos;
  const bool is_complex = banner.find("complex") != std::string::npos;
  const bool is_sym = banner.find("symmetric") != std::string::npos;
  const bool is_herm = banner.find("hermitian") != std::string::npos;
  const bool is_skew = banner.find("skew") != std::string::npos;
  const bool is_array = banner.find("array") != std::string::npos;
  if (is_array) {
    out->error = "dense array .mtx not supported in native path";
    std::fclose(f);
    return false;
  }

  // skip comments
  do {
    if (!std::fgets(line, sizeof line, f)) {
      out->error = "missing size line";
      std::fclose(f);
      return false;
    }
  } while (line[0] == '%');

  int64_t m, n, nnz;
  if (std::sscanf(line, "%ld %ld %ld", &m, &n, &nnz) != 3) {
    out->error = "bad size line";
    std::fclose(f);
    return false;
  }
  out->m = m;
  out->n = n;
  out->complex_ = is_complex;

  const bool expand = is_sym || is_herm || is_skew;
  out->row.reserve(expand ? 2 * nnz : nnz);
  out->col.reserve(expand ? 2 * nnz : nnz);
  out->re.reserve(expand ? 2 * nnz : nnz);
  if (is_complex) out->im.reserve(expand ? 2 * nnz : nnz);

  for (int64_t k = 0; k < nnz; ++k) {
    if (!std::fgets(line, sizeof line, f)) {
      out->error = "truncated entries";
      std::fclose(f);
      return false;
    }
    char* p = line;
    const int64_t i = std::strtol(p, &p, 10) - 1;
    const int64_t j = std::strtol(p, &p, 10) - 1;
    if (i < 0 || i >= m || j < 0 || j >= n) {
      out->error = "entry index out of declared bounds";
      std::fclose(f);
      return false;
    }
    double a = 1.0, b = 0.0;
    if (!is_pattern) {
      a = std::strtod(p, &p);
      if (is_complex) b = std::strtod(p, &p);
    }
    out->row.push_back(i);
    out->col.push_back(j);
    out->re.push_back(a);
    if (is_complex) out->im.push_back(b);
    if (expand && i != j) {
      out->row.push_back(j);
      out->col.push_back(i);
      double sa = a, sb = b;
      if (is_skew) sa = -a, sb = -b;
      if (is_herm) sb = -b;
      out->re.push_back(sa);
      if (is_complex) out->im.push_back(sb);
    }
  }
  std::fclose(f);
  return true;
}

Coo* g_last = nullptr;

}  // namespace

extern "C" {

// Parse path; returns handle id (>0) or 0 on failure. Single outstanding
// handle (the loader is sequential); metadata returned via out params.
int64_t ptn_mtx_open(const char* path, int64_t* m, int64_t* n, int64_t* nnz,
                     int32_t* is_complex) {
  delete g_last;
  g_last = new Coo();
  if (!parse_mtx(path, g_last)) {
    delete g_last;
    g_last = nullptr;
    return 0;
  }
  *m = g_last->m;
  *n = g_last->n;
  *nnz = static_cast<int64_t>(g_last->row.size());
  *is_complex = g_last->complex_ ? 1 : 0;
  return 1;
}

// Copy out COO arrays (caller allocates nnz-sized buffers).
void ptn_mtx_read(int64_t* row, int64_t* col, double* re, double* im) {
  if (!g_last) return;
  const int64_t nnz = static_cast<int64_t>(g_last->row.size());
  std::memcpy(row, g_last->row.data(), nnz * sizeof(int64_t));
  std::memcpy(col, g_last->col.data(), nnz * sizeof(int64_t));
  std::memcpy(re, g_last->re.data(), nnz * sizeof(double));
  if (im && g_last->complex_)
    std::memcpy(im, g_last->im.data(), nnz * sizeof(double));
  delete g_last;
  g_last = nullptr;
}

// Pack COO (unsorted, duplicates summed) into padded ELL.
// Returns the max row width; caller first calls with cols==nullptr to get
// the width, allocates [n_rows * width] buffers, then calls again.
int64_t ptn_coo_to_ell(int64_t n_rows, int64_t nnz, const int64_t* row,
                       const int64_t* col, const double* re, const double* im,
                       int64_t width, int32_t* out_cols, double* out_re,
                       double* out_im) {
  std::vector<int64_t> count(n_rows, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    if (row[k] < 0 || row[k] >= n_rows) return -1;
    count[row[k]]++;
  }
  int64_t w = 1;
  for (int64_t i = 0; i < n_rows; ++i) w = std::max(w, count[i]);
  if (!out_cols) return w;

  std::vector<int64_t> fill(n_rows, 0);
  std::memset(out_cols, 0, n_rows * width * sizeof(int32_t));
  std::memset(out_re, 0, n_rows * width * sizeof(double));
  if (out_im) std::memset(out_im, 0, n_rows * width * sizeof(double));
  for (int64_t k = 0; k < nnz; ++k) {
    const int64_t i = row[k];
    if (fill[i] >= width) return -1;
    const int64_t o = i * width + fill[i]++;
    out_cols[o] = static_cast<int32_t>(col[k]);
    out_re[o] = re[k];
    if (out_im && im) out_im[o] = im[k];
  }
  return w;
}

}  // extern "C"
