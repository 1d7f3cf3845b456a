// C / Fortran-callable API over primme_tpu_torch, the PyTorch/CUDA port.
//
// The reference is a C library first (dprimme / dprimme_svds,
// include/primme_eigs.h:382-477; F77 shim src/eigs/primme_f77.c).
// This shim gives native codes the same capability over the port: it
// embeds CPython once per process and forwards into
// primme_tpu_torch.capi_support, which runs the solver on the card (or on
// the CPU when PTPU_PLATFORM=cpu). It is the JAX package's native/capi.cpp
// with the module it imports changed: the exported ptpu_* symbols and
// their signatures are the same, so one C program links against either
// library (never both in one process). Two operator modes, mirroring the
// reference's test-driver CSR path (tests/COMMON/csr.c) and its
// user-matvec contract (primme_params.matrixMatvec,
// include/primme_eigs.h:170):
//
//   ptpu_eigsh_csr     — CSR matrix by pointer, eigenpairs out
//   ptpu_eigsh_matvec  — user matvec callback (column-major blocks)
//   ptpu_svds_csr      — singular triplets of a rectangular CSR
//
// F77 bindings (trailing-underscore, all-pointer args, integer target
// codes — the primme_target order) are provided for each. Every call
// returns 0 on success; on failure ptpu_last_error() has the message.
//
// Build: primme_tpu_torch.native.capi_library() (g++ -shared -fPIC against
//        the running interpreter's Python.h and libpython, into
//        primme_tpu_torch/_build/libprimme_tpu_torch_capi-<hash>.so).
// Link:  -L<that dir> -l:<that file> -Wl,-rpath,<that dir>; run with
//        PYTHONPATH=<repo>:<site-packages> (the embedded interpreter does
//        not see a virtualenv's packages otherwise).

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

namespace {

PyObject *g_mod = nullptr;         // primme_tpu_torch.capi_support
std::string g_err;                 // last error from this layer
std::once_flag g_init_once;        // first-call interpreter init guard

// Append str(obj) to out, tolerating non-UTF8 / NULL results
// (PyUnicode_AsUTF8 can return NULL; never feed that to std::string).
void append_pystr(std::string *out, PyObject *obj) {
  if (!obj) return;
  PyObject *s = PyObject_Str(obj);
  if (s) {
    const char *c = PyUnicode_AsUTF8(s);
    if (c) {
      *out += ": ";
      *out += c;
    }
    Py_DECREF(s);
  }
  PyErr_Clear();
}

// Format the pending Python exception into g_err (never prints, never
// re-raises SystemExit the way PyErr_Print would).
void fetch_pyerr(const char *prefix) {
  PyObject *et, *ev, *tb;
  PyErr_Fetch(&et, &ev, &tb);
  g_err = prefix;
  append_pystr(&g_err, ev);
  Py_XDECREF(et);
  Py_XDECREF(ev);
  Py_XDECREF(tb);
}

// Initialize the interpreter once (thread-safe: concurrent first calls
// from native threads, e.g. OpenMP codes, race on Py_IsInitialized
// without the once_flag); afterwards every entry point takes/releases
// the GIL around its single Python call.
int ensure_init() {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      PyEval_SaveThread();  // release the GIL the init left held
    }
    PyGILState_STATE g = PyGILState_Ensure();
    g_mod = PyImport_ImportModule("primme_tpu_torch.capi_support");
    if (g_mod == nullptr)
      fetch_pyerr("import primme_tpu_torch.capi_support failed");
    PyGILState_Release(g);
  });
  return g_mod ? 0 : -100;
}

// Call capi_support.<name>(*args) -> int return code; on Python-level
// failure fetch capi_support.last_error() into g_err.
int call_int(const char *name, PyObject *args) {
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *fn = PyObject_GetAttrString(g_mod, name);
  PyObject *r = fn ? PyObject_CallObject(fn, args) : nullptr;
  Py_XDECREF(fn);
  Py_DECREF(args);
  int rc = -101;
  if (r && PyLong_Check(r)) rc = static_cast<int>(PyLong_AsLong(r));
  if (!r) {
    fetch_pyerr("python call raised");
  } else if (!PyLong_Check(r)) {
    // a non-integer return must not surface a STALE cached message
    g_err = std::string("unexpected non-integer return from ") + name;
  } else if (rc != 0) {
    PyObject *le = PyObject_CallMethod(g_mod, "last_error", nullptr);
    if (le) {
      const char *c = PyUnicode_AsUTF8(le);
      g_err = c ? c : "(unrepresentable error)";
      Py_DECREF(le);
    }
    PyErr_Clear();
  }
  Py_XDECREF(r);
  PyGILState_Release(g);
  return rc;
}

inline long long addr(const void *p) {
  return static_cast<long long>(reinterpret_cast<intptr_t>(p));
}

}  // namespace

extern "C" {

typedef void (*ptpu_matvec_f)(const double *x, double *y, int block_size,
                              void *ctx);

const char *ptpu_last_error(void) { return g_err.c_str(); }

// --- eigsh, CSR operator -------------------------------------------------
int ptpu_eigsh_csr(long long n, long long nnz, const long long *indptr,
                   const long long *indices, const double *data, int k,
                   const char *which, double tol, const char *method,
                   double sigma, double *evals, double *evecs,
                   double *resnorms) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue(
      "(LLLLLisdsdLLL)", n, nnz, addr(indptr), addr(indices), addr(data), k,
      which ? which : "SA", tol, method ? method : "", sigma, addr(evals),
      addr(evecs), addr(resnorms));
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("eigsh_csr", args);
}

// --- eigsh, user matvec callback ------------------------------------------
int ptpu_eigsh_matvec(long long n, ptpu_matvec_f matvec, void *ctx, int k,
                      const char *which, double tol, const char *method,
                      double sigma, long long max_matvecs, double *evals,
                      double *evecs, double *resnorms) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue(
      "(LLLisdsdLLLL)", n, addr(reinterpret_cast<void *>(matvec)), addr(ctx),
      k, which ? which : "SA", tol, method ? method : "", sigma, max_matvecs,
      addr(evals), addr(evecs), addr(resnorms));
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("eigsh_matvec", args);
}

// --- svds, CSR operator ----------------------------------------------------
int ptpu_svds_csr(long long m, long long n, long long nnz,
                  const long long *indptr, const long long *indices,
                  const double *data, int k, const char *which, double tol,
                  double *svals, double *u, double *v) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue(
      "(LLLLLLisdLLL)", m, n, nnz, addr(indptr), addr(indices), addr(data), k,
      which ? which : "LM", tol, addr(svals), addr(u), addr(v));
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("svds_csr", args);
}

// --- Parameter-object surface ----------------------------------------------
// The C-ABI analogue of primme_params_create / primme_set_method /
// primme_set_member / primme_free (include/primme_eigs.h:461-477) plus a
// generic parameterized run (the dprimme(evals, evecs, resnorms, params)
// call shape). The handle's configuration is replayed against the true
// problem size at run time, preserving the reference's ordering
// semantics (a member set after set_method overrides the preset).

long long ptpu_params_create(void) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod(g_mod, "params_create", nullptr);
  long long h = -101;
  if (r && PyLong_Check(r)) h = PyLong_AsLongLong(r);
  if (!r) fetch_pyerr("params_create raised");
  Py_XDECREF(r);
  PyGILState_Release(g);
  return h;
}

int ptpu_params_free(long long h) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(L)", h);
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("params_free", args);
}

// Set a member by reference label ("numEvals", "maxBlockSize",
// "correction.maxInnerIterations", "targetShifts" = "0.5 1.5", ...).
// Values are strings; numeric/enum coercion happens per member type.
int ptpu_params_set(long long h, const char *label, const char *value) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(Lss)", h, label ? label : "",
                                 value ? value : "");
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("params_set", args);
}

// Apply a method preset by name ("PRIMME_JDQMR", "GD_Olsen_plusK", ...).
int ptpu_params_set_method(long long h, const char *method) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(Ls)", h, method ? method : "");
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("params_set_method", args);
}

// Read a numeric member (enums come back as their reference constant).
int ptpu_params_get(long long h, const char *label, double *out) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(LsL)", h, label ? label : "", addr(out));
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("params_get", args);
}

int ptpu_params_display(long long h) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(L)", h);
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("params_display", args);
}

// Generic parameterized solve over a CSR matrix: evals/resnorms
// [numEvals], evecs [n*numEvals] column-major.
int ptpu_eigsh_run(long long h, long long n, long long nnz,
                   const long long *indptr, const long long *indices,
                   const double *data, double *evals, double *evecs,
                   double *resnorms) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args =
      Py_BuildValue("(LLLLLLLLL)", h, n, nnz, addr(indptr), addr(indices),
                    addr(data), addr(evals), addr(evecs), addr(resnorms));
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("eigsh_run", args);
}

// --- svds parameter-object surface -----------------------------------------
// The primme_svds_params_create / primme_svds_set_method /
// primme_svds_set_member analogue (include/primme_svds.h), over the
// svds reflection layer including the embedded primme.* /
// primmeStage2.* stage labels.

long long ptpu_svds_params_create(void) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod(g_mod, "svds_params_create", nullptr);
  long long h = -101;
  if (r && PyLong_Check(r)) h = PyLong_AsLongLong(r);
  if (!r) fetch_pyerr("svds_params_create raised");
  Py_XDECREF(r);
  PyGILState_Release(g);
  return h;
}

int ptpu_svds_params_free(long long h) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(L)", h);
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("svds_params_free", args);
}

int ptpu_svds_params_set(long long h, const char *label, const char *value) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(Lss)", h, label ? label : "",
                                 value ? value : "");
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("svds_params_set", args);
}

// primme_svds_set_method(method, methodStage1, methodStage2) analogue;
// empty strings keep per-method defaults.
int ptpu_svds_params_set_method(long long h, const char *method,
                                const char *m1, const char *m2) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(Lsss)", h, method ? method : "",
                                 m1 ? m1 : "", m2 ? m2 : "");
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("svds_params_set_method", args);
}

int ptpu_svds_params_get(long long h, const char *label, double *out) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(LsL)", h, label ? label : "", addr(out));
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("svds_params_get", args);
}

// Parameterized svds run (the dprimme_svds(svals, svecs, resNorms,
// params) call shape): svals/resnorms [numSvals], U [m*k], V [n*k]
// column-major.
int ptpu_svds_run(long long h, long long m, long long n, long long nnz,
                  const long long *indptr, const long long *indices,
                  const double *data, double *svals, double *u, double *v,
                  double *resnorms) {
  if (ensure_init()) return -100;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *args = Py_BuildValue(
      "(LLLLLLLLLLL)", h, m, n, nnz, addr(indptr), addr(indices), addr(data),
      addr(svals), addr(u), addr(v), addr(resnorms));
  PyGILState_Release(g);
  if (!args) return -102;
  return call_int("svds_run", args);
}

// --- F77 bindings ----------------------------------------------------------
// All-pointer arguments; `target` uses the primme_target integer order
// (0 smallest, 1 largest, 2 closest_geq, 3 closest_leq, 4 closest_abs,
// 5 largest_abs — include/primme_eigs.h:47-54), like the reference's
// label-based F77 surface (include/primme_eigs_f77.h). No hidden
// string-length arguments.

void ptpu_eigsh_csr_(const long long *n, const long long *nnz,
                     const long long *indptr, const long long *indices,
                     const double *data, const int *k, const int *target,
                     const double *tol, const double *sigma, double *evals,
                     double *evecs, double *resnorms, int *ierr) {
  // primme_target enum order: geq/leq sit at codes 2-3, abs targets at 4-5
  static const char *codes[] = {"SA", "LA", "CGT", "CLT", "SM", "LM"};
  const char *w = (*target >= 0 && *target <= 5) ? codes[*target] : "SA";
  *ierr = ptpu_eigsh_csr(*n, *nnz, indptr, indices, data, *k, w, *tol, "",
                         *sigma, evals, evecs, resnorms);
}

void ptpu_eigsh_matvec_(const long long *n, ptpu_matvec_f matvec, void *ctx,
                        const int *k, const int *target, const double *tol,
                        const double *sigma, const long long *max_matvecs,
                        double *evals, double *evecs, double *resnorms,
                        int *ierr) {
  // primme_target enum order: geq/leq sit at codes 2-3, abs targets at 4-5
  static const char *codes[] = {"SA", "LA", "CGT", "CLT", "SM", "LM"};
  const char *w = (*target >= 0 && *target <= 5) ? codes[*target] : "SA";
  *ierr = ptpu_eigsh_matvec(*n, matvec, ctx, *k, w, *tol, "", *sigma,
                            *max_matvecs, evals, evecs, resnorms);
}

void ptpu_svds_csr_(const long long *m, const long long *n,
                    const long long *nnz, const long long *indptr,
                    const long long *indices, const double *data,
                    const int *k, const int *largest, const double *tol,
                    double *svals, double *u, double *v, int *ierr) {
  *ierr = ptpu_svds_csr(*m, *n, *nnz, indptr, indices, data, *k,
                        *largest ? "LM" : "SM", *tol, svals, u, v);
}

// F77 parameter surface. CHARACTER arguments arrive per the gfortran
// convention: the data pointer in place, hidden length arguments
// (size_t) appended after the declared argument list in order; values
// are right-trimmed of blanks (Fortran pads CHARACTER with spaces).
static std::string f_str(const char *s, size_t len) {
  while (len > 0 && (s[len - 1] == ' ' || s[len - 1] == '\0')) --len;
  return std::string(s, len);
}

void ptpu_params_create_(long long *h) { *h = ptpu_params_create(); }

void ptpu_params_free_(const long long *h, int *ierr) {
  *ierr = ptpu_params_free(*h);
}

void ptpu_params_set_(const long long *h, const char *label,
                      const char *value, int *ierr, size_t llab,
                      size_t lval) {
  *ierr = ptpu_params_set(*h, f_str(label, llab).c_str(),
                          f_str(value, lval).c_str());
}

void ptpu_params_set_method_(const long long *h, const char *method,
                             int *ierr, size_t lmeth) {
  *ierr = ptpu_params_set_method(*h, f_str(method, lmeth).c_str());
}

void ptpu_params_get_(const long long *h, const char *label, double *out,
                      int *ierr, size_t llab) {
  *ierr = ptpu_params_get(*h, f_str(label, llab).c_str(), out);
}

void ptpu_eigsh_run_(const long long *h, const long long *n,
                     const long long *nnz, const long long *indptr,
                     const long long *indices, const double *data,
                     double *evals, double *evecs, double *resnorms,
                     int *ierr) {
  *ierr = ptpu_eigsh_run(*h, *n, *nnz, indptr, indices, data, evals, evecs,
                         resnorms);
}

void ptpu_svds_params_create_(long long *h) { *h = ptpu_svds_params_create(); }

void ptpu_svds_params_free_(const long long *h, int *ierr) {
  *ierr = ptpu_svds_params_free(*h);
}

void ptpu_svds_params_set_(const long long *h, const char *label,
                           const char *value, int *ierr, size_t llab,
                           size_t lval) {
  *ierr = ptpu_svds_params_set(*h, f_str(label, llab).c_str(),
                               f_str(value, lval).c_str());
}

void ptpu_svds_params_set_method_(const long long *h, const char *method,
                                  const char *m1, const char *m2, int *ierr,
                                  size_t lm, size_t l1, size_t l2) {
  *ierr = ptpu_svds_params_set_method(*h, f_str(method, lm).c_str(),
                                      f_str(m1, l1).c_str(),
                                      f_str(m2, l2).c_str());
}

void ptpu_svds_params_get_(const long long *h, const char *label,
                           double *out, int *ierr, size_t llab) {
  *ierr = ptpu_svds_params_get(*h, f_str(label, llab).c_str(), out);
}

void ptpu_svds_run_(const long long *h, const long long *m,
                    const long long *n, const long long *nnz,
                    const long long *indptr, const long long *indices,
                    const double *data, double *svals, double *u, double *v,
                    double *resnorms, int *ierr) {
  *ierr = ptpu_svds_run(*h, *m, *n, *nnz, indptr, indices, data, svals, u, v,
                        resnorms);
}

}  // extern "C"
