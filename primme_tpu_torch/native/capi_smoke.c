/* The C/Fortran ABI of primme_tpu_torch driven from C at full size: the
 * program of chip_smoke.py phase 37, linked against
 * libprimme_tpu_torch_capi (primme_tpu_torch.native.capi_library()).
 *
 *   capi_smoke DIR K TOL SVDS_K
 *
 * reads three CSR matrices that the caller wrote into DIR, each as int64
 * rows, int64 cols, int64 nnz, then int64 indptr[rows + 1], int64
 * indices[nnz] and double data[nnz]:
 *
 *   lap.bin  a symmetric matrix for ptpu_eigsh_csr, its F77 twin
 *            ptpu_eigsh_csr_ and ptpu_params_* + ptpu_eigsh_run
 *            (numEvals K, eps TOL, jacobi 1, PRIMME_DEFAULT_METHOD);
 *   mv.bin   a symmetric matrix that this program multiplies itself, on
 *            the host, as ptpu_eigsh_matvec's callback (column-major
 *            blocks, the reference's matrixMatvec contract);
 *   inc.bin  a rectangular matrix for ptpu_svds_csr and
 *            ptpu_svds_params_* + ptpu_svds_run (SVDS_K largest, eps TOL,
 *            primme_svds_hybrid);
 *
 * each eigsh call for the K smallest eigenvalues at tolerance TOL. It
 * writes what each call returns into DIR as raw doubles: out_csr.bin,
 * out_f77.bin, out_matvec.bin and out_run.bin hold evals[K],
 * resnorms[K] and evecs[n K] (column-major); out_svds.bin svals[SVDS_K],
 * U[m SVDS_K] and V[n SVDS_K]; out_svds_run.bin svals[SVDS_K],
 * resnorms[SVDS_K], U and V. It prints each call's return code and
 * seconds, and exits 1 at the first call that fails, with
 * ptpu_last_error(). Run it with PYTHONPATH holding the repository and
 * the interpreter's site-packages; the solves run on the card unless
 * PTPU_PLATFORM=cpu.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

extern const char *ptpu_last_error(void);
extern int ptpu_eigsh_csr(long long n, long long nnz, const long long *indptr,
                          const long long *indices, const double *data, int k,
                          const char *which, double tol, const char *method,
                          double sigma, double *evals, double *evecs,
                          double *resnorms);
extern void ptpu_eigsh_csr_(const long long *n, const long long *nnz,
                            const long long *indptr, const long long *indices,
                            const double *data, const int *k,
                            const int *target, const double *tol,
                            const double *sigma, double *evals, double *evecs,
                            double *resnorms, int *ierr);
typedef void (*ptpu_matvec_f)(const double *x, double *y, int block_size,
                              void *ctx);
extern int ptpu_eigsh_matvec(long long n, ptpu_matvec_f matvec, void *ctx,
                             int k, const char *which, double tol,
                             const char *method, double sigma,
                             long long max_matvecs, double *evals,
                             double *evecs, double *resnorms);
extern long long ptpu_params_create(void);
extern int ptpu_params_free(long long h);
extern int ptpu_params_set(long long h, const char *label, const char *value);
extern int ptpu_params_set_method(long long h, const char *method);
extern int ptpu_eigsh_run(long long h, long long n, long long nnz,
                          const long long *indptr, const long long *indices,
                          const double *data, double *evals, double *evecs,
                          double *resnorms);
extern int ptpu_svds_csr(long long m, long long n, long long nnz,
                         const long long *indptr, const long long *indices,
                         const double *data, int k, const char *which,
                         double tol, double *svals, double *u, double *v);
extern long long ptpu_svds_params_create(void);
extern int ptpu_svds_params_free(long long h);
extern int ptpu_svds_params_set(long long h, const char *label,
                                const char *value);
extern int ptpu_svds_params_set_method(long long h, const char *method,
                                       const char *m1, const char *m2);
extern int ptpu_svds_run(long long h, long long m, long long n, long long nnz,
                         const long long *indptr, const long long *indices,
                         const double *data, double *svals, double *u,
                         double *v, double *resnorms);

typedef struct {
  long long rows, cols, nnz;
  long long *indptr, *indices;
  double *data;
} Csr;

static const char *g_dir;

static void die(const char *what) {
  printf("capi_smoke: %s failed: %s\n", what, ptpu_last_error());
  fflush(stdout);
  exit(1);
}

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + 1e-9 * t.tv_nsec;
}

static FILE *open_in_dir(const char *name, const char *mode) {
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", g_dir, name);
  FILE *f = fopen(path, mode);
  if (!f) {
    printf("capi_smoke: cannot open %s\n", path);
    exit(1);
  }
  return f;
}

static void *xmalloc(size_t bytes) {
  void *p = malloc(bytes ? bytes : 1);
  if (!p) {
    printf("capi_smoke: out of memory (%zu bytes)\n", bytes);
    exit(1);
  }
  return p;
}

static void read_exact(FILE *f, void *p, size_t size, size_t count) {
  if (fread(p, size, count, f) != count) {
    printf("capi_smoke: short read\n");
    exit(1);
  }
}

static Csr read_csr(const char *name) {
  Csr a;
  long long head[3];
  FILE *f = open_in_dir(name, "rb");
  read_exact(f, head, sizeof(long long), 3);
  a.rows = head[0];
  a.cols = head[1];
  a.nnz = head[2];
  a.indptr = xmalloc(sizeof(long long) * (a.rows + 1));
  a.indices = xmalloc(sizeof(long long) * a.nnz);
  a.data = xmalloc(sizeof(double) * a.nnz);
  read_exact(f, a.indptr, sizeof(long long), a.rows + 1);
  read_exact(f, a.indices, sizeof(long long), a.nnz);
  read_exact(f, a.data, sizeof(double), a.nnz);
  fclose(f);
  return a;
}

/* write the given arrays of doubles, one after another, to DIR/name */
static void write_out(const char *name, const double *a, long long na,
                      const double *b, long long nb, const double *c,
                      long long nc, const double *d, long long nd) {
  FILE *f = open_in_dir(name, "wb");
  const double *ptrs[4] = {a, b, c, d};
  long long counts[4] = {na, nb, nc, nd};
  for (int i = 0; i < 4; i++)
    if (ptrs[i] && fwrite(ptrs[i], sizeof(double), counts[i], f) !=
                       (size_t)counts[i]) {
      printf("capi_smoke: short write to %s\n", name);
      exit(1);
    }
  fclose(f);
}

/* y = A x for each column of the column-major [rows, bs] block x */
static void csr_matvec(const double *x, double *y, int bs, void *ctx) {
  const Csr *a = (const Csr *)ctx;
  for (int b = 0; b < bs; b++) {
    const double *xc = x + (long long)b * a->cols;
    double *yc = y + (long long)b * a->rows;
    for (long long i = 0; i < a->rows; i++) {
      double s = 0.0;
      for (long long q = a->indptr[i]; q < a->indptr[i + 1]; q++)
        s += a->data[q] * xc[a->indices[q]];
      yc[i] = s;
    }
  }
}

int main(int argc, char **argv) {
  if (argc != 5) {
    printf("usage: capi_smoke DIR K TOL SVDS_K\n");
    return 2;
  }
  g_dir = argv[1];
  int k = atoi(argv[2]);
  double tol = atof(argv[3]);
  int ks = atoi(argv[4]);
  Csr lap = read_csr("lap.bin"), mv = read_csr("mv.bin");
  Csr inc = read_csr("inc.bin");
  long long n = lap.rows;
  double *evals = xmalloc(sizeof(double) * k);
  double *res = xmalloc(sizeof(double) * k);
  double *evecs = xmalloc(sizeof(double) * n * k);
  double t;
  int rc;

  t = now();
  rc = ptpu_eigsh_csr(n, lap.nnz, lap.indptr, lap.indices, lap.data, k, "SA",
                      tol, "", 0.0, evals, evecs, res);
  printf("ptpu_eigsh_csr rc=%d %.3f s\n", rc, now() - t);
  fflush(stdout);
  if (rc) die("ptpu_eigsh_csr");
  write_out("out_csr.bin", evals, k, res, k, evecs, n * k, NULL, 0);

  { /* the F77 binding: target code 0 = primme_smallest */
    int target = 0, ierr = -1;
    double sigma = 0.0;
    t = now();
    ptpu_eigsh_csr_(&n, &lap.nnz, lap.indptr, lap.indices, lap.data, &k,
                    &target, &tol, &sigma, evals, evecs, res, &ierr);
    printf("ptpu_eigsh_csr_ ierr=%d %.3f s\n", ierr, now() - t);
    fflush(stdout);
    if (ierr) die("ptpu_eigsh_csr_");
    write_out("out_f77.bin", evals, k, res, k, evecs, n * k, NULL, 0);
  }

  { /* a host CSR product of this program as the matvec callback */
    double *ev2 = xmalloc(sizeof(double) * k);
    double *rn2 = xmalloc(sizeof(double) * k);
    double *x2 = xmalloc(sizeof(double) * mv.rows * k);
    t = now();
    rc = ptpu_eigsh_matvec(mv.rows, csr_matvec, &mv, k, "SA", tol, "", 0.0, 0,
                           ev2, x2, rn2);
    printf("ptpu_eigsh_matvec rc=%d %.3f s\n", rc, now() - t);
    fflush(stdout);
    if (rc) die("ptpu_eigsh_matvec");
    write_out("out_matvec.bin", ev2, k, rn2, k, x2, mv.rows * k, NULL, 0);
    free(ev2);
    free(rn2);
    free(x2);
  }

  { /* the parameter handle: numEvals, eps, jacobi, the default method */
    char buf[64];
    long long h = ptpu_params_create();
    if (h <= 0) die("ptpu_params_create");
    snprintf(buf, sizeof buf, "%d", k);
    rc = ptpu_params_set(h, "numEvals", buf);
    snprintf(buf, sizeof buf, "%.17g", tol);
    rc |= ptpu_params_set(h, "eps", buf);
    rc |= ptpu_params_set(h, "jacobi", "1");
    rc |= ptpu_params_set_method(h, "PRIMME_DEFAULT_METHOD");
    if (rc) die("ptpu_params_set");
    t = now();
    rc = ptpu_eigsh_run(h, n, lap.nnz, lap.indptr, lap.indices, lap.data,
                        evals, evecs, res);
    printf("ptpu_eigsh_run rc=%d %.3f s\n", rc, now() - t);
    fflush(stdout);
    if (rc) die("ptpu_eigsh_run");
    if (ptpu_params_free(h)) die("ptpu_params_free");
    write_out("out_run.bin", evals, k, res, k, evecs, n * k, NULL, 0);
  }

  { /* svds: the fixed-signature entry, then the parameter handle */
    double *sv = xmalloc(sizeof(double) * ks);
    double *srn = xmalloc(sizeof(double) * ks);
    double *u = xmalloc(sizeof(double) * inc.rows * ks);
    double *v = xmalloc(sizeof(double) * inc.cols * ks);
    char buf[64];
    t = now();
    rc = ptpu_svds_csr(inc.rows, inc.cols, inc.nnz, inc.indptr, inc.indices,
                       inc.data, ks, "LM", tol, sv, u, v);
    printf("ptpu_svds_csr rc=%d %.3f s\n", rc, now() - t);
    fflush(stdout);
    if (rc) die("ptpu_svds_csr");
    write_out("out_svds.bin", sv, ks, u, inc.rows * ks, v, inc.cols * ks,
              NULL, 0);
    long long h = ptpu_svds_params_create();
    if (h <= 0) die("ptpu_svds_params_create");
    snprintf(buf, sizeof buf, "%d", ks);
    rc = ptpu_svds_params_set(h, "numSvals", buf);
    snprintf(buf, sizeof buf, "%.17g", tol);
    rc |= ptpu_svds_params_set(h, "eps", buf);
    rc |= ptpu_svds_params_set(h, "target", "primme_svds_largest");
    rc |= ptpu_svds_params_set_method(h, "primme_svds_hybrid", "", "");
    if (rc) die("ptpu_svds_params_set");
    t = now();
    rc = ptpu_svds_run(h, inc.rows, inc.cols, inc.nnz, inc.indptr,
                       inc.indices, inc.data, sv, u, v, srn);
    printf("ptpu_svds_run rc=%d %.3f s\n", rc, now() - t);
    fflush(stdout);
    if (rc) die("ptpu_svds_run");
    if (ptpu_svds_params_free(h)) die("ptpu_svds_params_free");
    write_out("out_svds_run.bin", sv, ks, srn, ks, u, inc.rows * ks, v,
              inc.cols * ks);
  }
  printf("capi_smoke OK\n");
  return 0;
}
