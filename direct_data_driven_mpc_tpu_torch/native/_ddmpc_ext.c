/* CPython extension: zero-overhead interactive per-step MPC solve.
 *
 * The ctypes FFI costs ~10 us/call -- more than the arithmetic it
 * wraps -- so the latency-critical interactive path uses this real C
 * extension instead (~100 ns call overhead via METH_FASTCALL and the
 * buffer protocol). One call performs the full per-step solve:
 *     u = u_base + U_gain @ theta
 *     cost = theta' P theta + q . theta + r
 * writing into caller-provided buffers. The ADMM inner loop for the
 * CONVEX slack variant is also exposed.
 *
 * Built on first use by native/__init__.py with the system compiler
 * against the CPython headers; no external dependencies.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>

/* Fetch a C-contiguous float64 buffer. Returns 0 on success. */
static int get_buf(PyObject *obj, Py_buffer *view, int writable) {
    int flags = PyBUF_C_CONTIGUOUS | (writable ? PyBUF_WRITABLE : 0);
    if (PyObject_GetBuffer(obj, view, flags) != 0) return -1;
    if (view->itemsize != sizeof(double)) {
        PyBuffer_Release(view);
        PyErr_SetString(PyExc_TypeError, "expected float64 buffer");
        return -1;
    }
    return 0;
}

/* affine_solve(u_base, U_gain, cost_P, cost_q, cost_r, theta, u_out)
 *   -> cost (float)
 * Shapes: u_base (nu,), U_gain (nu, nt), cost_P (nt, nt), cost_q
 * (nt,), theta (nt,), u_out (nu,) writable. */
static PyObject *affine_solve(PyObject *self, PyObject *const *args,
                              Py_ssize_t nargs) {
    if (nargs != 7) {
        PyErr_SetString(PyExc_TypeError, "expected 7 arguments");
        return NULL;
    }
    Py_buffer ub, ug, cp, cq, th, uo;
    double cost_r = PyFloat_AsDouble(args[4]);
    if (cost_r == -1.0 && PyErr_Occurred()) return NULL;
    if (get_buf(args[0], &ub, 0)) return NULL;
    if (get_buf(args[1], &ug, 0)) { PyBuffer_Release(&ub); return NULL; }
    if (get_buf(args[2], &cp, 0)) goto fail2;
    if (get_buf(args[3], &cq, 0)) goto fail3;
    if (get_buf(args[5], &th, 0)) goto fail4;
    if (get_buf(args[6], &uo, 1)) goto fail5;

    {
        Py_ssize_t nu = ub.len / (Py_ssize_t)sizeof(double);
        Py_ssize_t nt = th.len / (Py_ssize_t)sizeof(double);
        const double *u_base = (const double *)ub.buf;
        const double *U_gain = (const double *)ug.buf;
        const double *P = (const double *)cp.buf;
        const double *q = (const double *)cq.buf;
        const double *theta = (const double *)th.buf;
        double *u_out = (double *)uo.buf;

        for (Py_ssize_t i = 0; i < nu; ++i) {
            const double *row = U_gain + i * nt;
            double acc = u_base[i];
            for (Py_ssize_t j = 0; j < nt; ++j)
                acc += row[j] * theta[j];
            u_out[i] = acc;
        }
        double cost = cost_r;
        for (Py_ssize_t i = 0; i < nt; ++i) {
            const double *row = P + i * nt;
            double rowdot = 0.0;
            for (Py_ssize_t j = 0; j < nt; ++j)
                rowdot += row[j] * theta[j];
            cost += theta[i] * rowdot + q[i] * theta[i];
        }
        PyBuffer_Release(&ub); PyBuffer_Release(&ug);
        PyBuffer_Release(&cp); PyBuffer_Release(&cq);
        PyBuffer_Release(&th); PyBuffer_Release(&uo);
        return PyFloat_FromDouble(cost);
    }

fail5: PyBuffer_Release(&th);
fail4: PyBuffer_Release(&cq);
fail3: PyBuffer_Release(&cp);
fail2: PyBuffer_Release(&ug); PyBuffer_Release(&ub);
    return NULL;
}

/* admm_iterate(v_c, v_theta, V_s, s, w, scratch, bound, rho,
 *              max_iters, tol, alpha) -> (iters, r_prim, r_dual)
 * s, w, scratch are writable (nbox,) buffers; warm-started in place.
 * alpha is the over-relaxation parameter (1.0 = plain ADMM); the
 * primal residual is reported on the un-relaxed iterate, matching
 * qp/admm.py exactly. */
static PyObject *admm_iterate(PyObject *self, PyObject *const *args,
                              Py_ssize_t nargs) {
    if (nargs != 11) {
        PyErr_SetString(PyExc_TypeError, "expected 11 arguments");
        return NULL;
    }
    Py_buffer vc, vt, vs, sb, wb, sc;
    double bound = PyFloat_AsDouble(args[6]);
    double rho = PyFloat_AsDouble(args[7]);
    long max_iters = PyLong_AsLong(args[8]);
    double tol = PyFloat_AsDouble(args[9]);
    double alpha = PyFloat_AsDouble(args[10]);
    if (PyErr_Occurred()) return NULL;
    if (get_buf(args[0], &vc, 0)) return NULL;
    if (get_buf(args[1], &vt, 0)) { PyBuffer_Release(&vc); return NULL; }
    if (get_buf(args[2], &vs, 0)) goto afail2;
    if (get_buf(args[3], &sb, 1)) goto afail3;
    if (get_buf(args[4], &wb, 1)) goto afail4;
    if (get_buf(args[5], &sc, 1)) goto afail5;

    {
        Py_ssize_t nbox = vc.len / (Py_ssize_t)sizeof(double);
        const double *v_c = (const double *)vc.buf;
        const double *v_theta = (const double *)vt.buf;
        const double *V_s = (const double *)vs.buf;
        double *s = (double *)sb.buf;
        double *w = (double *)wb.buf;
        double *scr = (double *)sc.buf;
        double rp = INFINITY, rd = INFINITY;
        long it = 0;
        for (; it < max_iters; ++it) {
            for (Py_ssize_t i = 0; i < nbox; ++i)
                scr[i] = s[i] - w[i];
            rp = 0.0; rd = 0.0;
            for (Py_ssize_t i = 0; i < nbox; ++i) {
                const double *row = V_s + i * nbox;
                double v = v_c[i] + v_theta[i];
                for (Py_ssize_t j = 0; j < nbox; ++j)
                    v += row[j] * scr[j];
                double v_hat = alpha * v + (1.0 - alpha) * s[i];
                double sn = v_hat + w[i];
                if (sn > bound) sn = bound;
                else if (sn < -bound) sn = -bound;
                double dprim = v - sn;
                double ddual = rho * (sn - s[i]);
                if (fabs(dprim) > rp) rp = fabs(dprim);
                if (fabs(ddual) > rd) rd = fabs(ddual);
                w[i] += v_hat - sn;
                s[i] = sn;
            }
            if (rp <= tol && rd <= tol) { ++it; break; }
        }
        PyBuffer_Release(&vc); PyBuffer_Release(&vt);
        PyBuffer_Release(&vs); PyBuffer_Release(&sb);
        PyBuffer_Release(&wb); PyBuffer_Release(&sc);
        return Py_BuildValue("ldd", it, rp, rd);
    }

afail5: PyBuffer_Release(&wb);
afail4: PyBuffer_Release(&sb);
afail3: PyBuffer_Release(&vs);
afail2: PyBuffer_Release(&vt); PyBuffer_Release(&vc);
    return NULL;
}

static PyMethodDef Methods[] = {
    {"affine_solve", (PyCFunction)affine_solve, METH_FASTCALL,
     "Full per-step affine MPC solve into a caller buffer."},
    {"admm_iterate", (PyCFunction)admm_iterate, METH_FASTCALL,
     "Warm-started ADMM inner loop (in-place s/w)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_ddmpc_ext",
    "Native interactive-path kernels for direct data-driven MPC.",
    -1, Methods,
};

PyMODINIT_FUNC PyInit__ddmpc_ext(void) {
    return PyModule_Create(&moduledef);
}
