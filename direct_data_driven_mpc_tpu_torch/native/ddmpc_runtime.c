/* ddmpc_runtime.c -- see ddmpc_runtime.h. C99, libc + libm only.
 *
 * Numerical parity: the affine solve and the over-relaxed ADMM loop
 * are the same iterations as qp/solution_map.py / qp/admm.py (float64
 * throughout); tests/test_torch_native.py asserts closed-loop agreement
 * with the Python controller to ~1e-12.
 */
#include "ddmpc_runtime.h"

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static const char MAGIC[8] = {'D', 'D', 'M', 'P', 'C', 'R', 'T', '1'};

/* y = M (rows x cols) @ x, accumulate into out (out must be inited) */
static void matvec_acc(const double *M, const double *x, double *out,
                       int rows, int cols) {
    for (int i = 0; i < rows; ++i) {
        const double *row = M + (size_t)i * cols;
        double acc = out[i];
        for (int j = 0; j < cols; ++j) acc += row[j] * x[j];
        out[i] = acc;
    }
}

static double quad_form(const double *P, const double *q, double r,
                        const double *x, int n) {
    double cost = r;
    for (int i = 0; i < n; ++i) {
        const double *row = P + (size_t)i * n;
        double rowdot = 0.0;
        for (int j = 0; j < n; ++j) rowdot += row[j] * x[j];
        cost += x[i] * rowdot + q[i] * x[i];
    }
    return cost;
}

static int read_exact(FILE *f, void *buf, size_t bytes) {
    return fread(buf, 1, bytes, f) == bytes ? 0 : -1;
}

static double *read_f64(FILE *f, size_t count) {
    double *a = (double *)malloc(count * sizeof(double));
    if (!a) return NULL;
    if (read_exact(f, a, count * sizeof(double)) != 0) {
        free(a);
        return NULL;
    }
    return a;
}

ddmpc_controller *ddmpc_load(const char *path) {
    FILE *f = fopen(path, "rb");
    if (!f) {
        fprintf(stderr, "ddmpc_load: cannot open %s\n", path);
        return NULL;
    }
    char magic[8];
    unsigned int hdr[10];
    double scal[6];
    if (read_exact(f, magic, 8) != 0 ||
        memcmp(magic, MAGIC, 8) != 0 ||
        read_exact(f, hdr, sizeof hdr) != 0 ||
        read_exact(f, scal, sizeof scal) != 0) {
        fprintf(stderr, "ddmpc_load: bad header in %s\n", path);
        fclose(f);
        return NULL;
    }

    ddmpc_controller *c =
        (ddmpc_controller *)calloc(1, sizeof(ddmpc_controller));
    if (!c) {
        fclose(f);
        return NULL;
    }
    c->kind = (int)hdr[0];
    c->n = (int)hdr[1];
    c->m = (int)hdr[2];
    c->p = (int)hdr[3];
    c->L = (int)hdr[4];
    c->n_mpc_step = (int)hdr[5];
    c->ns = (int)hdr[6];
    c->nbox = (int)hdr[7];
    c->admm_iters = (int)hdr[8];
    c->nt = c->n * (c->m + c->p);
    c->nu = c->L * c->m;
    c->cost_r = scal[0];
    c->bound = scal[1];
    c->rho = scal[2];
    c->alpha = scal[3];
    c->tol = scal[4];
    c->eps_max = scal[5];

    int ok = 1;
    size_t nt = (size_t)c->nt, nu = (size_t)c->nu, nb = (size_t)c->nbox;
    ok = ok && (c->u_past = read_f64(f, (size_t)c->n * c->m)) != NULL;
    ok = ok && (c->y_past = read_f64(f, (size_t)c->n * c->p)) != NULL;
    if (ok && c->kind == 1) {
        ok = ok && (c->v_c = read_f64(f, nb)) != NULL;
        ok = ok && (c->V_theta = read_f64(f, nb * nt)) != NULL;
        ok = ok && (c->V_s = read_f64(f, nb * nb)) != NULL;
        ok = ok && (c->u_c = read_f64(f, nu)) != NULL;
        ok = ok && (c->U_theta = read_f64(f, nu * nt)) != NULL;
        ok = ok && (c->U_s = read_f64(f, nu * nb)) != NULL;
        ok = ok && (c->cost_P = read_f64(f, (nt + nb) * (nt + nb))) != NULL;
        ok = ok && (c->cost_q = read_f64(f, nt + nb)) != NULL;
        if (ok) {
            c->s = (double *)calloc(nb, sizeof(double));
            c->w = (double *)calloc(nb, sizeof(double));
            ok = c->s && c->w;
        }
    } else if (ok) {
        ok = ok && (c->u_base = read_f64(f, nu)) != NULL;
        ok = ok && (c->U_gain = read_f64(f, nu * nt)) != NULL;
        ok = ok && (c->cost_P = read_f64(f, nt * nt)) != NULL;
        ok = ok && (c->cost_q = read_f64(f, nt)) != NULL;
    }
    if (ok && c->ns > 0) {
        size_t ns = (size_t)c->ns;
        ok = ok && (c->A = read_f64(f, ns * ns)) != NULL;
        ok = ok && (c->B = read_f64(f, ns * c->m)) != NULL;
        ok = ok && (c->C = read_f64(f, (size_t)c->p * ns)) != NULL;
        ok = ok && (c->D = read_f64(f, (size_t)c->p * c->m)) != NULL;
        ok = ok && (c->x = read_f64(f, ns)) != NULL;
    }
    if (ok) {
        c->u_opt = (double *)calloc(nu, sizeof(double));
        c->theta = (double *)calloc(nt, sizeof(double));
        size_t scr_len = nb > (size_t)c->ns ? nb : (size_t)c->ns;
        if (nt + nb > scr_len) scr_len = nt + nb;
        c->scr = (double *)calloc(scr_len ? scr_len : 1, sizeof(double));
        c->scr2 = (double *)calloc(scr_len ? scr_len : 1, sizeof(double));
        ok = c->u_opt && c->theta && c->scr && c->scr2;
    }
    fclose(f);
    if (!ok) {
        fprintf(stderr, "ddmpc_load: truncated/invalid blob %s\n", path);
        ddmpc_free(c);
        return NULL;
    }
    return c;
}

void ddmpc_free(ddmpc_controller *c) {
    if (!c) return;
    free(c->u_past); free(c->y_past);
    free(c->u_base); free(c->U_gain); free(c->cost_P); free(c->cost_q);
    free(c->v_c); free(c->V_theta); free(c->V_s);
    free(c->u_c); free(c->U_theta); free(c->U_s);
    free(c->s); free(c->w);
    free(c->A); free(c->B); free(c->C); free(c->D); free(c->x);
    free(c->u_opt); free(c->theta); free(c->scr); free(c->scr2);
    free(c);
}

static void build_theta(ddmpc_controller *c) {
    memcpy(c->theta, c->u_past, (size_t)c->n * c->m * sizeof(double));
    memcpy(c->theta + (size_t)c->n * c->m, c->y_past,
           (size_t)c->n * c->p * sizeof(double));
}

int ddmpc_solve(ddmpc_controller *c) {
    build_theta(c);
    if (c->kind == 0) {
        memcpy(c->u_opt, c->u_base, (size_t)c->nu * sizeof(double));
        matvec_acc(c->U_gain, c->theta, c->u_opt, c->nu, c->nt);
        c->cost = quad_form(c->cost_P, c->cost_q, c->cost_r, c->theta,
                            c->nt);
        c->converged = 1;
        for (int i = 0; i < c->nu; ++i)
            if (!isfinite(c->u_opt[i])) c->converged = 0;
        return 0;
    }

    /* Over-relaxed ADMM, warm-started from the previous solve; the
     * same iteration as qp/admm.py::admm_solve_np. */
    int nb = c->nbox;
    double *v_theta = c->scr2; /* (nb) */
    memset(v_theta, 0, (size_t)nb * sizeof(double));
    matvec_acc(c->V_theta, c->theta, v_theta, nb, c->nt);

    double rp = INFINITY, rd = INFINITY;
    int it = 0;
    double *scr = c->scr;
    for (; it < c->admm_iters; ++it) {
        for (int i = 0; i < nb; ++i) scr[i] = c->s[i] - c->w[i];
        rp = 0.0; rd = 0.0;
        for (int i = 0; i < nb; ++i) {
            const double *row = c->V_s + (size_t)i * nb;
            double v = c->v_c[i] + v_theta[i];
            for (int j = 0; j < nb; ++j) v += row[j] * scr[j];
            double v_hat = c->alpha * v + (1.0 - c->alpha) * c->s[i];
            double sn = v_hat + c->w[i];
            if (sn > c->bound) sn = c->bound;
            else if (sn < -c->bound) sn = -c->bound;
            double dprim = v - sn;
            double ddual = c->rho * (sn - c->s[i]);
            if (fabs(dprim) > rp) rp = fabs(dprim);
            if (fabs(ddual) > rd) rd = fabs(ddual);
            c->w[i] += v_hat - sn;
            c->s[i] = sn;
        }
        if (rp <= c->tol && rd <= c->tol) { ++it; break; }
    }
    c->iters = it;
    c->r_prim = rp;
    c->r_dual = rd;

    /* extraction: u = u_c + U_theta theta + U_s (s - w); cost over
     * [theta; s - w]. */
    double *tt = c->scr; /* (nt + nb) */
    memcpy(tt, c->theta, (size_t)c->nt * sizeof(double));
    for (int i = 0; i < nb; ++i) tt[c->nt + i] = c->s[i] - c->w[i];
    memcpy(c->u_opt, c->u_c, (size_t)c->nu * sizeof(double));
    matvec_acc(c->U_theta, c->theta, c->u_opt, c->nu, c->nt);
    matvec_acc(c->U_s, tt + c->nt, c->u_opt, c->nu, nb);
    c->cost = quad_form(c->cost_P, c->cost_q, c->cost_r, tt,
                        c->nt + nb);
    c->converged = (rp <= c->tol && rd <= c->tol);
    for (int i = 0; i < c->nu; ++i)
        if (!isfinite(c->u_opt[i])) c->converged = 0;
    return 0;
}

const double *ddmpc_input_at_step(const ddmpc_controller *c, int k) {
    if (k < 0 || k >= c->L) return NULL;
    return c->u_opt + (size_t)k * c->m;
}

void ddmpc_observe(ddmpc_controller *c, const double *u,
                   const double *y) {
    size_t um = (size_t)c->m, yp = (size_t)c->p;
    memmove(c->u_past, c->u_past + um,
            ((size_t)c->n - 1) * um * sizeof(double));
    memcpy(c->u_past + ((size_t)c->n - 1) * um, u, um * sizeof(double));
    memmove(c->y_past, c->y_past + yp,
            ((size_t)c->n - 1) * yp * sizeof(double));
    memcpy(c->y_past + ((size_t)c->n - 1) * yp, y, yp * sizeof(double));
}

int ddmpc_plant_step(ddmpc_controller *c, const double *u,
                     const double *w, double *y) {
    if (c->ns <= 0) return -1;
    int ns = c->ns;
    /* y = C x + D u + w (output BEFORE the state update, matching
     * models/lti_model.py and reference model_simulation.py:94-96) */
    for (int i = 0; i < c->p; ++i) {
        double acc = w ? w[i] : 0.0;
        const double *Crow = c->C + (size_t)i * ns;
        for (int j = 0; j < ns; ++j) acc += Crow[j] * c->x[j];
        const double *Drow = c->D + (size_t)i * c->m;
        for (int j = 0; j < c->m; ++j) acc += Drow[j] * u[j];
        y[i] = acc;
    }
    /* x <- A x + B u */
    double *xn = c->scr; /* ns <= scr_len */
    for (int i = 0; i < ns; ++i) {
        double acc = 0.0;
        const double *Arow = c->A + (size_t)i * ns;
        for (int j = 0; j < ns; ++j) acc += Arow[j] * c->x[j];
        const double *Brow = c->B + (size_t)i * c->m;
        for (int j = 0; j < c->m; ++j) acc += Brow[j] * u[j];
        xn[i] = acc;
    }
    memcpy(c->x, xn, (size_t)ns * sizeof(double));
    return 0;
}
