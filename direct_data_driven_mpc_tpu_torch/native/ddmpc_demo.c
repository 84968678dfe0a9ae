/* ddmpc_demo.c -- closed-loop demonstration / parity harness for the
 * standalone C deployment runtime.
 *
 * Usage: ddmpc_demo <controller.blob> <noise.f64> <T> <out.f64>
 *
 * Loads a controller blob exported with an embedded plant
 * (utils/export.py), then runs T closed-loop steps of the paper's
 * Algorithm 1/2 (solve every n_mpc_step steps, apply u_opt rows
 * 0..n_mpc_step-1) entirely in C -- the same loop as
 * control/operation.py::simulate_data_driven_mpc_control_loop.
 *
 * noise.f64: T*p little-endian float64 measurement-noise samples.
 * out.f64:   u_sys (T*m) || y_sys (T*p) || costs (T) as float64, where
 *            costs[k] is the optimal cost of the most recent solve.
 * Exit code: 0 on success (all solves converged and finite), 1 on any
 * failure.
 */
#include "ddmpc_runtime.h"

#include <stdio.h>
#include <stdlib.h>

int main(int argc, char **argv) {
    if (argc != 5) {
        fprintf(stderr,
                "usage: %s <controller.blob> <noise.f64> <T> <out.f64>\n",
                argv[0]);
        return 1;
    }
    ddmpc_controller *c = ddmpc_load(argv[1]);
    if (!c) return 1;
    if (c->ns <= 0) {
        fprintf(stderr, "blob has no embedded plant block\n");
        ddmpc_free(c);
        return 1;
    }
    long T = strtol(argv[3], NULL, 10);
    if (T <= 0) {
        fprintf(stderr, "bad T\n");
        ddmpc_free(c);
        return 1;
    }

    double *w_sys = (double *)malloc((size_t)T * c->p * sizeof(double));
    double *u_sys = (double *)malloc((size_t)T * c->m * sizeof(double));
    double *y_sys = (double *)malloc((size_t)T * c->p * sizeof(double));
    double *costs = (double *)malloc((size_t)T * sizeof(double));
    if (!w_sys || !u_sys || !y_sys || !costs) return 1;

    FILE *nf = fopen(argv[2], "rb");
    if (!nf || fread(w_sys, sizeof(double), (size_t)T * c->p, nf) !=
                   (size_t)T * c->p) {
        fprintf(stderr, "cannot read %ld x %d noise samples from %s\n",
                T, c->p, argv[2]);
        return 1;
    }
    fclose(nf);

    int all_ok = 1;
    for (long t = 0; t < T; t += c->n_mpc_step) {
        ddmpc_solve(c);
        all_ok = all_ok && c->converged;
        long kmax = t + c->n_mpc_step;
        if (kmax > T) kmax = T;
        for (long k = t; k < kmax; ++k) {
            const double *u = ddmpc_input_at_step(c, (int)(k - t));
            ddmpc_plant_step(c, u, w_sys + (size_t)k * c->p,
                             y_sys + (size_t)k * c->p);
            for (int i = 0; i < c->m; ++i)
                u_sys[(size_t)k * c->m + i] = u[i];
            ddmpc_observe(c, u, y_sys + (size_t)k * c->p);
            costs[k] = c->cost;
        }
    }

    FILE *of = fopen(argv[4], "wb");
    if (!of) {
        fprintf(stderr, "cannot open %s for writing\n", argv[4]);
        return 1;
    }
    fwrite(u_sys, sizeof(double), (size_t)T * c->m, of);
    fwrite(y_sys, sizeof(double), (size_t)T * c->p, of);
    fwrite(costs, sizeof(double), (size_t)T, of);
    fclose(of);

    fprintf(stderr, "ddmpc_demo: %ld steps, kind=%d, converged=%s\n", T,
            c->kind, all_ok ? "all" : "NOT ALL");
    free(w_sys); free(u_sys); free(y_sys); free(costs);
    ddmpc_free(c);
    return all_ok ? 0 : 1;
}
