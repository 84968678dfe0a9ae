"""QP solves per second: B T times the evaluations completed in the
window, over the window's host-clock seconds (closed by a synchronize).

``solves_per_s.host`` is the same rate in a cell where the host's call
nearly paces the evaluations: there the host's speed, which moves from
run to run more than the card's, moves the rate, so it has a bound of
its own and does not loosen the card-paced cells'."""


def read(run):
    return run.B * run.T * run.n_eval / run.window_s
