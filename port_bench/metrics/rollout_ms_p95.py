"""The 95th percentile (nearest rank) of the intervals between
consecutive evaluations' completions, read from CUDA events recorded
after each call, the first from an event at the window's start. The
intervals add up to the window, so a stall of the host lands in them.

``rollout_ms_p95.host`` is the same tail in a cell the host paces, where
it follows the host's speed and is a per-layer reading of the entry's
host path rather than an end-to-end bound."""


def read(run):
    return run.interval_p95_ms()
