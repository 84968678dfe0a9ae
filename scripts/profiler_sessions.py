"""How often a ``torch.profiler`` session over phase 38's calls comes back
without device activity, and what such a session holds instead.

Phase 38 of ``chip_smoke.py`` (``time_parallel_phase``) counts the device
kernels of ``time_parallel_rollout`` and of the sequential engine
(``linear_closed_loop_rollout``), one scenario at T = 400, K = 1 and 50,
float32 and float64. This script opens N sessions over each of those
eight calls, each session shaped as ``chip_smoke.device_kernels`` shapes
it (one discarded warm-up step, then the active calls), and records per
session: the device kernels and copies (the card's own activity
records); the host's runtime calls that launch kernels and that copy or
fill, as the same session recorded them (``chip_smoke.LAUNCH_CALLS``,
``COPY_CALLS``, which phase 38 counts); and how far the first device
activity starts after the first launch call, and the last ends after the
last. A pass with the host idle for PAD_MS after the recording step
opens and before it closes tells a window that closes on late records
from one that misses them outright. An empty session has its Chrome
trace written to ``build/profiler/``.

Run on one card from the repository root:

    python3 scripts/profiler_sessions.py [SESSIONS [PAD_MS ...]]

(default 40 sessions a call, passes at 0 and 20 ms). The sequential
engine at K = 1 (about 10,000 launches a call) takes at most 5 sessions
a pass.
"""

import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def session(fn, calls, pad_ms, dump=None) -> dict:
    """One profiler session over ``calls`` calls of ``fn()`` after a
    discarded warm-up call (``device_kernels``'s shape); what it saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        for i in range(1 + calls):
            if pad_ms and i == 1:
                time.sleep(pad_ms / 1e3)
            fn()
            torch.cuda.synchronize()
            if pad_ms and i == calls:
                time.sleep(pad_ms / 1e3)
            prof.step()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = [e for e in events if e.device_type != DeviceType.CUDA
                and e.name in cs.LAUNCH_CALLS + cs.COPY_CALLS]
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
    out = {"kernels": len(dev) - copies, "copies": copies,
           "launch_calls": sum(e.name in cs.LAUNCH_CALLS for e in launches),
           "copy_calls": sum(e.name in cs.COPY_CALLS for e in launches),
           "cpu_events": len(events) - len(dev)}
    if dev and launches:
        out["first_lag_us"] = (min(e.time_range.start for e in dev)
                               - min(e.time_range.start for e in launches))
        out["last_lag_us"] = (max(e.time_range.end for e in dev)
                              - max(e.time_range.end for e in launches))
    if not dev and dump:
        prof.export_chrome_trace(dump)
    # What the device records hold besides kernels and copies (the
    # device track also shows each synchronize).
    out["other_device"] = sorted({e.name for e in dev if e.name.startswith(
        ("Memcpy", "Memset")) is False and not e.name[:1].islower()
        and "(" not in e.name and "<" not in e.name})
    out["launch_names"] = sorted({e.name for e in events
                                  if e.device_type != DeviceType.CUDA
                                  and e.name.startswith("cu")})
    return out


def main() -> int:
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
        linear_closed_loop_rollout,
        time_parallel_rollout,
    )

    if not torch.cuda.is_available():
        raise SystemExit("profiler_sessions: no CUDA device")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    pads = [float(x) for x in sys.argv[2:]] or [0.0, 20.0]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    out_dir = os.path.join(ROOT, "build", "profiler")
    os.makedirs(out_dir, exist_ok=True)
    plant, ctrl = cs.build_four_tank_robust()
    x0s, ups, yps = cs.scenario_batch(plant, ctrl, 1, dev)
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    Ws = draw_noise_batch(0, 1, cs.T_MAIN, ctrl.p, plant.get_eps_max(), dev)
    T = cs.T_MAIN
    dumped = 0
    for pad in pads:
        for K in (1, 50):
            n_outer = math.ceil(T / K)
            for dt in (torch.float32, torch.float64):
                bm = build_linear_engine(ctrl, plant.as_params(),
                                         solves_per_block=K, device=dev,
                                         dtype=dt)
                ins = tuple(a[0].to(dt) for a in (x0s, ups, yps, Ws))
                fns = {"time-parallel": (lambda: time_parallel_rollout(
                           bm, *ins, T), 3),
                       "sequential": (lambda: linear_closed_loop_rollout(
                           bm, *ins, T), 1 if n_outer > 100 else 3)}
                for name, (fn, calls) in fns.items():
                    seen, t0 = [], time.perf_counter()
                    for i in range(min(n, 5) if n_outer > 100 and
                                   name == "sequential" else n):
                        dump = None
                        if dumped < 4:
                            dump = os.path.join(
                                out_dir, f"profiler_empty_{dumped}.json")
                        s = session(fn, calls, pad, dump)
                        if s["kernels"] + s["copies"] == 0:
                            print(f"  EMPTY session {i}: {s}"
                                  + (f" (trace {os.path.basename(dump)})"
                                     if dump else ""), flush=True)
                            dumped += dump is not None
                        seen.append(s)
                    k = np.array([s["kernels"] for s in seen])
                    c = np.array([s["copies"] for s in seen])
                    lc = np.array([s["launch_calls"] for s in seen])
                    cc = np.array([s["copy_calls"] for s in seen])
                    short = int(sum(s["kernels"] < s["launch_calls"]
                                    or s["copies"] < s["copy_calls"]
                                    for s in seen))
                    lag = np.array([s["first_lag_us"] for s in seen
                                    if "first_lag_us" in s])
                    end = np.array([s["last_lag_us"] for s in seen
                                    if "last_lag_us" in s])
                    empty = int(sum(s["kernels"] + s["copies"] == 0
                                    for s in seen))
                    print(f"  host runtime calls seen: "
                          f"{seen[0]['launch_names']}; device records other "
                          f"than kernels and copies: "
                          f"{seen[0]['other_device']}", flush=True)
                    print(f"pad {pad:g} ms, K={K} {str(dt)[6:]} {name} "
                          f"({calls} calls a session): {len(seen)} "
                          f"sessions, {empty} empty, {short} with fewer "
                          f"device records than launch or copy calls; "
                          f"device kernels a session {k.min()}-{k.max()}, "
                          f"kernel launch calls {lc.min()}-{lc.max()}; "
                          f"device copies {c.min()}-{c.max()}, copy calls "
                          f"{cc.min()}-{cc.max()}; first device activity "
                          + (f"{lag.min():.1f} / {np.median(lag):.1f} / "
                             f"{lag.max():.1f} us after the first launch "
                             f"call (min / median / max), last "
                             f"{end.min():.1f} / {np.median(end):.1f} / "
                             f"{end.max():.1f} us after the last"
                             if lag.size else "no lag measured")
                          + f"; {time.perf_counter() - t0:.1f} s [{smi}]",
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
