"""Smoke run of the PyTorch port on one NVIDIA card.

Drives the port's four main paths through their hand-written CUDA
kernels and checks them, and the sweep and tuning path around them.
First the Monte-Carlo batch of the paper's four-tank Robust controller
(B = 4096 scenarios x T = 400 closed-loop steps, N = 400, L = 30, slack
NONE) through
``direct_data_driven_mpc_tpu_torch/ops/csrc/fused_rollout.cu``:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: both kernels are compiled from the sources in this checkout,
   one nvcc each, started together;
3. host build: the controller exactly as ``bench.py`` builds it
   (seed 0), the block maps for K = 50 (kernel) and K = 100 (classic
   engine);
4. main path: ``make_fused_batched_rollout`` on the card, with launch
   counts; K1's plan (its state pass and its product) from the library
   against ``rollout_plan``, each kernel's blocks per SM, registers and
   local (spill) bytes, and the CUDA kernels one rollout launches (2,
   0 copies: the host's launch records in ``torch.profiler`` over three
   calls after a discarded warm-up; their names from the device's
   records where the session holds one per launch, else printed as not
   read); kernel vs its plain PyTorch version (u, y and
   final state bit-equal; costs rtol 1e-3, atol 1e-5) and vs the classic
   condensed engine (u, y, final state atol 2e-5; costs as before);
5. float64 truth: the kernel's max |du| against the plain version in
   float64 (64 scenarios) below 1e-4;
6. edges: a ragged batch, a rollout that does not divide into blocks,
   and the noise rotation against ``torch.roll`` (bit-equal);
7. timing: closed-loop QP solves/s of the kernel, the plain version
   and the classic engine, with CUDA events.

Then the fused ADMM closed loop of ``bench.py``'s ``four_tank_convex``
(CONVEX slack, c = 1, B = 65536 x T = 400) through
``direct_data_driven_mpc_tpu_torch/ops/csrc/fused_admm.cu``:

8. host build: the CONVEX controller and the fused operators, the
   kernel's tile and shared memory checked against ``admm_plan``; K4's
   blocks per SM, registers and local (spill) bytes per thread;
9. main path: ``make_fused_admm_rollout`` on the card, with the launch
   count; every solve converged; kernel vs plain version (u, y, final
   state and ADMM state atol 2e-5; costs rtol 1e-3, atol 1e-5;
   converged flags equal);
10. float64 truth: the kernel's max |du| against the plain version in
    float64 (64 scenarios) below 1e-4;
11. variants, each kernel vs plain version at the same tolerances:
    ``four_tank_box`` (|u| <= 0.85 checked too), the 4-phase setpoint
    schedule, ``n_mpc_step = 4``, a ragged batch, a segmented run
    (two halves through ``solver_state0``, against the uninterrupted
    one), L = 15 (nbox 30) and L = 60 (nbox 120, N = 800), and
    ``four_tank_convex`` at B = 4096, where the plan takes the
    half-height tile (32 scenarios a block; the launch counted in
    ``fused_admm.small_tile_launches``);
12. timing: solves/s of the kernel and the plain version, in turns.

Then the adaptive penalty ladder of ``bench.py``'s ``four_tank_ladder``
(slack NONE, |u| <= 0.85, the default 7-rung ladder, B = 65536 x
T = 400) through kernel K5 (``fused_ladder_kernel`` of
``ops/csrc/fused_admm.cu``):

13. host build: the ladder's stacked operators, the kernel's tile (the
    rung group) and shared memory, checked against ``ladder_tile_rows``
    and ``ladder_kernel_smem_bytes``; K5's blocks per SM, registers and
    local (spill) bytes per thread;
14. main path: ``make_fused_ladder_rollout`` on the card, with the launch
    count; every solve from index 10 converged (the fraction over all
    solves and a histogram of the final rungs are printed); kernel vs
    plain version: rung lanes equal, u, y, state and ADMM state atol
    2e-5, costs rtol 1e-3 / atol 1e-5;
15. float64 truth: max |du| against the plain version in float64 (64
    scenarios, the same rung group) below 1e-4;
16. variants, kernel vs plain version: a ragged batch, and a segmented
    run (two segments through ``solver_state0``) whose rung groups sit on
    different rungs at the cut, against the uninterrupted run;
17. timing: the kernel and the plain version, in turns.

Then ``bench.py``'s ``large_plant`` (a random stable 10-state, 10-input,
10-output plant, N = 600, L = 30, B = 65536 x T = 400, K = 25,
``cost_mode="post"``) through kernel K3 (``ops/csrc/fused_rollout.cu``,
its no-cost kernel, whose products run on the tensor cores as 3xTF32):

18. host build: the controller (seed 0) and the block maps; K3's plan
    from the library against ``nocost_plan`` at K = 25 and 50;
19. main path: ``make_fused_batched_rollout(cost_mode="post")``, with
    launch counts; kernel vs plain version on u, y and the final state
    at atol 1e-4 (the kernel sums its 3xTF32 products in another order
    than cuBLAS, and every float32 path of large_plant sits 2e-5 to
    3e-5 from float64), the post-pass costs on the two trajectories at
    rtol 1e-3 / atol 1e-2 (each cost is a small difference of terms
    near 1e3); then K = 50 solves per block (B = 8192), where K3 takes
    32 scenarios per block, against the plain version at 1e-4;
20. float64 truth: max |du| and |dy| against the plain version in
    float64 (1024 scenarios), each below 1e-4; the post-pass costs (cost
    factor truncated at rtol 1e-6, as in the JAX package) against
    ``cost_mode="inkernel"`` at the same truncation, run by the plain
    version on 1024 scenarios (rtol 1e-3 / atol 1e-2), and in float64 on
    the float64 trajectories (atol 1e-8); the truncation's own effect on
    the costs is printed;
21. timing: the kernel, the cost post-pass and the plain version, each
    on its own, and the per-block cuBLAS product, whose 16 calls are
    K3's library yardstick.

And ``bench.py``'s ``tracking`` (``four_tank_tracking``: the main
path's controller and batch, B = 4096 x T = 400, with a setpoint channel
of 4 lanes, K = 50, and the 4-phase retarget schedule: the baked
setpoints, then 0.85 x them, in alternation every 2 outer blocks)
through K1, run right after phase 7: once the post-pass of phase 19 has
run a cuDNN convolution, ``torch.profiler`` has been seen to record no
device activity in the process (on the H100), and phases 23 and 26 print
numbers from the device's records (each check there rests on the host's
launch records):

22. host build: the tracking operator and block map, with their set-up
    seconds; K1's plan and slot table at this shape (rank 20: two
    passes);
23. main path: ``make_fused_batched_rollout(bm_t, T)(..., setpoints)``
    on the card, with launch counts; K1 vs its plain version (U, Y and
    s_fin bit-equal where cuBLAS sums as one FMA chain, else atol 2e-5
    with the reason printed; costs rtol 1e-3, atol 1e-5), vs the classic
    engine (K = 100, atol 2e-5) and vs the generic loop with a
    ``TrackingMap`` and the schedule per solve (64 scenarios, u atol
    1e-4);
24. float64 truth: K1's max |du| against the plain version in float64
    (64 scenarios) below 1e-4, and ``bench.py``'s retarget probe: y(T)
    within 0.05 of 0.85 x y_s;
25. edges: the constant schedule r_bar against the plain map of phase 4
    (U, Y, s_fin bit-equal in K1; in the plain version bit-equal where
    cuBLAS keeps one FMA chain), a per-scenario schedule, a ragged batch,
    T = 37 at K = 8, the amortized rotation against ``torch.roll`` of
    noise and setpoint lanes together, and the classic engine's in-scan
    noise at full width (bounded, finite, equal to the explicit-noise run
    fed the same draws);
26. timing: K1, its plain version and the classic engine, in turns, the
    one-addmm yardstick, and the device's idle share over 20 amortized
    rollouts (``torch.profiler``; printed with the device records and
    host launches of the session, and only where each launch and copy
    has its device record, else "not read").

Then ``bench.py``'s three generic configurations (its
``run_convex_config``: the four-tank controller of seed 0, N = 400,
L = 30, B = 4096 x T = 400, the main path's noise) through the generic
loop's iterative solvers and ``parallel.batch.make_batched_rollout``,
plain PyTorch with no kernel of their own, run right after phase 26
(phase 30 prints a busy share from ``torch.profiler``'s device
records):

27. ``four_tank_convex_generic``: CONVEX slack, c = 1, 16 ADMM
    iterations per solve; the converged lanes; against K4 from the same
    zero state at 16 iterations and tolerance 1e-6 (u and y within
    1e-4); against its float64 run on 64 scenarios (max |du| < 1e-4);
    a segmented run (two halves through ``solver_state0``) bit-equal to
    the uninterrupted one;
28. ``four_tank_box_generic``: slack NONE, |u| <= 0.85, rho = 1, up to
    60 iterations (early exit per scenario): |u| checked; against K4's
    box variant from zero at 60 iterations (u and y within 1e-4); the
    adaptive ladder (rho None, cap 120) on 1024 scenarios against its
    float64 run (1e-4), with a histogram of the final rungs;
29. ``four_tank_nonconvex``: NON_CONVEX slack (opted in), c = 0.05,
    4 bound updates x 16 ADMM iterations per solve: the converged lanes
    and the largest violation of the Eq. 6d constraint; against its
    float64 run on 64 scenarios (max |du| < 1e-4);
30. timing: each of the three in turns, ms per rollout and solves/s by
    CUDA events, then the kernels and copies one rollout launches (the
    host's launch records in ten ``torch.profiler`` sessions, one per
    segment chained through ``solver_state0``, each bit-equal to the
    full run; at least one kernel per step) and the device's idle share
    where every session's device records are complete (else "not read",
    with the counts). None of the converged fractions is asserted.
    Beside ``four_tank_nonconvex``, the same controller through the fused
    entry (``make_fused_admm_rollout``, K4's NON_CONVEX mode, one launch
    a rollout, from the generic loop's cold start): its inputs against
    the generic loop's run and its float64 run (max |du| < 1e-4), its
    final bounds against the generic loop's, and its ms per rollout in
    turns with the generic loop's.

Then the sweep and tuning path (plain PyTorch and numpy, no kernel of
its own), right after phase 30, so that phase 35 traces before phase
19's convolution:

31. the host layer: the four-tank controller through
    ``create_data_driven_mpc_controller`` from ``four_tank_params``
    (spec and host operator bit-equal to ``build_four_tank_robust``'s);
    ``closed_loop_spectrum`` of the K = 50 block map (stable) and of the
    terminal-free (UCON) controller (unstable), with each radius;
    ``simulate_data_driven_mpc_control_loop`` for 50 steps against the
    generic loop in float64 on the card, on the same noise (1e-8 on u);
32. the heterogeneous sweep at ``four_tank_robust``'s scale: B = 4096
    data realisations (N = 400, L = 30, seed s for realisation s)
    simulated and arranged into Hankels in numpy;
    ``build_batched_solution_operators`` on the card (timed, every
    feasible lane true; 16 realisations against the host's
    ``build_solution_operators_fallback`` within 1e-9 of each field's
    largest magnitude); ``stacked_solution_map`` and
    ``heterogeneous_closed_loop`` at B = 4096 x T = 400 (timed; 64
    scenarios each alone within 2e-5 on u and y, and in float64 within
    1e-4 on u); ``rollout_metrics``;
33. segmented runs with checkpoints: the CONVEX ADMM of
    ``four_tank_convex_generic`` (16 iterations, B = 4096) in 4 segments
    of 100 steps, resumed after segment 2 into a zero template, and one
    ``batched_closed_loop`` over the segments' noise, all bit-equal,
    solver state included; again with the box ADMM's ladder (integer
    rung lanes) on 1024 scenarios; the checkpoint's size and its save
    and load times;
34. differentiable tuning of the paper's controller (nz 571, nc 168) in
    float64 on the card: ``differentiable_solution_map`` against the
    host operator (1e-9), the gradient at the example's 100x inflated
    alpha ridge against central differences (rtol 1e-4), 25 Adam steps
    at lr 0.4 (B = 64, T = 80) that lower the loss; ms per value and
    grad;
35. profiling: one heterogeneous segment (B = 4096, T = 40) under
    ``utils.profiling.trace``; the Chrome trace must hold the host's
    kernel launch events, and the card's kernel events are counted
    against them (``trace`` warns when some are missing; the warning is
    printed).

Then one controller for one plant, with nothing batched (no kernel of
its own: the C runtime on the host, plain PyTorch on the card), right
after phase 35 and before phase 19's convolution (phase 38 counts the
host's launch records in ``torch.profiler``):

36. the interactive per-step solve: the C extension and the runtime's
    demo built from this checkout (compiler, its version, seconds);
    ``four_tank_robust``'s controller (nz 571, nc 168, slack NONE) and
    ``four_tank_convex``'s (CONVEX, c = 1, nbox 60), each with
    ``solve_path`` "native" and "numpy" (read back); a 40-step host
    closed loop native against numpy (NONE atol 1e-12, CONVEX 1e-7:
    both exit at 1e-8 on their own residuals); p50 and p99 microseconds
    of ``update_and_solve_data_driven_mpc`` per path and slack, beside
    the host's CPU: live, each of 200 solves in a closed loop whose
    window moves every step (the per-step cost a deployment pays), and
    re-solving one window 200 times (``bench.py``'s real-time metric;
    for CONVEX a re-solve from the warm start it converged to);
37. export and the C runtime: ``export_controller`` of both controllers
    with the plant embedded, the demo binary for T = 400 on seed-0
    noise against the port's Python loop on the same noise (NONE atol
    1e-10, CONVEX 1e-7, the last cost within 1e-6); a bad header and a
    truncated blob refused;
38. the time-parallel rollout: ``time_parallel_rollout`` on the card,
    one scenario of ``four_tank_robust`` with the main path's noise,
    T = 400, block maps at K = 1 (400 outer blocks) and K = 50 (8), in
    float32 and float64, plain and with ``four_tank_tracking``'s
    schedule: float64 against the sequential
    ``linear_closed_loop_rollout`` in float64 (u, y, final state 1e-9;
    costs rtol 1e-7), float32 max |du| < 1e-4 against float64; ms per
    trajectory by CUDA events after a warm-up, in turns with the
    sequential engine at B = 1, and the kernels and copies launched per
    call of each (the host's launch records in ``torch.profiler``, three
    calls, one for the sequential engine at K = 1, after a discarded
    warm-up call, in each of two sessions; ``device_kernels``);
39. the device ops on the paper's data on the card: ``hankel_matrix``
    bit-equal to the host's, ``matrix_rank`` and
    ``evaluate_persistent_excitation`` equal to the host's, the
    initial-state observer's round trip (1e-8), the equilibrium pair
    (1e-10) and ``lti_rollout`` against ``LTIModel.simulate`` (1e-10),
    in float64; given numpy and no device, the ops run on the card.

Then the multi-device path on ``torch.distributed`` (no kernel of its
own: K1 and K4 run per shard), right after phase 39 and before phase
19's convolution (phase 42 counts the host's launch records in
``torch.profiler``):

40. ``bench.py``'s ``sharded`` configuration (l.798-906) on a world of
    one NCCL rank, ``make_scenario_mesh()``: the four-tank Robust
    controller at B = 16384 x T = 400 (its noise's first 4096 rows are
    the main path's, bit for bit) through ``make_sharded_fused_rollout``
    (K1), plain and with ``four_tank_tracking``'s schedule per scenario
    (a shared schedule refused), ``four_tank_convex`` at B = 65536 x
    T = 400 through ``make_sharded_fused_admm_rollout`` (K4, the ADMM
    state included), and the classic engine (K = 100) with in-scan
    noise through ``make_sharded_linear_rollout``: each bit-equal to its
    unsharded run, the metrics equal to the unsharded result's; K1 and
    K4 sharded and unsharded timed in turns by CUDA events, and the
    metrics' ``all_reduce``;
41. two ranks on the one card: gloo, the collectives of CUDA tensors
    staged through host memory by design; the ranks started by
    ``torch.multiprocessing`` (``spawn``) on a ``FileStore`` in a
    temporary directory, each ending its group; the card's compute mode
    printed first. ``make_mesh_rollout`` with the four-tank
    ``SolutionMap`` at B = 4096 x T = 400 on (2, 1) and (1, 2) meshes,
    data-parallel and on (1, 2) model-parallel, and with the ADMM
    (CONVEX, c = 1, 16 iterations), box-ladder (|u| <= 0.85, cap 120)
    and NON_CONVEX (c = 0.05, 4 x 16) solvers at B = 4096 with T cut to
    40: the concatenated shards against this process's run (u, y within
    2e-5, metrics rtol 1e-5); ``global_scenario_indices`` and the noise
    of both ranks against one process's draw (bit-equal);
42. the alpha-sharded PMINRES on the four-tank Robust spec (nz 571, nc
    168), on the one-rank NCCL mesh and on phase 41's two ranks (1, 2):
    a float64 solve at tol 1e-10 against the exact operator (atol 1e-6),
    a float32 solve with one refinement restart against it (1e-4, one
    rank), ``make_distributed_closed_loop`` at B = 64 in float64 (tol
    1e-11) against the generic loop with the exact map (u within 1e-7;
    T cut from 40 to 8 on one rank and to 1 on two); ms and iterations
    per solve, the device kernels per MINRES iteration
    (``torch.profiler``); CONVEX slack refused.

Then the edges of the system, the example CLIs, the paper reproduction
and the top-level entry points, at the CLIs' own defaults, their configs
built here (``example_configs``: the two YAML files' values; whether
PyYAML and matplotlib are importable is printed, no step needs them; no
figure is drawn):

43. the example pipelines (``direct_data_driven_mpc_tpu_torch.examples``):
    the direct example, T = 401 (``--t_sim 400``, seed 0, n = 4 inputs
    applied per solve), on the host loop and the ``kernel``, ``linear``
    and ``fused`` engines, K1 launched once at B = 1 and its U, Y and
    final state against the plain version (bit-equal, or within 2e-5
    with the reason printed), each device engine within 1e-4 of the host
    loop in float64, the ``fused`` CONVEX variant against the host's
    CONVEX loop (1e-4) and the ``--u_min/--u_max`` box at 0.85 (|u|
    checked); K1's and the plain version's ms per rollout at B = 1 by
    CUDA events; Monte Carlo at 4096 x 200 (the classic engine, in-loop
    noise; stable, finite); setpoint tracking at 512 x 400, K = 25 (K1
    launched once, U, Y and final state against the plain version as
    above, u within 1e-4 of the generic loop with the schedule per
    solve); tuning at 8 x 80 with 25 Adam steps (the loss lowered);
44. the paper reproduction: the three schemes at t_sim 600, seed 4, on
    the host, y_0 forced to 0.4; the final output errors;
45. the top-level entry points (``direct_data_driven_mpc_tpu_torch.entry``):
    ``entry()``'s step on the card against the generic loop's first step
    (2e-5), and ``dryrun_multichip(2)``, two gloo ranks sharing the card,
    each check of ``__graft_entry__.py`` passed and K1 and K4 launched in
    the ranks. Host-clock seconds throughout (the pipelines include
    their controller builds).

Then every shape the JAX package's engine tests take, after phase 21
(neither phase reads ``torch.profiler``):

46. the seven random shapes of tests/test_random_dims.py
    (``RANDOM_DIMS``: m and p of 1 to 3, ns != n, n_mpc_step of 1 to 5,
    NOMINAL and UCON), each at B = 4096 x T = 400 from its seed: K1 at
    K = 2 and at ``suggest_solves_per_block``'s K, launched once each
    through ``make_fused_batched_rollout``, U, Y and the final state
    against the plain version (bit-equal, or within 2e-5 with the reason
    printed; costs rtol 1e-3, atol 1e-5); K3 (``cost_mode="post"``) at
    1e-4, its post-pass costs at rtol 1e-3 / atol 1e-2; K4 on the ROBUST
    shapes with CONVEX slack and K5 on all seven with the box |u| <=
    0.85, each launched once, against the plain version as above, their
    residual lanes within 2e-5 (a converged flag may differ only where
    the two residuals fall on either side of the tolerance), K5's rung
    lanes equal; each kernel's max |du| against its float64 plain
    version (64 scenarios) below 1e-4, beside the plain version's; ms per
    rollout of each kernel and its plain version by CUDA events, in
    turns;
47. ``bench.py``'s ``long_horizon`` (l.1002-1004: N = 800, L = 60, nz
    1121) through K1 at B = 65536 x T = 400, launched once, U, Y and the
    final state bit-equal to the plain version, max |du| against float64
    (64 scenarios) below 1e-4, ms per rollout and solves/s of the
    amortized run and its plain version in turns; and
    ``long_horizon_convex`` (l.936-949: CONVEX, nbox 120) through K4 at
    B = 65536 x T = 400 against its plain version (atol 2e-5), both timed
    in turns.

Then the constrained engines at ``large_plant``, where the resident plans
of K4 and K5 do not fit one block (after phase 47; it reads no
``torch.profiler``):

48. ``large_plant_convex`` (CONVEX slack, nbox 300, iters (4, 30, 4),
    cold 200, tol 1e-4) through the wide body K4w and
    ``large_plant_ladder`` (the box |u| <= 0.85 with the default 7-rung
    ladder, nbox 200, bench's ladder iterations) through K5w, each at
    B = 16384 x T = 400: the route (the wide launch count 1, the
    resident 0), the tile and shared memory checked against
    ``admm_wide_plan`` / ``ladder_wide_group``, registers and spill
    bytes; against the plain version (``compare_admm_at_rounding``) u,
    y, the final windows, s, w and the residual lanes within 2e-5
    (bit-equal printed as such), costs at rtol 1e-3 / atol 1e-2, a
    converged flag differing only where a residual straddles tol, K5's
    rung lanes and final rungs equal; the converged fraction; the
    kernel's max |du| against float64 (64 scenarios) no more than 2e-5
    above the plain version's; ms per rollout of the kernel and of the
    plain version, each alone, in turns, beside ``admm_bound``'s bound
    and the share of it reached; the ring's stages, the padded rows, the
    blocks the card holds at once, and the panel bytes the design reads
    over the kernel's time (derived).
    Then, at ``four_tank_convex`` and ``four_tank_ladder`` (B = 65536 x
    T = 400), the wide body through the library's launcher against the
    resident one at the same bar (costs at atol 1e-5), both timed in
    turns: why the resident body keeps the shapes it takes.

Then the last options the port took from the JAX package (after phase
48; it reads no ``torch.profiler``):

49. the classic engine's Monte-Carlo aggregate mode at ``bench.py``'s
    ``large_plant`` classic configuration (l.971-992: the plant of phase
    18, K = 50, B = 65536 x T = 400, noise drawn in the block loop from a
    generator at the plant's eps_max): ``make_linear_batched_rollout``
    with ``emit_trajectories=False`` and ``True``, costs, converged
    flags, final state and windows bit-equal, u and y empty ``(B, 0,
    10)`` in the first; each run's peak device memory and ms per rollout
    (CUDA events, in turns); then the ladder's ``balance_ratio``
    through its kernels, each launched once with its counts read: K5 at
    ``four_tank_ladder`` (phase 14's shape) at 5.0 and 7.3 (not exact in
    float32), on its box |u| <= 0.85 and on phase 16's |u| <= 3, K5w at
    ``large_plant_ladder`` (phase 48's shape) at 20.0, each bit-equal to
    its plain version at that ratio (u, y, the final windows, s, w, the
    residual and rung lanes, the final rungs), the rung lanes that differ
    from the default ratio's kernel run counted (at least one, except at
    |u| <= 0.85, where every group climbs to the top rung at any of these
    ratios), and its converged fraction from solve 10 printed beside the
    default's.

The profiled checks (phases 4, 23, 26, 30, 35, 38, 42) rest on the host's
launch records, which ``torch.profiler`` keeps. The device's own records,
which a session can lose in part or in whole (more the more sessions the
process has run), feed only printed numbers (K1's kernel names, busy shares, a trace's kernel events), each
beside the session's record and launch counts, or printed as not read
(``session_records``).

The script sets ``torch.set_float32_matmul_precision("high")`` first,
as a user's process might: the port scopes IEEE float32 to its
parity-bound paths (``ops/precision.py``), the library yardsticks are
timed inside the same guard, and at the end the caller's setting must
read back.

Any failed check raises. Run from the repository root:
``python3 chip_smoke.py``. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it the kernels'
record, each with its time beside its bound: the least time the card
could take for the same work, the larger of the bytes it must move over
3.35 TB/s and its operations over the peak rate of their type (float32
over 67 TFLOP/s; K3's three TF32 passes over 495 TFLOP/s, its float32
bound kept beside it), the H100 SXM's published peaks at 700 W.
"""

from __future__ import annotations

import collections
import ctypes
import json
import math
import os
import platform
import re
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

FOUR_TANK = dict(
    A=np.array(
        [
            [0.921, 0, 0.041, 0],
            [0, 0.918, 0, 0.033],
            [0, 0, 0.924, 0],
            [0, 0, 0, 0.937],
        ]
    ),
    B=np.array([[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]]),
    C=np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]]),
    D=np.zeros((2, 2)),
    eps_max=0.002,
)
KERNELS = ("fused_rollout", "fused_admm")  # kernel libraries (sources)
B_MAIN, T_MAIN = 4096, 400
B_ADMM, T_ADMM = 65536, 400  # bench.py's fused ADMM batch
B_VARIANT = 8192  # the ADMM variants' batch
ATOL = 2e-5  # u, y and state (tests/test_pallas_rollout.py)
COST_RTOL, COST_ATOL = 1e-3, 1e-5
# large_plant's costs: each is a small difference of terms near 1e3, so
# summation order alone (the post-pass against its in-kernel costs on the
# same float32 trajectories), or trajectories a few 1e-5 apart (K3's
# against the plain version's), move it by a few 1e-3.
POST_COST_ATOL = 1e-2
NORTH_STAR = 1e-4  # max |du| against float64
# bench.py's fused ADMM iterations: four_tank_convex's (K4) and
# four_tank_ladder's (K5).
CONVEX_KW = dict(iters=(4, 5, 2), cold_iters=24, tol=1e-5)
LADDER_KW = dict(iters=(0, 16, 4), cold_iters=80, tol=2e-5)
# K3 against its plain version: its 3xTF32 products sum in another order
# than cuBLAS, and large_plant's float32 paths sit 2e-5 to 3e-5 from
# float64 (tests/test_torch_cuda.py holds K3 at the same bar).
K3_ATOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, 700 W
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12  # TF32 on the tensor cores, dense


def bound(flops: float, nbytes: float,
          flop_per_s: float = FP32_FLOP_PER_S) -> dict:
    """The least time for ``flops`` operations at ``flop_per_s`` that
    must move ``nbytes`` of device memory, and which of the two sets
    it."""
    t_ops = flops / flop_per_s * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def log(msg: str) -> None:
    print(msg, flush=True)


def build_four_tank_robust(N: int = 400, L: int = 30, seed: int = 0,
                           slack: str = "NONE", c: float = 1.0,
                           allow_nonconvex_slack: bool = False,
                           solve_path=None):
    """The four-tank Robust controller as ``bench.py`` builds it:
    uniform input data, bounded measurement noise, slack NONE (or
    CONVEX, as its fused ADMM configurations build it, or NON_CONVEX at
    c = 0.05, opted in, as ``four_tank_nonconvex`` builds it); its
    per-step solve on ``solve_path`` (None: the controller's default)."""
    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel

    m, p = 2, 2
    rng = np.random.default_rng(seed)
    plant = LTIModel(**FOUR_TANK)
    eps = plant.get_eps_max()
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = eps * rng.uniform(-1, 1, (N, p))
    y_d = plant.simulate(u_d, w_d, N)
    ctrl = DirectDataDrivenMPCController(
        m=m, p=p, u_d=u_d, y_d=y_d,
        **four_tank_params(eps, L, slack, c),
        allow_nonconvex_slack=allow_nonconvex_slack, solve_path=solve_path,
    )
    return plant, ctrl


def four_tank_params(eps: float, L: int = 30, slack: str = "NONE",
                     c: float = 1.0) -> dict:
    """The four-tank Robust controller's parameter dict (the keys of
    ``utils.config.get_data_driven_mpc_controller_params``, as
    ``control.creation.create_data_driven_mpc_controller`` takes them)
    with ``bench.py``'s values: n = 4, one input applied per solve."""
    from direct_data_driven_mpc_tpu_torch.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    return dict(
        n=4, L=L, Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=eps, lamb_alpha=0.1 / max(eps, 1e-12), lamb_sigma=1000.0,
        c=c, slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )


def example_configs():
    """``(plant, controller dict)``: the example CLIs' defaults,
    ``examples/config/models/four_tank_system_params.yaml`` and
    ``examples/config/controllers/data_driven_mpc_example_params.yaml``
    as ``LTISystemModel`` and ``get_data_driven_mpc_controller_params``
    load them (Algorithm 2: n inputs applied per solve), built here
    because the card's machine may lack PyYAML
    (tests/test_torch_examples.py holds the two equal). A new plant each
    call: the pipelines move its state."""
    from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
    from direct_data_driven_mpc_tpu_torch.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    n, L, m, p, eps = 4, 30, 2, 2, 0.002
    return LTIModel(**FOUR_TANK), dict(
        u_range=[-1, 1], N=400, n=n, eps_max=eps, L=L,
        Q=3 * np.eye(p * L), R=0.0001 * np.eye(m * L),
        lamb_alpha=0.1 / eps, lamb_sigma=1000, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=n,
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
    )


def build_large_plant(N: int = 600, L: int = 30, seed: int = 0,
                      slack: str = "NONE"):
    """``bench.py``'s ``large_plant``: ``random_stable_lti(seed=0, ns=10,
    m=10, p=10)``, u_s = 0.5, y_s its equilibrium output, uniform input
    data and bounded noise from ``default_rng(seed)``, Robust, slack
    NONE (or ``slack``, a ``SlackVarConstraintTypes`` name)."""
    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_tpu_torch.models.random_lti import (
        random_stable_lti,
    )
    from direct_data_driven_mpc_tpu_torch.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    n = m = p = 10
    plant = random_stable_lti(seed=0, ns=n, m=m, p=p)
    eps = plant.get_eps_max()
    u_s = 0.5 * np.ones((m, 1))
    y_s = plant.get_equilibrium_output_from_input(u_s.ravel()).reshape(-1, 1)
    rng = np.random.default_rng(seed)
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = eps * rng.uniform(-1, 1, (N, p))
    y_d = plant.simulate(u_d, w_d, N)
    ctrl = DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L), u_s=u_s, y_s=y_s,
        eps_max=eps, lamb_alpha=0.1 / max(eps, 1e-12), lamb_sigma=1000.0,
        c=1.0, slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    return plant, ctrl


#: The seven shapes of tests/test_random_dims.py:38-47, as it lists them:
#: (seed, ns, n, m, p, L, n_mpc_step, controller type, terminal
#: constraint); the last two are UCON (no terminal constraint).
RANDOM_DIMS = (
    (0, 3, 3, 1, 1, 8, 1, "ROBUST", True),
    (1, 5, 4, 2, 3, 9, 3, "ROBUST", True),
    (2, 2, 2, 3, 1, 6, 1, "NOMINAL", True),
    (3, 6, 5, 1, 2, 11, 5, "ROBUST", True),
    (4, 4, 3, 2, 2, 7, 2, "NOMINAL", True),
    (5, 4, 4, 2, 2, 9, 1, "ROBUST", False),
    (6, 3, 3, 1, 2, 8, 3, "ROBUST", False),
)
RANDOM_DIMS_BOX = 0.85  # K5's input box |u| <= 0.85 at every shape


def random_dims_data(case):
    """``(plant, controller keywords, rng)`` of one shape of
    ``RANDOM_DIMS``, made from its seed as tests/test_random_dims.py
    makes them: ``random_stable_lti(seed, ns, m, p)`` at spectral radius
    0.85, uniform input data and noise of 0.002, u_s = 0.3, y_s its
    equilibrium output. ``rng`` has drawn the data; its next draw is the
    closed loop's noise."""
    from direct_data_driven_mpc_tpu_torch.models.random_lti import (
        random_stable_lti,
    )

    seed, ns, n, m, p, L, n_mpc_step, _, terminal = case
    rng = np.random.default_rng(seed)
    plant = random_stable_lti(seed=seed, ns=ns, m=m, p=p,
                              spectral_radius=0.85)
    N = m * (L + 2 * n) + L + 2 * n - 1 + 10
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    y_d = plant.simulate(u_d, w_d, N)
    u_s = 0.3 * np.ones((m, 1))
    y_s = plant.get_equilibrium_output_from_input(u_s.ravel()).reshape(-1, 1)
    return plant, dict(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L, Q=3.0 * np.eye(p * L),
        R=1e-4 * np.eye(m * L), u_s=u_s, y_s=y_s, eps_max=0.002,
        lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0, n_mpc_step=n_mpc_step,
        use_terminal_constraint=terminal,
    ), rng


def build_random_dims(case, slack: str = "NONE"):
    """``(plant, controller)`` of one shape of ``RANDOM_DIMS`` in the
    port, with ``slack`` (CONVEX for K4, on the ROBUST shapes)."""
    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_tpu_torch.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    plant, kw, _ = random_dims_data(case)
    return plant, DirectDataDrivenMPCController(
        **kw, slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType[case[7]],
    )


def random_dims_label(case) -> str:
    seed, ns, n, m, p, L, nb, ctype, terminal = case
    return (f"case {seed} (ns={ns} n={n} m={m} p={p} L={L} nb={nb} "
            f"{ctype} {'TEC' if terminal else 'UCON'})")


def scenario_batch(plant, ctrl, B, device, dtype=torch.float32):
    """Every scenario starts from the plant's state after the data run
    and the controller's initial window (as in ``bench.py``)."""
    def tile(a, shape):
        return torch.as_tensor(a, dtype=dtype, device=device).reshape(
            shape
        ).expand(B, *shape[1:]).contiguous()

    return (
        tile(plant.get_state(), (1, -1)),
        tile(ctrl.u_past, (1, ctrl.n, ctrl.m)),
        tile(ctrl.y_past, (1, ctrl.n, ctrl.p)),
    )


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check_close(name, got, want, atol, rtol=0.0):
    """Raise unless |got - want| <= atol + rtol |want| everywhere."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    excess = (got.double() - want.double()).abs() - (
        atol + rtol * want.double().abs()
    )
    worst = float(excess.max())
    if worst > 0:
        raise AssertionError(
            f"{name}: exceeds atol {atol} rtol {rtol} by {worst:.3e} "
            f"(max |diff| {max_abs(got, want):.3e})"
        )
    return max_abs(got, want)


def time_amortized(run, args, seconds=1.0, min_reps=8):
    """Milliseconds per rollout of an amortized ``run(*args, R)``, by
    CUDA events, after a warm-up; R (at least ``min_reps``) is chosen
    to fill ~``seconds``."""
    def timed(R):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        checksum, ok = run(*args, R)
        end.record()
        torch.cuda.synchronize()
        if not bool(ok):
            raise AssertionError(f"non-finite checksum {float(checksum)}")
        return start.elapsed_time(end) / R

    per = timed(2)  # warm-up, and a first estimate
    R = max(min_reps, min(4000, math.ceil(seconds * 1e3 / per)))
    return timed(R), R


#: The CUDA runtime and driver calls that start device work, as
#: ``torch.profiler`` records them on the host: kernel launches, then
#: copies and fills.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
COPY_CALLS = ("cudaMemcpy", "cudaMemcpyAsync", "cudaMemset",
              "cudaMemsetAsync")


class Session(NamedTuple):
    """What one ``torch.profiler`` session recorded of the device work it
    saw start (:func:`session_records`).

    ``launches`` and ``copies`` are the host's kernel launch and copy or
    fill calls, the evidence every check rests on; ``kernel_records`` and
    ``copy_records`` the device's own records matched to them, ``names``
    the kernel records by kernel name and ``ms`` the matched records'
    device milliseconds by name; ``complete`` says that each launch and
    each copy has its one device record, and only then are ``names`` and
    ``ms`` the whole of the session's device work. ``stray`` counts the
    device records of no call in the session (matched by correlation id;
    0 when matched by count)."""

    launches: int
    copies: int
    kernel_records: int
    copy_records: int
    names: collections.Counter
    ms: dict
    complete: bool
    matched_by: str
    stray: int = 0

    def counts(self) -> str:
        """The device records against the host's calls, for a printed
        line."""
        return (f"device records: {self.kernel_records} of {self.launches} "
                f"kernel launches, {self.copy_records} of {self.copies} "
                f"copies, {self.stray} of no call in the session (matched "
                f"by {self.matched_by})")


def session_records(events) -> Session:
    """Read one profiler session's events (``prof.events()``): the host's
    launch and copy calls (``LAUNCH_CALLS``, ``COPY_CALLS``, recorded
    on the host, never lost) and the device's records of them, which a
    session can lose in part or in whole, more the more sessions the
    process has run (``PERF.md`` §7).

    A device record is matched to its call by correlation id, which
    torch gives a runtime call and the device record it started alike
    (``FunctionEvent.id``), where every host call carries a distinct
    positive one; else by count, copies told from kernels by name
    (``Memcpy``/``Memset``). The per-step ``ProfilerStep*`` marker on
    the device track is no record of a call. Raises only if the host
    shows no device work."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name in LAUNCH_CALLS + COPY_CALLS]
    launches = sum(e.name in LAUNCH_CALLS for e in host)
    copies = len(host) - launches
    if not host:
        raise AssertionError("the profiled calls issued no device work")
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("ProfilerStep")]
    ids = [getattr(e, "id", 0) for e in host]
    by_id = all(isinstance(i, int) and i > 0 for i in ids) \
        and len(set(ids)) == len(ids)
    stray = 0
    if by_id:
        kind = {e.id: e.name in LAUNCH_CALLS for e in host}
        stray = len(device)
        device = [e for e in device if getattr(e, "id", 0) in kind]
        stray -= len(device)
        is_kernel = [kind[e.id] for e in device]
        whole = all(n == 1 for n in
                    collections.Counter(e.id for e in device).values())
    else:
        is_kernel = [not e.name.startswith(("Memcpy", "Memset"))
                     for e in device]
        whole = True
    kernel_records = sum(is_kernel)
    copy_records = len(device) - kernel_records
    names, ms = collections.Counter(), {}
    for e, kernel in zip(device, is_kernel):
        name = (re.findall(r"\w+_kernel\b", e.name) or [e.name])[0]
        if kernel:
            names[name] += 1
        ms[name] = ms.get(name, 0.0) + e.device_time_total / 1e3
    return Session(launches, copies, kernel_records, copy_records, names,
                   ms, whole and (kernel_records, copy_records)
                   == (launches, copies),
                   "correlation id" if by_id else "count", stray)


def profile_session(fn, calls: int = 1, warmup: int = 0) -> tuple:
    """``(Session, wall ms, fn()'s last result)``: ``calls`` calls of
    ``fn()`` under one ``torch.profiler`` session (CPU and CUDA
    activity), after ``warmup`` calls the session discards (the
    profiler's own ``warmup`` step), each call waited for; the wall time
    is the host's clock over the recorded calls."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    steps = schedule(wait=0, warmup=warmup, active=calls, repeat=1) \
        if warmup else None
    wall = 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=steps) as prof:
        for i in range(warmup + calls):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            if i >= warmup:
                wall += (time.perf_counter() - t0) * 1e3
            if steps is not None:
                prof.step()
    return session_records(prof.events()), wall, out


def admm_config(name: str):
    """``(plant, controller, operator, engine keywords)`` of one fused
    ADMM configuration as ``bench.py`` (``run_fused_admm_config``)
    builds it: seed 0, four-tank Robust, N = 400, L = 30 unless named
    otherwise."""
    from direct_data_driven_mpc_tpu_torch.qp.admm import (
        compute_admm_operator_np,
    )
    from direct_data_driven_mpc_tpu_torch.qp.box import (
        compute_box_admm_operator_np,
    )

    if name == "four_tank_box":
        # Slack NONE with a saturated input box at the fixed rho = 1.
        plant, ctrl = build_four_tank_robust()
        op = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-0.85, 0.85), rho=1.0
        )
        return plant, ctrl, op, dict(iters=(0, 14, 4), cold_iters=60,
                                     tol=2e-5)
    if name.startswith("four_tank_ladder"):
        # The default 7-rung ladder from the middle rung (balance ratio
        # 10); "four_tank_ladder_u3" loosens the box to |u| <= 3.
        plant, ctrl = build_four_tank_robust()
        u = 3.0 if name.endswith("_u3") else 0.85
        op = compute_box_admm_operator_np(ctrl.spec, u_bounds=(-u, u))
        return plant, ctrl, op, dict(LADDER_KW)
    N, L = {"four_tank_convex_q4": (400, 15),
            "long_horizon_convex": (800, 60)}.get(name, (400, 30))
    plant, ctrl = build_four_tank_robust(N=N, L=L, slack="CONVEX")
    track = name == "four_tank_admm_tracking"
    op = compute_admm_operator_np(ctrl.spec, return_setpoint_maps=track)
    kw = dict(CONVEX_KW)
    if track:
        # Four phases around the baked setpoints (scaling an equilibrium
        # pair keeps it an equilibrium).
        phases = np.array([1.0, 0.85, 1.1, 0.95])
        kw.update(iters=(4, 6, 2), setpoints=np.repeat(
            phases[:, None] * op["r_bar"][None], T_ADMM // 4, axis=0
        ))
    return plant, ctrl, op, kw


def compare_admm(tag, got, want):
    """Kernel against plain version: u, y, final windows and ADMM state
    within ``ATOL``, costs within ``COST_RTOL``/``COST_ATOL``, converged
    flags equal. Returns the largest |diff| off the costs and on them."""
    errs = [
        check_close(f"{tag} {f}", getattr(got, f), getattr(want, f), ATOL)
        for f in ("u_sys", "y_sys", "x_final", "u_past", "y_past")
    ]
    errs += [
        check_close(f"{tag} solver_state.{f}", a, b, ATOL)
        for f, a, b in zip(("s", "w"), got.solver_state, want.solver_state)
    ]
    err_c = check_close(f"{tag} costs", got.costs, want.costs, COST_ATOL,
                        COST_RTOL)
    if not torch.equal(got.converged, want.converged):
        raise AssertionError(f"{tag}: converged flags differ")
    return max(errs), err_c


def admm_phases(dev, smi) -> dict:
    """Phases 8-12: the fused ADMM closed loop through kernel K4.
    Returns its record for the ``kernels`` line."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    # 8. Host build of four_tank_convex and its fused operators.
    t0 = time.perf_counter()
    plant, ctrl, op, kw = admm_config("four_tank_convex")
    if (ctrl.spec.nz, ctrl.spec.nc) != (571, 168):
        raise AssertionError(
            f"QP dims {ctrl.spec.nz}, {ctrl.spec.nc} != 571, 168"
        )
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops, dims = fa.build_fused_admm_operator(plant.as_params(), op, ctrl.n,
                                             ctrl.m, ctrl.p, device=dev)
    sizes = (dims.S, dims.nb * dims.m, dims.nb * dims.p, dims.nbox,
             dims.nxi)
    lib = _kernels.load("fused_admm").lib
    tile = lib.fused_admm_tile_rows(*sizes, B_ADMM)
    smem = lib.fused_admm_smem_bytes(*sizes, B_ADMM)
    plan = fa.admm_plan(dims, B_ADMM, fa.sm_count(dev))
    if (tile, smem) != plan:
        raise AssertionError(f"K4 plan: library ({tile}, {smem}) vs Python "
                             f"{plan}")
    per_sm = lib.fused_admm_blocks_per_sm(*sizes, B_ADMM)
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.fused_admm_kernel_attributes(dims.nbox, 8, ctypes.byref(regs),
                                           ctypes.byref(local))
    if per_sm < 1 or err:
        raise AssertionError(f"K4 occupancy {per_sm}, attributes error "
                             f"{err}")
    log(f"ADMM host build: four_tank_convex nz={ctrl.spec.nz} "
        f"nc={ctrl.spec.nc}, first solve {ctrl.get_problem_solve_status()}"
        f", {t_host:.2f} s; fused operators Vop "
        f"{tuple(ops.Vop.shape)}, M1 {tuple(ops.M1.shape)}, M2 "
        f"{tuple(ops.M2.shape)} in {time.perf_counter() - t0:.2f} s; "
        f"kernel tile {tile} scenarios (warp-owned, s and w in "
        f"registers), {smem} B of shared memory per block")
    log(f"K4 occupancy: {per_sm} blocks per SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
        f"{regs.value} registers and {local.value} local (spill) bytes per "
        f"thread (cudaFuncGetAttributes)")

    def inputs(plant, ctrl, B, T=T_ADMM, seed=0):
        Ws = draw_noise_batch(seed, B, T, ctrl.p, plant.get_eps_max(),
                              device=dev)
        return (*scenario_batch(plant, ctrl, B, dev), Ws)

    def rollouts(plant, ctrl, op, T=T_ADMM, **kw):
        """The kernel's and the plain version's rollouts."""
        args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T)
        return (
            fa.make_fused_admm_rollout(*args, device=dev, **kw),
            fa.make_fused_admm_rollout(
                *args, device=dev, rollout=fa.fused_admm_reference, **kw
            ),
        )

    # 9. The main path, through the kernel.
    ins = inputs(plant, ctrl, B_ADMM)
    run_k, run_p = rollouts(plant, ctrl, op, **kw)
    fa.fused_admm.launches = 0
    res = run_k(*ins)
    torch.cuda.synchronize()
    main_launches = fa.fused_admm.launches
    if main_launches < 1:
        raise AssertionError("the ADMM main path launched no kernel")
    if res.u_sys.shape != (B_ADMM, T_ADMM, 2) or res.costs.shape != (
        B_ADMM, T_ADMM
    ):
        raise AssertionError(f"ADMM main-path shapes "
                             f"{tuple(res.u_sys.shape)} "
                             f"{tuple(res.costs.shape)}")
    if not bool(res.converged.all()):
        raise AssertionError(
            f"ADMM main path: {float((~res.converged).float().mean()):.2e}"
            " of the solves did not converge"
        )
    log(f"ADMM main path: four_tank_convex B={B_ADMM} T={T_ADMM}, "
        f"iters {kw['iters']} + cold {kw['cold_iters']}, fused_admm "
        f"launches {main_launches}, all {B_ADMM * T_ADMM} solves converged")
    kernel_err, err_c = compare_admm("four_tank_convex kernel vs plain",
                                     res, run_p(*ins))
    log(f"ADMM kernel vs plain (B={B_ADMM}, T={T_ADMM}): max |diff| on "
        f"u, y, state and solver state {kernel_err:.3e} (atol {ATOL}); "
        f"costs {err_c:.3e} (rtol {COST_RTOL}, atol {COST_ATOL}); "
        "converged flags equal")

    # 10. Float64 truth for the first 64 scenarios.
    run64 = fa.make_fused_admm_rollout(
        plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T_ADMM, device=dev,
        dtype=torch.float64, rollout=fa.fused_admm_reference, **kw,
    )
    u64 = run64(*(a[:64].double() for a in ins)).u_sys
    du = max_abs(res.u_sys[:64], u64)
    if not du < NORTH_STAR:
        raise AssertionError(f"ADMM max |du| vs float64 {du:.3e} >= 1e-4")
    log(f"ADMM float64 truth (64 scenarios): kernel max |du| {du:.3e} "
        f"(< {NORTH_STAR})")

    # 11. Variants, each through the kernel and against the plain version.
    def variant(tag, run_pair, args):
        before = fa.fused_admm.launches
        got = run_pair[0](*args)
        torch.cuda.synchronize()
        if fa.fused_admm.launches != before + 1:
            raise AssertionError(f"{tag} did not go through the kernel")
        err, err_c = compare_admm(tag, got, run_pair[1](*args))
        log(f"ADMM variant {tag}: max |diff| {err:.3e}, costs "
            f"{err_c:.3e}, converged {float(got.converged.float().mean())}")
        return got

    for name in ("four_tank_box", "four_tank_admm_tracking"):
        p_v, c_v, op_v, kw_v = admm_config(name)
        got = variant(f"{name} B={B_VARIANT}", rollouts(p_v, c_v, op_v,
                                                        **kw_v),
                      inputs(p_v, c_v, B_VARIANT))
        if name == "four_tank_box":
            u_max = float(got.u_sys.abs().max())
            if u_max > 0.85 + 1e-6:
                raise AssertionError(f"box violated: max |u| {u_max}")
            log(f"  box respected: max |u| {u_max:.6f} <= 0.85")
    ins_v = tuple(a[:B_VARIANT] for a in ins)
    variant(f"n_mpc_step=4 B={B_VARIANT}",
            rollouts(plant, ctrl, op, n_mpc_step=4,
                     **dict(kw, iters=(4, 8, 2))), ins_v)
    B_r = B_VARIANT - 13
    variant(f"ragged B={B_r}", (run_k, run_p),
            tuple(a[:B_r] for a in ins))
    # Segmented: two halves, the second warm-started through
    # solver_state0. The second half derives its first solve's maps from
    # the carried state (the Gpre product) where the uninterrupted run
    # takes them from the in-kernel plant product, so the two differ by
    # float32 rounding, which the closed loop carries: that is held to
    # the float64 bar, the kernel to the plain version at atol 2e-5.
    half = T_ADMM // 2
    first = rollouts(plant, ctrl, op, T=half, **kw)
    second = rollouts(plant, ctrl, op, T=half, **dict(kw, cold_iters=0))
    segs = []
    for i in (0, 1):
        seg1 = first[i](*ins_v[:3], ins_v[3][:, :half])
        segs.append((seg1, second[i](
            seg1.x_final, seg1.u_past, seg1.y_past, ins_v[3][:, half:],
            solver_state0=seg1.solver_state,
        )))
    seg_err = max(compare_admm(f"segmented half {h}", segs[0][h],
                               segs[1][h])[0] for h in (0, 1))
    full = run_k(*ins_v)
    du_seg = max_abs(torch.cat([s.u_sys for s in segs[0]], 1), full.u_sys)
    if not du_seg < NORTH_STAR:
        raise AssertionError(f"segmented vs uninterrupted max |du| "
                             f"{du_seg:.3e} >= {NORTH_STAR}")
    dy_seg = max_abs(torch.cat([s.y_sys for s in segs[0]], 1), full.y_sys)
    log(f"ADMM variant segmented ({half} + {half} steps through "
        f"solver_state0) B={B_VARIANT}: kernel vs plain max |diff| "
        f"{seg_err:.3e}; vs the uninterrupted run max |du| {du_seg:.3e} "
        f"(< {NORTH_STAR}), |dy| {dy_seg:.3e}")
    for name in ("four_tank_convex_q4", "long_horizon_convex"):
        p_v, c_v, op_v, kw_v = admm_config(name)
        n_box = op_v["v_c"].shape[0]
        variant(f"{name} (nbox {n_box}) B=4096",
                rollouts(p_v, c_v, op_v, **kw_v), inputs(p_v, c_v, 4096))
    # four_tank_convex at 4096 x 400 (the benchmark's convex.b4096 cell):
    # a batch too small for 64-scenario blocks to fill the card, so K4
    # runs its half-height tile.
    B_s, sms = 4096, fa.sm_count(dev)
    small = (fa.admm_plan(dims, B_s, sms)[0],
             lib.fused_admm_tile_rows(*sizes, B_s))
    if small != (fa.SMALL_TILE, fa.SMALL_TILE):
        raise AssertionError(f"K4 plan at B={B_s} on {sms} SMs: (Python, "
                             f"library) {small} scenarios a block, "
                             f"expected {fa.SMALL_TILE}")
    before = fa.fused_admm.small_tile_launches
    variant(f"four_tank_convex half-height tile ({fa.SMALL_TILE} scenarios "
            f"a block) B={B_s}", (run_k, run_p), tuple(a[:B_s] for a in ins))
    if fa.fused_admm.small_tile_launches != before + 1:
        raise AssertionError(f"four_tank_convex B={B_s}: "
                             f"{fa.fused_admm.small_tile_launches - before} "
                             "launches on the half-height tile, expected 1")

    # 12. Timing at the main shape, in turns.
    solves = B_ADMM * T_ADMM
    runs = {
        "kernel": fa.make_amortized_admm_run(
            plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T_ADMM,
            device=dev, **kw,
        ),
        "plain": fa.make_amortized_admm_run(
            plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T_ADMM,
            device=dev, rollout=fa.fused_admm_reference, **kw,
        ),
    }
    ms = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        before = fa.fused_admm.launches
        t, R = time_amortized(runs[name], ins, min_reps=4)
        launched = fa.fused_admm.launches - before
        expected = R + 2 if name == "kernel" else 0
        if launched != expected:
            raise AssertionError(f"ADMM {name}: {launched} launches, "
                                 f"expected {expected}")
        ms[name].append(t)
        log(f"ADMM timing {name}: {t:.4f} ms/rollout over R={R} -> "
            f"{solves / (t * 1e-3):,.0f} solves/s [{smi}]")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"ADMM solves/s (mean of 2 turns, four_tank_convex B={B_ADMM} x "
        f"T={T_ADMM}, {smi}): "
        + ", ".join(f"{k} {solves / (v * 1e-3):,.0f}"
                    for k, v in mean.items()))
    return {
        "name": "fused_admm",
        "route": "cuda",
        "source": "direct_data_driven_mpc_tpu_torch/ops/csrc/fused_admm.cu",
        "replaces": "direct_data_driven_mpc_tpu/ops/pallas_admm.py:702",
        "launches": main_launches,
        "max_abs_err": kernel_err,
        "ms": mean["kernel"],
        "plain_ms": mean["plain"],
        **admm_bound(ops, dims, B_ADMM, T_ADMM, sum(kw["iters"])),
        # No single PyTorch call runs a closed loop of iterative solves.
        "library_ms": None,
    }


def admm_bound(ops, dims, B, n_blocks, n_iter, extra_out_floats=0):
    """Bound of one fused ADMM rollout (K4, or K5 with its per-solve
    rung lane as ``extra_out_floats``): the products of every solve
    (``n_iter`` iterations of ``nbox x nbox``, the extraction, the plant
    step), and the noise, carries and operators read once and the
    outputs written once."""
    W1 = dims.Mw + dims.nxi
    per_solve = 2 * (n_iter * dims.nbox ** 2 + dims.nbox * W1
                     + dims.D2 * dims.W2)
    nbm, nbp = dims.nb * dims.m, dims.nb * dims.p
    carry = dims.S + dims.Mw + dims.nbox + dims.nxi + 2 * dims.nbox
    out = (nbm + nbp + 3 + extra_out_floats) * n_blocks + dims.S \
        + 2 * dims.nbox
    nbytes = 4 * B * (nbp * n_blocks + carry + out) + tensor_bytes(
        ops.Vop, ops.M1, ops.M2, ops.b2)
    return bound(per_solve * B * n_blocks, nbytes)


def compare_ladder(tag, got, want, rung_got, rung_want):
    """Ladder kernel against plain version: rung lanes equal, then as
    :func:`compare_admm`."""
    if not torch.equal(rung_got, rung_want):
        raise AssertionError(f"{tag}: rung lanes differ")
    if not torch.equal(got.solver_state.rho_idx, want.solver_state.rho_idx):
        raise AssertionError(f"{tag}: final rungs differ")
    return compare_admm(tag, got, want)


def ladder_phases(dev, smi) -> dict:
    """Phases 13-17: the penalty-ladder closed loop through kernel K5.
    Returns its record for the ``kernels`` line."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    # 13. Host build of four_tank_ladder and its stacked operators.
    t0 = time.perf_counter()
    plant, ctrl, op, kw = admm_config("four_tank_ladder")
    ops, dims = fl.build_fused_ladder_operator(
        plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, device=dev
    )
    R = ops.Vop.shape[0]
    sizes = (dims.S, dims.nb * dims.m, dims.nb * dims.p, dims.nbox,
             dims.nxi)
    lib = _kernels.load("fused_admm").lib
    tile = lib.fused_ladder_tile_rows(*sizes)
    smem = lib.fused_ladder_smem_bytes(*sizes)
    if (tile, smem) != (fl.ladder_tile_rows(dims),
                        fl.ladder_kernel_smem_bytes(dims, tile)):
        raise AssertionError(f"ladder plan: library ({tile}, {smem}) vs "
                             f"Python {fl.ladder_tile_rows(dims)}")
    per_sm = lib.fused_ladder_blocks_per_sm(*sizes)
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.fused_ladder_kernel_attributes(dims.nbox, ctypes.byref(regs),
                                             ctypes.byref(local))
    if per_sm < 1 or err:
        raise AssertionError(f"K5 occupancy {per_sm}, attributes error "
                             f"{err}")
    log(f"ladder host build: four_tank_ladder nbox={dims.nbox}, R={R} "
        f"rungs rho {float(ops.rhos[0]):.3g} .. {float(ops.rhos[-1]):.3g}"
        f", per rung Vop {tuple(ops.Vop.shape[1:])}, M1 "
        f"{tuple(ops.M1.shape[1:])}, M2 {tuple(ops.M2.shape[1:])} "
        f"({tensor_bytes(ops.Vop, ops.M1, ops.M2, ops.b2)} B stacked) in "
        f"{time.perf_counter() - t0:.2f} s; kernel tile = rung group "
        f"{tile} scenarios (group rule {fl.ladder_smem_bytes(dims, tile)} "
        f"B), {smem} B of shared memory per block (one rung resident, s "
        f"and w in registers)")
    log(f"K5 occupancy: {per_sm} blocks per SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
        f"{regs.value} registers and {local.value} local (spill) bytes per "
        f"thread (cudaFuncGetAttributes)")

    def inputs(B, T=T_ADMM, seed=0):
        Ws = draw_noise_batch(seed, B, T, ctrl.p, plant.get_eps_max(),
                              device=dev)
        return (*scenario_batch(plant, ctrl, B, dev), Ws)

    def pair(op, T=T_ADMM, **extra):
        """The kernel's and the plain version's rollouts, each keeping
        its rung lanes in ``lanes``."""
        lanes = {}

        def keep(fn, key):
            def rollout(*args):
                out = fn(*args)
                lanes[key] = out[5]
                return out
            return rollout

        args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T)
        kwx = dict(kw, device=dev, **extra)
        return (fl.make_fused_ladder_rollout(
                    *args, rollout=keep(fl.fused_ladder, "kernel"), **kwx),
                fl.make_fused_ladder_rollout(
                    *args, rollout=keep(fl.fused_ladder_reference, "plain"),
                    **kwx),
                lanes)

    # 14. The main path, through the kernel.
    ins = inputs(B_ADMM)
    run_k, run_p, lanes = pair(op)
    fl.fused_ladder.launches = 0
    res = run_k(*ins)
    torch.cuda.synchronize()
    main_launches = fl.fused_ladder.launches
    if main_launches < 1:
        raise AssertionError("the ladder main path launched no kernel")
    if res.u_sys.shape != (B_ADMM, T_ADMM, 2):
        raise AssertionError(f"ladder shapes {tuple(res.u_sys.shape)}")
    conv10 = float(res.converged[:, 10:].float().mean())
    if conv10 != 1.0:
        raise AssertionError(f"ladder: {1 - conv10:.2e} of the solves "
                             "from index 10 on did not converge")
    hist = torch.bincount(res.solver_state.rho_idx.long(), minlength=R)
    moves = int((lanes["kernel"][:, 1:] != lanes["kernel"][:, :-1]).sum())
    log(f"ladder main path: four_tank_ladder B={B_ADMM} T={T_ADMM}, iters "
        f"{kw['iters']} + cold {kw['cold_iters']}, fused_ladder launches "
        f"{main_launches}; converged: all solves from index 10, "
        f"{float(res.converged.float().mean()):.6f} of all; final rungs "
        f"{hist.tolist()} (rung 0 .. {R - 1}); {moves // tile} group rung "
        f"moves in {B_ADMM // tile} groups")
    rung_k = lanes["kernel"]
    want = run_p(*ins)
    kernel_err, err_c = compare_ladder("four_tank_ladder kernel vs plain",
                                       res, want, rung_k, lanes["plain"])
    log(f"ladder kernel vs plain (B={B_ADMM}, T={T_ADMM}): rung lanes "
        f"equal; max |diff| on u, y, state and solver state "
        f"{kernel_err:.3e} (atol {ATOL}); costs {err_c:.3e} (rtol "
        f"{COST_RTOL}, atol {COST_ATOL})")

    # 15. Float64 truth for the first 64 scenarios, in one rung group.
    run64 = fl.make_fused_ladder_rollout(
        plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T_ADMM, device=dev,
        dtype=torch.float64, rollout=fl.fused_ladder_reference,
        rung_group=tile, **kw,
    )
    u64 = run64(*(a[:64].double() for a in ins)).u_sys
    du = max_abs(res.u_sys[:64], u64)
    if not du < NORTH_STAR:
        raise AssertionError(f"ladder max |du| vs float64 {du:.3e}")
    log(f"ladder float64 truth (64 scenarios, rung group {tile}): kernel "
        f"max |du| {du:.3e} (< {NORTH_STAR})")

    # 16. A ragged batch, and a segmented run whose groups sit on
    # different rungs at the cut: at |u| <= 3 the scenarios started from
    # the mirrored window walk down the ladder on another path, and the
    # cut follows the first solve after which the groups' rungs differ.
    B_r = B_VARIANT - 13
    fl.fused_ladder.launches = 0
    got = run_k(*(a[:B_r] for a in ins))
    if fl.fused_ladder.launches != 1:
        raise AssertionError("ragged ladder run did not go through K5")
    err, _ = compare_ladder(f"ladder ragged B={B_r}", got,
                            run_p(*(a[:B_r] for a in ins)),
                            lanes["kernel"], lanes["plain"])
    log(f"ladder variant ragged B={B_r}: rung lanes equal, max |diff| "
        f"{err:.3e}")
    _, _, op2, _ = admm_config("four_tank_ladder_u3")
    x0, up, yp, W = (a[:B_VARIANT].clone() for a in ins)
    half = B_VARIANT // 2
    for a in (x0, up, yp):
        a[half:] *= -1.0
    full = pair(op2)
    whole = full[0](x0, up, yp, W)
    split = full[2]["kernel"].amin(0) != full[2]["kernel"].amax(0)
    if not bool(split.any()):
        raise AssertionError("segmented ladder run: the groups never sit "
                             "on different rungs")
    T1 = int(split.nonzero()[0]) + 1
    first = pair(op2, T=T1)
    second = pair(op2, T=T_ADMM - T1, cold_iters=0)
    segs = []
    for i in (0, 1):
        s1 = first[i](x0, up, yp, W[:, :T1])
        s2 = second[i](s1.x_final, s1.u_past, s1.y_past, W[:, T1:],
                       solver_state0=s1.solver_state)
        segs.append((s1, s2))
    rungs = segs[0][0].solver_state.rho_idx
    if int(rungs[0]) == int(rungs[-1]):
        raise AssertionError("segmented ladder run: the groups share one "
                             "rung at the cut")
    seg_err = max(compare_admm(f"ladder segment {h}", segs[0][h],
                               segs[1][h])[0] for h in (0, 1))
    du_seg = max_abs(torch.cat([s.u_sys for s in segs[0]], 1), whole.u_sys)
    if not du_seg < NORTH_STAR:
        raise AssertionError(f"segmented ladder vs uninterrupted max |du| "
                             f"{du_seg:.3e} >= {NORTH_STAR}")
    log(f"ladder variant segmented ({T1} + {T_ADMM - T1} steps, |u| <= 3, "
        f"half the scenarios mirrored) B={B_VARIANT}: groups on rungs "
        f"{sorted(set(rungs.tolist()))} at the cut; kernel vs plain max "
        f"|diff| {seg_err:.3e}; vs the uninterrupted run max |du| "
        f"{du_seg:.3e} (< {NORTH_STAR})")

    # 17. Timing at the main shape, in turns.
    solves = B_ADMM * T_ADMM
    runs = {
        name: fl.make_amortized_ladder_run(
            plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T_ADMM,
            device=dev, rollout=fn, **kw,
        )
        for name, fn in (("kernel", fl.fused_ladder),
                         ("plain", fl.fused_ladder_reference))
    }
    ms = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        before = fl.fused_ladder.launches
        t, R_t = time_amortized(runs[name], ins, seconds=0.5,
                                min_reps=4 if name == "kernel" else 2)
        launched = fl.fused_ladder.launches - before
        expected = R_t + 2 if name == "kernel" else 0
        if launched != expected:
            raise AssertionError(f"ladder {name}: {launched} launches, "
                                 f"expected {expected}")
        ms[name].append(t)
        log(f"ladder timing {name}: {t:.4f} ms/rollout over R={R_t} -> "
            f"{solves / (t * 1e-3):,.0f} solves/s [{smi}]")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"ladder solves/s (mean of 2 turns, four_tank_ladder B={B_ADMM} x "
        f"T={T_ADMM}, {smi}): "
        + ", ".join(f"{k} {solves / (v * 1e-3):,.0f}"
                    for k, v in mean.items()))
    return {
        "name": "fused_ladder",
        "route": "cuda",
        "source": "direct_data_driven_mpc_tpu_torch/ops/csrc/fused_admm.cu",
        "replaces": "direct_data_driven_mpc_tpu/ops/pallas_admm.py:1271",
        "launches": main_launches,
        "max_abs_err": kernel_err,
        "ms": mean["kernel"],
        "plain_ms": mean["plain"],
        **admm_bound(ops, dims, B_ADMM, T_ADMM, sum(kw["iters"]),
                     extra_out_floats=1),
        "library_ms": None,
    }


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn()`` by CUDA events, after one
    warm-up call; its products run in IEEE float32 (the library
    yardsticks are float32 numbers, whatever the caller allows)."""
    from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32

    with ieee_float32():
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def large_plant_phases(dev, smi) -> dict:
    """Phases 18-21: ``large_plant`` with ``cost_mode="post"`` through
    kernel K3. Returns its record for the ``kernels`` line."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
    )
    from direct_data_driven_mpc_tpu_torch.ops import _kernels
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    B, T, K = B_ADMM, T_ADMM, 25
    K50 = 50  # bench.py's other large_plant depth: K3's 32-row plan
    # 18. Host build (float64), then the block maps on the card.
    t0 = time.perf_counter()
    plant, ctrl = build_large_plant()
    if (ctrl.spec.nz, ctrl.spec.nc) != (1761, 1200):
        raise AssertionError(f"large_plant QP dims {ctrl.spec.nz}, "
                             f"{ctrl.spec.nc} != 1761, 1200")
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                             device=dev)
    op = fr._build_fused_operator(bm, include_cost=False)
    lib = _kernels.load("fused_rollout").lib
    log(f"large_plant host build: nz={ctrl.spec.nz} nc={ctrl.spec.nc} in "
        f"{t_host:.2f} s; block map K={K} and the operator without cost "
        f"columns G {tuple(op.G.shape)} in {time.perf_counter() - t0:.2f}"
        f" s; K3 plan {lib.fused_rollout_nocost_tile_rows(op.S, op.nw)} "
        f"scenarios per block, "
        f"{lib.fused_rollout_nocost_smem_bytes(op.S, op.nw)} B of shared "
        f"memory (K1's state pass would take "
        f"{fr.rollout_plan(op.S, op.nw).state_bytes} B)")
    for k in (K, K50):
        nw = op.nw // K * k
        plan = (lib.fused_rollout_nocost_tile_rows(op.S, nw),
                lib.fused_rollout_nocost_smem_bytes(op.S, nw))
        if plan != fr.nocost_plan(op.S, nw):
            raise AssertionError(f"K3 plan at K={k}: library {plan} vs "
                                 f"Python {fr.nocost_plan(op.S, nw)}")

    # 19. The main path, through the kernel.
    Ws = draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                          device=dev)
    x0s, ups, yps = scenario_batch(plant, ctrl, B, dev)
    run = fr.make_fused_batched_rollout(bm, T, cost_mode="post")
    fr.fused_rollout.launches = fr.fused_rollout_nocost.launches = 0
    res = run(x0s, ups, yps, Ws)
    torch.cuda.synchronize()
    main_launches = fr.fused_rollout_nocost.launches
    if main_launches < 1 or fr.fused_rollout.launches:
        raise AssertionError(f"large_plant main path: {main_launches} K3 "
                             f"and {fr.fused_rollout.launches} K1 launches")
    if res.u_sys.shape != (B, T, 10) or res.costs.shape != (B, T):
        raise AssertionError(f"large_plant shapes {tuple(res.u_sys.shape)}"
                             f" {tuple(res.costs.shape)}")
    if not bool(res.converged.all()):
        raise AssertionError("non-finite costs on the large_plant path")
    log(f"large_plant main path: B={B} T={T} K={K} cost_mode=post, "
        f"fused_rollout_nocost launches {main_launches}")
    n_outer = T // K
    s0, W = fr._center_and_pack(bm, x0s, ups, yps, Ws, n_outer, K, 0)
    want_k = fr.fused_rollout_reference(op, s0, W)
    got_k = fr.fused_rollout(op, s0, W)
    errs = {name: check_close(f"K3 vs plain {name}", g, w, K3_ATOL)
            for name, g, w in zip(("U", "Y", "s_fin"),
                                  got_k[:2] + got_k[3:],
                                  want_k[:2] + want_k[3:])}
    kernel_err = max(errs.values())
    post = fr._make_post_cost_fn(bm, 1)
    c_plain = post(ups, yps, want_k[0].reshape(B, T, 10),
                   want_k[1].reshape(B, T, 10))
    # The costs follow the trajectories: on large_plant each is a small
    # difference of terms near 1e3, so u and y a few 1e-5 apart move it
    # by a few 1e-3 (POST_COST_ATOL, as for the post-pass below).
    err_c = check_close("K3 vs plain costs", res.costs, c_plain,
                        POST_COST_ATOL, COST_RTOL)
    log(f"large_plant kernel (3xTF32) vs plain (B={B}, T={T}): max |dU| "
        f"{errs['U']:.3e}, |dY| {errs['Y']:.3e}, |ds_fin| "
        f"{errs['s_fin']:.3e} (atol {K3_ATOL}); costs {err_c:.3e} (rtol "
        f"{COST_RTOL}, atol {POST_COST_ATOL})")
    del want_k, got_k
    # K = 50 solves per block, where the 64-scenario plan does not fit
    # and K3 takes 32 scenarios per block.
    bm50 = build_linear_engine(ctrl, plant.as_params(),
                               solves_per_block=K50, device=dev)
    op50 = fr._build_fused_operator(bm50, include_cost=False)
    rows50 = lib.fused_rollout_nocost_tile_rows(op50.S, op50.nw)
    if rows50 != 32:
        raise AssertionError(f"K3 at K={K50}: {rows50} scenarios per block")
    s50, W50 = fr._center_and_pack(
        bm50, x0s[:B_VARIANT], ups[:B_VARIANT], yps[:B_VARIANT],
        Ws[:B_VARIANT], T // K50, K50, 0,
    )
    before = fr.fused_rollout_nocost.launches
    got50 = fr.fused_rollout(op50, s50, W50)
    torch.cuda.synchronize()
    if fr.fused_rollout_nocost.launches != before + 1:
        raise AssertionError(f"large_plant K={K50} did not go through K3")
    want50 = fr.fused_rollout_reference(op50, s50, W50)
    err50 = max(check_close(f"K3 K={K50} vs plain {name}", g, w, K3_ATOL)
                for name, g, w in zip(("U", "Y", "s_fin"),
                                      got50[:2] + got50[3:],
                                      want50[:2] + want50[3:]))
    log(f"large_plant K={K50} (B={B_VARIANT}, T={T}): K3 at "
        f"{rows50} scenarios per block, "
        f"{lib.fused_rollout_nocost_smem_bytes(op50.S, op50.nw)} B; vs "
        f"plain max |diff| on U, Y, s_fin {err50:.3e} (atol {K3_ATOL})")
    del bm50, op50, s50, W50, got50, want50

    # 20. Float64 truth (1024 scenarios) and the in-kernel costs. The
    # post-pass truncates the cost factor at rtol 1e-6, as the JAX
    # package does, so it is held to the in-kernel costs of an operator
    # truncated the same way: in float32 on the same trajectories at a
    # fixed limit (the gap is summation order only: 5.2e-3 before the
    # truncation, 3.1e-3 after it on the CPU at B = 4, T = 50), and in
    # float64 on the float64 trajectories, where the two must agree to
    # rounding.
    bm64 = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                               device=dev, dtype=torch.float64)
    n_sub = min(1024, B)
    sub = [a[:n_sub].double() for a in (x0s, ups, yps, Ws)]
    res64 = fr.make_fused_batched_rollout(
        bm64, T, cost_rank_rtol=1e-6, rollout=fr.fused_rollout_reference
    )(*sub)
    du = max_abs(res.u_sys[:n_sub], res64.u_sys)
    dy = max_abs(res.y_sys[:n_sub], res64.y_sys)
    if not (du < NORTH_STAR and dy < NORTH_STAR):
        raise AssertionError(f"large_plant max |du| {du:.3e}, |dy| "
                             f"{dy:.3e} vs float64")
    du_plain = max_abs(fr.fused_rollout_reference(
        op, s0[:n_sub], W[:n_sub])[0].reshape(n_sub, T, 10), res64.u_sys)
    c_ink = fr.fused_rollout_reference(
        fr._build_fused_operator(bm, cost_rank_rtol=1e-6), s0[:n_sub],
        W[:n_sub],
    )[2].reshape(n_sub, T)
    e = check_close("post vs inkernel costs", res.costs[:n_sub], c_ink,
                    POST_COST_ATOL, COST_RTOL)
    post64 = fr._make_post_cost_fn(bm64, 1)(sub[1], sub[2], res64.u_sys,
                                            res64.y_sys)
    e64 = check_close("float64 post vs inkernel costs", post64,
                      res64.costs, 1e-8)
    err_post64 = max_abs(res.costs[:n_sub], res64.costs)
    untruncated = fr.make_fused_batched_rollout(
        bm64, T, rollout=fr.fused_rollout_reference
    )(*sub).costs
    fault = max_abs(untruncated, res64.costs)
    log(f"large_plant float64 truth ({n_sub} scenarios): kernel max |du| "
        f"{du:.3e}, |dy| {dy:.3e} (< {NORTH_STAR}; the float32 plain "
        f"version's |du| {du_plain:.3e}); post-pass costs vs float64 "
        f"{err_post64:.3e} (costs {float(res64.costs.min()):.3f} .. "
        f"{float(res64.costs.max()):.1f}); post vs in-kernel at rank "
        f"{fr._build_fused_operator(bm, cost_rank_rtol=1e-6).rank}: "
        f"{n_sub} scenarios, plain version, max |diff| {e:.3e} (rtol "
        f"{COST_RTOL}, atol {POST_COST_ATOL}); in float64 {e64:.3e} (atol "
        f"1e-8); the truncation at rtol 1e-6 moves the float64 costs by "
        f"up to {fault:.3e}")

    # 21. Timing at the main shape: the kernel, the post-pass and the
    # plain version each alone, then the whole amortized path.
    u_sys, y_sys = res.u_sys, res.y_sys
    parts = {
        "kernel": lambda: fr.fused_rollout(op, s0, W),
        "plain": lambda: fr.fused_rollout_reference(op, s0, W),
        "post-pass": lambda: post(ups, yps, u_sys, y_sys),
    }
    ms = {k: [] for k in parts}
    for name in ("kernel", "plain", "post-pass", "post-pass", "plain",
                 "kernel"):
        before = fr.fused_rollout_nocost.launches
        t = cuda_ms(parts[name], reps=4)
        launched = fr.fused_rollout_nocost.launches - before
        if launched != (5 if name == "kernel" else 0):
            raise AssertionError(f"large_plant {name}: {launched} launches")
        ms[name].append(t)
        log(f"large_plant timing {name}: {t:.4f} ms per rollout [{smi}]")
    sw = torch.cat([W[:, 0], s0], dim=1)
    t_mm = cuda_ms(lambda: torch.addmm(op.bias, sw, op.G), reps=20)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    whole, R_w = time_amortized(
        fr.make_amortized_run(bm, T, cost_mode="post"), (x0s, ups, yps, Ws),
        seconds=0.5, min_reps=2,
    )
    solves = B * T
    flops = 2.0 * B * n_outer * op.G.shape[0] * op.G.shape[1]
    log(f"large_plant (B={B} x T={T}, {smi}): kernel {mean['kernel']:.4f} "
        f"ms ({flops / mean['kernel'] / 1e9:.1f} TFLOP/s of float32 work), "
        f"plain {mean['plain']:.4f} ms, post-pass "
        f"{mean['post-pass']:.4f} ms (means of 2 turns); one per-block "
        f"cuBLAS product (addmm {tuple(sw.shape)} x {tuple(op.G.shape)}) "
        f"{t_mm:.4f} ms, x {n_outer} = {t_mm * n_outer:.4f} ms; whole "
        f"amortized path {whole:.4f} ms per rollout over R={R_w} -> "
        f"{solves / (whole * 1e-3):,.0f} solves/s")
    nbytes = tensor_bytes(s0, W, op.G, op.bias, res.u_sys, res.y_sys) \
        + 4 * B * op.S
    return {
        "name": "fused_rollout_nocost",
        "route": "cuda",
        "source": "direct_data_driven_mpc_tpu_torch/ops/csrc/"
                  "fused_rollout.cu",
        "replaces": "direct_data_driven_mpc_tpu/ops/pallas_rollout.py:629",
        "launches": main_launches,
        "max_abs_err": kernel_err,
        "ms": mean["kernel"],
        "plain_ms": mean["plain"],
        "precision": "tf32x3",
        # Three TF32 passes on the tensor cores; the float32 bound of
        # the same products beside it.
        **bound(3 * flops, nbytes, TF32_FLOP_PER_S),
        "fp32_bound_ms": bound(flops, nbytes)["bound_ms"],
        # A recursion over 16 blocks has no one-call equivalent; the
        # yardstick is 16 calls of one op, the per-block addmm.
        "library_ms": t_mm * n_outer,
    }


def k1_rows(op, s0, W):
    """The ``(B n_outer, D)`` rows ``[w_t | s_t]`` of K1's product, by
    the plain recursion of the state columns (in IEEE float32)."""
    from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32

    S, n_outer = op.S, W.shape[1]
    states = [s0]
    with ieee_float32():
        for t in range(n_outer - 1):
            states.append(torch.addmm(op.bias[:S], torch.cat(
                [W[:, t], states[-1]], dim=1), op.G[:, :S]))
    return torch.cat([W, torch.stack(states, 1)], 2).reshape(
        -1, op.G.shape[0])


def k1_report(op, s0, W, calls: int = 3) -> int:
    """K1's plan from the library against ``rollout_plan``, each of its
    two kernels' blocks per SM, registers and local (spill) bytes, and
    the CUDA kernels one ``fused_rollout`` call launches (returned):
    counted from the host's launch records over ``calls`` calls after a
    discarded warm-up (:func:`profile_session`), each call adding one to
    ``fused_rollout.launches``; the kernels' names read from the device's
    records only where the session holds one for each launch."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr

    lib = _kernels.load("fused_rollout").lib
    plan = (ctypes.c_int * 7)()
    fits = lib.fused_rollout_plan(op.S, op.nw, plan)
    want = fr.rollout_plan(op.S, op.nw)
    if tuple(plan) != tuple(want) or bool(fits) != want.fits:
        raise AssertionError(f"K1 plan: library {tuple(plan)} vs Python "
                             f"{want}")
    pack = fr.k1_pack(op)
    table = pack.slots
    log(f"K1 plan: {want}; {table.shape[0]} column tiles x "
        f"{table.shape[1]} pass(es) of {want.slots} slots, "
        f"{-(-B_MAIN * W.shape[1] // want.rows)} row tiles; a row tile "
        f"streams {pack.streamed} of {pack.dense} slices of D "
        f"({100 * pack.streamed / pack.dense:.2f} %), per tile and pass "
        f"{pack.slices[..., 0].tolist()}")
    for which, name in enumerate(("state pass", "product")):
        regs, local = ctypes.c_int(), ctypes.c_int()
        if lib.fused_rollout_kernel_attributes(which, ctypes.byref(regs),
                                               ctypes.byref(local)):
            raise AssertionError(f"K1 {name}: no attributes")
        per_sm = lib.fused_rollout_blocks_per_sm(op.S, op.nw, which)
        if per_sm < 1:
            raise AssertionError(f"K1 {name}: {per_sm} blocks per SM")
        log(f"K1 {name}: {per_sm} blocks per SM, {regs.value} registers, "
            f"{local.value} local (spill) bytes per thread")
    before = fr.fused_rollout.launches
    s = profile_session(lambda: fr.fused_rollout(op, s0, W), calls,
                        warmup=1)[0]
    moved = fr.fused_rollout.launches - before
    if moved != calls + 1 or (s.launches, s.copies) != (2 * calls, 0):
        raise AssertionError(f"K1: {moved} wrapper launches, {s.launches} "
                             f"kernel launches and {s.copies} copies over "
                             f"{calls + 1} calls (the first discarded), "
                             "expected one and two per call, no copy")
    if s.complete:
        expected = collections.Counter({
            "fused_rollout_state_kernel": calls,
            "fused_rollout_product_kernel": calls})
        if s.names != expected:
            raise AssertionError(f"K1 launched {dict(s.names)}")
        names = f"names {sorted(s.names)}"
    else:
        names = (f"names not read: {s.kernel_records} of {s.launches} "
                 "device records")
    log(f"K1: 2 CUDA kernel launches per rollout (host records, {calls} "
        f"calls), 0 copies; {names}; {s.counts()}")
    return s.launches // calls


def equal_or_close(name, got, want, why) -> float:
    """Max |got - want|: 0 where the two are bit-equal, else within
    ``ATOL``, with ``why`` printed."""
    err = max_abs(got, want)
    if err:
        check_close(name, got, want, ATOL)
        log(f"  {name}: not bit-equal, max |diff| {err:.3e} within atol "
            f"{ATOL}: {why}")
    return err


def tracking_phases(dev, smi, main) -> dict:
    """Phases 22-26: ``four_tank_tracking`` through kernel K1, with the
    main path's controller, batch and plain-map rollout in ``main``.
    Returns K1's record at this configuration for the ``kernels``
    line."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_tracking_engine,
        make_linear_batched_rollout,
    )
    from direct_data_driven_mpc_tpu_torch.control.loop import (
        closed_loop_rollout,
    )
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_block_noise,
    )

    plant, ctrl = main["plant"], main["ctrl"]
    x0s, ups, yps, Ws = main["inputs"]
    B, T = B_MAIN, T_MAIN
    cublas = ("cuBLAS sums the product in another order than one FMA "
              "chain at this shape")
    # 22. Host build: the tracking operator and block map.
    t0 = time.perf_counter()
    top = ctrl.tracking_operator()
    t_op = time.perf_counter() - t0
    n_r = ctrl.m + ctrl.p
    K = fr.suggest_solves_per_block(plant.get_system_order(), ctrl.n,
                                    ctrl.m, ctrl.p, n_steps=T, n_r=n_r)
    t0 = time.perf_counter()
    bm_t = build_tracking_engine(ctrl, plant.as_params(),
                                 solves_per_block=K, device=dev)
    t_map = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = fr._build_fused_operator(bm_t)
    pack = fr.k1_pack(op)
    t_fused = time.perf_counter() - t0
    n_tiles, n_pass = pack.slots.shape[:2]
    D = op.G.shape[0]
    log(f"tracking host build: four_tank_tracking, tracking operator "
        f"U_r {top['U_r'].shape} (feasible {top['feasible']}) in "
        f"{t_op:.3f} s; block map K={K}, n_r={bm_t.n_r}, r_bar "
        f"{bm_t.r_bar.tolist()} in {t_map:.2f} s; fused operator G "
        f"{tuple(op.G.shape)} (S={op.S}, nw={op.nw}, rank {op.rank}) and "
        f"K1's pack in {t_fused:.2f} s")
    if (K, op.S, op.nw, op.rank, op.G.shape[1]) != (50, 20, 104, 20, 1270):
        raise AssertionError(f"four_tank_tracking shape K={K}, S={op.S}, "
                             f"nw={op.nw}, rank {op.rank}, G "
                             f"{tuple(op.G.shape)}")
    if (n_tiles, n_pass, pack.Gp.shape[2]) != (8, 2, 128):
        raise AssertionError(f"K1 slot table {n_tiles} tiles x {n_pass} "
                             f"passes, D padded to {pack.Gp.shape[2]}")
    log(f"K1 slot table at four_tank_tracking: n_tiles {n_tiles}, n_pass "
        f"{n_pass} (each solve's {op.rank} Z columns and q in two slots), "
        f"D = {D} padded to {pack.Gp.shape[2]}")

    # 23. The main path, through the kernel.
    n_outer = T // K
    r0 = torch.as_tensor(np.concatenate([ctrl.u_s.ravel(),
                                         ctrl.y_s.ravel()]),
                         dtype=torch.float32, device=dev)
    low = torch.tensor([(i // 2) % 2 == 1 for i in range(n_outer)],
                       device=dev)
    sched = torch.where(low[:, None], 0.85 * r0, r0)  # bench.py:724-731
    run = fr.make_fused_batched_rollout(bm_t, T)
    fr.fused_rollout.launches = fr.fused_rollout_nocost.launches = 0
    res = run(x0s, ups, yps, Ws, sched)
    torch.cuda.synchronize()
    main_launches = fr.fused_rollout.launches
    if main_launches < 1 or fr.fused_rollout_nocost.launches:
        raise AssertionError(f"tracking main path: {main_launches} K1 and "
                             f"{fr.fused_rollout_nocost.launches} K3 "
                             "launches")
    if res.u_sys.shape != (B, T, 2) or res.costs.shape != (B, T):
        raise AssertionError(f"tracking shapes {tuple(res.u_sys.shape)} "
                             f"{tuple(res.costs.shape)}")
    if not bool(res.converged.all()):
        raise AssertionError("non-finite costs on the tracking path")
    log(f"tracking main path: B={B} T={T} K={K}, schedule "
        f"{[round(float(v), 4) for v in sched[:, 2]]} (y_s[0] per outer "
        f"block), fused_rollout launches {main_launches}")
    s0, W = fr._center_and_pack(bm_t, x0s, ups, yps, Ws, n_outer, K, 0,
                                setpoints=sched)
    got = fr.fused_rollout(op, s0, W)
    want = fr.fused_rollout_reference(op, s0, W)
    k1_report(op, s0, W)
    err = {name: equal_or_close(f"tracking K1 vs plain {name}", g, w,
                                cublas)
           for name, g, w in zip(("U", "Y", "s_fin"), got[:2] + got[3:],
                                 want[:2] + want[3:])}
    err_c = check_close("tracking K1 vs plain C", got[2], want[2],
                        COST_ATOL, COST_RTOL)
    kernel_err = max(err.values())
    log(f"tracking K1 vs plain (B={B}, T={T}): max |dU| {err['U']:.3e}, "
        f"|dY| {err['Y']:.3e}, |ds_fin| {err['s_fin']:.3e}; max |dC| "
        f"{err_c:.3e} (rtol {COST_RTOL}, atol {COST_ATOL})")
    bm_t100 = build_tracking_engine(ctrl, plant.as_params(),
                                    solves_per_block=100, device=dev)
    sched100 = sched[::2]  # one row per 100 steps: the same schedule
    classic_fn = make_linear_batched_rollout(bm_t100, T, setpoints=sched100)
    classic = classic_fn(x0s, ups, yps, Ws)
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        e = check_close(f"tracking K1 vs classic {field}",
                        getattr(res, field), getattr(classic, field), ATOL)
        log(f"tracking K1 vs classic engine (K=100) {field}: max |diff| "
            f"{e:.3e}")
    e = check_close("tracking K1 vs classic costs", res.costs,
                    classic.costs, COST_ATOL, COST_RTOL)
    log(f"tracking K1 vs classic engine costs: max |diff| {e:.3e}")
    n_gen = 64
    gen = closed_loop_rollout(
        plant.as_params(), ctrl.tracking_map(device=dev), x0s[:n_gen],
        ups[:n_gen], yps[:n_gen], Ws[:n_gen], T,
        setpoints=sched.repeat_interleave(K, dim=0),
    )
    e_u = check_close("tracking K1 vs generic loop u", res.u_sys[:n_gen],
                      gen.u_sys, NORTH_STAR)
    e_y = max_abs(res.y_sys[:n_gen], gen.y_sys)
    log(f"tracking K1 vs generic loop (TrackingMap, schedule per solve, "
        f"{n_gen} scenarios): max |du| {e_u:.3e} (atol {NORTH_STAR}), "
        f"|dy| {e_y:.3e}")

    # 24. Float64 truth (64 scenarios) and the retarget probe.
    bm_t64 = build_tracking_engine(ctrl, plant.as_params(),
                                   solves_per_block=K, device=dev,
                                   dtype=torch.float64)
    s0_64, W_64 = fr._center_and_pack(
        bm_t64, *(a[:64].double() for a in (x0s, ups, yps, Ws)), n_outer,
        K, 0, setpoints=sched.double(),
    )
    U64 = fr.fused_rollout_reference(fr._build_fused_operator(bm_t64),
                                     s0_64, W_64)[0]
    du = max_abs(res.u_sys[:64], U64.reshape(64, T, 2))
    if not du < NORTH_STAR:
        raise AssertionError(f"tracking max |du| vs float64 {du:.3e}")
    y_end = res.y_sys[:, -1]
    target = 0.85 * r0[2:]
    miss = float((y_end - target).abs().max())
    if not miss < 0.05:  # bench.py:771-777
        raise AssertionError(f"retarget probe: y(T) {y_end[0].tolist()} "
                             f"misses {target.tolist()} by {miss:.3e}")
    log(f"tracking float64 truth (64 scenarios): K1 max |du| {du:.3e} (< "
        f"{NORTH_STAR}); retarget probe: y(T) {y_end[0].tolist()} vs "
        f"target {target.tolist()}, max miss over {B} scenarios "
        f"{miss:.3e} (< 0.05)")

    # 25. Edges.
    s0_r, W_r = fr._center_and_pack(bm_t, x0s, ups, yps, Ws, n_outer, K, 0,
                                    setpoints=r0)
    got_r = fr.fused_rollout(op, s0_r, W_r)
    want_r = fr.fused_rollout_reference(op, s0_r, W_r)
    plain_k1, plain_ref = main["k1"], main["plain"]
    for name, i in (("U", 0), ("Y", 1), ("s_fin", 3)):
        if not torch.equal(got_r[i], plain_k1[i]):
            raise AssertionError(f"dr = 0: K1 {name} differs from the "
                                 "plain map's")
        equal_or_close(f"dr = 0 plain version {name} vs the plain map's",
                       want_r[i], plain_ref[i], cublas)
    e_c = check_close("dr = 0 costs", got_r[2], plain_k1[2], COST_ATOL,
                      COST_RTOL)
    log(f"edge: constant schedule r_bar: K1's U, Y and s_fin bit-equal to "
        f"the plain four_tank_robust map's (phase 4); costs max |diff| "
        f"{e_c:.3e} (the wider factor's rounding)")

    scales = torch.linspace(1.0, 0.85, B, device=dev)
    per_scen = scales[:, None, None] * sched[None]
    s0_s, W_s = fr._center_and_pack(bm_t, x0s, ups, yps, Ws, n_outer, K, 0,
                                    setpoints=per_scen)
    got_s = fr.fused_rollout(op, s0_s, W_s)
    want_s = fr.fused_rollout_reference(op, s0_s, W_s)
    for name, i in (("U", 0), ("Y", 1), ("s_fin", 3)):
        equal_or_close(f"per-scenario schedule {name}", got_s[i], want_s[i],
                       cublas)
        if not torch.equal(got_s[i][0], got[i][0]):
            raise AssertionError(f"per-scenario schedule {name}: scenario "
                                 "0 (scale 1) differs from the shared run")
    check_close("per-scenario schedule C", got_s[2], want_s[2], COST_ATOL,
                COST_RTOL)
    log(f"edge: per-scenario schedule ({B}, {n_outer}, {n_r}), scales 1 .. "
        "0.85: K1 matches the plain version; scenario 0 equals the shared "
        "run's")

    Br = 4000
    got_b = fr.fused_rollout(op, s0[:Br].contiguous(), W[:Br].contiguous())
    want_b = fr.fused_rollout_reference(op, s0[:Br], W[:Br])
    for name, g, w in zip(("U", "Y", "s_fin"), got_b[:2] + got_b[3:],
                          want_b[:2] + want_b[3:]):
        check_close(f"tracking ragged B={Br} {name}", g, w, ATOL)
    check_close(f"tracking ragged B={Br} C", got_b[2], want_b[2],
                COST_ATOL, COST_RTOL)
    for name, g, full in zip(("U", "Y", "C", "s_fin"), got_b, got):
        if not torch.equal(g, full[:Br]):
            raise AssertionError(f"tracking ragged B={Br} {name} differs "
                                 "from the same rows of the full batch")
    log(f"edge: tracking ragged batch B={Br} matches the plain version and "
        "the full batch's rows")

    T_odd, K_odd = 37, 8
    bm_t8 = build_tracking_engine(ctrl, plant.as_params(),
                                  solves_per_block=K_odd, device=dev)
    n_outer8 = math.ceil(T_odd / K_odd)
    sched8 = sched[:n_outer8]
    ins_odd = (x0s, ups, yps, Ws[:, :T_odd].contiguous())
    before = fr.fused_rollout.launches
    odd = fr.make_fused_batched_rollout(bm_t8, T_odd)(*ins_odd, sched8)
    if fr.fused_rollout.launches != before + 1:
        raise AssertionError("tracking T=37 run did not go through K1")
    s0_8, W_8 = fr._center_and_pack(bm_t8, *ins_odd, n_outer8, K_odd,
                                    n_outer8 * K_odd - T_odd, sched8)
    U8 = fr.fused_rollout_reference(fr._build_fused_operator(bm_t8), s0_8,
                                    W_8)[0]
    check_close("tracking T=37 K=8 u", odd.u_sys,
                U8.reshape(B, -1, 2)[:, :T_odd], ATOL)
    classic8 = make_linear_batched_rollout(bm_t8, T_odd, setpoints=sched8)(
        *ins_odd)
    check_close("tracking T=37 K=8 y vs classic", odd.y_sys,
                classic8.y_sys, ATOL)
    log(f"edge: tracking T={T_odd}, K={K_odd} (ragged last block) matches "
        "the plain version and the classic engine")

    for w_off in (1, 3, n_outer - 1):
        rot = fr.fused_rollout(op, s0, W, w_off=w_off)
        rolled = fr.fused_rollout(
            op, s0, torch.roll(W, -w_off, dims=1).contiguous()
        )
        for g, w in zip(rot, rolled):
            if not torch.equal(g, w):
                raise AssertionError(f"tracking w_off={w_off} rotation "
                                     "differs from torch.roll")
    log("edge: w_off rotation of noise and setpoint lanes together is "
        "bit-equal to torch.roll")

    eps = plant.get_eps_max()
    rng_run = make_linear_batched_rollout(bm_t100, T, use_rng_noise=True,
                                          eps_max=eps, setpoints=sched100)
    got_n = rng_run(x0s, ups, yps,
                    torch.Generator(device=dev).manual_seed(3))
    g3 = torch.Generator(device=dev).manual_seed(3)
    draws = torch.stack([draw_block_noise(g3, B, 100 * ctrl.p, eps, dev)
                         for _ in range(T // 100)], dim=1)
    w_max = float(draws.abs().max())
    if not (0.99 * eps < w_max <= eps):
        raise AssertionError(f"in-scan noise max |w| {w_max} vs eps {eps}")
    want_n = classic_fn(x0s, ups, yps, draws.reshape(B, T, ctrl.p))
    for field in ("u_sys", "y_sys", "costs", "x_final"):
        g, w = getattr(got_n, field), getattr(want_n, field)
        if not (bool(torch.isfinite(g).all()) and torch.equal(g, w)):
            raise AssertionError(f"in-scan noise {field} differs from the "
                                 "explicit-noise run on the same draws")
    log(f"edge: classic engine in-scan noise (B={B}, T={T}, K=100, "
        f"tracking): max |w| {w_max:.6f} <= eps_max {eps}, mean "
        f"{float(draws.mean()):.2e}; u, y, costs, x_final bit-equal to the "
        "explicit-noise run on the same draws")

    # 26. Timing at the main shape, in turns.
    solves = B * T
    args = (x0s, ups, yps, Ws)
    runs = {
        "kernel": fr.make_amortized_run(bm_t, T, setpoints=sched),
        "plain": fr.make_amortized_run(
            bm_t, T, setpoints=sched, rollout=fr.fused_rollout_reference),
    }

    def classic_run(x0s, ups, yps, Ws, R):
        checksum = torch.zeros((), device=dev)
        for _ in range(R):
            r = classic_fn(x0s, ups, yps, Ws)
            checksum = checksum + r.costs[:, -1].sum() + r.x_final.sum() \
                + r.u_sys.sum() + r.y_sys.sum()
        return checksum, torch.isfinite(checksum)

    runs["classic"] = classic_run
    ms = {k: [] for k in runs}
    for name in ("kernel", "plain", "classic", "classic", "plain",
                 "kernel"):
        before = fr.fused_rollout.launches
        t, R = time_amortized(runs[name], args)
        launched = fr.fused_rollout.launches - before
        expected = R + 2 if name == "kernel" else 0
        if launched != expected:
            raise AssertionError(f"tracking {name}: {launched} launches, "
                                 f"expected {expected}")
        ms[name].append(t)
        log(f"tracking timing {name}: {t:.4f} ms/rollout over R={R} -> "
            f"{solves / (t * 1e-3):,.0f} solves/s [{smi}]")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"tracking solves/s (mean of 2 turns, four_tank_tracking B={B} x "
        f"T={T}, {smi}): "
        + ", ".join(f"{k} {solves / (v * 1e-3):,.0f}"
                    for k, v in mean.items()))
    R_p = 20
    sess, wall_ms, _ = profile_session(lambda: runs["kernel"](*args, R_p))
    if sess.complete:
        dev_ms = sum(sess.ms.values())
        log(f"tracking device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms wall "
            f"over {R_p} amortized rollouts under the profiler (idle "
            f"{1 - dev_ms / wall_ms:.1%}); against {mean['kernel']:.4f} ms "
            f"per rollout without it, idle "
            f"{1 - dev_ms / R_p / mean['kernel']:.1%}; device ms per "
            "rollout: "
            + ", ".join(f"{k} {v / R_p:.4f}"
                        for k, v in sorted(sess.ms.items(),
                                           key=lambda kv: -kv[1]))
            + f"; {sess.counts()}")
    else:
        log(f"tracking busy share not read over {R_p} amortized rollouts "
            f"({wall_ms:.3f} ms wall under the profiler): {sess.counts()}")
    rows = k1_rows(op, s0, W)
    t_lib = cuda_ms(lambda: torch.addmm(op.bias, rows, op.G), reps=20)
    del rows
    flops = 2.0 * B * n_outer * D * op.G.shape[1]
    nbytes = tensor_bytes(s0, W, op.G, op.bias, *got)
    rec = bound(flops, nbytes)
    log(f"tracking K1 yardstick: one addmm ({B * n_outer}, {D}) x "
        f"{tuple(op.G.shape)}: {t_lib:.4f} ms; bound {rec['bound_ms']:.4f}"
        f" ms ({rec['bound_by']}: {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB) [{smi}]")
    return {
        "name": "fused_rollout (four_tank_tracking)",
        "route": "cuda",
        "source": "direct_data_driven_mpc_tpu_torch/ops/csrc/"
                  "fused_rollout.cu",
        "replaces": "direct_data_driven_mpc_tpu/ops/pallas_rollout.py:490",
        "launches": main_launches,
        "max_abs_err": kernel_err,
        "ms": mean["kernel"],
        "plain_ms": mean["plain"],
        **rec,
        "library_ms": t_lib,
    }


def generic_phases(dev, smi, main, B=B_MAIN, T=T_MAIN) -> dict:
    """Phases 27-29: ``bench.py``'s generic configurations (its
    ``run_convex_config``: seed 0, N = 400, L = 30) through the generic
    loop's iterative solvers and the batch layer, each checked against
    K4 or its float64 run. Returns each configuration's rollout and its
    float32 result, for phase 30."""
    from direct_data_driven_mpc_tpu_torch.control.loop import make_solve_fn
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        batched_closed_loop,
        make_batched_rollout,
    )
    from direct_data_driven_mpc_tpu_torch.qp.admm import (
        compute_admm_operator_np,
    )
    from direct_data_driven_mpc_tpu_torch.qp.box import (
        compute_box_admm_operator_np,
    )
    from direct_data_driven_mpc_tpu_torch.qp.nonconvex import (
        compute_nonconvex_operator_np,
        nonconvex_admm_solve,
    )

    B64, B_LAD = min(B, 64), min(B, 1024)
    out = {}

    def frac(mask):
        return float(mask.float().mean())

    def against_k4(tag, plant, ctrl, op, iters, res, ins):
        """K4 from the same zero state, its iterations summed to the
        loop's, at the loop's tolerance: u and y within 1e-4."""
        run = fa.make_fused_admm_rollout(
            plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T, device=dev,
            iters=(iters,), cold_iters=0, tol=1e-6,
        )
        k4 = run(*ins)
        e_u = check_close(f"{tag} vs K4 u", res.u_sys, k4.u_sys, NORTH_STAR)
        e_y = check_close(f"{tag} vs K4 y", res.y_sys, k4.y_sys, NORTH_STAR)
        log(f"{tag} vs K4 ({iters} iterations from zero, tol 1e-6): max "
            f"|du| {e_u:.3e}, |dy| {e_y:.3e} (atol {NORTH_STAR}); "
            f"converged: loop {frac(res.converged):.6f}, K4 "
            f"{frac(k4.converged):.6f}")

    def against_f64(tag, plant, solver64, iters, res, ins, n):
        r64 = batched_closed_loop(
            plant.as_params(), solver64, *(a[:n].double() for a in ins),
            n_steps=T, admm_iters=iters,
        )
        du = max_abs(res.u_sys[:n], r64.u_sys)
        if not du < NORTH_STAR:
            raise AssertionError(f"{tag}: max |du| vs float64 {du:.3e} >= "
                                 f"{NORTH_STAR}")
        log(f"{tag} float64 truth ({n} scenarios): max |du| {du:.3e} (< "
            f"{NORTH_STAR}); converged: float32 "
            f"{frac(res.converged[:n]):.6f}, float64 "
            f"{frac(r64.converged):.6f}")
        return r64

    def first_run(tag, run, ins):
        t0 = time.perf_counter()
        res = run(*ins)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        if res.u_sys.shape != (B, T, 2) or not bool(
            torch.isfinite(res.u_sys).all() & torch.isfinite(res.costs).all()
        ):
            raise AssertionError(f"{tag}: shape {tuple(res.u_sys.shape)} "
                                 "or non-finite values")
        log(f"{tag}: B={B} T={T}, first rollout {secs:.2f} s, converged "
            f"lanes {frac(res.converged):.6f} [{smi}]")
        return res

    # 27. four_tank_convex_generic: CONVEX slack, c = 1, 16 iterations.
    plant, ctrl = build_four_tank_robust(slack="CONVEX")
    ins = (*scenario_batch(plant, ctrl, B, dev), main["inputs"][3])
    solver = ctrl.admm_solver(device=dev)
    run = make_batched_rollout(plant.as_params(), solver, T, admm_iters=16)
    tag = "four_tank_convex_generic"
    res = first_run(tag, run, ins)
    against_k4(tag, plant, ctrl, compute_admm_operator_np(ctrl.spec), 16,
               res, ins)
    against_f64(tag, plant, ctrl.admm_solver(device=dev,
                                             dtype=torch.float64),
                16, res, ins, B64)
    h = T // 2
    first = batched_closed_loop(plant.as_params(), solver, *ins[:3],
                                ins[3][:, :h], n_steps=h, admm_iters=16)
    second = batched_closed_loop(
        plant.as_params(), solver, first.x_final, first.u_past,
        first.y_past, ins[3][:, h:], n_steps=T - h, admm_iters=16,
        solver_state0=first.solver_state,
    )
    for name in ("u_sys", "y_sys", "costs", "converged"):
        if not torch.equal(torch.cat([getattr(first, name),
                                      getattr(second, name)], 1),
                           getattr(res, name)):
            raise AssertionError(f"{tag} segmented {name} differs from the "
                                 "uninterrupted run")
    log(f"{tag} segmented ({h} + {T - h} steps through solver_state0): u, "
        "y, costs and converged lanes bit-equal to the uninterrupted run")
    out[tag] = dict(run=run, ins=ins, res=res, plant=plant.as_params(),
                    solver=solver, iters=16)

    # 28. four_tank_box_generic: slack NONE, |u| <= 0.85, rho = 1, cap 60.
    plant, ctrl = main["plant"], main["ctrl"]
    ins = main["inputs"]
    solver = ctrl.box_admm_solver(u_bounds=(-0.85, 0.85), rho=1.0,
                                  device=dev)
    run = make_batched_rollout(plant.as_params(), solver, T, admm_iters=60)
    tag = "four_tank_box_generic"
    res = first_run(tag, run, ins)
    u_max = float(res.u_sys.abs().max())
    if u_max > 0.85 + 1e-6:
        raise AssertionError(f"{tag}: box violated, max |u| {u_max}")
    log(f"{tag}: box respected, max |u| {u_max:.6f} <= 0.85")
    against_k4(tag, plant, ctrl, compute_box_admm_operator_np(
        ctrl.spec, u_bounds=(-0.85, 0.85), rho=1.0), 60, res, ins)
    out[tag] = dict(run=run, ins=ins, res=res, plant=plant.as_params(),
                    solver=solver, iters=60)
    # The adaptive ladder (rho None, cap 120) on B_LAD scenarios.
    lad_ins = tuple(a[:B_LAD] for a in ins)
    lad = batched_closed_loop(
        plant.as_params(), ctrl.box_admm_solver(u_bounds=(-0.85, 0.85),
                                                device=dev),
        *lad_ins, n_steps=T, admm_iters=120,
    )
    lad64 = against_f64(
        f"{tag} ladder (cap 120, B={B_LAD})", plant,
        ctrl.box_admm_solver(u_bounds=(-0.85, 0.85), device=dev,
                             dtype=torch.float64),
        120, lad, lad_ins, B_LAD,
    )
    R = 7
    log(f"{tag} ladder: final rungs float32 "
        f"{torch.bincount(lad.solver_state.rho_idx.long(), minlength=R).tolist()}"
        f", float64 "
        f"{torch.bincount(lad64.solver_state.rho_idx.long(), minlength=R).tolist()}"
        f" (rungs 0-{R - 1}); converged {frac(lad.converged):.6f}, from "
        f"solve 10 on {frac(lad.converged[:, 10:]):.6f}")

    # 29. four_tank_nonconvex: c = 0.05, 4 outer x 16 inner iterations.
    plant, ctrl = build_four_tank_robust(slack="NON_CONVEX", c=0.05,
                                         allow_nonconvex_slack=True)
    ins = (*scenario_batch(plant, ctrl, B, dev), main["inputs"][3])
    solver = ctrl.nonconvex_admm_solver(device=dev)
    tag = "four_tank_nonconvex"
    worst = {}

    def solve(theta, state):
        # make_solve_fn's NON_CONVEX solve, keeping the largest
        # violation of the Eq. 6d constraint and the bound range.
        u, cost, st, stats = nonconvex_admm_solve(
            solver, theta, outer_iters=4, inner_iters=16, state=state,
            tol=1e-6,
        )
        for k, v in (("viol", stats.constraint_violation.max()),
                     ("bound_max", stats.bound.max()),
                     ("bound_min", -stats.bound.min())):
            worst[k] = v if k not in worst else torch.maximum(worst[k], v)
        return u.reshape(theta.shape[0], -1, ctrl.m), cost, st, \
            stats.converged

    state0 = make_solve_fn(solver, ctrl.m, admm_iters=16)[1]
    res = first_run(tag, make_batched_rollout(
        plant.as_params(), (solve, state0), T), ins)
    log(f"{tag}: largest violation of |sigma_pred| <= c eps_max (1 + "
        f"|alpha|_1) {float(worst['viol']):.3e}; bounds in "
        f"[{-float(worst['bound_min']):.6e}, "
        f"{float(worst['bound_max']):.6e}] (c eps_max "
        f"{float(solver.c_eps):.1e})")
    r64 = against_f64(tag, plant, ctrl.nonconvex_admm_solver(
        device=dev, dtype=torch.float64), 16, res, ins, B64)
    run = make_batched_rollout(plant.as_params(), solver, T, admm_iters=16)
    out[tag] = dict(run=run, ins=ins, res=res, plant=plant.as_params(),
                    solver=solver, iters=16, res64=r64,
                    op=compute_nonconvex_operator_np(ctrl.spec))
    return out


def fused_nonconvex_timing(nc, smi) -> None:
    """Phase 30's fused NON_CONVEX path: ``four_tank_nonconvex`` (c =
    0.05) through ``make_fused_admm_rollout`` (K4's NON_CONVEX mode, 4
    bound updates x 16 iterations, tolerance 1e-6 as the generic
    loop's), one launch a rollout, against the generic loop's run and
    its float64 run, then both timed in turns by CUDA events."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa

    generic, ins, res, r64 = (nc[k] for k in ("run", "ins", "res",
                                              "res64"))
    B, T = res.costs.shape
    fused = fa.make_fused_admm_rollout(
        nc["plant"], nc["op"], 4, 2, 2, T, iters=(nc["iters"],), tol=1e-6,
        device=ins[0].device)
    before = fa.fused_admm.launches
    got = fused(*ins)
    torch.cuda.synchronize()
    if fa.fused_admm.launches != before + 1:
        raise AssertionError("four_tank_nonconvex fused: "
                             f"{fa.fused_admm.launches - before} K4 launches")
    n = r64.u_sys.shape[0]
    du, du64 = max_abs(got.u_sys, res.u_sys), max_abs(got.u_sys[:n],
                                                       r64.u_sys)
    db = float(((got.solver_state.bound - res.solver_state.bound).abs()
                / res.solver_state.bound).max())
    if not (du < NORTH_STAR and du64 < NORTH_STAR and db < 1e-5):
        raise AssertionError(
            f"four_tank_nonconvex fused: max |du| {du:.3e} against the "
            f"generic loop, {du64:.3e} against float64, bound {db:.3e} "
            "relative")
    ms = {"fused": [], "generic": []}
    for name in ("fused", "generic", "generic", "fused"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        (fused if name == "fused" else generic)(*ins)
        end.record()
        torch.cuda.synchronize()
        ms[name].append(start.elapsed_time(end))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"four_tank_nonconvex fused (K4's NON_CONVEX mode, B={B} x T={T}): "
        f"max |du| {du:.3e} against the generic loop, {du64:.3e} against "
        f"float64 ({n} scenarios), bounds within {db:.3e} relative; "
        f"converged {float(got.converged.float().mean()):.6f} (generic "
        f"{float(res.converged.float().mean()):.6f}); {mean['fused']:.2f} "
        f"ms per rollout "
        f"against the generic loop's {mean['generic']:.2f} (means of 2 "
        f"turns) [{smi}]")


def generic_timing(dev, smi, runs) -> None:
    """Phase 30: each generic configuration's rollout, in turns, by CUDA
    events (its phase's run was the warm-up): ms per rollout and
    solves/s; then the kernels and copies one rollout launches, from the
    host's records of ten ``torch.profiler`` sessions, one per segment
    chained through ``solver_state0``, and the device's busy share under
    them where every session's device records are complete."""
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        batched_closed_loop,
    )

    ms = {k: [] for k in runs}
    names = list(runs)
    for name in names + names[::-1]:
        run, ins, ref = (runs[name][k] for k in ("run", "ins", "res"))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        res = run(*ins)
        end.record()
        torch.cuda.synchronize()
        if not torch.equal(res.u_sys, ref.u_sys):
            raise AssertionError(f"{name}: timed rollout differs from its "
                                 "checked run")
        ms[name].append(start.elapsed_time(end))
        B, T = res.costs.shape
        log(f"generic timing {name}: {ms[name][-1]:.2f} ms per rollout -> "
            f"{B * T / ms[name][-1] * 1e3:,.0f} solves/s [{smi}]")
    for name in names:
        plant, solver, iters, ins, ref = (
            runs[name][k] for k in ("plant", "solver", "iters", "ins", "res")
        )
        B, T = ref.costs.shape
        mean = sum(ms[name]) / len(ms[name])
        total = collections.Counter()
        dev_ms = wall = 0.0
        complete = True
        state, x, up, yp = None, *ins[:3]
        seg = T // 10
        for t0 in range(0, T, seg):
            sess, w, part = profile_session(
                lambda: batched_closed_loop(
                    plant, solver, x, up, yp, ins[3][:, t0 : t0 + seg],
                    n_steps=seg, admm_iters=iters, solver_state0=state,
                ))
            wall += w
            dev_ms += sum(sess.ms.values())
            complete &= sess.complete
            total.update(launches=sess.launches, copies=sess.copies,
                         kernel_records=sess.kernel_records,
                         copy_records=sess.copy_records, stray=sess.stray)
            if not torch.equal(part.u_sys, ref.u_sys[:, t0 : t0 + seg]):
                raise AssertionError(f"{name}: profiled segment at step "
                                     f"{t0} differs from the full run")
            state, x, up, yp = (part.solver_state, part.x_final,
                                part.u_past, part.y_past)
        kernels, copies = total["launches"], total["copies"]
        if kernels < T:
            raise AssertionError(f"{name}: {kernels} kernel launches over "
                                 f"{T} steps")
        counts = (f"device records: {total['kernel_records']} of {kernels} "
                  f"kernel launches, {total['copy_records']} of {copies} "
                  f"copies, {total['stray']} of no call in the session, "
                  f"over the ten sessions (matched by {sess.matched_by})")
        busy = (f"device busy {dev_ms:.1f} of {wall:.1f} ms under the "
                f"profiler (idle {1 - dev_ms / wall:.1%}), against "
                f"{mean:.2f} ms without it (idle {1 - dev_ms / mean:.1%})"
                if complete else
                f"device busy not read ({wall:.1f} ms wall under the "
                "profiler)")
        log(f"generic {name} (B={B} x T={T}, {smi}): {mean:.2f} ms per "
            f"rollout (mean of 2 turns) -> {B * T / mean * 1e3:,.0f} "
            f"solves/s; {kernels} kernels and {copies} copies launched per "
            f"rollout ({kernels / T:.1f} per closed-loop step, host "
            f"records); {busy}; {counts}")
    if "four_tank_nonconvex" in runs:
        fused_nonconvex_timing(runs["four_tank_nonconvex"], smi)


def timer_ms(timer) -> str:
    """A ``utils.profiling.Timer``'s samples as best / p50 in ms."""
    s = timer.summary()
    return f"best {s['best_s'] * 1e3:.2f} ms, p50 {s['p50_s'] * 1e3:.2f} ms"


def host_layer_phase(dev, smi, main, n_steps=50) -> None:
    """Phase 31: the host layer. The controller through
    ``create_data_driven_mpc_controller`` from ``four_tank_params``, bit-
    equal to ``build_four_tank_robust``'s; the stability certificate of
    the K = 50 block map and of the terminal-free (UCON) controller; the
    host closed loop against the generic loop in float64 on the card."""
    from direct_data_driven_mpc_tpu_torch.control.creation import (
        create_data_driven_mpc_controller,
    )
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
        closed_loop_spectrum,
    )
    from direct_data_driven_mpc_tpu_torch.control.loop import (
        closed_loop_rollout,
    )
    from direct_data_driven_mpc_tpu_torch.control.operation import (
        simulate_data_driven_mpc_control_loop,
    )
    from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel

    plant, ctrl = main["plant"], main["ctrl"]
    params = four_tank_params(plant.get_eps_max())
    made = create_data_driven_mpc_controller(params, ctrl.u_d, ctrl.y_d)
    for name in ("H", "A", "b_const", "S", "g", "r0"):
        if not np.array_equal(getattr(made.spec, name),
                              getattr(ctrl.spec, name)):
            raise AssertionError(f"created controller: spec {name} differs")
    want = ctrl.solution_operator()
    for key, value in made.solution_operator().items():
        if not np.array_equal(value, want[key]):
            raise AssertionError(f"created controller: operator {key} "
                                 "differs")
    log(f"host layer: create_data_driven_mpc_controller (nz={made.spec.nz}, "
        f"nc={made.spec.nc}): spec and host operator bit-equal to "
        "build_four_tank_robust's")

    K = main["bm50"].os_c.shape[0] // main["bm50"].M_T.shape[0]
    tec = closed_loop_spectrum(main["bm50"])
    ucon_ctrl = create_data_driven_mpc_controller(
        params, ctrl.u_d, ctrl.y_d, use_terminal_constraint=False
    )
    ucon = closed_loop_spectrum(build_linear_engine(
        ucon_ctrl, plant.as_params(), solves_per_block=K, device=dev,
        dtype=torch.float64,
    ))
    if not tec["stable"] or ucon["stable"]:
        raise AssertionError(
            f"spectra: TEC radius {tec['spectral_radius']}, UCON radius "
            f"{ucon['spectral_radius']}: expected stable and unstable"
        )
    log(f"closed_loop_spectrum (K={K} solves per block): TEC stable, "
        f"radius {tec['spectral_radius']:.6f} (per solve "
        f"{tec['spectral_radius'] ** (1 / K):.6f}); UCON unstable, radius "
        f"{ucon['spectral_radius']:.6f} (per solve "
        f"{ucon['spectral_radius'] ** (1 / K):.6f})")

    model = LTIModel(**FOUR_TANK)
    model.set_state(plant.get_state().copy())
    x0 = model.get_state().copy()
    up0, yp0 = made.u_past.reshape(1, 4, 2), made.y_past.reshape(1, 4, 2)
    w = main["inputs"][3][0, :n_steps].double().cpu().numpy()
    t0 = time.perf_counter()
    u_h, y_h = simulate_data_driven_mpc_control_loop(
        model, made, n_steps, np_random=None, verbose=0, w_sys=w
    )
    host_s = time.perf_counter() - t0
    res = closed_loop_rollout(
        plant.as_params(), ctrl.solution_map(device=dev,
                                             dtype=torch.float64),
        *(torch.as_tensor(a, dtype=torch.float64, device=dev)
          for a in (x0[None], up0, yp0, w[None])),
        n_steps=n_steps,
    )
    e_u = check_close("host loop vs generic loop u", res.u_sys[0].cpu(),
                      torch.from_numpy(u_h), 1e-8)
    e_y = check_close("host loop vs generic loop y", res.y_sys[0].cpu(),
                      torch.from_numpy(y_h), 1e-8)
    log(f"simulate_data_driven_mpc_control_loop ({n_steps} steps, host "
        f"{made.solve_path} solves, {host_s:.3f} s) vs the generic loop in "
        f"float64 on "
        f"{dev.type}: max |du| {e_u:.3e}, |dy| {e_y:.3e} (atol 1e-8) "
        f"[{smi}]")


def realisation_data(B, N=400, n=4, L=30):
    """``B`` data realisations of the four-tank plant with the input and
    noise distributions of ``build_four_tank_robust`` (seed ``s`` for
    realisation ``s``), simulated together in numpy from rest, arranged
    into Hankels of depth L + n. Returns ``(Hu (B, (L+n)m, N-L-n+1), Hy,
    x_final (B, 4), u_past (B, n, 2), y_past (B, n, 2))``, float64."""
    from direct_data_driven_mpc_tpu_torch.ops.host import hankel_matrix_np

    A, Bm, C, D = (FOUR_TANK[k] for k in "ABCD")
    eps = FOUR_TANK["eps_max"]
    U = np.empty((B, N, 2))
    Wd = np.empty((B, N, 2))
    for s in range(B):
        rng = np.random.default_rng(s)
        U[s] = rng.uniform(-1, 1, (N, 2))
        Wd[s] = eps * rng.uniform(-1, 1, (N, 2))
    x = np.zeros((B, 4))
    Y = np.empty((B, N, 2))
    for k in range(N):
        Y[:, k] = x @ C.T + U[:, k] @ D.T + Wd[:, k]
        x = x @ A.T + U[:, k] @ Bm.T
    starts = np.arange(L + n)[:, None] + np.arange(N - L - n + 1)[None, :]

    def hankels(X):
        return X[:, starts].transpose(0, 1, 3, 2).reshape(
            B, (L + n) * 2, -1)

    Hu, Hy = hankels(U), hankels(Y)
    for s in (0, B - 1):
        if not (np.array_equal(Hu[s], hankel_matrix_np(U[s], L + n))
                and np.array_equal(Hy[s], hankel_matrix_np(Y[s], L + n))):
            raise AssertionError("batched Hankels differ from "
                                 "hankel_matrix_np")
    return Hu, Hy, x, U[:, -n:], Y[:, -n:]


def sweep_phase(dev, smi, main, B=B_MAIN, T=T_MAIN, n_alone=64,
                n_fallback=16) -> dict:
    """Phase 32: the heterogeneous Monte-Carlo sweep at ``bench.py``'s
    ``four_tank_robust`` scale, one data realisation per scenario:
    ``build_batched_solution_operators`` on the card (feasible lanes,
    against the host fallback), ``stacked_solution_map`` and
    ``heterogeneous_closed_loop`` (against each map alone, and against
    float64). Returns the stacked map and the inputs, for phase 35."""
    from direct_data_driven_mpc_tpu_torch.control.loop import (
        closed_loop_rollout,
    )
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        heterogeneous_closed_loop,
        stack_plants,
    )
    from direct_data_driven_mpc_tpu_torch.qp.batch_build import (
        build_batched_solution_operators,
        build_solution_operators_fallback,
        stacked_solution_map,
    )
    from direct_data_driven_mpc_tpu_torch.qp.solution_map import SolutionMap
    from direct_data_driven_mpc_tpu_torch.utils.profiling import (
        Timer,
        rollout_metrics,
    )

    plant, ctrl = main["plant"], main["ctrl"]
    t0 = time.perf_counter()
    Hu, Hy, xs, ups, yps = realisation_data(B)
    log(f"sweep: {B} data realisations (N=400, L=30) simulated and arranged "
        f"into Hankels {Hu.shape} in numpy, {time.perf_counter() - t0:.2f} s")
    kw = dict(dims=ctrl.spec.dims, Q=ctrl.Q, R=ctrl.R, u_s=ctrl.u_s,
              y_s=ctrl.y_s, eps_max=ctrl.eps_max,
              lamb_alpha=ctrl.lamb_alpha, lamb_sigma=ctrl.lamb_sigma)
    Hu_d = torch.as_tensor(Hu, device=dev)
    Hy_d = torch.as_tensor(Hy, device=dev)
    timer = Timer()
    ops = timer.timeit(lambda: build_batched_solution_operators(
        Hu_d, Hy_d, device=dev, **kw))
    del Hu_d, Hy_d
    if not bool(ops["feasible"].all()):
        raise AssertionError(f"batched build: "
                             f"{int((~ops['feasible']).sum())} infeasible "
                             "lanes")
    build_s = timer.best
    log(f"build_batched_solution_operators (B={B}, nz={ctrl.spec.nz}, float64 "
        f"on {dev.type}): {timer_ms(timer)} over {len(timer.samples)} runs; "
        f"every feasible lane true [{smi}]")

    t0 = time.perf_counter()
    serial = build_solution_operators_fallback(
        Hu[:n_fallback], Hy[:n_fallback], c=ctrl.c, **kw)
    serial_s = (time.perf_counter() - t0) / n_fallback
    worst = 0.0
    for key in ("z_base", "Z", "u_base", "U_gain", "cost_P", "cost_q",
                "cost_r"):
        want = torch.as_tensor(serial[key])
        scale = max(1.0, float(want.abs().max()))
        e = check_close(f"batched vs fallback {key}",
                        ops[key][:n_fallback].cpu(), want, 1e-9 * scale)
        worst = max(worst, e / scale)
    own = ctrl.solution_operator()
    scale = max(1.0, float(np.abs(own["U_gain"]).max()))
    e0 = check_close("batched realisation 0 vs the main controller U_gain",
                     ops["U_gain"][0].cpu(), torch.as_tensor(own["U_gain"]),
                     1e-9 * scale)
    log(f"batched vs build_solution_operators_fallback ({n_fallback} "
        f"realisations, host): max |diff| / field max {worst:.3e} (< 1e-9); "
        f"realisation 0 vs the main controller's U_gain {e0:.3e}; the "
        f"serial build takes {serial_s:.3f} s per realisation on the host, "
        f"the batched {build_s / B * 1e3:.4f} ms per realisation [{smi}]")
    del Hu, Hy

    sol = stacked_solution_map(ops, torch.float32, dev)
    plants = stack_plants([plant.as_params()] * B)
    ins = [torch.as_tensor(a, dtype=torch.float32, device=dev)
           for a in (xs, ups, yps)] + [main["inputs"][3][:B, :T]]
    timer = Timer()
    res = timer.timeit(lambda: heterogeneous_closed_loop(
        plants, sol, *ins, n_steps=T), iters=2)
    if res.u_sys.shape != (B, T, 2) or not bool(
        torch.isfinite(res.u_sys).all() & res.converged.all()
    ):
        raise AssertionError("heterogeneous sweep: wrong shape or "
                             "non-finite values")
    log(f"heterogeneous_closed_loop (B={B} x T={T}, one operator per "
        f"realisation, float32): {timer_ms(timer)} per rollout -> "
        f"{B * T / timer.best:,.0f} solves/s [{smi}]")

    e_u = e_y = 0.0
    for b in range(n_alone):
        one = closed_loop_rollout(
            plant.as_params(), SolutionMap(*(f[b] for f in sol)),
            *(a[b:b + 1] for a in ins), n_steps=T,
        )
        e_u = max(e_u, check_close(f"scenario {b} alone u", one.u_sys[0],
                                   res.u_sys[b], ATOL))
        e_y = max(e_y, check_close(f"scenario {b} alone y", one.y_sys[0],
                                   res.y_sys[b], ATOL))
    sol64 = stacked_solution_map({k: ops[k][:n_alone] for k in ops},
                                 torch.float64, dev)
    res64 = heterogeneous_closed_loop(
        stack_plants([plant.as_params()] * n_alone), sol64,
        *(a[:n_alone].double() for a in ins), n_steps=T,
    )
    du = max_abs(res.u_sys[:n_alone], res64.u_sys)
    if not du < NORTH_STAR:
        raise AssertionError(f"sweep: max |du| vs float64 {du:.3e}")
    log(f"sweep: {n_alone} scenarios each alone with its own map: max |du| "
        f"{e_u:.3e}, |dy| {e_y:.3e} (atol {ATOL}); against float64 max |du| "
        f"{du:.3e} (< {NORTH_STAR})")
    metrics = rollout_metrics(res, ctrl.u_s, ctrl.y_s)
    log(f"sweep rollout_metrics: {json.dumps(metrics)}")
    del ops, sol64, res64
    return dict(plants=plants, sol=sol, ins=ins)


def segmented_phase(dev, smi, main, B=B_MAIN, B_lad=1024, seg=100,
                    n_seg=4) -> None:
    """Phase 33: segmented runs with checkpoints. The CONVEX ADMM of
    ``four_tank_convex_generic`` (16 iterations) on ``B`` scenarios, then
    the box ADMM's ladder (integer rung lanes) on ``B_lad``: ``n_seg``
    segments with a checkpoint after each; a resume from the checkpoint
    after segment ``n_seg // 2`` into a zero template; one
    ``batched_closed_loop`` over the segments' concatenated noise."""
    from direct_data_driven_mpc_tpu_torch.control.segmented import (
        SegmentState,
        resume_from_checkpoint,
        run_segmented,
        segment_noise,
    )
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        batched_closed_loop,
    )
    from direct_data_driven_mpc_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from direct_data_driven_mpc_tpu_torch.utils.profiling import Timer

    fields = ("u_sys", "y_sys", "costs", "converged")
    cvx_plant, cvx = build_four_tank_robust(slack="CONVEX")
    cases = (
        ("CONVEX ADMM (c = 1, 16 iterations)", cvx_plant,
         cvx.admm_solver(device=dev), 16, B, cvx),
        ("box ADMM ladder (|u| <= 0.85, cap 120)", main["plant"],
         main["ctrl"].box_admm_solver(u_bounds=(-0.85, 0.85), device=dev),
         120, B_lad, main["ctrl"]),
    )
    half = n_seg // 2
    with tempfile.TemporaryDirectory() as tmp:
        for tag, plant, solver, iters, Bc, ctrl in cases:
            x0s, ups, yps = scenario_batch(plant, ctrl, Bc, dev)
            P = plant.as_params()
            kw = dict(eps_max=plant.get_eps_max(), segment_steps=seg,
                      admm_iters=iters)

            def start():
                return SegmentState(x=x0s, u_past=ups, y_past=yps,
                                    segment=0, seed=33)

            full_path = os.path.join(tmp, "full.npz")
            t0 = time.perf_counter()
            end, full = run_segmented(P, solver, start(), n_segments=n_seg,
                                      checkpoint_path=full_path, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            full_s = time.perf_counter() - t0
            part_path = os.path.join(tmp, "part.npz")
            _, first = run_segmented(P, solver, start(), n_segments=half,
                                     checkpoint_path=part_path, **kw)
            zero = SegmentState(
                x=torch.zeros_like(x0s), u_past=torch.zeros_like(ups),
                y_past=torch.zeros_like(yps), segment=0, seed=0,
                solver_state=type(end.solver_state)(
                    *(torch.zeros_like(t) for t in end.solver_state)),
            )
            resumed = resume_from_checkpoint(part_path, zero)
            end2, second = run_segmented(P, solver, resumed,
                                         n_segments=n_seg - half, **kw)
            once = batched_closed_loop(
                P, solver, x0s, ups, yps,
                torch.cat([segment_noise(33, i, Bc, seg, 2, kw["eps_max"],
                                         dev) for i in range(n_seg)], 1),
                n_steps=n_seg * seg, admm_iters=iters,
            )
            for name in fields:
                joined = torch.cat([getattr(first, name),
                                    getattr(second, name)], 1)
                if not (torch.equal(joined, getattr(full, name))
                        and torch.equal(getattr(once, name),
                                        getattr(full, name))):
                    raise AssertionError(f"{tag}: {name} differs between "
                                         "the runs")
            for a, b, c in zip((end2.x, end2.u_past, end2.y_past,
                                *end2.solver_state),
                               (end.x, end.u_past, end.y_past,
                                *end.solver_state),
                               (once.x_final, once.u_past, once.y_past,
                                *once.solver_state)):
                if not (a.dtype == b.dtype and torch.equal(a, b)
                        and torch.equal(b, c)):
                    raise AssertionError(f"{tag}: final state differs "
                                         "between the runs")
            if end2.segment != n_seg:
                raise AssertionError(f"{tag}: resumed at segment "
                                     f"{resumed.segment}, ended at "
                                     f"{end2.segment}")
            save_t, load_t = Timer(), Timer()
            for _ in range(3):
                with save_t.measure():
                    save_checkpoint(full_path, end,
                                    metadata={"segment": end.segment})
                with load_t.measure():
                    load_checkpoint(full_path, zero)
            lanes = ", ".join(str(t.dtype) for t in end.solver_state)
            log(f"segmented {tag}, B={Bc}: {n_seg} x {seg} steps "
                f"({full_s:.2f} s with a checkpoint after each), {half} + "
                f"resume into a zero template + {n_seg - half}, and one "
                f"batched_closed_loop over the {n_seg} segments' noise: every "
                f"field, the final state and the solver state ({lanes}) "
                f"bit-equal; checkpoint {os.path.getsize(full_path):,} "
                f"bytes, save {save_t.best * 1e3:.2f} ms, load "
                f"{load_t.best * 1e3:.2f} ms [{smi}]")


def tuning_phase(dev, smi, main, B=64, T=80, steps=25, lr=0.4) -> None:
    """Phase 34: differentiable tuning of the paper's controller in
    float64 on the card, from the example's 100x inflated alpha ridge:
    the differentiable map against the host operator, the gradient
    against central differences, ``steps`` Adam steps."""
    from direct_data_driven_mpc_tpu_torch.control.tuning import (
        differentiable_solution_map,
        make_closed_loop_objective,
        tune_regularization,
    )
    from direct_data_driven_mpc_tpu_torch.utils.profiling import Timer

    plant, ctrl = main["plant"], main["ctrl"]
    a_yaml, s_yaml = ctrl.lamb_alpha * ctrl.eps_max, ctrl.lamb_sigma
    sol = differentiable_solution_map(ctrl.spec, a_yaml, s_yaml, device=dev)
    host = ctrl.solution_operator()
    worst = 0.0
    for key, value in sol._asdict().items():
        want = torch.as_tensor(host[key])
        scale = max(1.0, float(want.abs().max()))
        worst = max(worst, check_close(f"differentiable map {key}",
                                       value.cpu(), want, 1e-9 * scale)
                    / scale)
    log(f"differentiable_solution_map (nz={ctrl.spec.nz}, nc={ctrl.spec.nc}, "
        f"float64 on {dev.type}) at the controller's weights vs the host "
        f"operator: max |diff| / max(1, field max) {worst:.3e} (< 1e-9)")

    rng = np.random.default_rng(34)
    eps = plant.get_eps_max()
    x0s, ups, yps = scenario_batch(plant, ctrl, B, dev, torch.float64)
    Ws = rng.uniform(-eps, eps, (B, T, 2))
    loss = make_closed_loop_objective(ctrl.spec, plant.as_params(), x0s, ups,
                                      yps, Ws, n_steps=T, device=dev)
    a0 = 100.0 * a_yaml
    log0 = torch.log(torch.tensor([a0, s_yaml], dtype=torch.float64))

    def value_and_grad():
        params = log0.clone().requires_grad_()
        value = loss(params)
        value.backward()
        return value.detach(), params.grad

    timer = Timer()
    _, g = timer.timeit(value_and_grad, iters=3)
    h = 1e-5
    with torch.no_grad():
        for i in range(2):
            e = torch.zeros(2, dtype=torch.float64)
            e[i] = h
            fd = float(loss(log0 + e) - loss(log0 - e)) / (2 * h)
            if not abs(float(g[i]) - fd) < 1e-6 + 1e-4 * abs(fd):
                raise AssertionError(f"gradient {i}: autograd {float(g[i])} "
                                     f"vs central difference {fd}")
            log(f"tuning gradient d loss / d log {('alpha', 'sigma')[i]}_reg "
                f"{float(g[i]):.6e} vs central difference {fd:.6e} (rtol "
                "1e-4)")
    out = tune_regularization(loss, a0, s_yaml, steps=steps,
                              learning_rate=lr)
    hist = out["loss_history"]
    if not out["final_loss"] < out["initial_loss"]:
        raise AssertionError(f"tuning did not lower the loss: {hist}")
    log(f"tune_regularization (B={B}, T={T}, {steps} Adam steps at lr {lr}, "
        f"float64 on {dev.type}): value and grad {timer_ms(timer)}; loss "
        f"{hist[0]:.6e} -> {hist[-1]:.6e} (best {out['final_loss']:.6e}); "
        f"alpha_reg {a0:.4e} -> {out['alpha_reg']:.4e}, sigma_reg "
        f"{out['sigma_reg']:.4e} [{smi}]")


def profiling_phase(dev, smi, sweep, T=40) -> None:
    """Phase 35: one heterogeneous segment (the sweep's batch, ``T``
    steps) under ``utils.profiling.trace``: the Chrome trace file exists
    and holds the host's kernel launch events (on the CPU, host operator
    events); the card's kernel events are counted against them, and a
    warning of ``trace`` that some are missing is printed, not
    raised."""
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        heterogeneous_closed_loop,
    )
    from direct_data_driven_mpc_tpu_torch.utils.profiling import (
        _launches_and_kernels,
        trace,
    )

    ins = sweep["ins"]
    with tempfile.TemporaryDirectory() as tmp:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with trace(tmp) as path:
                heterogeneous_closed_loop(sweep["plants"], sweep["sol"],
                                          *ins[:3], ins[3][:, :T],
                                          n_steps=T)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    B = ins[0].shape[0]
    head = (f"profiling: utils.profiling.trace of one heterogeneous segment "
            f"(B={B} x T={T}) wrote a {size:,}-byte Chrome trace with")
    if dev.type != "cuda":
        count = sum(e.get("cat") == "cpu_op" for e in events)
        if count == 0:
            raise AssertionError("profiling: the trace holds no cpu_op "
                                 "events")
        log(f"{head} {count} cpu_op events ({count / T:.1f} per step) "
            f"[{smi}]")
        return
    launches, kernels = _launches_and_kernels(events)
    if launches == 0:
        raise AssertionError("profiling: the trace holds no kernel launch "
                             "events")
    log(f"{head} {launches} kernel launch events ({launches / T:.1f} per "
        f"step) and {kernels} kernel events of the card against them"
        + "".join(f"; warning: {w.message}" for w in caught)
        + f" [{smi}]")


def host_cpu() -> str:
    """The host's CPU, for host-side latencies: the model name (where
    the kernel reports one), vendor, family and model, the vector ISA
    that PyTorch found and the number of CPUs."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    return (f"{info.get('model name', platform.processor() or 'unknown')}, "
            f"{info.get('vendor_id', platform.machine())} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}, "
            f"{torch.backends.cpu.get_cpu_capability()}, "
            f"{os.cpu_count()} CPUs")


def native_phase(smi, host, n_steps=40, n_lat=200) -> None:
    """Phase 36: the interactive per-step solve in the C extension
    against numpy: builds, ``solve_path``, a host closed loop and the
    per-call latency."""
    from direct_data_driven_mpc_tpu_torch import native
    from direct_data_driven_mpc_tpu_torch.control.operation import (
        simulate_data_driven_mpc_control_loop,
    )

    t0 = time.perf_counter()
    ext = native.load()
    t_ext = time.perf_counter() - t0
    t0 = time.perf_counter()
    demo = native.build_runtime_demo()
    t_demo = time.perf_counter() - t0
    version = subprocess.run([ext.compiler, "--version"],
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()[0]
    log(f"native build: {ext.compiler} ({version}); {ext.path.name} "
        f"compiled in {ext.build_seconds:.2f} s ({t_ext:.2f} s with the "
        f"load), {os.path.basename(demo)} in {t_demo:.2f} s [host {host}; "
        f"card {smi}]")

    atol = {"NONE": 1e-12, "CONVEX": 1e-7}
    for slack in ("NONE", "CONVEX"):
        runs, lat = {}, {}
        for path in ("native", "numpy"):
            plant, ctrl = build_four_tank_robust(slack=slack,
                                                 solve_path=path)
            if ctrl.solve_path != path:
                raise AssertionError(f"{slack}: solve_path reads "
                                     f"{ctrl.solve_path!r}, asked {path!r}")
            if slack == "NONE":
                dims = f"nz {ctrl.spec.nz}, nc {ctrl.spec.nc}"
                if (ctrl.spec.nz, ctrl.spec.nc) != (571, 168):
                    raise AssertionError(f"four_tank_robust: {dims}")
            else:
                dims = f"nbox {ctrl._op['v_c'].shape[0]}"
                if ctrl._op["v_c"].shape[0] != 60:
                    raise AssertionError(f"four_tank_convex: {dims}")
            w = plant.get_eps_max() * np.random.default_rng(0).uniform(
                -1, 1, (n_steps + n_lat, ctrl.p))
            runs[path] = simulate_data_driven_mpc_control_loop(
                plant, ctrl, n_steps, None, verbose=0, w_sys=w[:n_steps])
            if ctrl.get_problem_solve_status() != "optimal":
                raise AssertionError(f"{slack} {path}: status "
                                     f"{ctrl.get_problem_solve_status()}")
            lat[path] = (live_solve_times(plant, ctrl, w[n_steps:]),
                         resolve_times(ctrl, n_lat))
        e_u = check_close(f"{slack} native vs numpy u",
                          torch.from_numpy(runs["native"][0]),
                          torch.from_numpy(runs["numpy"][0]), atol[slack])
        e_y = check_close(f"{slack} native vs numpy y",
                          torch.from_numpy(runs["native"][1]),
                          torch.from_numpy(runs["numpy"][1]), atol[slack])
        log(f"native interactive {slack} ({dims}): {n_steps}-step host "
            f"loop native vs numpy max |du| {e_u:.3e}, |dy| {e_y:.3e} "
            f"(atol {atol[slack]}); update_and_solve_data_driven_mpc, "
            f"p50 / p99 us of {n_lat} calls, live (the window moving) "
            f"then re-solving one window: "
            + "; ".join(f"{path} {p50(live)} / {p99(live)}, "
                        f"{p50(again)} / {p99(again)}"
                        for path, (live, again) in lat.items())
            + f" [host {host}; card {smi}]")


def live_solve_times(plant, ctrl, w) -> np.ndarray:
    """Seconds of each ``update_and_solve_data_driven_mpc`` in a host
    closed loop over the noise ``w`` (one solve per step, as in
    ``control.operation``'s loop at ``n_mpc_step`` 1): the window moves
    every step, so each CONVEX solve starts from the last step's
    iterate, not from its own solution."""
    times = np.empty(len(w))
    for k in range(len(w)):
        t0 = time.perf_counter()
        ctrl.update_and_solve_data_driven_mpc()
        times[k] = time.perf_counter() - t0
        u = ctrl.get_optimal_control_input_at_step(n_step=0)
        y = plant.simulate_step(u=u, w=w[k])
        ctrl.store_input_output_measurement(
            u_current=u.reshape(-1, 1), y_current=y.reshape(-1, 1))
    return times


def resolve_times(ctrl, n: int) -> np.ndarray:
    """Seconds of each of ``n`` ``update_and_solve_data_driven_mpc``
    calls on one window (``bench.py:1199-1208``)."""
    times = np.empty(n)
    for k in range(n):
        t0 = time.perf_counter()
        ctrl.update_and_solve_data_driven_mpc()
        times[k] = time.perf_counter() - t0
    return times


def p50(seconds) -> str:
    return f"{np.percentile(seconds, 50) * 1e6:.2f}"


def p99(seconds) -> str:
    return f"{np.percentile(seconds, 99) * 1e6:.2f}"


def export_phase(smi, T=400) -> None:
    """Phase 37: both controllers exported with the plant embedded, run
    for ``T`` steps by the C demo against the port's Python loop."""
    from direct_data_driven_mpc_tpu_torch import native
    from direct_data_driven_mpc_tpu_torch.control.operation import (
        simulate_data_driven_mpc_control_loop,
    )
    from direct_data_driven_mpc_tpu_torch.utils.export import (
        export_controller,
    )

    demo = native.build_runtime_demo()
    atol = {"NONE": 1e-10, "CONVEX": 1e-7}
    with tempfile.TemporaryDirectory() as tmp:
        def run(blob, noise, steps, out):
            return subprocess.run([demo, blob, noise, str(steps), out],
                                  capture_output=True, text=True,
                                  timeout=120)

        noise = os.path.join(tmp, "noise.f64")
        out = os.path.join(tmp, "out.f64")
        for slack in ("NONE", "CONVEX"):
            plant, ctrl = build_four_tank_robust(slack=slack)
            x0 = plant.get_state().copy()
            blob = os.path.join(tmp, f"{slack}.blob")
            export_controller(ctrl, blob, plant=plant, x0=x0)
            w = plant.get_eps_max() * np.random.default_rng(0).uniform(
                -1, 1, (T, ctrl.p))
            np.ascontiguousarray(w, dtype="<f8").tofile(noise)
            t0 = time.perf_counter()
            proc = run(blob, noise, T, out)
            t_demo = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"C demo {slack} exited with "
                                     f"{proc.returncode}: {proc.stderr}")
            raw = np.fromfile(out, dtype="<f8")
            m, p = ctrl.m, ctrl.p
            if raw.size != T * (m + p + 1):
                raise AssertionError(f"C demo {slack}: {raw.size} values")
            u_c = raw[: T * m].reshape(T, m)
            y_c = raw[T * m : T * (m + p)].reshape(T, p)
            costs_c = raw[T * (m + p) :]
            plant.set_state(x0)
            t0 = time.perf_counter()
            u_py, y_py = simulate_data_driven_mpc_control_loop(
                plant, ctrl, T, None, verbose=0, w_sys=w)
            t_py = time.perf_counter() - t0
            e_u = check_close(f"C runtime {slack} u", torch.from_numpy(u_c),
                              torch.from_numpy(u_py), atol[slack])
            e_y = check_close(f"C runtime {slack} y", torch.from_numpy(y_c),
                              torch.from_numpy(y_py), atol[slack])
            e_c = abs(costs_c[-1] - ctrl.get_optimal_cost_value())
            if not np.isfinite(costs_c).all() or e_c > 1e-6:
                raise AssertionError(f"C runtime {slack}: last cost off by "
                                     f"{e_c:.3e}")
            log(f"export + C runtime {slack}: blob "
                f"{os.path.getsize(blob):,} bytes; the demo ran T={T} "
                f"steps, exit status {proc.returncode}, in {t_demo:.3f} s "
                f"(process start included; the Python loop "
                f"{t_py:.3f} s); against the Python loop max |du| "
                f"{e_u:.3e}, |dy| {e_y:.3e} (atol {atol[slack]}), last "
                f"cost {e_c:.3e} (1e-6) [{smi}]")
        data = open(blob, "rb").read()
        bad = os.path.join(tmp, "bad.blob")
        with open(bad, "wb") as f:
            f.write(b"NOTDDMPC" + data[8:])
        trunc = os.path.join(tmp, "trunc.blob")
        with open(trunc, "wb") as f:
            f.write(data[: len(data) // 2])
        codes = []
        for name, path, why in (("bad header", bad, "bad header"),
                                ("truncated blob", trunc, "truncated")):
            proc = run(path, noise, 2, out)
            if proc.returncode == 0 or why not in proc.stderr:
                raise AssertionError(f"C demo accepted a {name}: "
                                     f"{proc.returncode} {proc.stderr}")
            codes.append(proc.returncode)
        log(f"export + C runtime: a bad header and a truncated blob refused "
            f"(exit statuses {codes[0]}, {codes[1]})")


def device_kernels(fn, calls: int = 3) -> tuple:
    """``(kernels, copies)`` per call of ``fn()``: the kernel launches and
    the copies and fills it issued, from the host's runtime calls in one
    profiler session of ``calls`` calls after one discarded warm-up call
    (:func:`profile_session`). Not from the device's own activity
    records: in a session of a few milliseconds some of those went
    missing, now and then all of them, their times scattered against the
    host's by up to ~21 ms on the card's machine
    (``scripts/profiler_sessions.py``, ``PERF.md`` §7), while the host's
    launch records were all there. Raises if ``fn`` issued no device
    work."""
    s = profile_session(fn, calls, warmup=1)[0]
    return s.launches / calls, s.copies / calls


def kernel_counts(fn, calls: int) -> str:
    """Kernels and copies launched per call (:func:`device_kernels`) from
    two profiler sessions of ``calls`` calls each (one pair when they
    agree), and the seconds the two sessions took."""
    t0 = time.perf_counter()
    counts = [device_kernels(fn, calls) for _ in range(2)]
    shown = counts[:1] if counts[0] == counts[1] else counts
    return (" / ".join(f"{k:g} kernels and {c:g} copies launched"
                       for k, c in shown)
            + f" per call (counted in {time.perf_counter() - t0:.1f} s)")


def time_parallel_phase(dev, smi, main, T=T_MAIN, Ks=(1, 50)) -> None:
    """Phase 38: ``time_parallel_rollout`` of one scenario on the card
    against the sequential engine, plain and with a setpoint schedule,
    at K = 1 and 50 in float32 and float64; on the card, timed in
    turns."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
        build_tracking_engine,
        linear_closed_loop_rollout,
        time_parallel_rollout,
    )

    plant, ctrl = main["plant"], main["ctrl"]
    x0s, ups, yps, Ws = main["inputs"]
    one = (x0s[0].double(), ups[0].double(), yps[0].double(),
           Ws[0, :T].double())
    r0 = np.concatenate([ctrl.u_s.ravel(), ctrl.y_s.ravel()])
    for K in Ks:
        n_outer = math.ceil(T / K)
        # bench.py:724-731: r0, then 0.85 r0, alternating every 100 steps.
        sched = np.stack([0.85 * r0 if (j * K // 100) % 2 else r0
                          for j in range(n_outer)])
        for kind, build, sp in (("plain", build_linear_engine, None),
                                ("tracking", build_tracking_engine, sched)):
            bms = {dt: build(ctrl, plant.as_params(), solves_per_block=K,
                             device=dev, dtype=dt)
                   for dt in (torch.float32, torch.float64)}
            tag = f"time-parallel K={K} (n_outer {n_outer}) {kind}"
            tp64 = time_parallel_rollout(bms[torch.float64], *one, T,
                                         setpoints=sp)
            seq64 = linear_closed_loop_rollout(bms[torch.float64], *one, T,
                                               setpoints=sp)
            errs = [check_close(f"{tag} f64 {name}", getattr(tp64, name),
                                getattr(seq64, name), 1e-9)
                    for name in ("u_sys", "y_sys", "x_final")]
            e_c = check_close(f"{tag} f64 costs", tp64.costs, seq64.costs,
                              1e-9, rtol=1e-7)
            tp32 = time_parallel_rollout(bms[torch.float32], *one, T,
                                         setpoints=sp)
            e_32 = max_abs(tp32.u_sys, tp64.u_sys)
            if tp32.u_sys.dtype != torch.float32 or e_32 >= NORTH_STAR:
                raise AssertionError(f"{tag}: float32 max |du| {e_32:.3e} "
                                     "against float64")
            log(f"{tag}: float64 against the sequential engine u, y, "
                f"x_final max |diff| {max(errs):.3e} (1e-9), costs "
                f"{e_c:.3e} (rtol 1e-7); float32 max |du| against float64 "
                f"{e_32:.3e} (< {NORTH_STAR}) [{smi}]")
            if kind == "tracking" or dev.type != "cuda":
                continue
            for dt, bm in bms.items():
                ins = tuple(a.to(dt) for a in one)
                calls = {
                    "time-parallel": lambda bm=bm, ins=ins: (
                        time_parallel_rollout(bm, *ins, T)),
                    "sequential": lambda bm=bm, ins=ins: (
                        linear_closed_loop_rollout(bm, *ins, T)),
                }
                reps = {"time-parallel": 50,
                        "sequential": 5 if n_outer > 100 else 50}
                ms = {k: [] for k in calls}
                for name in ("time-parallel", "sequential", "sequential",
                             "time-parallel"):
                    ms[name].append(cuda_ms(calls[name], reps[name]))
                profiled = {"time-parallel": 3,
                            "sequential": 1 if n_outer > 100 else 3}
                counts = {k: kernel_counts(fn, profiled[k])
                          for k, fn in calls.items()}
                dname = str(dt).replace("torch.", "")
                log(f"time-parallel timing K={K} {dname}: "
                    + "; ".join(
                        f"{k} {min(v):.4f}-{max(v):.4f} ms per trajectory, "
                        f"{counts[k]}" for k, v in ms.items())
                    + f" [{smi}]")


def device_ops_phase(dev, smi, main) -> None:
    """Phase 39: the Hankel, rank, persistent-excitation, observer,
    equilibrium and plant-rollout ops on the card against the host's, on
    the paper's data in float64."""
    from direct_data_driven_mpc_tpu_torch import ops
    from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
    from direct_data_driven_mpc_tpu_torch.ops.hankel import matrix_rank
    from direct_data_driven_mpc_tpu_torch.ops.host import (
        evaluate_persistent_excitation_np,
        hankel_matrix_np,
    )
    from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams

    ctrl = main["ctrl"]
    order = ctrl.L + 2 * ctrl.n
    u_d = torch.as_tensor(ctrl.u_d, device=dev)
    H = ops.hankel_matrix(u_d, order)
    if H.device != u_d.device or not np.array_equal(
            H.cpu().numpy(), hankel_matrix_np(ctrl.u_d, order)):
        raise AssertionError("hankel_matrix on the card differs from the "
                             "host's")
    if dev.type == "cuda":
        # numpy in, no device: the card, as jnp.asarray's accelerator.
        H_np = ops.hankel_matrix(ctrl.u_d, order)
        u_np = ops.calculate_equilibrium_input_from_output(
            *(FOUR_TANK[k] for k in "ABCD"), ctrl.y_s.ravel())
        if (H_np.device.type, u_np.device.type) != ("cuda", "cuda") or (
                not torch.equal(H_np, H)):
            raise AssertionError("a device op given numpy did not run on "
                                 f"the card: {H_np.device}, {u_np.device}")
    rank = int(matrix_rank(H))
    want = evaluate_persistent_excitation_np(ctrl.u_d, order)
    got = ops.evaluate_persistent_excitation(u_d, order)
    if rank != want[0] or got != want or not got[1]:
        raise AssertionError(f"rank {rank}, PE {got} against the host's "
                             f"{want}")
    const = ops.evaluate_persistent_excitation(torch.ones_like(u_d), order)
    if const[1]:
        raise AssertionError("constant data passed the PE check")

    A, B, C, D = (torch.as_tensor(FOUR_TANK[k], device=dev) for k in "ABCD")
    params = LTIParams(A, B, C, D)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.normal(size=4), device=dev)
    U = torch.as_tensor(rng.uniform(-1, 1, (4, 2)), device=dev)
    _, Y = ops.lti_rollout(params, x0, U, torch.zeros_like(U))
    x_hat = ops.estimate_initial_state(
        ops.observability_matrix(A, C),
        ops.toeplitz_input_output_matrix(A, B, C, D, 4), U.reshape(-1),
        Y.reshape(-1))
    e_x = check_close("estimate_initial_state", x_hat, x0, 1e-8)
    y_s = torch.as_tensor(ctrl.y_s.ravel(), device=dev)
    u_eq = ops.calculate_equilibrium_input_from_output(A, B, C, D, y_s)
    y_back = ops.calculate_equilibrium_output_from_input(A, B, C, D, u_eq)
    e_eq = check_close("equilibrium pair", y_back, y_s, 1e-10)

    model = LTIModel(**FOUR_TANK)
    model.set_state(np.zeros(4))
    w = FOUR_TANK["eps_max"] * rng.uniform(-1, 1, ctrl.y_d.shape)
    want_y = model.simulate(ctrl.u_d, w, ctrl.N)
    x_fin, got_y = ops.lti_rollout(
        params, torch.zeros(4, dtype=torch.float64, device=dev), u_d,
        torch.as_tensor(w, device=dev))
    e_y = check_close("lti_rollout", got_y.cpu(), torch.from_numpy(want_y),
                      1e-10)
    check_close("lti_rollout x_final", x_fin.cpu(),
                torch.from_numpy(model.get_state()), 1e-10)
    log(f"device ops on {dev.type}: hankel_matrix {tuple(H.shape)} "
        f"bit-equal to the host's, rank {rank} and PE {got} equal to the "
        f"host's (constant data: {const}); x0 round trip max |dx| "
        f"{e_x:.3e} (1e-8); equilibrium pair {e_eq:.3e} (1e-10); "
        f"lti_rollout over the {ctrl.N} data steps against "
        f"LTIModel.simulate {e_y:.3e} (1e-10), float64 [{smi}]")


B_SHARDED = 16384  # bench.py:798-906's sharded batch
# Phase 42's closed loop: B = 64 as tests/test_distributed_qp.py, T cut
# from 40 to 8 on one rank and to 1 on two: each solve of the loop took
# 2.0-2.5 s on one rank and 11-12 s on two gloo ranks, which stage three
# collectives per MINRES iteration through host memory.
B_PMINRES, T_PMINRES, T_PMINRES_TWO = 64, 8, 1
# Two ranks' metrics against one process's: the float32 costs come from
# cuBLAS products over 2048 rows against 4096, which round otherwise
# (single costs 3.3e-4 apart), and move the mean final cost past 1e-6.
METRICS_RTOL = 1e-5


def same_bits(tag, got, want, fields) -> None:
    """Every named field of two results bit-equal (and the solver
    states, where both carry one)."""
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: {f} differs, max |diff| "
                                 f"{max_abs(a, b):.3e}")
    if got.solver_state is not None:
        for f, a, b in zip(got.solver_state._fields, got.solver_state,
                           want.solver_state):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: solver state {f} differs")


def on_device(obj, dev):
    """A solver (a NamedTuple of tensors, nested ones included) on
    ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    return type(obj)(*(on_device(x, dev) for x in obj))


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


RESULT = ("u_sys", "y_sys", "costs", "converged", "x_final", "u_past",
          "y_past")


def unsharded_metrics(res) -> tuple:
    """``mean_final_cost`` and ``frac_converged`` of one whole result,
    summed as ``parallel.mesh.shard_metrics`` sums a shard."""
    return (float(res.costs[:, -1].double().sum() / res.costs.shape[0]),
            float(res.converged.sum(dtype=torch.float64)
                  / res.converged.numel()))


def sharded_phase(dev, smi, main, B=B_SHARDED, B_admm=B_ADMM,
                  T=T_MAIN):
    """Phase 40: ``bench.py``'s ``sharded`` configuration (l.798-906) on
    a world of one rank (NCCL on the card): the sharded K1, K1 with a
    tracking map, K4 and the classic engine with in-scan noise, each
    bit-equal to its unsharded run, the metrics equal to those of the
    unsharded result; K1 and K4 timed in turns against their unsharded
    runs, and the metrics' all_reduce timed. Returns the mesh."""
    import torch.distributed as dist

    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_tracking_engine,
        make_linear_batched_rollout,
    )
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel import mesh as pm
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )
    from direct_data_driven_mpc_tpu_torch.parallel.collectives import (
        all_reduce_sum,
    )

    plant, ctrl, bm50, bm100 = (main[k] for k in ("plant", "ctrl", "bm50",
                                                  "bm100"))
    mesh = pm.make_scenario_mesh(device=dev)
    sizes, _ = pm.mesh_layout(mesh)
    eps = plant.get_eps_max()
    K = bm50.os_c.shape[0] // bm50.M_T.shape[0]
    log(f"mesh: a world of {dist.get_world_size()} on "
        f"{dist.get_backend()}, (data, model) = ({sizes['data']}, "
        f"{sizes['model']}); B={B} x T={T}, K={K}")
    ins = (*scenario_batch(plant, ctrl, B, dev),
           draw_noise_batch(0, B, T, ctrl.p, eps, dev))
    if not torch.equal(ins[3][:B_MAIN], main["inputs"][3]):
        raise AssertionError("the main path's noise is not the first rows "
                             "of the larger batch's")
    log(f"noise: the first {B_MAIN} of {B} scenarios' draws are the main "
        "path's, bit for bit")

    def check_metrics(tag, metrics, res):
        want = unsharded_metrics(res)
        got = (float(metrics["mean_final_cost"]),
               float(metrics["frac_converged"]))
        if got != want:
            raise AssertionError(f"{tag} metrics {got} != {want}")
        return got

    def launched(kernel, run, args):
        kernel.launches = 0
        out = run(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            if kernel.launches < 1:
                raise AssertionError(f"{kernel.__name__} was not launched")
        return out, kernel.launches

    sharded = pm.make_sharded_fused_rollout(mesh, bm50, T)
    unsharded = fr.make_fused_batched_rollout(bm50, T)
    (res, metrics), n_k1 = launched(fr.fused_rollout, sharded, ins)
    want = unsharded(*ins)
    same_bits("sharded K1", res, want, RESULT)
    mean, conv = check_metrics("sharded K1", metrics, want)
    log(f"sharded K1 (fused_rollout launches {n_k1}): u, y, costs, final "
        f"state bit-equal to the unsharded rollout; mean_final_cost "
        f"{mean:.9g}, frac_converged {conv} equal to the unsharded "
        "result's")

    bm_t = build_tracking_engine(ctrl, plant.as_params(),
                                 solves_per_block=K, device=dev)
    n_outer = T // K
    r0 = torch.as_tensor(np.concatenate([ctrl.u_s.ravel(),
                                         ctrl.y_s.ravel()]),
                         dtype=torch.float32, device=dev)
    low = torch.tensor([(i // 2) % 2 == 1 for i in range(n_outer)],
                       device=dev)
    sched = torch.where(low[:, None], 0.85 * r0, r0)  # bench.py:724-731
    per_scenario = sched.expand(B, *sched.shape).contiguous()
    sharded_t = pm.make_sharded_fused_rollout(mesh, bm_t, T)
    (res_t, metrics_t), n_k1t = launched(
        fr.fused_rollout, sharded_t, (*ins, per_scenario))
    want_t = fr.make_fused_batched_rollout(bm_t, T)(*ins, per_scenario)
    same_bits("sharded K1 tracking", res_t, want_t, RESULT)
    check_metrics("sharded K1 tracking", metrics_t, want_t)
    try:
        sharded_t(*ins, sched)
    except ValueError:
        pass
    else:
        raise AssertionError("a shared (n_outer, n_r) schedule was taken")
    log(f"sharded K1 at four_tank_tracking (launches {n_k1t}), schedule "
        f"per scenario {tuple(per_scenario.shape)}: bit-equal; a shared "
        "schedule refused (ValueError), as in JAX")
    del res_t, want_t, per_scenario

    plant_c, ctrl_c, op, kw = admm_config("four_tank_convex")
    ins_c = (*scenario_batch(plant_c, ctrl_c, B_admm, dev),
             draw_noise_batch(0, B_admm, T, ctrl_c.p, eps, dev))
    args_c = (plant_c.as_params(), op, ctrl_c.n, ctrl_c.m, ctrl_c.p, T)
    sharded_a = pm.make_sharded_fused_admm_rollout(mesh, *args_c,
                                                   device=dev, **kw)
    unsharded_a = fa.make_fused_admm_rollout(*args_c, device=dev, **kw)
    (res_a, metrics_a), n_k4 = launched(fa.fused_admm, sharded_a, ins_c)
    want_a = unsharded_a(*ins_c)
    same_bits("sharded K4", res_a, want_a, RESULT)
    mean_a, conv_a = check_metrics("sharded K4", metrics_a, want_a)
    log(f"sharded K4 at four_tank_convex (B={B_admm} x T={T}, "
        f"fused_admm launches {n_k4}): u, y, costs, converged, state and "
        f"the ADMM state (s, w) bit-equal; mean_final_cost {mean_a:.9g}, "
        f"frac_converged {conv_a:.6f} equal to the unsharded result's")
    del res_a, want_a

    def rng_run(run):
        return run(*ins[:3], torch.Generator(device=dev).manual_seed(3))

    res_l = rng_run(pm.make_sharded_linear_rollout(
        mesh, bm100, T, use_rng_noise=True, eps_max=eps))
    want_l = rng_run(make_linear_batched_rollout(
        bm100, T, use_rng_noise=True, eps_max=eps))
    same_bits("sharded classic engine", res_l, want_l, RESULT)
    log(f"sharded classic engine (K=100, in-scan noise, B={B}): bit-equal "
        "to the unsharded run on a generator seeded alike")
    del res_l, want_l
    if dev.type != "cuda":
        return mesh

    solves = {"K1": B * T, "K4": B_admm * T}
    runs = {
        "K1": {"sharded": lambda: sharded(*ins),
               "unsharded": lambda: unsharded(*ins)},
        "K4": {"sharded": lambda: sharded_a(*ins_c),
               "unsharded": lambda: unsharded_a(*ins_c)},
    }
    for kernel, reps in (("K1", 20), ("K4", 2)):
        ms = {"sharded": [], "unsharded": []}
        for name in ("sharded", "unsharded", "unsharded", "sharded"):
            ms[name].append(cuda_ms(runs[kernel][name], reps=reps))
        log(f"timing sharded {kernel}: " + "; ".join(
            f"{name} " + ", ".join(f"{t:.4f}" for t in v) + " ms -> "
            f"{solves[kernel] / (sum(v) / len(v) * 1e-3):,.0f} solves/s"
            for name, v in ms.items()) + f" [{smi}]")
    t_metrics = cuda_ms(lambda: pm.shard_metrics(res, mesh), reps=200)
    x = torch.zeros(4, dtype=torch.float64, device=dev)
    t_ar = cuda_ms(lambda: all_reduce_sum(x, mesh.get_group("data")),
                   reps=200)
    log(f"timing metrics: shard_metrics {t_metrics * 1e3:.1f} us per call "
        f"(its all_reduce of 4 float64 alone {t_ar * 1e3:.1f} us) "
        f"[{smi}]")
    return mesh


def two_rank_worker(rank, world, tmp, case):
    """One of phase 41's ranks (``torch.multiprocessing`` calls it in a
    process of its own): joins the gloo group on a ``FileStore`` in
    ``tmp``, runs the mesh rollouts and the PMINRES cases on
    ``case['device']``, writes its results to ``tmp/out_<rank>.pt`` and
    ends its group."""
    from datetime import timedelta

    import torch.distributed as dist

    from direct_data_driven_mpc_tpu_torch.parallel import mesh as pm
    from direct_data_driven_mpc_tpu_torch.parallel import multihost as mh
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )
    from direct_data_driven_mpc_tpu_torch.parallel.collectives import (
        all_reduce_sum,
    )
    from direct_data_driven_mpc_tpu_torch.qp import distributed as qd

    dev = torch.device(case["device"])
    torch.set_float32_matmul_precision("high")
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), world), rank=rank, world_size=world,
        timeout=timedelta(seconds=300))
    try:
        B, eps = case["B"], case["eps"]
        out = {}
        idx = mh.global_scenario_indices(B)
        out["indices"] = torch.as_tensor(idx)
        out["noise"] = draw_noise_batch(0, len(idx), case["T"], 2, eps, dev,
                                        first_index=int(idx[0])).cpu()
        x = torch.tensor([rank + 1.0], device=dev)
        out["gloo_sum"] = all_reduce_sum(x, dist.group.WORLD).cpu()

        meshes = {shape: pm.make_scenario_mesh(*shape, device=dev)
                  for shape in ((2, 1), (1, 2))}
        for shape, mesh in meshes.items():
            sl = pm.scenario_slice(B, mesh)
            n = sl.stop - sl.start
            x0s, ups, yps = (torch.as_tensor(a, device=dev).expand(
                n, *a.shape[1:]).contiguous() for a in case["window"])
            Ws = draw_noise_batch(0, n, case["T"], 2, eps, dev,
                                  first_index=sl.start)
            for name, (solver, T, iters, mp) in case["runs"].items():
                if mp and shape[1] == 1:
                    continue
                run = pm.make_mesh_rollout(
                    mesh, case["plant"], on_device(solver, dev), T,
                    admm_iters=iters, model_parallel=mp)
                t0 = time.perf_counter()
                res, metrics = run(x0s, ups, yps, Ws[:, :T])
                sync(dev)
                key = f"{shape}/{name}"
                out[f"{key}/s"] = torch.tensor(time.perf_counter() - t0)
                out[f"{key}/u"], out[f"{key}/y"], out[f"{key}/c"] = (
                    res.u_sys.cpu(), res.y_sys.cpu(), res.costs.cpu())
                out[f"{key}/metrics"] = torch.stack([
                    metrics["mean_final_cost"],
                    metrics["frac_converged"]]).cpu()
        p = case["pminres"]
        mesh = meshes[1, 2]
        for name, kw in p["solves"].items():
            solve = qd.make_distributed_kkt_solver(p["spec"], mesh,
                                                   device=dev, **kw)
            sync(dev)
            t0 = time.perf_counter()
            u, res, iters = solve(p["theta"])
            out[f"pminres/{name}/s"] = torch.tensor(time.perf_counter() - t0)
            out[f"pminres/{name}/u"] = u.cpu()
            out[f"pminres/{name}/res"] = res.cpu()
            out[f"pminres/{name}/iters"] = iters.cpu()
        run = qd.make_distributed_closed_loop(
            mesh, case["plant"], p["spec"], p["T"], device=dev, **p["kw"])
        t0 = time.perf_counter()
        res = run(*p["inputs"])
        sync(dev)
        out["pminres/loop/s"] = torch.tensor(time.perf_counter() - t0)
        out["pminres/loop/u"] = res.u_sys.cpu()
        out["pminres/loop/converged"] = res.converged.cpu()
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def two_rank_phase(dev, smi, main, mesh, B=B_MAIN, T=T_MAIN, T_iter=40,
                   T_loop=T_PMINRES_TWO, B_loop=B_PMINRES, timeout=900):
    """Phase 41: two ranks on the one card (gloo with CUDA tensors, the
    collectives staged through host memory by design), started by
    ``torch.multiprocessing`` with ``spawn``: the generic loop of the
    four-tank ``SolutionMap`` on (2, 1) and (1, 2) meshes, data- and
    model-parallel, and the ADMM, box-ladder and NON_CONVEX solvers
    (T cut to ``T_iter``), their concatenated shards against this
    process's run on its world of one; the global scenario indices and
    the noise across both ranks. The ranks also run phase 42's PMINRES
    cases on the (1, 2) mesh; their results are returned for it."""
    import torch.multiprocessing as mp

    from direct_data_driven_mpc_tpu_torch.parallel import mesh as pm
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    plant, ctrl = main["plant"], main["ctrl"]
    eps = plant.get_eps_max()
    if dev.type == "cuda":
        mode = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        log(f"compute mode: {mode} (two processes must share the card)")
    _, ctrl_c = build_four_tank_robust(slack="CONVEX")
    _, ctrl_n = build_four_tank_robust(slack="NON_CONVEX", c=0.05,
                                       allow_nonconvex_slack=True)
    sol = ctrl.solution_map(device="cpu")
    runs = {  # name -> (solver on the host, T, admm_iters, model parallel)
        "exact": (sol, T, 100, False),
        "exact_model_parallel": (sol, T, 100, True),
        "admm": (ctrl_c.admm_solver(device="cpu"), T_iter, 16, False),
        "box_ladder": (ctrl.box_admm_solver(u_bounds=(-0.85, 0.85),
                                            device="cpu"), T_iter, 120,
                       False),
        "nonconvex": (ctrl_n.nonconvex_admm_solver(device="cpu"), T_iter,
                      16, False),
    }
    window = (plant.get_state().reshape(1, -1),
              ctrl.u_past.reshape(1, ctrl.n, ctrl.m),
              ctrl.y_past.reshape(1, ctrl.n, ctrl.p))
    window = tuple(torch.as_tensor(a, dtype=torch.float32) for a in window)
    case = dict(device=str(dev), B=B, T=T, eps=eps, window=window,
                plant=plant.as_params(), runs=runs,
                pminres=pminres_case(main, T_loop, B_loop))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(two_rank_worker, args=(2, tmp, case),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"the two ranks ran past {timeout} s")
        secs = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"out_{r}.pt"))
                for r in range(2)]
    log(f"two ranks (gloo, spawn, FileStore) ran in {secs:.1f} s, start "
        "and exit included")

    whole = draw_noise_batch(0, B, T, 2, eps, dev).cpu()
    if not (torch.equal(torch.cat([o["indices"] for o in outs]),
                        torch.arange(B))
            and torch.equal(torch.cat([o["noise"] for o in outs]), whole)):
        raise AssertionError("the ranks' global indices or noise differ "
                             "from the single process's")
    if not all(float(o["gloo_sum"]) == 3.0 for o in outs):
        raise AssertionError("gloo all_reduce of CUDA tensors: "
                             f"{[float(o['gloo_sum']) for o in outs]}")
    log(f"global_scenario_indices: the ranks hold scenarios 0-{B // 2 - 1} "
        f"and {B // 2}-{B - 1}; their noise drawn from their first indices "
        "is the single process's draw, bit for bit; gloo all_reduce of "
        f"{dev.type} tensors: 1 + 2 = 3")

    x0s, ups, yps = scenario_batch(plant, ctrl, B, dev)
    Ws = whole.to(dev)
    for name, (solver, T_run, iters, mp_) in runs.items():
        ref, ref_m = pm.make_mesh_rollout(
            mesh, plant.as_params(), on_device(solver, dev), T_run,
            admm_iters=iters)(x0s, ups, yps, Ws[:, :T_run])
        ref_m = torch.stack([ref_m["mean_final_cost"],
                             ref_m["frac_converged"]]).cpu()
        for shape in ((2, 1), (1, 2)):
            key = f"{shape}/{name}"
            if f"{key}/u" not in outs[0]:
                continue
            if shape == (2, 1):
                got = {f: torch.cat([o[f"{key}/{f}"] for o in outs])
                       for f in ("u", "y", "c")}
            else:
                got = {f: outs[0][f"{key}/{f}"] for f in ("u", "y", "c")}
                for f in ("u", "y", "c"):
                    if not torch.equal(outs[1][f"{key}/{f}"], got[f]):
                        raise AssertionError(f"{key}: the model replicas' "
                                             f"{f} differ")
            e_u = check_close(f"{key} u", got["u"].to(dev), ref.u_sys, ATOL)
            e_y = check_close(f"{key} y", got["y"].to(dev), ref.y_sys, ATOL)
            e_c = float(((got["c"].to(dev) - ref.costs).abs()
                         / ref.costs.abs()).max())
            e_m = max(float(((o[f"{key}/metrics"] - ref_m).abs()
                             / ref_m.abs()).max()) for o in outs)
            if not e_m <= METRICS_RTOL:
                raise AssertionError(
                    f"{key} metrics {outs[0][key + '/metrics'].tolist()} "
                    f"against {ref_m.tolist()}")
            log(f"two ranks {shape} {name} (B={B}, T={T_run}): max |du| "
                f"{e_u:.3e}, |dy| {e_y:.3e} (atol {ATOL}), costs rel "
                f"{e_c:.3e} against one process; metrics {ref_m.tolist()} "
                f"rel {e_m:.3e} (rtol {METRICS_RTOL}) on both ranks; "
                f"{float(outs[0][key + '/s']):.2f} s")
    return outs


PMINRES_F64 = dict(dtype=torch.float64, tol=1e-10, max_iters=5000)
PMINRES_F32 = dict(dtype=torch.float32, refine=1, max_iters=4000)
PMINRES_LOOP = dict(dtype=torch.float64, tol=1e-11, max_iters=5000)


def pminres_case(main, T_loop, B=B_PMINRES) -> dict:
    """Phase 42's problem: the paper's four-tank Robust spec (nz 571, nc
    168), its initial window, the solver settings and the closed loop's
    first ``B`` scenarios of the main path's batch for ``T_loop`` steps,
    in float64 on the host."""
    plant, ctrl = main["plant"], main["ctrl"]
    x0s, ups, yps, Ws = main["inputs"]
    return dict(
        spec=ctrl.spec,
        theta=np.concatenate([ctrl.u_past.ravel(), ctrl.y_past.ravel()]),
        solves={"float64": PMINRES_F64},
        T=T_loop, kw=PMINRES_LOOP,
        inputs=tuple(a.double().cpu() for a in (
            x0s[:B], ups[:B], yps[:B], Ws[:B, :T_loop])),
    )


def pminres_phase(dev, smi, main, mesh, outs, T_loop=T_PMINRES,
                  B=B_PMINRES) -> None:
    """Phase 42: the alpha-sharded PMINRES on the four-tank Robust spec,
    on this process's one-rank mesh (NCCL on the card) and on phase 41's
    two-rank (1, 2) gloo mesh: single solves in float64 (tol 1e-10)
    against the exact operator (atol 1e-6), float32 with one refinement
    restart against float64 (1e-4; one rank), the closed loop at B x T
    in float64
    (tol 1e-11) against the generic loop with the exact map (u within
    1e-7); ms and iterations per solve, device kernels per MINRES
    iteration; CONVEX slack refused."""
    from direct_data_driven_mpc_tpu_torch.control.loop import (
        closed_loop_rollout,
    )
    from direct_data_driven_mpc_tpu_torch.qp import distributed as qd
    from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
        compute_solution_map,
        solve_u,
    )

    plant, ctrl = main["plant"], main["ctrl"]
    p = pminres_case(main, T_loop, B)
    spec = p["spec"]
    if (spec.nz, spec.nc) != (571, 168):
        raise AssertionError(f"QP dims {spec.nz}, {spec.nc}")
    exact = compute_solution_map(spec, device=dev, dtype=torch.float64)
    u_ex = solve_u(exact, torch.as_tensor(p["theta"], device=dev))
    bars = {"float64": 1e-6, "float32_refine": NORTH_STAR}
    # The float32 restart solve (~4400 iterations) runs on one rank only:
    # at two gloo ranks' 4.4-5.8 ms per iteration it would take 20-25 s.
    for name, kw in dict(p["solves"], float32_refine=PMINRES_F32).items():
        solve = qd.make_distributed_kkt_solver(spec, mesh, device=dev, **kw)
        sync(dev)
        t0 = time.perf_counter()
        u, res, iters = solve(p["theta"])
        sync(dev)
        found = {"one rank": (u.cpu(), res.cpu(), iters.cpu(),
                              time.perf_counter() - t0)}
        if name in p["solves"]:
            found["two ranks (1, 2)"] = tuple(
                outs[0][f"pminres/{name}/{k}"]
                for k in ("u", "res", "iters", "s"))
        for where, (u, res, iters, secs) in found.items():
            du = max_abs(u.double().to(dev), u_ex)
            if not du < bars[name]:
                raise AssertionError(f"PMINRES {name} on {where}: max |du| "
                                     f"{du:.3e} >= {bars[name]}")
            log(f"PMINRES {name} on {where}: max |du| {du:.3e} against the "
                f"exact operator (< {bars[name]}), residual "
                f"{float(res):.3e}, {int(iters)} iterations, "
                f"{secs * 1e3:.1f} ms per solve, "
                f"{secs / int(iters) * 1e3:.3f} ms per iteration [{smi}]")
    if dev.type == "cuda":
        counts = []
        for n_iter in (20, 60):
            fixed = qd.make_distributed_kkt_solver(
                spec, mesh, device=dev, dtype=torch.float64, tol=0.0,
                max_iters=n_iter)
            counts.append(device_kernels(lambda: fixed(p["theta"]), 1))
        per = [(b - a) / 40 for a, b in zip(counts[0], counts[1])]
        log(f"PMINRES on one rank: {per[0]:g} kernels and {per[1]:g} "
            "copies launched per MINRES iteration (a 60-iteration solve "
            "less a 20-iteration one, over 40)")

    run = qd.make_distributed_closed_loop(mesh, plant.as_params(), spec,
                                          T_loop, device=dev,
                                          **p["kw"])
    ins = tuple(a.to(dev) for a in p["inputs"])
    sync(dev)
    t0 = time.perf_counter()
    res = run(*ins)
    sync(dev)
    secs = time.perf_counter() - t0
    ref = closed_loop_rollout(plant.as_params(), exact, *ins,
                              n_steps=T_loop)
    for where, (u, conv, s) in {
        "one rank": (res.u_sys, res.converged, secs),
        "two ranks (1, 2)": tuple(outs[0][f"pminres/loop/{k}"]
                                  for k in ("u", "converged", "s")),
    }.items():
        T_run = u.shape[1]  # the two-rank run is this run's first steps
        du = check_close(f"PMINRES closed loop on {where}", u.to(dev),
                         ref.u_sys[:, :T_run], 1e-7)
        log(f"PMINRES closed loop on {where} (B={B}, T={T_run}, float64, "
            f"tol {p['kw']['tol']}): max |du| {du:.3e} against the generic "
            f"loop with the exact map (atol 1e-7); converged "
            f"{float(conv.double().mean()):.4f}; {float(s):.2f} s, "
            f"{float(s) / T_run * 1e3:.1f} ms per solve of {B} scenarios "
            f"[{smi}]")
    _, ctrl_c = build_four_tank_robust(slack="CONVEX")
    try:
        qd.make_distributed_kkt_solver(ctrl_c.spec, mesh, device=dev)
    except ValueError as e:
        log(f"PMINRES refuses CONVEX slack: {e}")
    else:
        raise AssertionError("PMINRES took a CONVEX slack spec")


def example_args(module, dev, *argv):
    """A port CLI's parsed flags: ``argv`` on its defaults, headless,
    silent, on ``dev``."""
    return module.parse_args([*argv, "--device", str(dev), "--verbose", "0",
                              "--no_plot"])


def example_controller(config, seed):
    """The controller an example pipeline builds from ``config`` with
    ``default_rng(seed)``, and its plant: the same draws, so the same
    controller."""
    from direct_data_driven_mpc_tpu_torch.control.creation import (
        create_data_driven_mpc_controller,
    )
    from direct_data_driven_mpc_tpu_torch.examples import common

    plant, _ = example_configs()
    rng = np.random.default_rng(seed)
    u_d, y_d = common.initial_data(plant, config, rng)
    return plant, create_data_driven_mpc_controller(config, u_d, y_d)


def timed(fn, dev):
    """``(fn(), seconds)`` on the host clock, the card synchronized."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def k1_at_one_scenario_ms(dev, config, T) -> tuple:
    """``(K1 ms, plain ms, rows)``: one rollout of the direct example's
    ``kernel`` engine at B = 1 (seed 0) by CUDA events, K1 against its
    plain version, and the rows B x n_outer of its product."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
    )
    from direct_data_driven_mpc_tpu_torch.examples import common
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr

    plant, ctrl = example_controller(config, 0)
    nb, n_steps = ctrl.n_mpc_step, T + 1
    K = min(50, -(-n_steps // nb))
    bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                             device=dev)
    n_outer = math.ceil(n_steps / (K * nb))
    W = torch.zeros((1, n_steps, ctrl.p), device=dev)
    s0, Wp = fr._center_and_pack(
        bm, *common.scenario_windows(plant, ctrl, 1, dev), W, n_outer,
        K * nb, n_outer * K * nb - n_steps)
    op = fr._build_fused_operator(bm)
    before = fr.fused_rollout.launches
    ms = {name: cuda_ms(lambda: rollout(op, s0, Wp), reps=200)
          for name, rollout in (("kernel", fr.fused_rollout),
                                ("plain", fr.fused_rollout_reference))}
    if fr.fused_rollout.launches - before != 201:
        raise AssertionError("K1 at B = 1 did not launch once per call")
    return ms["kernel"], ms["plain"], n_outer


def example_phase(dev, smi, T=400, mc=(4096, 200), track=(512, 400, 25),
                  tune=(8, 80, 25)) -> None:
    """Phase 43: the example CLIs' pipelines on ``dev`` at their
    defaults, the configs from :func:`example_configs` (no YAML)."""
    import importlib.util

    from direct_data_driven_mpc_tpu_torch.control.loop import (
        closed_loop_rollout,
    )
    from direct_data_driven_mpc_tpu_torch.examples import (
        common,
        direct_data_driven_mpc_example as direct,
        monte_carlo_example as mc_ex,
        regularization_tuning_example as tuning,
        setpoint_tracking_example as tracking,
    )
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    cuda = dev.type == "cuda"
    log("phase 43: PyYAML "
        + ("importable" if importlib.util.find_spec("yaml") else "absent")
        + ", matplotlib "
        + ("importable" if importlib.util.find_spec("matplotlib")
           else "absent") + " (the configs are built here, no figure)")

    def direct_run(*argv, rollout=fr.fused_rollout):
        plant, config = example_configs()
        args = example_args(direct, dev, "--t_sim", str(T), "--seed", "0",
                            *argv)
        return timed(lambda: direct.simulate(plant, config, args,
                                             rollout=rollout), dev)

    # The direct example at T + 1 steps on every engine (seed 0).
    host, t_host = direct_run("--engine", "host")
    fr.fused_rollout.launches = 0
    kern, t_kern = direct_run("--engine", "kernel")
    k1 = fr.fused_rollout.launches
    if cuda and k1 != 1:
        raise AssertionError(f"--engine kernel launched K1 {k1} times")
    plain, _ = direct_run("--engine", "kernel",
                          rollout=fr.fused_rollout_reference)
    errs = [equal_or_close(
        f"direct kernel vs plain {key}", torch.as_tensor(kern[key]),
        torch.as_tensor(plain[key]), "cuBLAS sums this one scenario in "
        "another order") for key in ("u_sys", "y_sys", "x_final", "u_past",
                                     "y_past")]
    log(f"direct example T={T + 1}: host {t_host:.3f} s; kernel "
        f"{t_kern:.3f} s, K1 launched {k1}, B = 1, max |diff| vs plain "
        f"(U, Y, s_fin) {max(errs):.3e} [{smi}]")
    runs = {"kernel": (kern, t_kern)}
    for engine in ("linear", "fused"):
        runs[engine] = direct_run("--engine", engine)
    host_c, _ = direct_run("--engine", "host", "--slack_var_const_type",
                           "Convex")
    runs["fused CONVEX"] = direct_run("--engine", "fused",
                                      "--slack_var_const_type", "Convex")
    for name, (out, secs) in runs.items():
        want = host_c if "CONVEX" in name else host
        du = check_close(f"direct {name} vs host float64 u",
                         torch.as_tensor(out["u_sys"]),
                         torch.as_tensor(want["u_sys"]), NORTH_STAR)
        if not out["converged"].all():
            raise AssertionError(f"direct {name}: not converged")
        log(f"direct {name}: {secs:.3f} s, max |du| vs host float64 "
            f"{du:.3e} (< {NORTH_STAR}), all converged [{smi}]")
    box, secs = direct_run("--engine", "fused", "--u_min", "-0.85",
                           "--u_max", "0.85")
    if not np.isfinite(box["u_sys"]).all() or \
            np.abs(box["u_sys"]).max() > 0.85 + 1e-6:
        raise AssertionError("direct fused box: |u| above 0.85 or not "
                             "finite")
    log(f"direct fused box |u| <= 0.85: {secs:.3f} s, max |u| "
        f"{np.abs(box['u_sys']).max():.7f}, converged "
        f"{box['converged'].mean():.4f} [{smi}]")
    if cuda:
        ms, plain_ms, rows = k1_at_one_scenario_ms(dev, example_configs()[1],
                                                   T)
        log(f"K1 at B = 1 ({rows} product rows): {ms:.4f} ms per rollout, "
            f"plain version {plain_ms:.4f} ms [{smi}]")

    # Monte Carlo: the classic engine, in-loop noise from a generator.
    B, T_mc = mc
    plant, config = example_configs()
    out, secs = timed(lambda: mc_ex.simulate(plant, config, example_args(
        mc_ex, dev, "--batch", str(B), "--t_sim", str(T_mc))), dev)
    if out["y_sys"].shape != (B, T_mc, 2) or not (
            np.isfinite(out["y_sys"]).all() and out["stable"]):
        raise AssertionError("Monte Carlo: shape, finiteness or stability")
    err = np.linalg.norm(out["y_sys"][:, -1] - out["y_s"], axis=-1)
    log(f"Monte Carlo {B} x {T_mc}: spectral radius "
        f"{out['spectral_radius']:.4f}, the rollout {out['seconds']:.4f} s "
        f"(Timer, after a warm-up; {B * T_mc / out['seconds']:,.0f} "
        f"solves/s), pipeline {secs:.2f} s; final tracking error p50 "
        f"{np.percentile(err, 50):.4f} [{smi}]")

    # Setpoint tracking: K1 with the staircase, against its plain version
    # and the generic loop with the schedule per solve.
    B, T_tr, K = track
    argv = ("--batch", str(B), "--t_sim", str(T_tr), "--solves_per_block",
            str(K))
    fr.fused_rollout.launches = 0
    plant, config = example_configs()
    got, secs = timed(lambda: tracking.simulate(
        plant, config, example_args(tracking, dev, *argv)), dev)
    k1 = fr.fused_rollout.launches
    if cuda and k1 != 1:
        raise AssertionError(f"tracking launched K1 {k1} times")
    plant, config = example_configs()
    want = tracking.simulate(plant, config, example_args(tracking, dev,
                                                         *argv),
                             rollout=fr.fused_rollout_reference)
    errs = [equal_or_close(f"tracking K1 vs plain {key}",
                           torch.as_tensor(got[key]),
                           torch.as_tensor(want[key]),
                           "cuBLAS sums this batch in another order")
            for key in ("u_sys", "y_sys", "x_final")]
    plant, ctrl = example_controller(dict(config, n_mpc_step=1), 0)
    x0s, ups, yps = common.scenario_windows(plant, ctrl, B, dev)
    Ws = draw_noise_batch(0, B, T_tr, 2, plant.get_eps_max(), dev)
    per_solve = torch.as_tensor(np.repeat(got["sched"], K, axis=0)[:T_tr],
                                device=dev)
    gen, t_gen = timed(lambda: closed_loop_rollout(
        plant.as_params(), ctrl.tracking_map(device=dev), x0s, ups, yps, Ws,
        T_tr, setpoints=per_solve), dev)
    du = check_close("tracking K1 vs generic loop u",
                     torch.as_tensor(got["u_sys"], device=dev), gen.u_sys,
                     NORTH_STAR)
    log(f"setpoint tracking {B} x {T_tr}, K={K}: pipeline {secs:.3f} s, "
        f"K1 launched {k1}; max |diff| vs plain (U, Y, s_fin) "
        f"{max(errs):.3e}; vs the generic loop ({t_gen:.3f} s) max |du| "
        f"{du:.3e} (< {NORTH_STAR}); RMSE {got['rmse']:.4f} [{smi}]")

    # Tuning the ridge weights by autograd, float64 on the card.
    B, T_tu, steps = tune
    plant, config = example_configs()
    out, secs = timed(lambda: tuning.simulate(plant, config, example_args(
        tuning, dev, "--batch", str(B), "--t_sim", str(T_tu), "--steps",
        str(steps))), dev)
    if not (np.isfinite(out["loss_history"]).all()
            and out["final_loss"] < out["initial_loss"]):
        raise AssertionError(f"tuning did not lower the loss: {out}")
    log(f"tuning {B} x {T_tu}, {steps} Adam steps: {secs:.2f} s, "
        f"{secs / steps * 1e3:.1f} ms per step (the controller, operator "
        f"and three more loss evaluations included), loss "
        f"{out['initial_loss']:.6e} -> {out['final_loss']:.6e} [{smi}]")


def reproduction_phase(dev, smi, t_sim=600) -> None:
    """Phase 44: the paper reproduction's three schemes at ``t_sim``,
    seed 4, from :func:`example_configs`; no figure."""
    from direct_data_driven_mpc_tpu_torch.examples import (
        robust_data_driven_mpc_reproduction as repro,
    )

    plant, config = example_configs()
    args = repro.parse_args(["--t_sim", str(t_sim), "--verbose", "0",
                             "--no_plot"])
    (u, y), secs = timed(lambda: repro.simulate(plant, config, args), dev)
    if [a.shape for a in u + y] != [(t_sim + 1, 2)] * 6 or not all(
            np.isfinite(a).all() for a in u + y):
        raise AssertionError("reproduction: shapes or finiteness")
    if abs(y[0][0] - 0.4).max() > 0.005:
        raise AssertionError(f"reproduction: y_0 {y[0][0]} not forced to "
                             "0.4")
    errs = ", ".join(
        f"{s.name} {np.abs(a[-1] - config['y_s'].ravel()).max():.5f}"
        for s, a in zip(repro.SCHEMES, y))
    log(f"reproduction t_sim={t_sim}, seed 4: {secs:.2f} s on the host "
        f"(3 x {t_sim + 1 - config['n']} steps); final output errors "
        f"{errs}")


def entry_phase(dev, smi, n_dryrun=2) -> None:
    """Phase 45: ``entry()``'s step on ``dev`` against the generic loop's
    first step, then ``dryrun_multichip(n_dryrun)``."""
    from direct_data_driven_mpc_tpu_torch import entry as port_entry
    from direct_data_driven_mpc_tpu_torch.control.loop import (
        closed_loop_rollout,
    )

    (fn, args), secs = timed(lambda: port_entry.entry(device=dev), dev)
    out, t_step = timed(lambda: fn(*args), dev)
    plant, ctrl = port_entry.four_tank_controller()
    x, u_past, y_past, w = args
    ref = closed_loop_rollout(
        plant.as_params(), ctrl.solution_map(device=dev), x[None],
        u_past[None], y_past[None], w[None, None], n_steps=1)
    errs = [check_close(f"entry {name}", got, want, ATOL)
            for name, got, want in (
                ("x_next", out[0], ref.x_final[0]),
                ("y", out[1], ref.y_sys[0, 0]),
                ("u0", out[2], ref.u_sys[0, 0]),
                ("u_past", out[3], ref.u_past[0]),
                ("y_past", out[4], ref.y_past[0]))]
    log(f"entry(): built in {secs:.2f} s, one step {t_step * 1e3:.2f} ms "
        f"(host clock, first call), max |diff| vs the generic loop's first "
        f"step {max(errs):.3e} (atol {ATOL}) [{smi}]")
    res, secs = timed(lambda: port_entry.dryrun_multichip(
        n_dryrun, device=dev), dev)
    if dev.type == "cuda" and not (res["k1_launches"] >= 2
                                   and res["k4_launches"] >= 1):
        raise AssertionError(f"dryrun ranks did not launch K1 and K4: {res}")
    log(f"dryrun_multichip({n_dryrun}) OK in {secs:.1f} s (spawn included):"
        f" mesh {res['mesh']}, B={res['B']}, mean_final_cost "
        f"{res['mean_final_cost']:.5f}, KKT res {res['res']:.1e} in "
        f"{res['iters']} iterations, |du| fused {res['du_fused']:.3e}, "
        f"tracking {res['du_track']:.1e}, KKT {res['du_kkt']:.3e}; rank 0 "
        f"launched K1 {res['k1_launches']}, K4 {res['k4_launches']} "
        f"[{smi}]")


def event_turns(fns: dict, reps: dict, count) -> dict:
    """Mean milliseconds per call of each ``fns[name]()`` by CUDA events,
    in turns (the names in order, then reversed), each already warm.
    ``count()`` reads the kernel's launch count: a "kernel" turn must add
    one launch per call and a "plain" turn none."""
    ms = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = count()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps[name]):
            fns[name]()
        end.record()
        torch.cuda.synchronize()
        launched = count() - before
        if launched != (reps[name] if name == "kernel" else 0):
            raise AssertionError(f"{name}: {launched} launches in "
                                 f"{reps[name]} calls")
        ms[name].append(start.elapsed_time(end) / reps[name])
    return {name: sum(v) / len(v) for name, v in ms.items()}


RESULT_FIELDS = ("u_sys", "y_sys", "x_final", "u_past", "y_past")


def result_bits(got, want) -> bool:
    """Whether u, y, the final windows and any solver state are equal."""
    fields = [(getattr(got, f), getattr(want, f)) for f in RESULT_FIELDS]
    if got.solver_state is not None:
        fields += list(zip(got.solver_state, want.solver_state))
    return all(torch.equal(a, b) for a, b in fields)


def compare_admm_at_rounding(tag, got, want, lanes, tol,
                             cost_atol=COST_ATOL):
    """Kernel against plain version where the two may differ by rounding:
    u, y, the final windows, s and w within ``ATOL``, costs within
    ``COST_RTOL``/``cost_atol``; the primal and dual residual lanes of
    every solve (``lanes[key][:2]``) within ``ATOL`` too, so a converged
    flag may differ only where the kernel's and the plain version's
    residuals fall on either side of ``tol``; K5's rung lanes
    (``lanes[key][2]``) and final rungs equal. Returns the largest
    |diff| off the costs, on them and on the residuals, and the number of
    flags that differ."""
    errs = [check_close(f"{tag} {f}", getattr(got, f), getattr(want, f),
                        ATOL) for f in RESULT_FIELDS]
    errs += [check_close(f"{tag} solver_state.{f}", a, b, ATOL)
             for f, a, b in zip(("s", "w"), got.solver_state,
                                want.solver_state)]
    err_c = check_close(f"{tag} costs", got.costs, want.costs, cost_atol,
                        COST_RTOL)
    k, p = lanes["kernel"], lanes["plain"]
    err_r = max(check_close(f"{tag} {n}", a, b, ATOL)
                for n, a, b in zip(("RP", "RD"), k[:2], p[:2]))
    flipped = got.converged != want.converged
    straddle = ((k[0] <= tol) != (p[0] <= tol)) | ((k[1] <= tol)
                                                   != (p[1] <= tol))
    if not bool(straddle[flipped].all()):
        raise AssertionError(f"{tag}: a converged flag differs where no "
                             "residual straddles the tolerance")
    if len(k) > 2:
        if not torch.equal(k[2], p[2]):
            raise AssertionError(f"{tag}: rung lanes differ")
        if not torch.equal(got.solver_state.rho_idx,
                           want.solver_state.rho_idx):
            raise AssertionError(f"{tag}: final rungs differ")
    return max(errs), err_c, err_r, int(flipped.sum())


#: Why a kernel and its plain version may differ by rounding at B = 4096:
#: cuBLAS picks its kernel by shape, and below about 8000 rows it may sum
#: the plain version's products in another order than one FMA chain
#: (tests/test_torch_cuda.py); the float64 check tells that from a fault.
ROUNDING = ("cuBLAS sums the plain version's products in another order at "
            "this shape; the kernel's distance to float64 is printed "
            "beside the plain version's")


def random_dims_phase(dev, smi, B=B_MAIN, T=T_MAIN, n64=64) -> None:
    """Phase 46: every kernel at the seven shapes of
    tests/test_random_dims.py, B x T scenarios each."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
    )
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )
    from direct_data_driven_mpc_tpu_torch.qp.admm import (
        compute_admm_operator_np,
    )
    from direct_data_driven_mpc_tpu_torch.qp.box import (
        compute_box_admm_operator_np,
    )

    def k1_count():
        return fr.fused_rollout.launches

    def k3_count():
        return fr.fused_rollout_nocost.launches

    for case in RANDOM_DIMS:
        t0 = time.perf_counter()
        seed, ns, n, m, p, L, nb, ctype, _ = case
        label = random_dims_label(case)
        plant, ctrl = build_random_dims(case)
        K = fr.suggest_solves_per_block(ns, n, m, p, n_mpc_step=nb,
                                        n_steps=T)
        Ws = draw_noise_batch(seed, B, T, p, plant.get_eps_max(), device=dev)
        ins = (*scenario_batch(plant, ctrl, B, dev), Ws)
        sub = tuple(a[:n64].double() for a in ins)
        rec = {}  # ms per rollout of each kernel and its plain version
        log(f"{label}: S={ns + n * (m + p)}, main K={K}, B={B} T={T}")

        calls, lanes = {}, {}

        def keep(fn, key):
            """``fn``, keeping its arguments (to time it alone) and, for K4
            and K5, its residual lanes (and K5's rung lanes)."""
            def rollout(*a):
                out = fn(*a)
                calls[key] = (fn, a)
                if len(out) > 4:
                    lanes[key] = out[3:6] if len(out) == 9 else out[3:5]
                return out
            return rollout

        def alone_ms(count, reps):
            """The kernel's and the plain version's last calls, each
            alone, in turns: ms per rollout."""
            return tuple(event_turns(
                {k: (lambda k=k: calls[k][0](*calls[k][1]))
                 for k in ("kernel", "plain")},
                {"kernel": reps, "plain": max(reps // 5, 1)}, count,
            ).values())

        # K1 at K = 2 and at the main K, then K3 at the main K.
        for k in (2, K):
            bm = build_linear_engine(ctrl, plant.as_params(),
                                     solves_per_block=k, device=dev)
            op = fr._build_fused_operator(bm)
            tiles, passes = fr.k1_pack(op).slots.shape[:2]
            fr.fused_rollout.launches = 0
            res = fr.make_fused_batched_rollout(
                bm, T, n_mpc_step=nb, rollout=keep(fr.fused_rollout,
                                                   "kernel"))(*ins)
            torch.cuda.synchronize()
            if fr.fused_rollout.launches != 1:
                raise AssertionError(f"{label} K1 K={k}: "
                                     f"{fr.fused_rollout.launches} launches")
            want = fr.make_fused_batched_rollout(
                bm, T, n_mpc_step=nb,
                rollout=keep(fr.fused_rollout_reference, "plain"))(*ins)
            err = max(equal_or_close(f"{label} K1 K={k} vs plain {f}",
                                     getattr(res, f), getattr(want, f),
                                     ROUNDING) for f in RESULT_FIELDS)
            err_c = check_close(f"{label} K1 K={k} costs", res.costs,
                                want.costs, COST_ATOL, COST_RTOL)
            bm64 = build_linear_engine(ctrl, plant.as_params(),
                                       solves_per_block=k, device=dev,
                                       dtype=torch.float64)
            u64 = fr.make_fused_batched_rollout(
                bm64, T, n_mpc_step=nb, rollout=fr.fused_rollout_reference
            )(*sub).u_sys
            du = max_abs(res.u_sys[:n64], u64)
            du_plain = max_abs(want.u_sys[:n64], u64)
            if not du < NORTH_STAR:
                raise AssertionError(f"{label} K1 K={k}: max |du| vs "
                                     f"float64 {du:.3e}")
            key = "k1" if k == K else "k1_2"
            rec[f"{key}_ms"], rec[f"{key}_plain_ms"] = alone_ms(k1_count, 20)
            log(f"  K1 K={k} (S={op.S}, Ku={op.Ku}, Kp={op.Kp}, rank "
                f"{op.rank}: {tiles} column tiles x {passes} pass(es)): "
                f"launches 1; vs plain max |diff| {err:.3e} "
                f"({'bit-equal' if err == 0 else f'atol {ATOL}'}), costs "
                f"{err_c:.3e}; max |du| vs float64 ({n64} scenarios) "
                f"{du:.3e}, the plain version's {du_plain:.3e}")

        fr.fused_rollout.launches = fr.fused_rollout_nocost.launches = 0
        res = fr.make_fused_batched_rollout(
            bm, T, n_mpc_step=nb, cost_mode="post",
            rollout=keep(fr.fused_rollout, "kernel"))(*ins)
        torch.cuda.synchronize()
        if (fr.fused_rollout_nocost.launches, fr.fused_rollout.launches) \
                != (1, 0):
            raise AssertionError(
                f"{label} K3: {fr.fused_rollout_nocost.launches} K3 and "
                f"{fr.fused_rollout.launches} K1 launches")
        want = fr.make_fused_batched_rollout(
            bm, T, n_mpc_step=nb, cost_mode="post",
            rollout=keep(fr.fused_rollout_reference, "plain"))(*ins)
        err = max(check_close(f"{label} K3 vs plain {f}", getattr(res, f),
                              getattr(want, f), K3_ATOL)
                  for f in RESULT_FIELDS)
        err_c = check_close(f"{label} K3 post-pass costs", res.costs,
                            want.costs, POST_COST_ATOL, COST_RTOL)
        du = max_abs(res.u_sys[:n64], u64)
        if not du < NORTH_STAR:
            raise AssertionError(f"{label} K3: max |du| vs float64 "
                                 f"{du:.3e}")
        rec["k3_ms"], rec["k3_plain_ms"] = alone_ms(k3_count, 20)
        log(f"  K3 K={K} (3xTF32, {fr.nocost_plan(op.S, op.nw)[0]} "
            f"scenarios per block): launches 1; vs plain max |diff| "
            f"{err:.3e} (atol {K3_ATOL}), post-pass costs {err_c:.3e} (rtol "
            f"{COST_RTOL}, atol {POST_COST_ATOL}); max |du| vs float64 "
            f"{du:.3e}")

        # K4 on the ROBUST shapes, the controller rebuilt with CONVEX
        # slack; K5 on every shape, on the box |u| <= RANDOM_DIMS_BOX.
        engines = []
        if ctype == "ROBUST":
            plant_c, ctrl_c = build_random_dims(case, slack="CONVEX")
            op_c = compute_admm_operator_np(ctrl_c.spec)
            args = (plant_c.as_params(), op_c, n, m, p, T)
            kw = dict(CONVEX_KW, n_mpc_step=nb, device=dev)
            engines.append((
                "K4", fa.fused_admm, CONVEX_KW["tol"],
                (*scenario_batch(plant_c, ctrl_c, B, dev), Ws),
                fa.build_fused_admm_operator(*args[:5], n_mpc_step=nb,
                                             device=dev)[1],
                fa.make_fused_admm_rollout(
                    *args, rollout=keep(fa.fused_admm, "kernel"), **kw),
                fa.make_fused_admm_rollout(
                    *args, rollout=keep(fa.fused_admm_reference, "plain"),
                    **kw),
                fa.make_fused_admm_rollout(
                    *args, rollout=fa.fused_admm_reference,
                    **dict(kw, dtype=torch.float64))))
        op_b = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-RANDOM_DIMS_BOX, RANDOM_DIMS_BOX))
        args = (plant.as_params(), op_b, n, m, p, T)
        kw = dict(LADDER_KW, n_mpc_step=nb, device=dev)
        run_l = fl.make_fused_ladder_rollout(
            *args, rollout=keep(fl.fused_ladder, "kernel"), **kw)
        engines.append((
            "K5", fl.fused_ladder, LADDER_KW["tol"], ins,
            fl.build_fused_ladder_operator(*args[:5], n_mpc_step=nb,
                                           device=dev)[1], run_l,
            fl.make_fused_ladder_rollout(
                *args, rollout=keep(fl.fused_ladder_reference, "plain"),
                **kw),
            fl.make_fused_ladder_rollout(
                *args, rollout=fl.fused_ladder_reference,
                rung_group=run_l.rung_group,
                **dict(kw, dtype=torch.float64))))
        for name, wrapper, tol, x, dims, run_k, run_p, run64 in engines:
            wrapper.launches = 0
            got = run_k(*x)
            torch.cuda.synchronize()
            if wrapper.launches != 1:
                raise AssertionError(f"{label} {name}: {wrapper.launches} "
                                     "launches")
            want = run_p(*x)
            bits = result_bits(got, want)
            err, err_c, err_r, flips = compare_admm_at_rounding(
                f"{label} {name} vs plain", got, want, lanes, tol)
            u64 = run64(*(a[:n64].double() for a in x)).u_sys
            du = max_abs(got.u_sys[:n64], u64)
            du_plain = max_abs(want.u_sys[:n64], u64)
            if not du < NORTH_STAR:
                raise AssertionError(f"{label} {name}: max |du| vs float64 "
                                     f"{du:.3e}")
            u_max = float(got.u_sys.abs().max())
            if name == "K5" and u_max > RANDOM_DIMS_BOX + 1e-6:
                raise AssertionError(f"{label} K5: box violated, {u_max}")
            key = name.lower()
            rec[f"{key}_ms"], rec[f"{key}_plain_ms"] = alone_ms(
                lambda: wrapper.launches, 5)
            log(f"  {name} (nbox {dims.nbox}"
                + (f", rung group {run_l.rung_group}" if name == "K5"
                   else "")
                + "): launches 1; vs plain "
                + ("bit-equal" if bits else
                   f"max |diff| {err:.3e} within atol {ATOL}, residual "
                   f"lanes {err_r:.3e}, {flips} converged flags on either "
                   f"side of tol {tol}: {ROUNDING}")
                + (", rung lanes equal" if name == "K5" else "")
                + f"; costs {err_c:.3e}; converged "
                f"{float(got.converged.float().mean()):.4f}; max |u| "
                f"{u_max:.4f}; max |du| vs float64 {du:.3e}, the plain "
                f"version's {du_plain:.3e}")
        log(f"  ms per rollout, each kernel and its plain version alone "
            f"[{smi}]: "
            + ", ".join(f"{k} {rec[f'{k}_ms']:.4f} (plain "
                        f"{rec[f'{k}_plain_ms']:.4f})"
                        for k in ("k1_2", "k1", "k3", "k4", "k5")
                        if f"{k}_ms" in rec)
            + f"; {time.perf_counter() - t0:.1f} s")


def long_horizon_phase(dev, smi, B=B_ADMM, T=T_ADMM, n64=64) -> None:
    """Phase 47: ``bench.py``'s ``long_horizon`` through K1 and
    ``long_horizon_convex`` through K4, B x T each."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
    )
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    t0 = time.perf_counter()
    plant, ctrl = build_four_tank_robust(N=800, L=60)
    if ctrl.spec.nz != 1121:
        raise AssertionError(f"long_horizon nz {ctrl.spec.nz} != 1121")
    K = fr.suggest_solves_per_block(plant.get_system_order(), ctrl.n,
                                    ctrl.m, ctrl.p, n_steps=T)
    bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                             device=dev)
    op = fr._build_fused_operator(bm)
    Ws = draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(), device=dev)
    ins = (*scenario_batch(plant, ctrl, B, dev), Ws)
    log(f"long_horizon: nz={ctrl.spec.nz} nc={ctrl.spec.nc}, K={K}, G "
        f"{tuple(op.G.shape)}, rank {op.rank}, "
        f"{fr.k1_pack(op).slots.shape[1]} slot pass(es); built in "
        f"{time.perf_counter() - t0:.2f} s")
    fr.fused_rollout.launches = 0
    res = fr.make_fused_batched_rollout(bm, T)(*ins)
    torch.cuda.synchronize()
    launches = fr.fused_rollout.launches
    if launches != 1:
        raise AssertionError(f"long_horizon: {launches} K1 launches")
    want = fr.make_fused_batched_rollout(
        bm, T, rollout=fr.fused_rollout_reference)(*ins)
    for f in RESULT_FIELDS:
        check_close(f"long_horizon K1 vs plain {f}", getattr(res, f),
                    getattr(want, f), 0.0)
    err_c = check_close("long_horizon K1 costs", res.costs, want.costs,
                        COST_ATOL, COST_RTOL)
    bm64 = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                               device=dev, dtype=torch.float64)
    du = max_abs(res.u_sys[:n64], fr.make_fused_batched_rollout(
        bm64, T, rollout=fr.fused_rollout_reference
    )(*(a[:n64].double() for a in ins)).u_sys)
    if not du < NORTH_STAR:
        raise AssertionError(f"long_horizon max |du| vs float64 {du:.3e}")
    runs = {"kernel": fr.make_amortized_run(bm, T),
            "plain": fr.make_amortized_run(
                bm, T, rollout=fr.fused_rollout_reference)}
    ms = {name: [] for name in runs}
    for name in ("kernel", "plain", "plain", "kernel"):
        ms[name].append(time_amortized(runs[name], ins, seconds=0.5,
                                       min_reps=2)[0])
    k1 = {k: sum(v) / len(v) for k, v in ms.items()}
    solves = B * T
    log(f"long_horizon K1 (B={B} x T={T}): launches {launches}; U, Y and "
        f"the final state bit-equal to the plain version, costs "
        f"{err_c:.3e}; max |du| vs float64 ({n64} scenarios) {du:.3e}; "
        f"kernel {k1['kernel']:.4f} ms per rollout -> "
        f"{solves / (k1['kernel'] * 1e-3):,.0f} solves/s, plain "
        f"{k1['plain']:.4f} ms -> {solves / (k1['plain'] * 1e-3):,.0f} "
        f"(amortized, means of 2 turns) [{smi}]")

    t1 = time.perf_counter()
    plant, ctrl, op, kw = admm_config("long_horizon_convex")
    ins = (*scenario_batch(plant, ctrl, B, dev),
           draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                            device=dev))
    args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T)
    run_k = fa.make_fused_admm_rollout(*args, device=dev, **kw)
    run_p = fa.make_fused_admm_rollout(
        *args, device=dev, rollout=fa.fused_admm_reference, **kw)
    fa.fused_admm.launches = 0
    got = run_k(*ins)
    torch.cuda.synchronize()
    if fa.fused_admm.launches != 1:
        raise AssertionError(f"long_horizon_convex: "
                             f"{fa.fused_admm.launches} K4 launches")
    err, err_c = compare_admm("long_horizon_convex K4 vs plain", got,
                              run_p(*ins))
    k4 = event_turns({"kernel": lambda: run_k(*ins),
                      "plain": lambda: run_p(*ins)},
                     {"kernel": 2, "plain": 1}, lambda: fa.fused_admm.launches)
    log(f"long_horizon_convex K4 (nbox {op['v_c'].shape[0]}, B={B} x "
        f"T={T}): launches 1; vs plain max |diff| {err:.3e} (atol {ATOL}), "
        f"costs {err_c:.3e}; converged "
        f"{float(got.converged.float().mean()):.6f}; kernel "
        f"{k4['kernel']:.3f} ms per rollout -> "
        f"{solves / (k4['kernel'] * 1e-3):,.0f} solves/s, plain "
        f"{k4['plain']:.3f} ms (means of 2 turns) "
        f"[{smi}]; {time.perf_counter() - t1:.1f} s")


def multidevice_phases(dev, smi, main_run) -> None:
    """Phases 40-42 on the main path's inputs ``main_run``; the process
    group they open is destroyed at the end."""
    mesh = sharded_phase(dev, smi, main_run)
    pminres_phase(dev, smi, main_run, mesh,
                  two_rank_phase(dev, smi, main_run, mesh))
    torch.distributed.destroy_process_group()


#: Phase 48: the constrained engines at ``large_plant`` (nbox 300 with
#: CONVEX slack, 200 on the input box), where the resident plans do not
#: fit and the wide bodies K4w and K5w run.
B_WIDE, T_WIDE = 16384, 400
WIDE_CONVEX_KW = dict(iters=(4, 30, 4), cold_iters=200, tol=1e-4)
WIDE_BOX = 0.85  # large_plant_ladder's input box |u| <= 0.85


def wide_launcher(ladder):
    """A rollout (``fused_admm``'s or ``fused_ladder``'s arguments, the
    balance ratio included) that calls the library's wide launcher
    directly, K4w or K5w, on the padded operators (``wide_operators``),
    at any shape its plan takes: at resident shapes it holds the two
    bodies against each other. It counts no launch."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa

    lib = _kernels.load("fused_admm").lib

    def rollout(ops, dims, carry, W, n_iter, *rest):
        Vop, M1, M2 = fa.wide_operators(ops.Vop, ops.M1, ops.M2)
        Bsz, n_blocks, nbp = W.shape
        nbm = dims.nb * dims.m
        sizes = (dims.S, nbm, nbp, dims.nbox, dims.nxi)
        kw = dict(dtype=torch.float32, device=W.device)
        out = [torch.empty((Bsz, n_blocks, nbm), **kw),
               torch.empty((Bsz, n_blocks, nbp), **kw),
               *(torch.empty((Bsz, n_blocks), **kw) for _ in range(3))]
        fin = [torch.empty((Bsz, w), **kw)
               for w in (dims.S, dims.nbox, dims.nbox)]
        stream = torch.cuda.current_stream().cuda_stream
        if ladder:
            rung0, G, ratio = rest
            if G != lib.fused_wide_tile_rows(*sizes):
                raise AssertionError(f"rung group {G} is not the wide tile "
                                     f"{lib.fused_wide_tile_rows(*sizes)}")
            rung = torch.empty((Bsz, n_blocks), dtype=torch.int32,
                               device=W.device)
            err = lib.fused_ladder_wide_launch(
                Vop.data_ptr(), M1.data_ptr(), M2.data_ptr(),
                ops.b2.data_ptr(), ops.lo.data_ptr(), ops.hi.data_ptr(),
                ops.u_lo.data_ptr(), ops.u_hi.data_ptr(),
                ops.rhos.data_ptr(), rung0.data_ptr(),
                *(c.data_ptr() for c in carry), W.data_ptr(),
                *(o.data_ptr() for o in out), rung.data_ptr(),
                *(f.data_ptr() for f in fin), Bsz, *sizes, n_blocks,
                int(n_iter), ops.Vop.shape[0], dims.alpha, 1.0 - dims.alpha,
                ratio, stream)
            out.append(rung)
        else:
            adds = rest[0] if rest else None
            err = lib.fused_admm_wide_launch(
                Vop.data_ptr(), M1.data_ptr(), M2.data_ptr(),
                ops.b2.data_ptr(), ops.lo.data_ptr(), ops.hi.data_ptr(),
                ops.u_lo.data_ptr(), ops.u_hi.data_ptr(),
                *(c.data_ptr() for c in carry), W.data_ptr(),
                adds.data_ptr() if adds is not None else None,
                *(o.data_ptr() for o in out), *(f.data_ptr() for f in fin),
                Bsz, *sizes, n_blocks, int(n_iter), dims.alpha,
                1.0 - dims.alpha, dims.rho, stream)
        if err:
            raise RuntimeError(f"wide launch failed: CUDA error {err}")
        return (*out, *fin)

    return rollout


def wide_panel_bytes(plan, dims, B, n_blocks, n_iter) -> int:
    """Bytes of operator panels the wide body reads from L2 in one
    rollout, by its design: each block streams the padded Vop n_iter
    times, M1 and M2 once, per solve. A count from shapes, not a
    measurement."""
    per_solve = 4 * (n_iter * dims.nbox * plan.ldv + dims.nbox * plan.ld1
                     + dims.D2 * plan.ld2)
    return per_solve * -(-B // plan.rows) * n_blocks


def _keep(fn, key, calls, lanes, ladder):
    """``fn`` as a rollout that records its arguments in ``calls[key]``
    (to time the call alone) and its residual lanes (K5: and rung lanes)
    in ``lanes[key]``."""
    def rollout(*a):
        out = fn(*a)
        calls[key] = (fn, a)
        lanes[key] = out[3:6] if ladder else out[3:5]
        return out
    return rollout


def wide_admm_phase(dev, smi) -> list:
    """Phase 48: ``large_plant_convex`` through K4w and
    ``large_plant_ladder`` through K5w, B_WIDE x T_WIDE each, against
    their plain versions and float64, each kernel and plain version timed
    alone in turns; then the wide body against the resident one at
    ``four_tank_convex`` and ``four_tank_ladder`` (B_ADMM x T_ADMM),
    timed in turns. Returns K4w's and K5w's records for the ``kernels``
    line."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )
    from direct_data_driven_mpc_tpu_torch.qp.admm import (
        compute_admm_operator_np,
    )
    from direct_data_driven_mpc_tpu_torch.qp.box import (
        compute_box_admm_operator_np,
    )

    lib = _kernels.load("fused_admm").lib
    B, T, n64 = B_WIDE, T_WIDE, 64
    records = []
    for name in ("large_plant_convex", "large_plant_ladder"):
        t0 = time.perf_counter()
        ladder = name.endswith("ladder")
        kname = f"K{5 if ladder else 4}w"
        plant, ctrl = build_large_plant(slack="NONE" if ladder else "CONVEX")
        if ladder:
            op = compute_box_admm_operator_np(
                ctrl.spec, u_bounds=(-WIDE_BOX, WIDE_BOX))
            kw, mod, wrapper = dict(LADDER_KW), fl, fl.fused_ladder
            ops, dims = fl.build_fused_ladder_operator(
                plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, device=dev)
            resident = fl.ladder_tile_rows(dims)
            tile = fl.ladder_wide_group(dims)
            prefix = "fused_ladder"
        else:
            op = compute_admm_operator_np(ctrl.spec)
            kw, mod, wrapper = dict(WIDE_CONVEX_KW), fa, fa.fused_admm
            ops, dims = fa.build_fused_admm_operator(
                plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, device=dev)
            resident = fa.admm_plan(dims)[0]
            tile = fa.admm_wide_plan(dims)[0]
            prefix = "fused_admm"
        sizes = (dims.S, dims.nb * dims.m, dims.nb * dims.p, dims.nbox,
                 dims.nxi)
        plan = (lib.fused_wide_tile_rows(*sizes),
                lib.fused_wide_smem_bytes(*sizes))
        if plan != fa.admm_wide_plan(dims) or plan[0] != tile:
            raise AssertionError(f"{name} wide plan: library {plan} vs "
                                 f"Python {fa.admm_wide_plan(dims)}, "
                                 f"group {tile}")
        wplan = fa.wide_plan(dims)
        if lib.fused_wide_stage_floats(*sizes) != wplan.stage:
            raise AssertionError(f"{name} ring stage: library "
                                 f"{lib.fused_wide_stage_floats(*sizes)} "
                                 f"floats vs Python {wplan.stage}")
        if resident != 0 or tile == 0:
            raise AssertionError(f"{name}: resident plan {resident}, wide "
                                 f"{tile}: not a wide shape")
        regs, local = ctypes.c_int(), ctypes.c_int()
        err = lib.fused_wide_kernel_attributes(int(ladder),
                                               ctypes.byref(regs),
                                               ctypes.byref(local))
        if err:
            raise AssertionError(f"{name}: attributes error {err}")
        n_iter = sum(kw["iters"])
        log(f"{name}: nz={ctrl.spec.nz} nc={ctrl.spec.nc}, S={dims.S}, "
            f"nbox={dims.nbox}, nxi={dims.nxi}, Vop "
            f"{tuple(ops.Vop.shape)}, M1 {tuple(ops.M1.shape)}, M2 "
            f"{tuple(ops.M2.shape)} ({tensor_bytes(ops.Vop, ops.M1, ops.M2, ops.b2):,} "
            f"operator bytes); resident plan 0, wide plan {plan[0]} "
            f"scenarios per block ({'the rung group, ' if ladder else ''}"
            f"{plan[1]} B of shared memory), {regs.value} registers and "
            f"{local.value} local (spill) bytes per thread; a ring of "
            f"{fa.WIDE_STAGES} stages of {wplan.stage} floats, operator "
            f"rows padded to {wplan.ldv}, {wplan.ld1}, {wplan.ld2}; "
            f"blocks not clustered; iters {kw['iters']} + cold "
            f"{kw['cold_iters']}, tol {kw['tol']}; host build "
            f"{time.perf_counter() - t0:.1f} s")

        calls, lanes = {}, {}
        args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T)
        make = (fl.make_fused_ladder_rollout if ladder
                else fa.make_fused_admm_rollout)
        ins = (*scenario_batch(plant, ctrl, B, dev),
               draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                                device=dev))
        run_k = make(*args, device=dev,
                     rollout=_keep(wrapper, "kernel", calls, lanes, ladder),
                     **kw)
        if ladder and run_k.rung_group != tile:
            raise AssertionError(f"{name}: rung group {run_k.rung_group} "
                                 f"!= the wide tile {tile}")
        wrapper.launches = wrapper.wide_launches = 0
        got = run_k(*ins)
        torch.cuda.synchronize()
        launches = wrapper.wide_launches
        if (launches, wrapper.launches) != (1, 0):
            raise AssertionError(f"{name}: {launches} wide and "
                                 f"{wrapper.launches} resident launches")
        if got.u_sys.shape != (B, T, ctrl.m):
            raise AssertionError(f"{name}: u shape {tuple(got.u_sys.shape)}")
        plain = getattr(mod, f"{prefix}_reference")
        want = make(*args, device=dev,
                    rollout=_keep(plain, "plain", calls, lanes, ladder),
                    **kw)(*ins)
        bits = result_bits(got, want)
        # large_plant's costs are small differences of terms near 1e3:
        # their summation order alone moves them by a few 1e-3.
        err, err_c, err_r, flips = compare_admm_at_rounding(
            f"{name} {kname} vs plain", got, want, lanes, kw["tol"],
            cost_atol=POST_COST_ATOL)
        rungs = ""
        if ladder:
            u_max = float(got.u_sys.abs().max())
            if u_max > WIDE_BOX + 1e-6:
                raise AssertionError(f"{name}: box violated, {u_max}")
            rungs = f", rung lanes equal, max |u| {u_max:.4f}"
        run64 = make(*args, device=dev, rollout=plain,
                     **dict(kw, dtype=torch.float64),
                     **({"rung_group": run_k.rung_group} if ladder else {}))
        u64 = run64(*(a[:n64].double() for a in ins)).u_sys
        du64 = max_abs(got.u_sys[:n64], u64)
        du64_plain = max_abs(want.u_sys[:n64], u64)
        # At tol 1e-4 and 400 closed-loop steps float32 itself sits about
        # 1e-4 from float64 here: the kernel may add no more than ATOL to
        # the plain float32 version's distance.
        if not du64 <= max(du64_plain, NORTH_STAR) + ATOL:
            raise AssertionError(f"{name}: max |du| vs float64 {du64:.3e}, "
                                 f"the plain version's {du64_plain:.3e}")
        ms = event_turns({k: (lambda k=k: calls[k][0](*calls[k][1]))
                          for k in ("kernel", "plain")},
                         {"kernel": 1, "plain": 1},
                         lambda: wrapper.wide_launches)
        bnd = admm_bound(ops, dims, B, T, n_iter,
                         extra_out_floats=int(ladder))
        panel = wide_panel_bytes(wplan, dims, B, T, n_iter)
        conv = float(got.converged.float().mean())
        log(f"  {kname} main path (B={B} x T={T}): wide launches "
            f"{launches}, resident 0; vs plain "
            + ("bit-equal on u, y, the final windows and the ADMM state"
               if bits else f"max |diff| {err:.3e} within atol {ATOL}")
            + f", residual lanes {err_r:.3e}, costs {err_c:.3e}, {flips} "
            f"converged flags on either side of tol {kw['tol']}{rungs}; "
            f"converged {conv:.4f}; max |du| vs float64 ({n64} scenarios) "
            f"{du64:.3e}, the plain version's {du64_plain:.3e}; kernel "
            f"{ms['kernel']:.2f} ms per rollout (bound "
            f"{bnd['bound_ms']:.1f} ms by {bnd['bound_by']}: "
            f"{bnd['bound_ms'] / ms['kernel']:.1%} of it reached), plain "
            f"{ms['plain']:.2f} ms (each alone, means of 2 turns); "
            f"{fa.WIDE_STAGES} ring stages, blocks not clustered; "
            f"panel bytes the design reads from L2 {panel / 1e12:.3f} TB "
            f"per rollout, {panel / ms['kernel'] / 1e9:.2f} TB/s over the "
            f"kernel's time (derived, not measured traffic) [{smi}]; "
            f"{time.perf_counter() - t0:.1f} s")
        records.append({
            "name": f"{prefix}_wide",
            "route": "cuda",
            "source": "direct_data_driven_mpc_tpu_torch/ops/csrc/"
                      "fused_admm.cu",
            "replaces": "direct_data_driven_mpc_tpu/ops/pallas_admm.py:"
                        + ("1271" if ladder else "702"),
            "launches": launches,
            "max_abs_err": err,
            "ms": ms["kernel"],
            "plain_ms": ms["plain"],
            **bnd,
            # No single PyTorch call runs a closed loop of iterative solves.
            "library_ms": None,
        })
        del calls, lanes, got, want, ins

    # Where both bodies take the shape, the resident one runs: the wide
    # body at the four-tank main shapes, through the library's launcher,
    # held to the resident body and timed against it in turns.
    for name in ("four_tank_convex", "four_tank_ladder"):
        t0 = time.perf_counter()
        ladder = name == "four_tank_ladder"
        plant, ctrl, op, kw = admm_config(name)
        wrapper = fl.fused_ladder if ladder else fa.fused_admm
        make = (fl.make_fused_ladder_rollout if ladder
                else fa.make_fused_admm_rollout)
        args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T_ADMM)
        ins = (*scenario_batch(plant, ctrl, B_ADMM, dev),
               draw_noise_batch(0, B_ADMM, T_ADMM, ctrl.p,
                                plant.get_eps_max(), device=dev))
        # "kernel" is the resident body (the wrapper counts its launch),
        # "plain" the wide one (the launcher counts none).
        calls, lanes = {}, {}
        got = make(*args, device=dev,
                   rollout=_keep(wrapper, "kernel", calls, lanes, ladder),
                   **kw)(*ins)
        wide = make(*args, device=dev,
                    rollout=_keep(wide_launcher(ladder), "plain", calls,
                                  lanes, ladder), **kw)(*ins)
        torch.cuda.synchronize()
        err, err_c, err_r, flips = compare_admm_at_rounding(
            f"{name} resident vs wide", got, wide, lanes, kw["tol"])
        ms = event_turns({k: (lambda k=k: calls[k][0](*calls[k][1]))
                          for k in ("kernel", "plain")},
                         {"kernel": 1, "plain": 1},
                         lambda: wrapper.launches + wrapper.wide_launches)
        log(f"  {name} (B={B_ADMM} x T={T_ADMM}): the wide body through "
            f"the library's launcher against the resident one: "
            + ("bit-equal" if result_bits(got, wide)
               else f"max |diff| {err:.3e} within atol {ATOL}")
            + f", residual lanes {err_r:.3e}, costs {err_c:.3e}, {flips} "
            f"converged flags differ; resident {ms['kernel']:.2f} ms per "
            f"rollout, wide {ms['plain']:.2f} ms "
            f"({ms['plain'] / ms['kernel']:.2f}x; means of 2 turns) "
            f"[{smi}]; {time.perf_counter() - t0:.1f} s")
        del calls, lanes, got, wide, ins
    return records


#: Phase 49: bench.py's large_plant classic configuration (l.971-992)
#: in the aggregate mode, and the ladder's balance ratio through K5 and
#: K5w (the default is 10).
B_AGG, T_AGG, K_AGG = 65536, 400, 50
K5_RATIOS = (5.0, 7.3)  # 7.3 is not exact in float32
K5W_RATIO = 20.0


def aggregate_mode_check(dev, smi, plant, ctrl) -> None:
    """Phase 49's first part: the classic engine at ``large_plant`` with
    ``emit_trajectories=False`` against ``True``, bit-equal in every
    emitted field, with peak device memory and ms per rollout."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
        make_linear_batched_rollout,
    )

    t0 = time.perf_counter()
    B, T = B_AGG, T_AGG
    bm = build_linear_engine(ctrl, plant.as_params(),
                             solves_per_block=K_AGG, device=dev)
    ins = scenario_batch(plant, ctrl, B, dev)
    runs = {emit: make_linear_batched_rollout(
                bm, T, use_rng_noise=True, eps_max=plant.get_eps_max(),
                emit_trajectories=emit)
            for emit in (False, True)}

    def call(emit):
        return runs[emit](*ins, torch.Generator(device=dev).manual_seed(0))

    res, peak = {}, {}
    for emit in (False, True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res[emit] = call(emit)
        torch.cuda.synchronize()
        peak[emit] = torch.cuda.max_memory_allocated() - base
    agg, full = res[False], res[True]
    m, p = ctrl.m, ctrl.p
    if (tuple(agg.u_sys.shape), tuple(agg.y_sys.shape)) != ((B, 0, m),
                                                            (B, 0, p)):
        raise AssertionError(f"aggregate mode: u {tuple(agg.u_sys.shape)}, "
                             f"y {tuple(agg.y_sys.shape)}")
    if tuple(full.u_sys.shape) != (B, T, m):
        raise AssertionError(f"full mode: u {tuple(full.u_sys.shape)}")
    same_bits("aggregate vs full mode", agg, full,
              ("costs", "x_final", "u_past", "y_past"))
    if not torch.equal(agg.converged, full.converged):
        raise AssertionError("aggregate vs full mode: converged differs")
    if not bool(agg.converged.all()):
        raise AssertionError("aggregate mode: non-finite costs")
    traj = tensor_bytes(full.u_sys, full.y_sys)
    del res, agg, full
    ms = event_turns({"aggregate": lambda: call(False),
                      "full": lambda: call(True)},
                     {"aggregate": 3, "full": 3}, lambda: 0)
    log(f"phase 49 aggregate mode: large_plant classic engine (K={K_AGG}, "
        f"B={B} x T={T}, generator noise): emit_trajectories=False "
        f"bit-equal to True in costs, converged, x_final, u_past, y_past; "
        f"u, y empty ({B}, 0, {m}); peak device memory above the inputs "
        f"{peak[False] / 1e9:.3f} GB aggregate, {peak[True] / 1e9:.3f} GB "
        f"full ({(peak[True] - peak[False]) / 1e9:.3f} GB less; the "
        f"trajectories are {traj / 1e9:.3f} GB); {ms['aggregate']:.2f} ms "
        f"per rollout aggregate, {ms['full']:.2f} ms full "
        f"({1 - ms['aggregate'] / ms['full']:.1%} less; means of 2 turns "
        f"of 3) [{smi}]; {time.perf_counter() - t0:.1f} s")


def ratio_check(dev, smi, name, plant, ctrl, op, ratios, B, wide,
                require_move=True) -> None:
    """Phase 49's second part for one configuration: the ladder kernel
    (K5, or K5w where ``wide``) at each of ``ratios``, launched once with
    the counts read, bit-equal to its plain version at that ratio; the
    rung lanes that differ from the default ratio's kernel run counted,
    and with ``require_move`` at least one required."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    t0 = time.perf_counter()
    T, wrapper = T_ADMM, fl.fused_ladder
    kname = "K5w" if wide else "K5"
    ins = (*scenario_batch(plant, ctrl, B, dev),
           draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                            device=dev))
    args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T)

    def kernel_run(ratio, lanes):
        calls = {}
        run = fl.make_fused_ladder_rollout(
            *args, device=dev, balance_ratio=ratio,
            rollout=_keep(wrapper, "kernel", calls, lanes, True),
            **LADDER_KW)
        wrapper.launches = wrapper.wide_launches = 0
        res = run(*ins)
        torch.cuda.synchronize()
        launched = (wrapper.wide_launches, wrapper.launches)
        if launched != ((1, 0) if wide else (0, 1)):
            raise AssertionError(f"{name} {kname} at ratio {ratio}: "
                                 f"{launched} wide and resident launches")
        return res

    def conv10(res):
        return float(res.converged[:, fl.CONVERGED_FROM:].float().mean())

    base_lanes = {}
    base = conv10(kernel_run(fl.BALANCE_RATIO, base_lanes))
    rung_base = base_lanes["kernel"][2]
    for ratio in ratios:
        lanes = {}
        got = kernel_run(ratio, lanes)
        want = fl.make_fused_ladder_rollout(
            *args, device=dev, balance_ratio=ratio,
            rollout=_keep(fl.fused_ladder_reference, "plain", {}, lanes,
                          True), **LADDER_KW)(*ins)
        if not result_bits(got, want):
            raise AssertionError(f"{name} {kname} at ratio {ratio}: not "
                                 "bit-equal to the plain version")
        for lane, a, b in zip(("RP", "RD", "rung"), lanes["kernel"],
                              lanes["plain"]):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} {kname} at ratio {ratio}: "
                                     f"{lane} lanes differ")
        if not torch.equal(got.solver_state.rho_idx,
                           want.solver_state.rho_idx):
            raise AssertionError(f"{name} {kname} at ratio {ratio}: final "
                                 "rungs differ")
        moved = int((lanes["kernel"][2] != rung_base).sum())
        if require_move and moved == 0:
            raise AssertionError(f"{name} {kname} at ratio {ratio}: rung "
                                 "lanes equal to the default ratio's")
        log(f"phase 49 {name} {kname} (B={B} x T={T}) at balance_ratio "
            f"{ratio} (float32 {float(np.float32(ratio))!r}): launched once, "
            f"bit-equal to the plain version (u, y, windows, s, w, residual "
            f"and rung lanes, final rungs); {moved} rung lanes differ from "
            f"ratio {fl.BALANCE_RATIO}'s; converged from solve "
            f"{fl.CONVERGED_FROM} {conv10(got):.6f} (ratio "
            f"{fl.BALANCE_RATIO}: {base:.6f}) [{smi}]")
    log(f"phase 49 {name}: {time.perf_counter() - t0:.1f} s")


def last_options_phase(dev, smi) -> None:
    """Phase 49: the classic engine's aggregate mode at ``large_plant``,
    then the balance ratio through K5 (``four_tank_ladder``, B_ADMM) and
    K5w (``large_plant_ladder``, B_WIDE)."""
    from direct_data_driven_mpc_tpu_torch.qp.box import (
        compute_box_admm_operator_np,
    )

    t0 = time.perf_counter()
    plant, ctrl = build_large_plant()
    log(f"phase 49 host build: large_plant nz={ctrl.spec.nz}, "
        f"{time.perf_counter() - t0:.1f} s")
    aggregate_mode_check(dev, smi, plant, ctrl)
    # At |u| <= 0.85 every group climbs to the top rung in its first two
    # solves at any of these ratios (measured on the CPU at B = 8192), so
    # there the ratio leaves the rung lanes as they are; at phase 16's
    # |u| <= 3 on the same shape the groups walk down the ladder, at a
    # pace the ratio sets.
    plant4, ctrl4, op4, _ = admm_config("four_tank_ladder")
    ratio_check(dev, smi, "four_tank_ladder", plant4, ctrl4, op4,
                K5_RATIOS, B_ADMM, wide=False, require_move=False)
    op4 = admm_config("four_tank_ladder_u3")[2]
    ratio_check(dev, smi, "four_tank_ladder_u3", plant4, ctrl4, op4,
                K5_RATIOS, B_ADMM, wide=False)
    op = compute_box_admm_operator_np(ctrl.spec,
                                      u_bounds=(-WIDE_BOX, WIDE_BOX))
    ratio_check(dev, smi, "large_plant_ladder", plant, ctrl, op,
                (K5W_RATIO,), B_WIDE, wide=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing run")
    dev = torch.device("cuda", 0)
    # TF32 allowed outside the port, as a user's process might set it:
    # the port's parity-bound paths scope IEEE float32 themselves, so
    # every bit-equality below holds under it.
    torch.set_float32_matmul_precision("high")

    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
        make_linear_batched_rollout,
    )
    from direct_data_driven_mpc_tpu_torch.ops import _kernels
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {card}, count {torch.cuda.device_count()}")

    # 2. Build: one nvcc per kernel source, all started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(_kernels.load, KERNELS))
    log(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log(f"  {lib.name}.cu -> {lib.path.name} in "
            f"{lib.build_seconds:.2f} s")
        for line in lib.compiler_log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"  ptxas: {line.strip()}")

    # 3. Host build (float64), then the block maps on the card.
    t0 = time.perf_counter()
    plant, ctrl = build_four_tank_robust()
    if (ctrl.spec.nz, ctrl.spec.nc) != (571, 168):
        raise AssertionError(
            f"QP dims {ctrl.spec.nz}, {ctrl.spec.nc} != 571, 168"
        )
    log(f"host build: controller nz={ctrl.spec.nz} nc={ctrl.spec.nc}, "
        f"solve path {ctrl.solve_path}, "
        f"{time.perf_counter() - t0:.2f} s")
    K_kernel = fr.suggest_solves_per_block(
        plant.get_system_order(), ctrl.n, ctrl.m, ctrl.p, n_steps=T_MAIN
    )
    t0 = time.perf_counter()
    bm50 = build_linear_engine(
        ctrl, plant.as_params(), solves_per_block=K_kernel, device=dev
    )
    bm100 = build_linear_engine(
        ctrl, plant.as_params(), solves_per_block=100, device=dev
    )
    log(f"block maps K={K_kernel} and K=100: "
        f"{time.perf_counter() - t0:.2f} s")

    # 4. The main path, through the kernel.
    Ws = draw_noise_batch(0, B_MAIN, T_MAIN, ctrl.p,
                          plant.get_eps_max(), device=dev)
    x0s, ups, yps = scenario_batch(plant, ctrl, B_MAIN, dev)
    run_main = fr.make_fused_batched_rollout(bm50, T_MAIN)
    fr.fused_rollout.launches = 0
    res = run_main(x0s, ups, yps, Ws)
    torch.cuda.synchronize()
    main_launches = fr.fused_rollout.launches
    if main_launches < 1:
        raise AssertionError("the main path launched no kernel")
    log(f"main path: B={B_MAIN} T={T_MAIN} K={K_kernel}, "
        f"fused_rollout launches {main_launches}")
    if res.u_sys.shape != (B_MAIN, T_MAIN, 2) or res.costs.shape != (
        B_MAIN, T_MAIN
    ):
        raise AssertionError(f"main-path shapes {tuple(res.u_sys.shape)} "
                             f"{tuple(res.costs.shape)}")
    if not bool(res.converged.all()):
        raise AssertionError("non-finite costs on the main path")

    op = fr._build_fused_operator(bm50)
    n_outer = T_MAIN // K_kernel
    s0, W = fr._center_and_pack(bm50, x0s, ups, yps, Ws, n_outer,
                                K_kernel, 0)
    got = fr.fused_rollout(op, s0, W)
    want = fr.fused_rollout_reference(op, s0, W)
    k1_cuda_kernels = k1_report(op, s0, W)
    # U, Y and s_fin are one FMA chain per value in the kernel and, at
    # this batch, in cuBLAS: bit-equal.
    err = {}
    for name, g, w in zip(("U", "Y", "s_fin"), got[:2] + got[3:],
                          want[:2] + want[3:]):
        err[name] = check_close(f"kernel vs plain {name}", g, w, 0.0)
    err_c = check_close("kernel vs plain C", got[2], want[2], COST_ATOL,
                        COST_RTOL)
    kernel_err = max(err.values())
    log(f"kernel vs plain (B={B_MAIN}, T={T_MAIN}): max |dU| "
        f"{err['U']:.3e}, |dY| {err['Y']:.3e}, |ds_fin| "
        f"{err['s_fin']:.3e} (atol 0); max |dC| {err_c:.3e} "
        f"(rtol {COST_RTOL}, atol {COST_ATOL})")

    classic = make_linear_batched_rollout(bm100, T_MAIN)(x0s, ups, yps, Ws)
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        e = check_close(f"kernel vs classic {field}",
                        getattr(res, field), getattr(classic, field), ATOL)
        log(f"kernel vs classic engine (K=100) {field}: max |diff| "
            f"{e:.3e}")
    e = check_close("kernel vs classic costs", res.costs, classic.costs,
                    COST_ATOL, COST_RTOL)
    log(f"kernel vs classic engine costs: max |diff| {e:.3e}")

    # 5. Float64 truth for the first 64 scenarios.
    bm50_64 = build_linear_engine(
        ctrl, plant.as_params(), solves_per_block=K_kernel, device=dev,
        dtype=torch.float64,
    )
    op64 = fr._build_fused_operator(bm50_64)
    s0_64, W_64 = fr._center_and_pack(
        bm50_64, x0s[:64], ups[:64], yps[:64], Ws[:64], n_outer,
        K_kernel, 0,
    )
    U64 = fr.fused_rollout_reference(op64, s0_64, W_64)[0]
    du = max_abs(res.u_sys[:64], U64.reshape(64, -1, 2))
    if not du < NORTH_STAR:
        raise AssertionError(f"max |du| vs float64 {du:.3e} >= 1e-4")
    log(f"float64 truth (64 scenarios): kernel max |du| {du:.3e} "
        f"(< {NORTH_STAR})")

    # 6. Edges.
    Br = 4000
    got_r = fr.fused_rollout(op, s0[:Br].contiguous(), W[:Br].contiguous())
    want_r = fr.fused_rollout_reference(op, s0[:Br], W[:Br])
    for name, g, w in zip(("U", "Y", "s_fin"), got_r[:2] + got_r[3:],
                          want_r[:2] + want_r[3:]):
        check_close(f"ragged B={Br} {name}", g, w, ATOL)
    check_close(f"ragged B={Br} C", got_r[2], want_r[2], COST_ATOL,
                COST_RTOL)
    for name, g, full in zip(("U", "Y", "C", "s_fin"), got_r, got):
        if not torch.equal(g, full[:Br]):
            raise AssertionError(f"ragged B={Br} {name} differs from the "
                                 "same rows of the full batch")
    log(f"edge: ragged batch B={Br} matches the plain version and the "
        "full batch's rows")

    T_odd, K_odd = 37, 8
    bm8 = build_linear_engine(
        ctrl, plant.as_params(), solves_per_block=K_odd, device=dev
    )
    inputs_odd = (x0s, ups, yps, Ws[:, :T_odd].contiguous())
    fr.fused_rollout.launches = 0
    odd = fr.make_fused_batched_rollout(bm8, T_odd)(*inputs_odd)
    if fr.fused_rollout.launches != 1:
        raise AssertionError("T=37 run did not go through the kernel")
    op8 = fr._build_fused_operator(bm8)
    n_outer8 = math.ceil(T_odd / K_odd)
    s0_8, W_8 = fr._center_and_pack(bm8, *inputs_odd, n_outer8, K_odd,
                                    n_outer8 * K_odd - T_odd)
    U8 = fr.fused_rollout_reference(op8, s0_8, W_8)[0]
    check_close("T=37 K=8 u", odd.u_sys,
                U8.reshape(B_MAIN, -1, 2)[:, :T_odd], ATOL)
    classic8 = make_linear_batched_rollout(bm8, T_odd)(*inputs_odd)
    check_close("T=37 K=8 y vs classic", odd.y_sys, classic8.y_sys, ATOL)
    log(f"edge: T={T_odd}, K={K_odd} (ragged last block) matches the "
        "plain version and the classic engine")

    for w_off in (1, 3, n_outer - 1):
        rot = fr.fused_rollout(op, s0, W, w_off=w_off)
        rolled = fr.fused_rollout(
            op, s0, torch.roll(W, -w_off, dims=1).contiguous()
        )
        for g, w in zip(rot, rolled):
            if not torch.equal(g, w):
                raise AssertionError(f"w_off={w_off} rotation differs "
                                     "from torch.roll")
    log("edge: w_off rotation is bit-equal to torch.roll of the noise")

    # 7. Timing at the main shape.
    solves = B_MAIN * T_MAIN
    args = (x0s, ups, yps, Ws)
    kernel_run = fr.make_amortized_run(bm50, T_MAIN)
    plain_run = fr.make_amortized_run(
        bm50, T_MAIN, rollout=fr.fused_rollout_reference
    )
    classic_fn = make_linear_batched_rollout(bm100, T_MAIN)

    def classic_run(x0s, ups, yps, Ws, R):
        checksum = torch.zeros((), device=dev)
        for _ in range(R):
            r = classic_fn(x0s, ups, yps, Ws)
            checksum = checksum + r.costs[:, -1].sum() + r.x_final.sum() \
                + r.u_sys.sum() + r.y_sys.sum()
        return checksum, torch.isfinite(checksum)

    ms = {"kernel": [], "plain": [], "classic": []}
    runs = {"kernel": kernel_run, "plain": plain_run,
            "classic": classic_run}
    for name in ("kernel", "plain", "classic", "classic", "plain",
                 "kernel"):
        before = fr.fused_rollout.launches
        t, R = time_amortized(runs[name], args)
        launched = fr.fused_rollout.launches - before
        expected = R + 2 if name == "kernel" else 0
        if launched != expected:
            raise AssertionError(f"{name}: {launched} launches, expected "
                                 f"{expected}")
        ms[name].append(t)
        log(f"timing {name}: {t:.4f} ms/rollout over R={R} -> "
            f"{solves / (t * 1e-3):,.0f} solves/s [{smi}]")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"solves/s (mean of 2 turns, B={B_MAIN} x T={T_MAIN}, {smi}): "
        + ", ".join(f"{k} {solves / (v * 1e-3):,.0f}"
                    for k, v in mean.items()))

    # K1's library yardstick: one addmm over all B x n_outer rows [w |
    # s_t] against G, the product the outputs need without the
    # recursion (the port never calls it).
    rows = k1_rows(op, s0, W)
    t_lib = cuda_ms(lambda: torch.addmm(op.bias, rows, op.G), reps=20)
    log(f"K1 yardstick: one addmm {tuple(rows.shape)} x "
        f"{tuple(op.G.shape)}: {t_lib:.4f} ms [{smi}]")
    del rows
    flops = 2.0 * B_MAIN * n_outer * op.G.shape[0] * op.G.shape[1]
    nbytes = tensor_bytes(s0, W, op.G, op.bias, *got)
    k1 = {
        "name": "fused_rollout",
        "route": "cuda",
        "source": "direct_data_driven_mpc_tpu_torch/ops/csrc/"
                  "fused_rollout.cu",
        "replaces": "direct_data_driven_mpc_tpu/ops/pallas_rollout.py:490",
        "launches": main_launches,
        "max_abs_err": kernel_err,
        "ms": mean["kernel"],
        "plain_ms": mean["plain"],
        **bound(flops, nbytes),
        "cuda_kernels": k1_cuda_kernels,  # per launch (host records)
        "library_ms": t_lib,
    }

    k1t = tracking_phases(dev, smi, dict(
        plant=plant, ctrl=ctrl, inputs=(x0s, ups, yps, Ws), k1=got,
        plain=want,
    ))
    main_run = dict(plant=plant, ctrl=ctrl, inputs=(x0s, ups, yps, Ws),
                    bm50=bm50, bm100=bm100)
    generic_timing(dev, smi, generic_phases(dev, smi, main_run))
    # 31-35, before phase 19's convolution (phase 35 counts a trace's
    # kernel events).
    host_layer_phase(dev, smi, main_run)
    sweep = sweep_phase(dev, smi, main_run)
    segmented_phase(dev, smi, main_run)
    tuning_phase(dev, smi, main_run)
    profiling_phase(dev, smi, sweep)
    del sweep
    # 36-39, before phase 19's convolution (phase 38 counts the host's
    # launch records in torch.profiler).
    host = host_cpu()
    native_phase(smi, host)
    export_phase(smi)
    time_parallel_phase(dev, smi, main_run)
    device_ops_phase(dev, smi, main_run)
    # 40-42, before phase 19's convolution (phase 42 counts the host's
    # launch records in torch.profiler).
    t0 = time.perf_counter()
    multidevice_phases(dev, smi, main_run)
    log(f"phases 40-42: {time.perf_counter() - t0:.1f} s")
    # 43-45: the example CLIs, the paper reproduction, the entry points.
    t0 = time.perf_counter()
    example_phase(dev, smi)
    reproduction_phase(dev, smi)
    entry_phase(dev, smi)
    log(f"phases 43-45: {time.perf_counter() - t0:.1f} s")
    k4 = admm_phases(dev, smi)
    k5 = ladder_phases(dev, smi)
    k3 = large_plant_phases(dev, smi)
    # 46-47, after phase 19's convolution: neither reads torch.profiler.
    t0 = time.perf_counter()
    random_dims_phase(dev, smi)
    t1 = time.perf_counter()
    long_horizon_phase(dev, smi)
    log(f"phases 46-47: {t1 - t0:.1f} + {time.perf_counter() - t1:.1f} s")
    # 48, after 47: it reads no torch.profiler.
    t0 = time.perf_counter()
    k4w, k5w = wide_admm_phase(dev, smi)
    log(f"phase 48: {time.perf_counter() - t0:.1f} s")
    # 49, after 48: it reads no torch.profiler.
    t0 = time.perf_counter()
    last_options_phase(dev, smi)
    log(f"phase 49: {time.perf_counter() - t0:.1f} s")
    if (torch.get_float32_matmul_precision() != "high"
            or torch.backends.cuda.matmul.fp32_precision != "tf32"):
        raise AssertionError("the caller's float32 matmul precision did not "
                             "survive the port's scoped guard")
    log("precision: the caller's torch.set_float32_matmul_precision("
        "'high') reads back after every phase")
    print(json.dumps({"kernels": [k1, k4, k5, k3, k1t, k4w, k5w]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
